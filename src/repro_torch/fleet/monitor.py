"""ECC-style error observation for the fleet recalibration loop (port
of `repro.fleet.monitor`).

The serving fleet cannot see cell margins — it sees ECC events: a
replayed request that lands on a word containing cells whose DRIFTED
margin went negative under the DEPLOYED timing row raises a correctable
(one failing cell, SECDED corrects) or uncorrectable (two or more
failing cells in one word) event.  This module supplies both halves of
that observation:

  * `ErrorMonitor.probe` — the margin side: ONE chunked `MarginEngine`
    dispatch pairing every module's drifted cells with ITS deployed
    per-(module, rank-bank) rows at the epoch temperature (the same
    module-diagonal + bank-diagonal extraction as
    `aldram.ALDRAMController.verify`), reduced to the per-(module,
    bank) count of failing tail cells and the worst margin.  This is
    simultaneously the fleet's PATROL SCRUB: a scrub pass reads every
    row, so each failing cell it finds is one observed (and corrected)
    correctable event.
  * `ecc_events` — the traffic side: expected correctable /
    uncorrectable event counts for the served accesses given the
    failing-cell counts, under a words-as-Bernoulli-coverage model.
    The uncorrectable probability is gated EXACTLY to zero for fewer
    than two failing cells (`np.where` on the integer count, not float
    arithmetic) so "zero uncorrectable events" is a deterministic
    outcome the error-driven policy can be held to, not a tolerance.

The event model is host numpy in float64, as the reference's; the
probe's margin grids, their module diagonals and the per-(module,
bank[, region]) reductions stay on the engine's device, and only the
[modules, banks(, regions)] results come back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.aldram import cell_diagonal
from repro_torch.core.sweep import MarginEngine
from repro_torch.core.variation import Population


@dataclasses.dataclass(frozen=True)
class ECCConfig:
    """SECDED-word event model + penalty prices.

    word_coverage    : probability that one served access's ECC word
                       contains a GIVEN failing tail cell of its
                       (module, bank) — the tail cells stand in for the
                       weak end of the bank, so coverage is well above
                       a physical cell/word ratio.
    accesses_per_epoch : served column accesses per (module, bank) per
                       epoch that the event expectation is priced over
                       (the replayed trace is a sample of this traffic).
    corr_penalty_ns  : latency of one correctable event (ECC pipeline
                       correction + scrub write-back).
    unc_penalty_ns   : cost of one uncorrectable event charged to the
                       latency account (machine-check, page retire,
                       recovery) — the reason the effective-latency
                       frontier punishes a stale table so hard.
    """

    word_coverage: float = 0.05
    accesses_per_epoch: float = 1.0e5
    corr_penalty_ns: float = 2.0e3
    unc_penalty_ns: float = 5.0e6


def ecc_events(fail_counts: np.ndarray, cfg: ECCConfig = ECCConfig(),
               accesses: np.ndarray | float | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Expected (correctable, uncorrectable) event counts per entry.

    fail_counts: integer [...] failing-cell counts f per (module,
    bank).  Each access's word covers a given failing cell with
    probability c, independently, so per access

        p_corr = f * c * (1 - c)^(f - 1)        (exactly one covered)
        p_unc  = 1 - (1 - c)^f - p_corr         (two or more covered)

    `p_unc` is forced to exactly 0.0 where f < 2: SECDED corrects a
    single failing cell with certainty, and the gate is on the integer
    count so float residue from the closed form can never report a
    phantom uncorrectable event (the error-driven policy's zero-
    uncorrectable guarantee in `benchmarks.fleet_bench` greps this).
    """
    f = np.asarray(fail_counts)
    if not np.issubdtype(f.dtype, np.integer):
        raise TypeError(f"fail_counts must be integer counts, got {f.dtype} "
                        "(the uncorrectable gate is on the integer count)")
    if (f < 0).any():
        raise ValueError(
            f"fail_counts must be non-negative, got min {f.min()} — a "
            "negative failing-cell count is always an upstream "
            "accounting bug, and the Bernoulli-coverage closed form "
            "would silently price it as a negative event rate")
    if accesses is None:
        accesses = cfg.accesses_per_epoch
    a = np.broadcast_to(np.asarray(accesses, np.float64), f.shape)
    c = float(cfg.word_coverage)
    ff = f.astype(np.float64)
    p_corr = ff * c * (1.0 - c) ** np.maximum(ff - 1.0, 0.0)
    p_unc = np.where(f >= 2,
                     np.clip(1.0 - (1.0 - c) ** ff - p_corr, 0.0, None),
                     0.0)
    return a * p_corr, a * p_unc


def event_penalty_ns(corr: np.ndarray, unc: np.ndarray,
                     cfg: ECCConfig = ECCConfig(),
                     accesses: np.ndarray | float | None = None
                     ) -> np.ndarray:
    """Per-access latency penalty (ns) of the given event counts —
    the ECC term of the fleet's effective-latency frontier.

    UNITS CONTRACT: `corr` and `unc` are absolute EVENT COUNTS over
    one accounting period of `accesses` served accesses — the same
    denominator `ecc_events` priced them from (pass the same
    `accesses` here, or leave both to the config default).  The
    config penalties are ns PER EVENT, so the result is ns PER
    ACCESS:

        penalty = (corr * corr_penalty_ns + unc * unc_penalty_ns)
                  / accesses      [ns/access]

    i.e. the number that adds directly onto a mean request latency.
    Passing per-access RATES for `corr`/`unc` (already divided by
    accesses) double-divides and understates the penalty by the
    access count — the regression test pins the counts-in /
    ns-per-access-out convention."""
    if accesses is None:
        accesses = cfg.accesses_per_epoch
    a = np.asarray(accesses, np.float64)
    return (np.asarray(corr) * cfg.corr_penalty_ns
            + np.asarray(unc) * cfg.unc_penalty_ns) / a


@dataclasses.dataclass
class ProbeResult:
    """One scrub pass: per-(module, rank-bank) failing-cell counts and
    worst margins under the deployed rows at the probe temperature."""

    fail_counts: np.ndarray      # [modules, banks(, regions)] int64
    worst_margin: np.ndarray     # [modules, banks(, regions)] float32

    @property
    def clean(self) -> bool:
        return bool((self.fail_counts == 0).all())

    def fail_mask(self) -> np.ndarray:
        return self.fail_counts > 0


@dataclasses.dataclass
class ErrorMonitor:
    """Margin-grid scrub of a (drifted) population under deployed rows.

    `engine.dispatch_count` increments once per probe chunk; at the
    fleet-simulation scales (tens of modules) a probe is ONE dispatch.
    The engine's device (default "cuda") runs the grid and its
    reductions.
    """

    engine: MarginEngine = dataclasses.field(default_factory=MarginEngine)
    max_grid_elems: int = 8_000_000

    def probe(self, pop: Population, rows: np.ndarray,
              temp_c: float) -> ProbeResult:
        """Pair every module's cells with ITS deployed per-bank rows.

        pop:  the population to scrub (typically drifted);
        rows: [modules, banks, 6] deployed timing rows — columns :4
              are the timing parameters, column 4 the per-(module,
              bank) refresh interval in ms (applied to BOTH the read
              and the write test: the deployed tREFI is one register).
              A [modules, banks, regions, 6] stack probes at subarray-
              region granularity: each cell's (bank, row-position
              group) pairs with its combo's (bank, region), exactly
              the region diagonal `ALDRAMController.verify` extracts,
              and the results gain the trailing region axis;
        temp_c: probe temperature (the epoch's operating temperature —
              margins are evaluated where the fleet actually serves).

        The dense margin grid pairs every cell with every row, so only
        its module diagonal (then the bank/region pairing within it,
        `aldram.cell_diagonal`) is useful; large fleets are chunked
        into module groups that keep each dispatch under
        `max_grid_elems`, exactly like `ALDRAMController.verify`.
        """
        rows = np.asarray(rows, np.float32)
        m, ch, bk, kc = pop.cells.shape[:4]
        if not (rows.ndim in (3, 4) and rows.shape[:2] == (m, bk)
                and rows.shape[-1] == 6):
            raise ValueError(f"rows {rows.shape} must be [{m}, {bk}(, "
                             "regions), 6]")
        rg = rows.shape[2] if rows.ndim == 4 else 1
        if kc % rg:
            raise ValueError(f"{rg} regions do not divide {kc} tail cells")
        kcr = kc // rg
        cols = bk * rg
        cpm = ch * bk * kc
        g = max(1, min(m, int((self.max_grid_elems
                               / (cpm * cols)) ** 0.5)))

        cells = pop.flat_cells().reshape(m, cpm, -1)
        fails, worsts = [], []
        for lo in range(0, m, g):
            sl = slice(lo, min(lo + g, m))
            n = sl.stop - sl.start
            combos = rows[sl, ..., :5].reshape(n * cols, 5).copy()
            # the deployed per-(module, bank[, region]) tREFI rides the
            # per-cell override columns (cell layout is (ch, bk, kc)-
            # major, the kc axis region-major: cell k -> group k // kcr)
            trefi = np.broadcast_to(
                rows[sl, ..., 4].reshape(n, 1, bk, rg, 1),
                (n, ch, bk, rg, kcr)).reshape(-1).astype(np.float32)
            read_m, write_m = self.engine.margins(
                cells[sl].reshape(n * cpm, -1), combos,
                temp_c=float(temp_c),
                trefi_read=trefi, trefi_write=trefi)
            # [bk, rg, n, ch, kcr, 1]: each cell under its own module's
            # (bank, region) row, the safer of the two tests taken last
            mb = torch.minimum(
                cell_diagonal(read_m, n, 0, cols, ch, bk, rg, 1),
                cell_diagonal(write_m, n, 0, cols, ch, bk, rg, 1))
            fails.append((mb < 0.0).sum(dim=(3, 4, 5)).permute(2, 0, 1))
            worsts.append(mb.amin(dim=(3, 4, 5)).permute(2, 0, 1))
        fail = torch.cat(fails).cpu().numpy().astype(np.int64)
        worst = torch.cat(worsts).cpu().numpy()
        if rows.ndim == 3:
            fail, worst = fail[..., 0], worst[..., 0]
        return ProbeResult(fail_counts=fail, worst_margin=worst)


__all__ = ["ECCConfig", "ErrorMonitor", "ProbeResult", "ecc_events",
           "event_penalty_ns"]

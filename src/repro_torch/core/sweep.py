"""Declarative profiling sweeps (port of `repro.core.sweep`): the
paper's Sec. 5 characterization campaign (modules x timing combos x
temperatures x read/write tests) as ONE `margin_grid` launch.

The margin kernel is elementwise over a (cells x combos) grid, so every
sweep axis is a block structure on that grid: temperature bins are the
per-combo temperature column, the read/write op is the kernel's two
outputs, and per-module safe refresh intervals are per-cell, per-op
tREFI override columns.

Host/device split: the [cells x combos] margin grids stay on the
engine's device (12 GB at the full 115-module campaign).  The `>= 0`
pass reductions over chips and tail cells run there too, and only the
[modules, banks(, regions), temps, combos] booleans cross to the host,
where the (small) combo selection runs in numpy.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.charge import ChargeConstants, DEFAULT_CONSTANTS
from repro_torch.core.variation import Population
from repro_torch.device import resolve_device


class Op(enum.Enum):
    """Which DRAM test a sweep exercises (paper Sec. 5.1)."""

    READ = "read"
    WRITE = "write"

    @classmethod
    def parse(cls, v: "Op | str") -> "Op":
        return v if isinstance(v, Op) else Op(str(v).lower())

    @property
    def latency_cols(self) -> tuple[int, ...]:
        """Combo columns of this test's latency sum (Fig. 3c/3d)."""
        return (0, 1, 3) if self is Op.READ else (0, 2, 3)


@dataclasses.dataclass(frozen=True)
class OpSweep:
    """One test of a campaign: an op, its combo grid, and (optionally)
    the per-module safe refresh interval the test runs at."""

    op: Op
    combos: np.ndarray                           # [n_combos, 5]
    trefi_ms: np.ndarray | float | None = None   # [modules], scalar, None

    def __post_init__(self):
        object.__setattr__(self, "op", Op.parse(self.op))
        object.__setattr__(self, "combos",
                           np.asarray(self.combos, np.float32))

    def trefi_per_module(self, n_modules: int) -> np.ndarray | None:
        if self.trefi_ms is None:
            return None
        t = np.asarray(self.trefi_ms, np.float32)
        if t.ndim == 0:
            t = np.full((n_modules,), float(t), np.float32)
        if t.shape != (n_modules,):
            raise ValueError(f"trefi_ms shape {t.shape} != ({n_modules},)")
        return t


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A declarative multi-axis profiling campaign: every test runs at
    every temperature bin.  All READ tests must agree on `trefi_ms`
    (likewise WRITE): the per-op override is a per-cell column shared
    by every combo column of that op in the fused launch."""

    tests: tuple[OpSweep, ...]
    temps: tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "tests", tuple(self.tests))
        object.__setattr__(self, "temps",
                           tuple(float(t) for t in self.temps))
        if not (self.tests and self.temps):
            raise ValueError("empty sweep")

    @classmethod
    def single(cls, op: Op | str, combos: np.ndarray,
               temps: tuple[float, ...] | float,
               trefi_ms: np.ndarray | float | None = None) -> "SweepSpec":
        temps = (temps,) if isinstance(temps, (int, float)) else tuple(temps)
        return cls(tests=(OpSweep(Op.parse(op), combos, trefi_ms),),
                   temps=temps)

    def op_trefi(self, op: Op, n_modules: int) -> np.ndarray | None:
        """The shared per-module tREFI override of all `op` tests."""
        picked: np.ndarray | None = None
        seen = False
        for t in self.tests:
            if t.op is not op:
                continue
            cur = t.trefi_per_module(n_modules)
            if seen and not _same_trefi(picked, cur):
                raise ValueError(
                    f"all {op.value} tests in one sweep must share trefi_ms")
            picked, seen = cur, True
        return picked


def _same_trefi(a: np.ndarray | None, b: np.ndarray | None) -> bool:
    if a is None or b is None:
        return a is b
    return np.array_equal(a, b)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Structured result of one fused campaign.

    Per test k (aligned with spec.tests):
      margins[k]:     [n_cells, n_temps, n_combos_k] raw test margins, a
                      view of the grid on the engine's device
      ok[k]:          [modules, n_temps, n_combos_k] pass envelope
      chosen[k]:      [modules, n_temps, 5] minimum-latency passing combo
                      (min latency sum, min tRCD tie-break), the
                      module's tREFI in column 4
      latency_sum[k]: [modules, n_temps] latency sum of the choice
    and the per-rank-level-bank views of the same launch:
      ok_bank[k] [modules, banks, n_temps, n_combos_k], chosen_bank[k]
      [modules, banks, n_temps, 5], latency_sum_bank[k]
      [modules, banks, n_temps], with ok[k] == ok_bank[k].all(1);
    and, when the campaign asks for `regions` > 1, the per-(bank,
    subarray region) views (the tail-cell axis is the row-position
    axis, split into `regions` contiguous groups):
      ok_region[k] [modules, banks, regions, n_temps, n_combos_k],
      chosen_region[k] [modules, banks, regions, n_temps, 5],
      latency_sum_region[k] [modules, banks, regions, n_temps],
    with ok_bank[k] == ok_region[k].all(2), exactly.
    """

    spec: SweepSpec
    std: T.TimingParams
    margins: tuple[torch.Tensor, ...]
    ok: tuple[np.ndarray, ...]
    chosen: tuple[np.ndarray, ...]
    latency_sum: tuple[np.ndarray, ...]
    ok_bank: tuple[np.ndarray, ...] = ()
    chosen_bank: tuple[np.ndarray, ...] = ()
    latency_sum_bank: tuple[np.ndarray, ...] = ()
    regions: int = 1
    ok_region: tuple[np.ndarray, ...] = ()
    chosen_region: tuple[np.ndarray, ...] = ()
    latency_sum_region: tuple[np.ndarray, ...] = ()

    @property
    def temps(self) -> tuple[float, ...]:
        return self.spec.temps

    def index(self, op: Op | str) -> int:
        """Index of the first test exercising `op`."""
        op = Op.parse(op)
        for k, t in enumerate(self.spec.tests):
            if t.op is op:
                return k
        raise KeyError(op)

    def reductions(self, op: Op | str) -> tuple[dict[str, float], ...]:
        """Per-temperature average reductions vs standard timings (the
        paper's Sec. 5.2 statistics), one dict per temp bin."""
        k = self.index(op)
        op = Op.parse(op)
        chosen, sums = self.chosen[k], self.latency_sum[k]
        base = self.std.read_sum() if op is Op.READ else self.std.write_sum()
        out = []
        for ti in range(len(self.temps)):
            r = param_reductions(chosen[:, ti, :], self.std, allsafe=True)
            r["latency_sum"] = float(1 - (sums[:, ti] / base).mean())
            out.append(r)
        return tuple(out)


def param_reductions(params: np.ndarray, std: T.TimingParams,
                     allsafe: bool = False) -> dict[str, float]:
    """Mean fractional timing reductions vs `std` (the paper's Sec. 5.2
    statistic).  params: [..., >=4] rows of (trcd, tras, twr, trp[, ..]).
    With `allsafe`, adds the max-based reductions that are safe for ALL
    modules (Sec. 6 system eval)."""
    cols = ("trcd", "tras", "twr", "trp")
    stds = (std.trcd, std.tras, std.twr, std.trp)
    flat = np.asarray(params).reshape(-1, params.shape[-1])
    r = {n: float(1 - (flat[:, i] / s).mean())
         for i, (n, s) in enumerate(zip(cols, stds))}
    if allsafe:
        r.update({f"{n}_allsafe": float(1 - flat[:, i].max() / s)
                  for i, (n, s) in enumerate(zip(cols, stds))})
    return r


def select_combos(combos: np.ndarray, ok: np.ndarray, op: Op | str,
                  trefi_ms: np.ndarray | None = None,
                  std: T.TimingParams = T.DDR3_1600
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised per-module combo selection (paper Sec. 5.1 step 4):
    among passing combos pick minimum latency sum, min-tRCD tie-break;
    fall back to the slowest combo when nothing passes.

    combos: [C, 5]; ok: [..., C] bool -> (chosen [..., 5], sums [...]).
    """
    op = Op.parse(op)
    lat_sum = combos[:, op.latency_cols].sum(-1)
    order = np.lexsort((combos[:, 0], lat_sum))        # min sum, min tRCD
    ok_ord = np.take_along_axis(ok, np.broadcast_to(order, ok.shape), -1)
    first = ok_ord.argmax(-1)                          # first pass in order
    has = ok_ord.any(-1)
    pick = np.where(has, order[first], int(lat_sum.argmax()))
    chosen = combos[pick].astype(np.float32)           # [..., 5]
    if trefi_ms is None:
        chosen[..., 4] = std.trefi
    else:
        # trefi is per-module: broadcast over any trailing sweep axes
        t = np.asarray(trefi_ms, np.float32)
        chosen[..., 4] = t.reshape(t.shape + (1,) * (pick.ndim - 1))
    return chosen, lat_sum[pick].astype(np.float32)


@dataclasses.dataclass
class MarginEngine:
    """Facade that compiles a `SweepSpec` into one kernel launch on
    `device` (default "cuda"; raises without a card).

    `dispatch_count` increments once per `margins` call — profiling
    campaigns cost O(1) launches regardless of the number of
    temperature bins, modules or ops."""

    constants: ChargeConstants = DEFAULT_CONSTANTS
    std: T.TimingParams = T.DDR3_1600
    device: str | torch.device = "cuda"
    dispatch_count: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _tensor(self, x) -> torch.Tensor | None:
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------ low level
    def margins(self, cells, combos, temps_combo=None,
                temp_c: float | None = None, trefi_read=None,
                trefi_write=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One launch: dense (read, write) margin grids [n, m] on the
        engine's device.  Give either `temps_combo` ([m] per-combo
        temperature) or a scalar `temp_c`; `trefi_read`/`trefi_write`
        are optional [n] per-cell refresh-interval overrides."""
        from repro_torch.kernels.charge_sim import ops as charge_ops
        combos = self._tensor(combos)
        if temps_combo is None:
            if temp_c is None:
                raise ValueError("need temps_combo or temp_c")
            temps_combo = torch.full((combos.shape[0],), float(temp_c),
                                     dtype=torch.float32, device=self.device)
        self.dispatch_count += 1
        return charge_ops.margin_sweep(
            self._tensor(cells), combos, self._tensor(temps_combo),
            self.constants, self._tensor(trefi_read),
            self._tensor(trefi_write))

    # ------------------------------------------------------------ campaign
    def campaign_columns(self, pop: Population, spec: SweepSpec):
        """The fused grid's column layout: tests concatenated, each
        test's combo grid tiled once per temperature bin (temp-major)
        with the bin temperature in the per-combo temperature column;
        per-module safe refresh intervals expanded to the per-cell,
        per-op override columns.  Returns (combos [M, 5], temps [M],
        {op: per-module tREFI or None}, {op: per-cell tREFI or None})."""
        n_mod = pop.n_modules
        cpm = int(np.prod(pop.cells.shape[1:4]))      # cells per module
        temps_arr = np.asarray(spec.temps, np.float32)
        blocks, temp_cols = [], []
        for test in spec.tests:
            blocks.append(np.tile(test.combos, (len(spec.temps), 1)))
            temp_cols.append(np.repeat(temps_arr, test.combos.shape[0]))
        trefi_mod = {op: spec.op_trefi(op, n_mod) for op in Op}
        trefi_cells = {op: (None if trefi_mod[op] is None
                            else np.repeat(trefi_mod[op], cpm))
                       for op in Op}
        return (np.concatenate(blocks, axis=0),
                np.concatenate(temp_cols, axis=0), trefi_mod, trefi_cells)

    def sweep(self, pop: Population, spec: SweepSpec,
              regions: int = 1) -> SweepResult:
        """Run a whole declarative campaign in ONE launch, then reduce
        the grid on the device to per-(module, bank) pass envelopes and,
        with `regions` > 1, per-(module, bank, subarray region) ones:
        the tail-cell axis splits into `regions` contiguous groups (cell
        k -> region k * regions // n_cells), still one launch."""
        n_mod = pop.n_modules
        ch, bk, kc = pop.cells.shape[1:4]
        if regions < 1 or kc % regions:
            raise ValueError(f"regions={regions} must divide the {kc} tail "
                             "cells (contiguous row-position groups)")
        n_temps = len(spec.temps)
        combos_all, temps_all, trefi_mod, trefi_cells = \
            self.campaign_columns(pop, spec)
        read_m, write_m = self.margins(
            pop.flat_cells(), combos_all, temps_all,
            trefi_read=trefi_cells[Op.READ],
            trefi_write=trefi_cells[Op.WRITE])

        margins, ok, chosen, sums = [], [], [], []
        ok_b, chosen_b, sums_b = [], [], []
        ok_r, chosen_r, sums_r = [], [], []
        off = 0
        for test in spec.tests:
            c = test.combos.shape[0]
            block = (read_m if test.op is Op.READ else write_m)
            m3 = block[:, off:off + n_temps * c].unflatten(1, (n_temps, c))
            off += n_temps * c
            # region envelope: every chip and every tail cell of the
            # region's row-position group passes; the bank envelope
            # intersects the regions, the module envelope the banks
            okr_d = ((m3 >= 0.0).view(n_mod, ch, bk, regions,
                                      kc // regions, n_temps, c)
                     .all(4).all(1))                 # [mod, bk, R, T, C]
            okb_k = okr_d.all(2).cpu().numpy()       # [mod, bk, T, C]
            ok_k = okb_k.all(1)
            ch_k, s_k = select_combos(test.combos, ok_k, test.op,
                                      trefi_mod[test.op], self.std)
            chb_k, sb_k = select_combos(test.combos, okb_k, test.op,
                                        trefi_mod[test.op], self.std)
            margins.append(m3)
            ok.append(ok_k)
            chosen.append(ch_k)
            sums.append(s_k)
            ok_b.append(okb_k)
            chosen_b.append(chb_k)
            sums_b.append(sb_k)
            if regions > 1:
                okr_k = okr_d.cpu().numpy()
                chr_k, sr_k = select_combos(test.combos, okr_k, test.op,
                                            trefi_mod[test.op], self.std)
                ok_r.append(okr_k)
                chosen_r.append(chr_k)
                sums_r.append(sr_k)
        return SweepResult(spec=spec, std=self.std,
                           margins=tuple(margins), ok=tuple(ok),
                           chosen=tuple(chosen), latency_sum=tuple(sums),
                           ok_bank=tuple(ok_b), chosen_bank=tuple(chosen_b),
                           latency_sum_bank=tuple(sums_b), regions=regions,
                           ok_region=tuple(ok_r),
                           chosen_region=tuple(chosen_r),
                           latency_sum_region=tuple(sums_r))

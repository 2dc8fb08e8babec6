"""Aging / variable-retention drift of the cell population (port of
`repro.fleet.drift`).

AL-DRAM's reliability argument (paper Sec. 4/5.1) is stated for the
population the profiler measured; FLY-DRAM (Chang et al.) shows the
margins it exploits DRIFT — retention degrades with age, variable-
retention-time (VRT) cells toggle between retention states over hours
to days, and the design-induced-variation follow-up (Lee et al.) shows
the guardband-setting tail is spatially concentrated and moves.  This
module is the silicon side of that story, host-side numpy over the
`variation.Population` hierarchy:

  * AGING: every cell accumulates a log-space shift toward its weak
    side (`variation.FIELD_WEAK_SIGNS`), at a per-cell, per-field rate.
    Rates are lognormal around the config's per-field means and are
    ACCELERATED for tail cells (`variation.weakness_score`): the weak
    tail that set the guardband is exactly the part of the population
    that moves fastest, so the deployed table's margin erodes where it
    was thinnest.  Aging also accelerates with operating temperature
    (Arrhenius-style factor per 10C above the reference).
  * VRT: each cell-day a cell may toggle into a degraded retention
    state (tau_ret multiplied by `vrt_drop`) and later recover — the
    step-function retention failures that make one-shot profiling
    insufficient no matter how generous the one-shot guardband.

The model is deliberately one-directional in expectation (aging never
improves a cell) so "the zero-error invariant must be RESTORED by the
online guardband, not waited out" is structural; VRT recovery is the
only mechanism that gives margin back.

`DriftModel.cells(...)` returns a stacked cell array shaped exactly
like `Population.cells` — feed it back through `Population.with_cells`
and the whole unchanged profile->table->replay stack (MarginEngine
sweeps, SimEngine replays, `ALDRAMController.verify`) prices the aged
fleet.

As in the reference, the drift is host numpy in float64 on numpy
Generators (the per-cell jitter once, then one uniform draw per
`advance`), cast to float32 last: given the same cells and seed the
trajectory is bit for bit the reference's.  The population's cells are
copied to the host once; `population` hands the drifted cells back on
the population's device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.variation import (Population, VariationConfig,
                                        weakness_score)
from repro_torch.core.variation import FIELD_WEAK_SIGNS as _SIGNS

FIELD_WEAK_SIGNS = np.asarray(_SIGNS, np.float32)


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Drift hyper-parameters; rates are ln-units per simulated DAY.

    The defaults are compressed so a fleet-month (30 epochs) spans the
    interesting regime on the calibrated population: the weakest bank
    rows start throwing correctable errors within the first week and
    an unrecalibrated table accumulates uncorrectable collisions well
    before day 30, while a tightened/re-profiled table stays clean.
    They are also bounded the other way: the worst-case accumulated
    shift over a fleet-month stays well inside the JEDEC anchor's
    margin headroom (~1.0 charge margin on the calibrated population;
    an all-field ln-shift of ~0.35, or a retention-only shift of ~2.0,
    is where standard timings start failing), so over a fleet-month at
    the validation operating points falling back to JEDEC rows restores
    the zero-error invariant — drift erodes the margin AL-DRAM
    exploits, not the manufacturer guarantee.  (Only a pathological
    month spent ENTIRELY >= ~12C above reference compounds enough
    thermally-accelerated aging to threaten the JEDEC anchor itself.)
    """

    # mean aging rate per field (tau_r, xfer, tau_ret85, tau_p, tau_w)
    rate_tau_r: float = 3.0e-4
    rate_xfer: float = 2.0e-4
    rate_tau_ret: float = 8.0e-3     # retention drifts fastest (VRT/aging)
    rate_tau_p: float = 3.0e-4
    rate_tau_w: float = 8.0e-4
    tail_accel: float = 2.5          # extra rate per unit weakness score
    rate_jitter: float = 0.4         # lognormal spread of per-cell rates
    # variable retention time: weak-state toggling
    vrt_prob: float = 1.5e-3         # per cell-day entry probability
    vrt_recover: float = 0.2         # per cell-day exit probability
    vrt_drop: float = 0.65           # tau_ret multiplier while in weak state
    # thermal acceleration of aging (per 10C above ref)
    temp_accel_per_10c: float = 0.35
    ref_temp_c: float = 45.0
    # within-bank row-position acceleration (design-induced variation,
    # Lee et al.): cells far from the sense amps / wordline drivers age
    # faster by (1 + region_accel * position), `position` the same
    # normalized row-position axis `charge.row_positions` partitions
    # into subarray regions — so under drift the regions of a bank
    # DIVERGE and a region table's compression ratio degrades over the
    # fleet-month.  0.0 = off: bit-exactly the pre-hierarchy
    # trajectories.
    region_accel: float = 0.0

    def rate_means(self) -> np.ndarray:
        return np.array([self.rate_tau_r, self.rate_xfer,
                         self.rate_tau_ret, self.rate_tau_p,
                         self.rate_tau_w], np.float32)


class DriftState(NamedTuple):
    """Carried drift state over the population hierarchy.

    aged: [modules, chips, banks, K, 5] accumulated ln-shift toward
          the weak side (>= 0, monotone non-decreasing).
    vrt:  [modules, chips, banks, K] bool — currently in the degraded
          retention state.
    day:  simulated days elapsed.
    """

    aged: np.ndarray
    vrt: np.ndarray
    day: float


class DriftModel:
    """Seeded, stateless-step drift process over one `Population`.

    The per-cell rates are drawn ONCE at construction (a cell's aging
    trajectory is a property of that cell, not re-rolled per step);
    `advance` folds in days at a given operating temperature and the
    VRT telegraph noise, and `cells`/`population` materialize the
    drifted parameters.
    """

    def __init__(self, pop: Population,
                 cfg: DriftConfig = DriftConfig(),
                 var_cfg: VariationConfig = VariationConfig(),
                 seed: int = 0):
        self.cfg = cfg
        self.pop = pop
        self.base = pop.cells.detach().cpu().numpy().astype(np.float64)
        rng = np.random.default_rng(seed)
        score = weakness_score(self.base, var_cfg)          # [..., ]
        jitter = np.exp(rng.normal(0.0, cfg.rate_jitter,
                                   self.base.shape))
        self.rates = (cfg.rate_means() * jitter
                      * (1.0 + cfg.tail_accel * score)[..., None])
        if cfg.region_accel != 0.0:
            from repro_torch.core.charge import row_positions
            pos = row_positions(self.base.shape[-2]).numpy().astype(
                np.float64)
            self.rates = self.rates * (
                1.0 + cfg.region_accel * pos)[:, None]
        self._rng = rng

    def init_state(self) -> DriftState:
        return DriftState(aged=np.zeros_like(self.base),
                          vrt=np.zeros(self.base.shape[:-1], bool),
                          day=0.0)

    def temp_factor(self, temp_c: float) -> float:
        """Arrhenius-style aging acceleration at `temp_c`."""
        dt = (temp_c - self.cfg.ref_temp_c) / 10.0
        return float(np.exp(self.cfg.temp_accel_per_10c
                            * max(dt, 0.0)))

    def advance(self, state: DriftState, days: float = 1.0,
                temp_c: float | None = None) -> DriftState:
        """Fold `days` of aging at `temp_c` plus VRT toggling."""
        cfg = self.cfg
        f = self.temp_factor(cfg.ref_temp_c if temp_c is None
                             else temp_c)
        aged = state.aged + self.rates * (days * f)
        p_in = 1.0 - (1.0 - cfg.vrt_prob) ** days
        p_out = 1.0 - (1.0 - cfg.vrt_recover) ** days
        u = self._rng.uniform(size=state.vrt.shape)
        vrt = np.where(state.vrt, u >= p_out, u < p_in)
        return DriftState(aged=aged, vrt=vrt, day=state.day + days)

    def cells(self, state: DriftState) -> np.ndarray:
        """Drifted stacked cell parameters (same layout as
        `Population.cells`): every field moves toward its weak side by
        the accumulated shift, and VRT cells additionally carry the
        degraded retention multiplier."""
        out = self.base * np.exp(FIELD_WEAK_SIGNS * state.aged)
        ret = np.where(state.vrt, self.cfg.vrt_drop, 1.0)
        out = out.copy()
        out[..., 2] *= ret
        return out.astype(np.float32)

    def population(self, state: DriftState) -> Population:
        return self.pop.with_cells(torch.from_numpy(self.cells(state)))


__all__ = ["DriftConfig", "DriftState", "DriftModel"]

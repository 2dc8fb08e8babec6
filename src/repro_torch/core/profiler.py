"""DRAM latency profiler — the SoftMC/FPGA campaign analogue (paper
Sec. 5), port of `repro.core.profiler`.

Given a module population, the profiler sweeps the refresh interval at
standard timings (Fig. 2a), derives the safe refresh interval (max
passing minus an 8 ms guardband), sweeps all timing combos at the safe
interval and each temperature (Fig. 2b/c), and selects per module the
minimum-latency passing combo.  Everything runs through
`repro_torch.core.sweep.MarginEngine`: a refresh campaign (both ops) is
one launch, and a multi-temperature read+write timing campaign is one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.charge import ChargeConstants, DEFAULT_CONSTANTS
from repro_torch.core.sweep import (MarginEngine, Op, OpSweep, SweepSpec,
                                    param_reductions)
from repro_torch.core.variation import Population


class RefreshProfile(NamedTuple):
    """Maximum error-free refresh intervals (ms) at standard timings.

    per_chip[m, c]: the worst bank (and tail cell) of chip c governs.
    per_bank[m, b]: rank-level bank b spans bank b of every chip, so
    the worst chip at that bank index governs.
    per_module == per_chip.min(1) == per_bank.min(1) exactly."""

    per_module: np.ndarray        # [modules]
    per_chip: np.ndarray          # [modules, chips]
    per_bank: np.ndarray          # [modules, banks]
    safe: np.ndarray              # [modules] = per_module - guardband


class TimingProfile(NamedTuple):
    """Chosen error-free timing combo per module at one temperature."""

    combos: np.ndarray            # [modules, 5] (trcd, tras, twr, trp, trefi)
    latency_sum: np.ndarray       # [modules]
    pass_per_module: np.ndarray   # [modules, n_combos] bool


@dataclasses.dataclass(frozen=True)
class Profiler:
    constants: ChargeConstants = DEFAULT_CONSTANTS
    std: T.TimingParams = T.DDR3_1600
    refresh_guardband_ms: float = T.REFRESH_STEP_MS
    grid_step: float = T.TIMING_STEP_NS
    device: str | torch.device = "cuda"
    engine: MarginEngine | None = None    # built from the fields if None

    def __post_init__(self):
        if self.engine is None:
            object.__setattr__(self, "engine", MarginEngine(
                constants=self.constants, std=self.std, device=self.device))
        object.__setattr__(self, "device", self.engine.device)

    # ---------------------------------------------------------- combo grids
    def combo_grid(self, op: Op | str) -> np.ndarray:
        op = Op.parse(op)
        grid = (T.read_combo_grid if op is Op.READ else T.write_combo_grid)
        return grid(self.std, self.grid_step)

    def campaign_spec(self, temps: tuple[float, ...],
                      rp_read: RefreshProfile,
                      rp_write: RefreshProfile) -> SweepSpec:
        """The standard full campaign: read+write combo grids at each
        test's safe refresh interval, across `temps`."""
        return SweepSpec(
            temps=tuple(temps),
            tests=(OpSweep(Op.READ, self.combo_grid(Op.READ), rp_read.safe),
                   OpSweep(Op.WRITE, self.combo_grid(Op.WRITE),
                           rp_write.safe)))

    # ---------------------------------------------------- refresh sweep (2a)
    def refresh_campaign(self, pop: Population, temp: float = 85.0,
                         grid_ms: np.ndarray | None = None
                         ) -> tuple[RefreshProfile, RefreshProfile]:
        """Refresh-interval envelopes for BOTH tests from ONE launch."""
        grid = grid_ms if grid_ms is not None else T.refresh_grid()
        combos = np.repeat(self.std.as_array().numpy()[None, :], len(grid),
                           axis=0)
        combos[:, 4] = grid
        read_m, write_m = self.engine.margins(pop.flat_cells(), combos,
                                              temp_c=temp)
        return (self._refresh_envelopes(pop, read_m, grid),
                self._refresh_envelopes(pop, write_m, grid))

    def refresh_profile(self, pop: Population, temp: float, op: Op | str,
                        grid_ms: np.ndarray | None = None) -> RefreshProfile:
        """Single-test shim over `refresh_campaign` (same one launch)."""
        rp_read, rp_write = self.refresh_campaign(pop, temp, grid_ms)
        return rp_read if Op.parse(op) is Op.READ else rp_write

    def _refresh_envelopes(self, pop: Population, margins: torch.Tensor,
                           grid: np.ndarray) -> RefreshProfile:
        m, ch, bk, k = pop.cells.shape[:4]
        # pass/fail reduced over tail cells on the device: [m, ch, bk, g]
        per_cellmin = ((margins >= 0.0).view(m, ch, bk, k, len(grid))
                       .all(3).cpu().numpy())

        def max_passing(mask: np.ndarray) -> np.ndarray:
            # the envelope is monotone (longer interval = more leakage),
            # so take the last grid value before the first failure
            any_fail = ~mask
            idx = np.where(any_fail.any(-1), any_fail.argmax(-1), len(grid))
            idx = np.maximum(idx - 1, 0)
            return grid[idx]

        per_bank = max_passing(per_cellmin.all(1))              # [m, banks]
        per_chip = max_passing(per_cellmin.all(2))              # [m, chips]
        per_module = max_passing(per_cellmin.all(1).all(1))
        safe = np.maximum(per_module - self.refresh_guardband_ms, grid[0])
        return RefreshProfile(per_module, per_chip, per_bank, safe)

    # ------------------------------------------------- timing sweep (2b/2c)
    def timing_profile(self, pop: Population, temp: float, op: Op | str,
                       safe_trefi_ms: np.ndarray | None = None
                       ) -> TimingProfile:
        """Sweep timing combos for every module at its safe refresh
        interval (shim over a single-test, single-temperature spec)."""
        op = Op.parse(op)
        spec = SweepSpec.single(op, self.combo_grid(op), (float(temp),),
                                safe_trefi_ms)
        res = self.engine.sweep(pop, spec)
        return TimingProfile(res.chosen[0][:, 0, :],
                             res.latency_sum[0][:, 0],
                             res.ok[0][:, 0, :])

    # ----------------------------------------------------------- reductions
    def reductions(self, prof: TimingProfile, op: Op | str
                   ) -> dict[str, float]:
        """Average per-parameter and latency-sum reductions vs standard."""
        op = Op.parse(op)
        r = param_reductions(prof.combos, self.std, allsafe=True)
        base = self.std.read_sum() if op is Op.READ else self.std.write_sum()
        r["latency_sum"] = float(1 - (prof.latency_sum / base).mean())
        return r

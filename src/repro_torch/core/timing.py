"""DRAM timing parameters and sweep grids (port of `repro.core.timing`).

The four critical parameters from the paper (Sec. 2): tRCD, tRAS, tWR,
tRP, plus the refresh interval tREFI.  All latencies in nanoseconds,
refresh interval in milliseconds.  Defaults are JEDEC DDR3-1600.

The grids stay numpy (they are small host-side tables); `as_array`
returns a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# Sweep steps (paper Sec. 5.1 / Sec. 6 methodology).
TIMING_STEP_NS = 1.25     # half a DDR3-1600 command clock; fine grid
REFRESH_STEP_MS = 8.0     # paper's refresh-interval sweep increment

# DDR3 standard refresh interval (64 ms retention window).
STANDARD_TREFI_MS = 64.0


@dataclasses.dataclass(frozen=True)
class TimingParams:
    """One set of DRAM timing parameters (the memory controller's knobs)."""

    trcd: float   # ACT -> READ/WRITE delay (sensing), ns
    tras: float   # ACT -> PRE delay (sensing + restore), ns
    twr:  float   # end of WRITE -> PRE delay (write recovery), ns
    trp:  float   # PRE -> ACT delay (precharge), ns
    trefi: float = STANDARD_TREFI_MS   # refresh window, ms
    tcl:  float = 13.75                # CAS latency (not optimised by AL-DRAM)

    def as_array(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """[5] float32 combo row (trcd, tras, twr, trp, trefi)."""
        return torch.tensor([self.trcd, self.tras, self.twr, self.trp,
                             self.trefi], dtype=torch.float32,
                            device=device)

    def as_row(self) -> np.ndarray:
        """Stacked-row layout consumed by the batched DRAM simulator
        (`repro_torch.core.sim_engine`): (trcd, tras, twr, trp, trefi,
        tcl)."""
        return np.array([self.trcd, self.tras, self.twr, self.trp,
                         self.trefi, self.tcl], dtype=np.float32)

    @classmethod
    def from_row(cls, row) -> "TimingParams":
        """Inverse of `as_row` (accepts any [>=6] float row)."""
        r = np.asarray(row, np.float64)
        return cls(trcd=float(r[0]), tras=float(r[1]), twr=float(r[2]),
                   trp=float(r[3]), trefi=float(r[4]), tcl=float(r[5]))

    def read_sum(self) -> float:
        """Latency sum used for the read test (Fig. 3c): tRCD+tRAS+tRP."""
        return self.trcd + self.tras + self.trp

    def write_sum(self) -> float:
        """Latency sum used for the write test (Fig. 3d): tRCD+tWR+tRP."""
        return self.trcd + self.twr + self.trp

    def scaled(self, r_trcd: float = 1.0, r_tras: float = 1.0,
               r_twr: float = 1.0, r_trp: float = 1.0) -> "TimingParams":
        return dataclasses.replace(
            self, trcd=self.trcd * r_trcd, tras=self.tras * r_tras,
            twr=self.twr * r_twr, trp=self.trp * r_trp)


# JEDEC DDR3-1600 (11-11-11-28 at 1.25 ns tCK; tWR = 15 ns).
DDR3_1600 = TimingParams(trcd=13.75, tras=35.0, twr=15.0, trp=13.75)

# The timing set used for the paper's real-system evaluation at 55C
# (Sec. 6): reductions of 27%/32%/33%/18% for tRCD/tRAS/tWR/tRP.
ALDRAM_55C_EVAL = DDR3_1600.scaled(1 - 0.27, 1 - 0.32, 1 - 0.33, 1 - 0.18)


def stack_timing(params: "Sequence[TimingParams]") -> np.ndarray:
    """Stack timing-parameter sets into the [S, 6] row matrix a batched
    replay campaign sweeps in one dispatch (see `as_row` for columns)."""
    return np.stack([p.as_row() for p in params], axis=0)


def _down_grid(standard: float, lo: float,
               step: float = TIMING_STEP_NS) -> np.ndarray:
    """Grid from `standard` downwards to >= lo, inclusive of standard."""
    n = int(np.floor((standard - lo) / step + 1e-9)) + 1
    return standard - step * np.arange(n)


def read_combo_grid(std: TimingParams = DDR3_1600,
                    step: float = TIMING_STEP_NS) -> np.ndarray:
    """All (tRCD, tRAS, tWR=std, tRP, tREFI=placeholder) combos for the
    read-operation test (Fig. 2b sweeps tRCD/tRAS/tRP)."""
    trcd = _down_grid(std.trcd, 3.75, step)
    tras = _down_grid(std.tras, 12.5, step=2 * step)
    trp = _down_grid(std.trp, 3.75, step)
    g = np.stack(np.meshgrid(trcd, tras, trp, indexing="ij"), axis=-1)
    g = g.reshape(-1, 3)
    out = np.zeros((g.shape[0], 5), dtype=np.float32)
    out[:, 0] = g[:, 0]            # trcd
    out[:, 1] = g[:, 1]            # tras
    out[:, 2] = std.twr            # twr held at standard
    out[:, 3] = g[:, 2]            # trp
    out[:, 4] = std.trefi
    return out


def write_combo_grid(std: TimingParams = DDR3_1600,
                     step: float = TIMING_STEP_NS) -> np.ndarray:
    """All (tRCD, tRAS=std, tWR, tRP, tREFI) combos for the write test
    (Fig. 2c sweeps tRCD/tWR/tRP)."""
    trcd = _down_grid(std.trcd, 3.75, step)
    twr = _down_grid(std.twr, 2.5, step)
    trp = _down_grid(std.trp, 3.75, step)
    g = np.stack(np.meshgrid(trcd, twr, trp, indexing="ij"), axis=-1)
    g = g.reshape(-1, 3)
    out = np.zeros((g.shape[0], 5), dtype=np.float32)
    out[:, 0] = g[:, 0]
    out[:, 1] = std.tras
    out[:, 2] = g[:, 1]
    out[:, 3] = g[:, 2]
    out[:, 4] = std.trefi
    return out


def refresh_grid(lo_ms: float = 8.0, hi_ms: float = 512.0) -> np.ndarray:
    """Refresh-interval sweep grid (Fig. 2a), 8 ms steps."""
    return np.arange(lo_ms, hi_ms + REFRESH_STEP_MS / 2, REFRESH_STEP_MS,
                     dtype=np.float32)

"""What the port's benchmark drivers share, the counterpart of
`benchmarks/common.py` without JAX: timed sections, CSV emission
(name,us_per_call,derived), the calibrated population and the
profiler, on the port's device (the card unless the caller asks for the
CPU)."""

from __future__ import annotations

import dataclasses
import time

import torch


def population(fast: bool = False, seed: int = 0,
               device: str | torch.device = "cuda"):
    """The calibrated 115-module population (`--fast`: 24 modules x 8
    cells), sampled by the port from a seeded `torch.Generator`."""
    from repro_torch.core.calibration import CALIBRATED_VARIATION
    from repro_torch.core.variation import sample_population
    cfg = CALIBRATED_VARIATION
    if fast:
        cfg = dataclasses.replace(cfg, n_modules=24, n_cells=8)
    return sample_population(torch.Generator().manual_seed(seed), cfg,
                             device=device)


def profiler(fast: bool = False, device: str | torch.device = "cuda"):
    from repro_torch.core.calibration import CALIBRATED_CONSTANTS
    from repro_torch.core.profiler import Profiler
    return Profiler(CALIBRATED_CONSTANTS, grid_step=2.5 if fast else 1.25,
                    device=device)


class timed:
    """Wall time of a section in microseconds; on a card, up to the end
    of the work it queued."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *a):
        if self.cuda:
            torch.cuda.synchronize()
        self.us = (time.monotonic() - self.t0) * 1e6


def emit(name: str, us: float, derived: str):
    print(f"{name},{us:.0f},{derived}", flush=True)

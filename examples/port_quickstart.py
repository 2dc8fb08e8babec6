"""Quickstart on the PyTorch/CUDA port (`repro_torch`): the AL-DRAM
pipeline in a minute, the port's counterpart of `examples/quickstart.py`.

Profiles a small simulated DIMM population (12 modules), builds the
per-module / per-temperature timing tables, verifies the reliability
invariant, and replays a memory trace under standard vs adaptive
timings.  The whole multi-temperature read+write campaign is two
margin-grid launches (one refresh sweep, one timing sweep) and the
verification one more.

    PYTHONPATH=src python examples/port_quickstart.py [--fast] \
        [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, cells=None, traces=None):
    """Run the demo; `cells` ([12, chips, banks, 8, 5]) and `traces` (the
    (arrival, bank, row, is_write) arrays of one [4096] trace) replace
    the port's own population and trace draws.  `--fast` is accepted
    for symmetry with the other examples (the demo is small already).
    Returns what it printed, by name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import convert
    from repro_torch.core import dram_sim
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.timing import DDR3_1600
    from repro_torch.core.variation import sample_population
    dev = args.device

    # 1. a small population (12 modules) for speed
    if cells is None:
        vcfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=12,
                                   n_cells=8)
        pop = sample_population(torch.Generator().manual_seed(0), vcfg,
                                device=dev)
    else:
        pop = convert.population(cells, device=dev)

    # 2. profile -> tables (45..85C bins): two margin-grid launches
    ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=2.5,
                                     device=dev), device=dev)
    ctrl.profile(pop)
    out = {"red55": ctrl.average_reductions(55.0),
           "red85": ctrl.average_reductions(85.0)}
    print("timing reductions @55C:", out["red55"])
    print("timing reductions @85C:", out["red85"])

    # 3. reliability invariant (the paper's stress test) over every
    # (module, temperature bin) pair
    out["verify"] = ctrl.verify(pop)
    out["dispatches"] = ctrl.engine.dispatch_count
    print("zero-error invariant:", out["verify"])
    print("kernel dispatches for profile+verify:", out["dispatches"])

    # 4. runtime selection + replay a trace
    module, temp = 3, 55.0
    fast = ctrl.select(module, temp)
    out["selected"] = fast
    print(f"module {module} @ {temp}C ->", fast)
    if traces is None:
        trace = dram_sim.synth_trace(torch.Generator().manual_seed(1), 4096,
                                     device=dev)
    else:
        trace = convert.trace(*traces, device=dev)
    std = dram_sim.simulate(trace, DDR3_1600, device=dev)
    adp = dram_sim.simulate(trace, fast, device=dev)
    out["lat_std"] = float(std["mean_latency_ns"])
    out["lat_fast"] = float(adp["mean_latency_ns"])
    print("mean DRAM latency: standard {:.1f}ns -> AL-DRAM {:.1f}ns "
          "({:.1%} faster)".format(out["lat_std"], out["lat_fast"],
                                   out["lat_std"] / out["lat_fast"] - 1))
    assert out["verify"] is True
    return out


if __name__ == "__main__":
    main()

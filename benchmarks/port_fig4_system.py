"""Fig. 4 on the port: the real-system evaluation of
`benchmarks/fig4_system.py`, on `repro_torch` — per-workload speedups,
single vs multi-core, AL-DRAM 55C timings vs DDR3 standard (`run`), and
the profiled-table variant that replays the workload pool under every
temperature bin's all-module-safe row (`run_profiled`).

    PYTHONPATH=src python -m benchmarks.port_fig4_system [--fast] [--cpu]

Paper: memory-intensive multi-core avg +14.0 %, non-intensive +2.9 %,
all-35 multi-core avg +10.5 %, best (STREAM) up to +20.5 %.  Each run
is one `SimEngine` campaign, one replay launch on the card; the
`dispatches=` field counts the port's launches (its traces are drawn on
the host, no synthesis dispatch).  Both take the population (cells
through `repro_torch.convert.population`) and the workload traces
(`repro_torch.convert.trace`, [70, N]) as given, or sample their own.
This module imports neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json

from benchmarks.port_common import emit, population, profiler, timed


def run(fast: bool = False, traces=None, device="cuda") -> dict:
    from repro_torch.core import perf_model
    from repro_torch.core.sim_engine import SimEngine
    engine = SimEngine(device=device)
    with timed(device) as t:
        res = perf_model.evaluate(n=2048 if fast else 8192, engine=engine,
                                  traces=traces)
    s = res["summary"]
    emit("fig4_system_speedup", t.us,
         "mem-intensive={:.1%}(paper 14.0%)|non-int={:.1%}(2.9%)|"
         "all35={:.1%}(10.5%)|best={}:{:.1%}(20.5%)|dispatches={}".format(
             s["multi_intensive_gmean"], s["multi_nonintensive_gmean"],
             s["multi_all_gmean"], s["best_multi"][0], s["best_multi"][1],
             res["dispatches"]["replay"]))
    return res


def run_profiled(fast: bool = False, pop=None, traces=None,
                 device="cuda") -> dict:
    """Temperature-resolved Fig. 4 from a profiled TimingTable: profile
    the population, then replay the workload pool under every bin's
    all-module-safe timing row in one batched campaign."""
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.sim_engine import SimEngine
    pop = population(fast, device=device) if pop is None else pop
    ctrl = ALDRAMController(profiler(fast, device), device=device)
    engine = SimEngine(device=device)
    with timed(device) as t:
        ctrl.profile(pop)
        res = ctrl.evaluate_system(pop, n=1024 if fast else 4096,
                                   engine=engine, traces=traces)
    cool, hot = res["temps"][0], res["temps"][-1]
    emit("fig4_profiled_table", t.us,
         "bins={}|all35@{:.0f}C={:.1%}|all35@{:.0f}C={:.1%}|"
         "intensive@{:.0f}C={:.1%}|replay_dispatches={}".format(
             len(res["temps"]), cool,
             res["per_temp"][cool]["multi_all_gmean"], hot,
             res["per_temp"][hot]["multi_all_gmean"], cool,
             res["per_temp"][cool]["multi_intensive_gmean"],
             engine.dispatch_count))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    r = run(args.fast, device=dev)
    print(json.dumps(r["summary"], indent=1, default=str))
    rp = run_profiled(fast=True, device=dev)
    print(json.dumps(rp["per_temp"], indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

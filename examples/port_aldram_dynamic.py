"""Closed-loop AL-DRAM on the PyTorch/CUDA port, the counterpart of
`examples/aldram_dynamic.py`: the ONLINE mechanism, end to end.

Profiles the module population, stacks the per-bin all-module-safe
timing rows (JEDEC fallback last), and replays the 35-workload pool
with the controller's temperature-bin switching running inside the
replay — per-request RC temperature sensing, conservative round-up,
down-switch hysteresis — under dynamic ambient scenarios (steady,
diurnal ramp, cooling failure, bursty), bracketed by the
static-worst-case and oracle deployments.  Two replay launches for the
whole campaign (adaptive_blocks (a) for the adaptive grid, then
replay_blocks for the static bracket).

    PYTHONPATH=src python examples/port_aldram_dynamic.py [--fast] \
        [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, cells=None, traces=None):
    """Run the demo; `cells` ([modules, chips, banks, K, 5]) and `traces`
    (the (arrival, bank, row, is_write) arrays of a [70, N] pool, N =
    4096, `--fast` 1024) replace the port's own draws.  Returns the
    table stack, its bin edges and the `evaluate_dynamic` result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmarks.port_common import population, profiler
    from repro_torch import convert
    from repro_torch.core.aldram import ALDRAMController, default_scenarios
    from repro_torch.core.sim_engine import SimEngine
    dev = args.device

    pop = (population(args.fast, device=dev) if cells is None
           else convert.population(cells, device=dev))
    if traces is not None:
        traces = convert.trace(*traces, device=dev)
    ctrl = ALDRAMController(profiler(args.fast, dev), device=dev)
    print("== profiling the population ==")
    ctrl.profile(pop)
    rows, bins = ctrl.table.safe_stack()
    print("bin edges (C):", list(map(float, bins)))
    print("table stack (trcd, tras, twr, trp | trefi, tcl), JEDEC last:")
    for r in rows:
        print("  ", [round(float(x), 2) for x in r])

    print("== adaptive replay under dynamic thermal scenarios ==")
    engine = SimEngine(device=dev)
    res = ctrl.evaluate_dynamic(pop, scenarios=default_scenarios(),
                                n=1024 if args.fast else 4096,
                                engine=engine, traces=traces)
    print(json.dumps(res["per_scenario"], indent=1))
    print(f"replay dispatches: {engine.dispatch_count} "
          "(1 adaptive grid + 1 static bracket)")
    for name, d in res["per_scenario"].items():
        gap = d["oracle_gmean"] - d["adaptive_gmean"]
        print(f"{name:>18}: adaptive {d['adaptive_gmean']:+.1%} vs "
              f"static-worst {d['static_worst_gmean']:+.1%} "
              f"(hysteresis costs {gap:+.2%})")
    assert engine.dispatch_count == 2, engine.dispatch_count
    return {"rows": rows, "bins": bins, "result": res,
            "dispatches": engine.dispatch_count}


if __name__ == "__main__":
    main()

"""The full AL-DRAM reproduction pipeline on the PyTorch/CUDA port, the
counterpart of `examples/aldram_profile.py`: refresh envelopes -> safe
intervals -> timing sweeps at 55/85C -> per-parameter reductions vs the
paper's measured numbers -> system speedup (Fig. 4), from the paper's
55C evaluation constants and from the profiler's own TimingTable,
resolved per temperature bin through one batched `SimEngine` campaign.
Every step goes through the port's drivers (`benchmarks/port_fig2_refresh`,
`port_fig3_population`, `port_fig4_system`).

    PYTHONPATH=src python examples/port_aldram_profile.py [--fast] \
        [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, cells=None, traces=None):
    """Run the pipeline; `cells` ([modules, chips, banks, K, 5]) replaces
    the port's population, and `traces` maps a request count to the
    (arrival, bank, row, is_write) arrays of a [70, n] pool (Fig. 4
    replays n = 8192, its profiled table 4096; `--fast` 2048 and 1024).
    Returns each driver's result by figure."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmarks import (port_fig2_refresh, port_fig3_population,
                            port_fig4_system)
    from repro_torch import convert
    dev, fast = args.device, args.fast
    pop = None if cells is None else convert.population(cells, device=dev)

    def pool(n):
        if traces is None:
            return None
        return convert.trace(*traces[n], device=dev)

    out = {}
    print("== refresh envelopes (Fig 2a) ==")
    out["fig2a"] = port_fig2_refresh.run(fast, pop=pop, device=dev)
    print(json.dumps(out["fig2a"], indent=1))
    print("== population analysis (Fig 3 / Sec 5.2) ==")
    out["fig3"] = port_fig3_population.run(fast, pop=pop, device=dev)
    print(json.dumps({k: v for k, v in out["fig3"].items()
                      if k != "result"}, indent=1))
    print("== system evaluation (Fig 4, paper 55C constants) ==")
    out["fig4"] = port_fig4_system.run(fast, traces=pool(2048 if fast
                                                         else 8192),
                                       device=dev)
    print(json.dumps(out["fig4"]["summary"], indent=1, default=str))
    print("== system evaluation (Fig 4, profiled TimingTable, "
          "temperature-resolved) ==")
    out["fig4_profiled"] = port_fig4_system.run_profiled(
        fast, pop=pop, traces=pool(1024 if fast else 4096), device=dev)
    print(json.dumps({str(t): s for t, s
                      in out["fig4_profiled"]["per_temp"].items()},
                     indent=1))
    return out


if __name__ == "__main__":
    main()

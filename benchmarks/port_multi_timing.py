"""Sec. 7.2 on the port: the interaction of simultaneous timing
reductions, `benchmarks/multi_timing.py` on `repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_multi_timing [--fast] \
        [--device cpu]

Reducing one parameter shrinks the opportunity to reduce another: the
per-module (tRAS_min | tRP) frontier — the minimal passing tRAS as tRP
is reduced, from one refresh launch and one read sweep at 55C — then
ONE `SimEngine` replay of every frontier row over one trace, pricing
each profiling-feasible point in system-level latency (each frontier
row is one timing column of the same launch).  The trace is given
(`trace`, e.g. through `repro_torch.convert.trace`) or drawn from
`torch.Generator().manual_seed(0)` with row-hit rate 0.5 (n = 8192;
`--fast` 2048).  This module imports neither JAX nor the reference
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from benchmarks.port_common import emit, population, profiler, timed


def run(fast: bool = False, *, pop=None, trace=None, device="cuda") -> dict:
    import torch

    from repro_torch.core import dram_sim
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.core.sweep import Op, SweepSpec
    from repro_torch.core.timing import DDR3_1600, stack_timing
    pop = population(fast, device=device) if pop is None else pop
    prof = profiler(fast, device)
    with timed(device) as t:
        rp_read, _ = prof.refresh_campaign(pop, 85.0)
        combos = prof.combo_grid(Op.READ)
        res = prof.engine.sweep(pop, SweepSpec.single(
            Op.READ, combos, (55.0,), rp_read.safe))
        ok = res.ok[0][:, 0, :]        # [modules, combos]
        frontier = {}
        for trp in sorted(set(combos[:, 3])):
            sel = combos[:, 3] == trp
            # min passing tRAS at this tRP per module (vectorised over
            # modules); skip tRP levels that fail for most modules
            tras = np.where(ok[:, sel], combos[sel, 1][None, :], np.inf)
            tras_min = np.where(ok[:, sel].any(1), tras.min(1), np.nan)
            if np.isnan(tras_min).mean() < 0.5:
                frontier[float(trp)] = float(np.nanmedian(tras_min))
        # system-level price of every frontier point: one replay launch
        # sweeps all (tRP, tRAS_min) rows over one trace
        rows = stack_timing([
            dataclasses.replace(DDR3_1600, trp=trp, tras=tras)
            for trp, tras in sorted(frontier.items())])
        if trace is None:
            trace = dram_sim.synth_trace(torch.Generator().manual_seed(0),
                                         2048 if fast else 8192,
                                         row_hit=0.5, device=device)
        engine = SimEngine(device=device)
        sim = engine.run(SimSpec(traces=(trace,), timings=rows))
        sys_lat = sim.mean_latency_ns[0, 0]          # [frontier points]
    trps = sorted(frontier)
    monotone = all(frontier[a] >= frontier[b] - 1e-6
                   for a, b in zip(trps, trps[1:]))
    emit("sec72_multi_timing_interaction", t.us,
         f"tras_min@trp{{{trps[0]:.2f}}}={frontier[trps[0]]:.1f}ns vs "
         f"@trp{{{trps[-1]:.2f}}}={frontier[trps[-1]]:.1f}ns|"
         f"interaction={'confirmed' if monotone else 'NOT confirmed'}|"
         f"sys_lat={sys_lat.min():.1f}..{sys_lat.max():.1f}ns"
         f"|replay_dispatches={engine.dispatch_count}")
    return {"frontier": frontier, "monotone": monotone,
            "system_latency_ns": {t_: float(l) for t_, l
                                  in zip(sorted(frontier), sys_lat)},
            "dispatches": {"replay": engine.dispatch_count}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.fast, device=args.device), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

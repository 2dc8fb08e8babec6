"""The thermal benchmark on the port, `benchmarks/thermal_bench.py` on
`repro_torch`: the ONLINE half of AL-DRAM (paper Sec. 4).

    PYTHONPATH=src python -m benchmarks.port_thermal_bench [--fast] \
        [--device cpu]

Replays the workload pool with the controller's bin switching running
inside the replay, under the stock dynamic thermal scenarios (steady,
diurnal ramp, cooling failure, bursty), and reports three deployments
per scenario: adaptive (in-replay selection over the profiled table
stack, with hysteresis), static worst case (one register set for the
scenario's peak sensed temperature) and oracle (zero hysteresis, the
upper bound).  `evaluate_dynamic(fused=True)` runs the adaptive replay,
the worst-bin round-up and the static bracket as ONE replay dispatch
(`SimEngine.run_bracket`: adaptive_blocks (a), or (b) with
`per_bank=True`, then replay_blocks on the card).  The pool is given
(`traces`, [70, N]) or drawn on the host; the reported dispatch count
is the port's own: replays plus the pool's synthesis
(`synth_dispatch_scope`), 2 when the bench draws the pool, 1 when it is
given (the reference synthesises inside its one dispatch).  `ctrl` may
be a controller that already profiled `pop`.

Asserted, as in the reference: adaptive >= static_worst - 1e-9 for
every scenario of every policy.  This module imports neither JAX nor
the reference package.
"""

from __future__ import annotations

import argparse
import json

from benchmarks.port_common import emit, population, profiler, timed


def run(fast: bool = False, *, pop=None, traces=None, ctrl=None,
        per_bank: bool = False, device="cuda") -> dict:
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.sim_engine import SimEngine

    pop = population(fast, device=device) if pop is None else pop
    fresh = ctrl is None
    ctrl = ctrl or ALDRAMController(profiler(fast, device), device=device)
    engine = SimEngine(device=ctrl.device)
    with perf_model.synth_dispatch_scope() as scope:
        with timed(ctrl.device) as t:
            if fresh:
                ctrl.profile(pop)
            res = ctrl.evaluate_dynamic(pop, n=1024 if fast else 4096,
                                        engine=engine, fused=True,
                                        per_bank=per_bank, traces=traces)
    dispatches = {"replay": engine.dispatch_count, "synth": scope.count}
    dispatches["total"] = dispatches["replay"] + dispatches["synth"]
    per = res["per_scenario"]
    # the acceptance bracket must hold for EVERY policy of the
    # campaign, not just the headline view
    for pd in res["per_policy"]:
        for name, d in pd.items():
            assert d["adaptive_gmean"] >= d["static_worst_gmean"] - 1e-9, \
                (name, d)
    assert dispatches["replay"] == 1, dispatches
    parts = ["{}:adapt={:.1%}/static={:.1%}/oracle={:.1%}".format(
        name, d["adaptive_gmean"], d["static_worst_gmean"],
        d["oracle_gmean"]) for name, d in per.items()]
    emit("thermal_adaptive_replay", t.us,
         "|".join(parts) + f"|dispatches={dispatches['total']}")
    res["dispatches"] = dispatches
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.fast, device=args.device)
    print(json.dumps(r["per_scenario"], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Fig. 3 + Sec. 5.2 on the port: the 115-module population analysis of
`benchmarks/fig3_population.py`, on `repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_fig3_population [--fast] [--cpu]

One refresh campaign (both ops) and one fused (85C, 55C) x (read,
write) timing campaign over the calibrated population, or the
population given as cells (`repro_torch.convert.population`); prints
the reference's two headline lines.  Paper targets: read latency -21.1 %
at 85C and -32.7 % at 55C on average, write -34.4 % and -55.1 %; at 55C
tRCD 17.3 / tRAS 37.7 / tWR 54.8 / tRP 35.2 %.  Returns the headline
numbers and, under "result", the campaign's `SweepResult`.  This module
imports neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json

from benchmarks.port_common import emit, population, profiler, timed

TEMPS = (85.0, 55.0)


def run(fast: bool = False, pop=None, device="cuda") -> dict:
    from repro_torch.core.sweep import Op
    pop = population(fast, device=device) if pop is None else pop
    prof = profiler(fast, device)
    out: dict = {}
    with timed(device) as t:
        rp_read, rp_write = prof.refresh_campaign(pop, 85.0)
        out["refresh"] = {
            "read_min_ms": float(rp_read.per_module.min()),
            "read_median_ms": float(sorted(rp_read.per_module)
                                    [pop.n_modules // 2]),
            "write_median_ms": float(sorted(rp_write.per_module)
                                     [pop.n_modules // 2]),
        }
        res = prof.engine.sweep(pop,
                                prof.campaign_spec(TEMPS, rp_read, rp_write))
        all_r = res.reductions(Op.READ)
        all_w = res.reductions(Op.WRITE)
        for ti, temp in enumerate(TEMPS):
            red_r, red_w = all_r[ti], all_w[ti]
            out[f"t{int(temp)}"] = {
                "read_sum": red_r["latency_sum"],
                "write_sum": red_w["latency_sum"],
                "trcd": red_r["trcd"], "tras": red_r["tras"],
                "twr": red_w["twr"], "trp": red_r["trp"],
                "allsafe": {k: red_r[f"{k}_allsafe"]
                            for k in ("trcd", "tras", "trp")}
                | {"twr": red_w["twr_allsafe"]},
            }
    emit("fig3_population", t.us,
         "read55={:.1%}(paper 32.7%)|write55={:.1%}(paper 55.1%)|"
         "read85={:.1%}(21.1%)|write85={:.1%}(34.4%)".format(
             out["t55"]["read_sum"], out["t55"]["write_sum"],
             out["t85"]["read_sum"], out["t85"]["write_sum"]))
    emit("sec52_param_reductions_55C", t.us,
         "tRCD={:.1%}(17.3)|tRAS={:.1%}(37.7)|tWR={:.1%}(54.8)|"
         "tRP={:.1%}(35.2)".format(
             out["t55"]["trcd"], out["t55"]["tras"],
             out["t55"]["twr"], out["t55"]["trp"]))
    out["result"] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    out = run(args.fast, device="cpu" if args.cpu else "cuda")
    out.pop("result")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

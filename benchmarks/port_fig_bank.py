"""Per-bank timing tables on the port, `benchmarks/fig_bank.py` on
`repro_torch`: price the per-bank deployment against the per-module
envelope.

    PYTHONPATH=src python -m benchmarks.port_fig_bank [--fast] \
        [--device cpu]

Profiles the population with a per-bank controller (the per-bank axis
rides the same fused campaign launch), builds the all-module-safe
per-bank rows per bin, and replays the workload pool under a [1 +
2 * bins, banks, 6] per-bank timing stack — JEDEC baseline + per-module
envelope rows (constant across banks) + per-bank rows — in ONE replay
launch (replay_blocks (b) on a card).  The pool is given (`traces`, a
[70, N] batch through `repro_torch.convert.trace`) or drawn on the host
(one synthesis dispatch); `ctrl` may be a per-bank controller that
already profiled `pop` (not profiled again).

Asserted, as in the reference: the table-level mean timing reductions
at the per-bank granularity are >= the per-module envelope's for both
tests, and every bank's latency sum <= its module's (structural: every
bank envelope contains its module envelope); the comparison is one
replay launch.  This module imports neither JAX nor the reference
package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from benchmarks.port_common import emit, spatial_campaign


def run(fast: bool = False, *, pop=None, traces=None, ctrl=None,
        device="cuda") -> dict:
    ctrl, res, dispatches, us = spatial_campaign(
        fast, lambda c, p, engine, n, tr:
            c.evaluate_bank_system(p, n=n, engine=engine, traces=tr),
        pop=pop, traces=traces, ctrl=ctrl, device=device)

    red = res["reductions"]
    for op, d in red.items():
        assert d["bank"] >= d["module"] - 1e-9, (op, d)
    sw = ctrl.sweep_result
    for k in range(len(sw.latency_sum)):
        assert (sw.latency_sum_bank[k]
                <= sw.latency_sum[k][:, None, :] + 1e-6).all()
    assert dispatches["replay"] == 1, dispatches

    cool, hot = res["temps"][0], res["temps"][-1]
    pt = res["per_temp"]
    mean_delta = float(np.mean([d["bank_minus_module"]
                                for d in pt.values()]))
    emit("fig_bank_tables", us,
         "read_red=bank {:.1%}/module {:.1%}|write_red=bank {:.1%}/"
         "module {:.1%}|all35@{:.0f}C=bank {:.1%}/module {:.1%}|"
         "all35@{:.0f}C=bank {:.1%}/module {:.1%}|"
         "mean_bank_delta={:+.2%}|dispatches={}".format(
             red["read"]["bank"], red["read"]["module"],
             red["write"]["bank"], red["write"]["module"],
             cool, pt[cool]["bank_all_gmean"], pt[cool]["module_all_gmean"],
             hot, pt[hot]["bank_all_gmean"], pt[hot]["module_all_gmean"],
             mean_delta, dispatches["total"]))
    res["dispatches"] = dispatches
    res["mean_bank_delta"] = mean_delta
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.fast, device=args.device)
    print(json.dumps({"reductions": r["reductions"],
                      "per_temp": {str(k): v
                                   for k, v in r["per_temp"].items()},
                      "mean_bank_delta": r["mean_bank_delta"]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

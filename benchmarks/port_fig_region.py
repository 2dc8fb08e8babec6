"""The subarray-region timing hierarchy on the port,
`benchmarks/fig_region.py` on `repro_torch`: price every spatial
resolution level of the profile -> table -> replay stack in ONE
compressed campaign.

    PYTHONPATH=src python -m benchmarks.port_fig_region [--fast] \
        [--device cpu]

Profiles the population at 8 regions per bank (the region axis rides
the same fused campaign launch), derives the 2- and 4-region tables
from the stored campaign, and replays the workload pool under module /
bank / region-2 / region-4 / region-8 rows at once: a [rows, U, 6]
mask-compressed unique-row store plus one [banks * regions] index map,
ONE replay launch (replay_blocks (c) on a card).  The pool is given
(`traces`, [70, N]) or drawn on the host (one synthesis dispatch);
`ctrl` may be a regions=8 controller that already profiled `pop`.

Asserted, as in the reference: the table-level mean timing reductions
are monotone in resolution for both tests (structural: every finer
envelope contains its coarser group's; the gmean speedups are reported,
not asserted), the 8-region store compresses below 0.5 of the dense
(banks x regions) layout, and the sweep is one replay launch plus one
synthesis (none when the pool is given).  This module imports neither
JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from benchmarks.port_common import emit, spatial_campaign

LEVELS = (2, 4, 8)
REGIONS = 8


def run(fast: bool = False, *, pop=None, traces=None, ctrl=None,
        device="cuda") -> dict:
    ctrl, res, dispatches, us = spatial_campaign(
        fast, lambda c, p, engine, n, tr:
            c.evaluate_region_system(p, n=n, engine=engine, levels=LEVELS,
                                     traces=tr),
        regions=REGIONS, pop=pop, traces=traces, ctrl=ctrl, device=device)

    # acceptance 1: monotone recovery per resolution level, asserted
    # on the select-metric latency-sum reductions (structural)
    red = res["reductions"]
    for op, d in red.items():
        seq = [d["module"], d["bank"]] + [d[f"region{lv}"]
                                          for lv in LEVELS]
        for a, b in zip(seq, seq[1:]):
            assert b >= a - 1e-9, (op, seq)
    # acceptance 2: the finest store stays deployable
    ratios = res["compression_ratio"]
    assert ratios[REGIONS] < 0.5, ratios
    # acceptance 3: the whole resolution sweep is ONE replay launch and
    # the pool's one synthesis (none when the pool is given)
    assert dispatches["replay"] == 1, dispatches
    assert dispatches["total"] == (1 if traces is not None else 2), \
        dispatches

    hot = res["temps"][-1]
    pt = res["per_temp"][hot]
    mean_gain = float(np.mean(
        [res["per_temp"][tc][f"region{REGIONS}_all_gmean"]
         - res["per_temp"][tc]["bank_all_gmean"]
         for tc in res["temps"]]))
    emit("fig_region_hierarchy", us,
         "read_red=mod {:.1%}/bank {:.1%}/r2 {:.1%}/r4 {:.1%}/r8 "
         "{:.1%}|write_red=bank {:.1%}/r8 {:.1%}|ratio8={:.3f}|"
         "ratio4={:.3f}|U={}|all35@{:.0f}C=bank {:.1%}/r8 {:.1%}|"
         "mean_r8_delta={:+.2%}|dispatches={}".format(
             red["read"]["module"], red["read"]["bank"],
             red["read"]["region2"], red["read"]["region4"],
             red["read"]["region8"], red["write"]["bank"],
             red["write"]["region8"], ratios[REGIONS], ratios[4],
             ctrl.table.n_unique, hot, pt["bank_all_gmean"],
             pt[f"region{REGIONS}_all_gmean"], mean_gain,
             dispatches["total"]))
    res["dispatches"] = dispatches
    res["mean_region_delta"] = mean_gain
    res["compression_ratio"] = {str(k): v for k, v in ratios.items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.fast, device=args.device)
    print(json.dumps({"reductions": r["reductions"],
                      "compression_ratio": r["compression_ratio"],
                      "mean_region_delta": r["mean_region_delta"]},
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

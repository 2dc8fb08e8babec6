"""Fig. 2b/2c on the port: the error-free timing-parameter combinations
of the representative module at its safe refresh interval, 55C vs 85C,
`benchmarks/fig2_timing.py` on `repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_fig2_timing [--fast] \
        [--device cpu]

One refresh campaign, then the whole (op x temperature) campaign in ONE
fused margin-grid launch, over the calibrated population or the
population given as cells (`repro_torch.convert.population`).  Paper:
read latency sum reducible 24 % at 85C / 36 % at 55C; write 35 % / 47 %.
This module imports neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from benchmarks.port_common import emit, population, profiler, timed

TEMPS = (85.0, 55.0)


def run(fast: bool = False, *, pop=None, device="cuda") -> dict:
    from repro_torch.core import timing as T
    from repro_torch.core.sweep import Op
    pop = population(fast, device=device) if pop is None else pop
    prof = profiler(fast, device)
    out = {}
    with timed(device) as t:
        rp_read, rp_write = prof.refresh_campaign(pop, 85.0)
        med = int(np.argsort(rp_read.per_module)[pop.n_modules // 2])
        res = prof.engine.sweep(pop,
                                prof.campaign_spec(TEMPS, rp_read, rp_write))
        for op, base in ((Op.READ, T.DDR3_1600.read_sum()),
                         (Op.WRITE, T.DDR3_1600.write_sum())):
            k = res.index(op)
            for ti, temp in enumerate(TEMPS):
                red = 1 - res.latency_sum[k][med, ti] / base
                n_pass = int(res.ok[k][med, ti].sum())
                out[f"{op.value}_{int(temp)}"] = {
                    "latency_reduction": float(red),
                    "passing_combos": n_pass,
                    "chosen": res.chosen[k][med, ti, :4].tolist(),
                }
    emit("fig2bc_timing_combos", t.us,
         "read 85/55C={:.0%}/{:.0%}(paper 24/36%)|write={:.0%}/{:.0%}"
         "(paper 35/47%)".format(
             out["read_85"]["latency_reduction"],
             out["read_55"]["latency_reduction"],
             out["write_85"]["latency_reduction"],
             out["write_55"]["latency_reduction"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.fast, device=args.device), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

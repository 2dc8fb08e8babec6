"""Fig. 2a on the port: the maximum error-free refresh interval of a
representative module at 85C (per bank / chip / module, read and
write), `benchmarks/fig2_refresh.py` on `repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_fig2_refresh [--fast] \
        [--device cpu]

One refresh campaign (both tests in one margin-grid launch) over the
calibrated population, or the population given as cells
(`repro_torch.convert.population`).  Paper: read 208 ms, write 160 ms at
module level; banks up to 352 / 256 ms; DDR3 standard 64 ms.  This
module imports neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from benchmarks.port_common import emit, population, profiler, timed


def run(fast: bool = False, *, pop=None, device="cuda") -> dict:
    pop = population(fast, device=device) if pop is None else pop
    prof = profiler(fast, device)
    out = {}
    with timed(device) as t:
        profiles = dict(zip(("read", "write"),
                            prof.refresh_campaign(pop, 85.0)))
        for op, rp in profiles.items():
            med = int(np.argsort(rp.per_module)[len(rp.per_module) // 2])
            out[op] = {
                "module_ms": float(rp.per_module[med]),
                "best_bank_ms": float(rp.per_bank[med].max()),
                "best_chip_ms": float(rp.per_chip[med].max()),
                "population_median_ms": float(np.median(rp.per_module)),
                "population_min_ms": float(rp.per_module.min()),
                "safe_ms": float(rp.safe[med]),
            }
    emit("fig2a_refresh_envelope", t.us,
         f"read={out['read']['module_ms']:.0f}ms(paper 208)|"
         f"write={out['write']['module_ms']:.0f}ms(paper 160)|std=64ms")
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

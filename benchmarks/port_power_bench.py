"""Sec. 7 power analysis on the port, `benchmarks/power_bench.py` on
`repro_torch`: AL-DRAM reduces DRAM power ~5.8 % (shorter tRAS active
windows plus the runtime speedup amortising background power).

    PYTHONPATH=src python -m benchmarks.port_power_bench

Host arithmetic (`repro_torch.core.power.power_reduction`); no kernel.
This module imports neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import json

from benchmarks.port_common import emit, timed


def run(fast: bool = False, *, device="cuda") -> dict:
    """`fast` and `device` are accepted for the harness; the model is
    host arithmetic and launches nothing."""
    from repro_torch.core.power import power_reduction
    with timed("cpu") as t:
        res = power_reduction()
    emit("sec7_power", t.us,
         "power_reduction={:.1%}(paper 5.8%)|per_access={:.1%}".format(
             res["power_reduction"], res["per_access_reduction"]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.fast, device=args.device), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

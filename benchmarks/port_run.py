"""Benchmark harness of the port, the counterpart of `benchmarks/run.py`:
one function per paper table or figure, each on `repro_torch`.  Prints
``name,us_per_call,derived`` CSV and writes a ``BENCH_<name>.json``
summary per bench (wall time, dispatch counts, headline numbers) under
``--out-dir`` (default ``chiprun_out/bench/``; the committed
``BENCH_*.json`` at the repository root are the JAX package's and are
never written here).

    PYTHONPATH=src python -m benchmarks.port_run [--fast] [--only NAME]
        [--repeat N] [--device cuda|cpu] [--out-dir DIR]
        [--baseline DIR] [--baseline-factor F]

``--repeat N`` runs each bench N times and reports the median wall
time.  ``--baseline DIR`` compares each bench's median wall time with
the ``BENCH_<name>.json`` in DIR (an earlier run of this harness),
prints the table, and exits non-zero when a bench ran slower than
``--baseline-factor`` (default 2.0) times its baseline; a missing,
malformed or other-mode baseline only warns.  Every bench runs on the
card unless ``--device cpu``.  This module imports neither JAX nor the
reference package, nor the reference's harness: `_headline`,
`_compare_baseline` and the summary writer are its own copies of
`benchmarks/run.py`'s, because the port keeps its own copy of whatever
it needs from the reference side, so that it stands without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

_MAX_DEPTH = 3
_MAX_ITEMS = 24
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_REPO_ROOT, "chiprun_out", "bench")


def benches() -> dict:
    """name -> fn(fast, device): every port driver."""
    from benchmarks import (port_fault_bench, port_fig2_refresh,
                            port_fig2_timing, port_fig3_population,
                            port_fig4_system, port_fig_bank, port_fig_region,
                            port_fleet_bench, port_framework,
                            port_multi_timing, port_power_bench,
                            port_repeatability, port_roofline,
                            port_sim_bench, port_thermal_bench,
                            port_traffic_bench)

    def kw(fn):
        return lambda fast, device: fn(fast, device=device)

    return {
        "fig2_refresh": kw(port_fig2_refresh.run),
        "fig2_timing": kw(port_fig2_timing.run),
        "fig3_population": kw(port_fig3_population.run),
        "fig4_system": kw(port_fig4_system.run),
        "fig4_profiled": kw(port_fig4_system.run_profiled),
        "fig_bank": kw(port_fig_bank.run),
        "fig_region": kw(port_fig_region.run),
        "sim_bench": kw(port_sim_bench.run),
        "thermal_bench": kw(port_thermal_bench.run),
        "power": kw(port_power_bench.run),
        "repeatability": kw(port_repeatability.run),
        "multi_timing": kw(port_multi_timing.run),
        "fleet_bench": kw(port_fleet_bench.run),
        "fault_bench": kw(port_fault_bench.run),
        "traffic_bench": kw(port_traffic_bench.run),
        "framework": kw(port_framework.run),
        "roofline": kw(port_roofline.run),
    }


def _headline(obj, depth: int = 0):
    """Scalar-only projection of a bench's result dict: keeps the JSON
    numbers and strings, drops arrays, tensors and objects."""
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    import numpy as np
    if isinstance(obj, np.generic):
        return obj.item()
    if depth >= _MAX_DEPTH:
        return None
    if isinstance(obj, dict):
        out = {}
        for k, v in list(obj.items())[:_MAX_ITEMS]:
            hv = _headline(v, depth + 1)
            if hv is not None or v is None:
                out[str(k)] = hv
        return out or None
    if isinstance(obj, (list, tuple)):
        vals = [_headline(v, depth + 1) for v in obj[:_MAX_ITEMS]]
        vals = [v for v in vals if v is not None]
        return vals or None
    return None


def _write_summary(out_dir: str, name: str, walls: list[float], fast: bool,
                   device: str, result, error: str | None = None) -> str:
    summary = {"name": name, "wall_s": round(statistics.median(walls), 6),
               "fast": fast, "device": device, "error": error}
    if len(walls) > 1:
        summary["repeats"] = len(walls)
        summary["wall_s_all"] = [round(w, 6) for w in walls]
    if isinstance(result, dict):
        if "dispatches" in result:
            summary["dispatches"] = _headline(result["dispatches"])
        summary["headline"] = _headline(result)
    path = os.path.join(out_dir, f"BENCH_{name}.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _compare_baseline(measured: dict[str, float], baseline_dir: str,
                      factor: float, fast: bool = False) -> list[str]:
    """Print a wall-time table against the baselines in `baseline_dir`;
    return the benches slower than `factor` x their baseline.  A bench
    without a readable baseline of the same --fast mode only warns."""
    regressions = []
    print(f"\nbaseline compare vs {baseline_dir} (fail > {factor:g}x):",
          file=sys.stderr)
    for name, wall in measured.items():
        path = os.path.join(baseline_dir, f"BENCH_{name}.json")
        try:
            with open(path) as f:
                base = json.load(f)
        except (OSError, ValueError):
            print(f"  {name}: {wall:.3f}s (no baseline)", file=sys.stderr)
            continue
        if not isinstance(base, dict) or not base.get("wall_s") \
                or bool(base.get("fast")) != bool(fast):
            print(f"  {name}: {wall:.3f}s (no comparable baseline)",
                  file=sys.stderr)
            continue
        ratio = wall / base["wall_s"]
        flag = " REGRESSION" if ratio > factor else ""
        print(f"  {name}: {wall:.3f}s vs {base['wall_s']:.3f}s "
              f"({ratio:.2f}x){flag}", file=sys.stderr)
        if ratio > factor:
            regressions.append(name)
    return regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="reduced population / fewer samples")
    ap.add_argument("--only", default=None)
    ap.add_argument("--repeat", type=int, default=1,
                    help="run each bench N times; report the median")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=DEFAULT_OUT,
                    help="directory for the BENCH_<name>.json summaries")
    ap.add_argument("--baseline", default=None,
                    help="directory of BENCH_<name>.json baselines")
    ap.add_argument("--baseline-factor", type=float, default=2.0)
    args = ap.parse_args(argv)

    table = benches()
    if args.only and args.only not in table:
        ap.error(f"--only {args.only!r}: one of {sorted(table)}")
    os.makedirs(args.out_dir, exist_ok=True)
    print("name,us_per_call,derived")
    failed, measured = [], {}
    for name, fn in table.items():
        if args.only and name != args.only:
            continue
        walls, res, err = [], None, None
        for _ in range(max(1, args.repeat)):
            t0 = time.monotonic()
            try:
                res = fn(args.fast, args.device)
            except Exception as e:  # noqa: BLE001 - reported per bench
                err = f"{type(e).__name__}: {e}"
                print(f"{name},0,ERROR:{err}", flush=True)
                traceback.print_exc(file=sys.stderr)
            walls.append(time.monotonic() - t0)
            if err:
                break
        if err:
            failed.append(name)
        else:
            measured[name] = statistics.median(walls)
        _write_summary(args.out_dir, name, walls, args.fast, args.device,
                       res, error=err)
    if args.baseline:
        regressions = _compare_baseline(measured, args.baseline,
                                        args.baseline_factor, args.fast)
        if regressions:
            print(f"wall-time regressions: {regressions}", file=sys.stderr)
            return 1
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Fault-injection benchmark of the PyTorch/CUDA port: the watchdog's
bounded-error / latency-give-back contract of `benchmarks/fault_bench.py`
(the JAX package's), on `repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_fault_bench [--full] [--cpu] \
        [--reference-uniforms]

Replays ONE adaptive campaign — (traces x policies x {tuned, JEDEC}
tables x thermal scenarios x fault rows) — in a single `SimEngine`
launch.  The grid, the tables, the scenarios and the fault rows are
`fault_bench.py`'s: a sensor that reads LOW (stuck cold from t = 0, or
latched cold at 40 % of the trace) keeps the aggressive cold-bin rows
through the hot bursts, at two error severities, each with the
watchdog off and on.  The acceptance bracket is asserted the same way:

  * the whole fault grid is exactly one engine launch;
  * the watchdog bound ``detected <= wd_err_n * (trips + 1) + probes``
    holds in every grid cell of every watchdog lane;
  * every watchdog-on lane shows >= 10x fewer silent corruptions and a
    lower error rate than its watchdog-off twin, at <= 2 points of
    timing reduction given back against the fault-free lane.

The error uniforms are the engine's own draw (a `torch.Generator` on
the device, seeded with the fault spec's seed) unless `fault_uniforms`
([T, N]) is given.  `reference_uniforms` loads the reference's seed-11
draws (`benchmarks/data/fault_uniforms_seed11.npz`, written by
`benchmarks/fault_uniforms.py`); under them the port replays the
reference's grid bit for bit and its `pairs` equal the reference's.
The >= 10x bracket depends on the draw: the mild-severity ratios sit
near 10 and fall below it under some draws.  This module imports
neither JAX nor the reference package.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

UNIFORMS = Path(__file__).resolve().parent / "data" / \
    "fault_uniforms_seed11.npz"


def reference_uniforms(fast: bool) -> np.ndarray:
    """The reference engine's [2, n] error uniforms of the grid (n =
    2048 fast, 4096 full)."""
    with np.load(UNIFORMS) as z:
        return z["fast" if fast else "full"]


def _mk_trace(n: int, seed: int):
    from repro_torch.core.dram_sim import Trace
    r = np.random.default_rng(seed)
    t = np.cumsum(r.uniform(2.0, 14.0, n)).astype(np.float32)
    return Trace(torch.tensor(t),
                 torch.tensor(r.integers(0, 8, n).astype(np.int32)),
                 torch.tensor(r.integers(0, 64, n).astype(np.int32)),
                 torch.tensor(r.uniform(size=n) < 0.3))


def _fault_grid(fast: bool, span_ns: float):
    """none + (mode x severity x {off, wd}) fault rows; returns the
    FaultSpec plus the (mode, severity) -> (f_off, f_wd) lane map."""
    from repro_torch.core import faults
    modes = {"stuck": dict(stuck_c=40.0, stuck_from_ns=0.0)}
    if not fast:
        modes["latched"] = dict(stuck_c=40.0,
                                stuck_from_ns=0.4 * span_ns)
    sevs = {"mild": 0.03, "severe": 0.08}
    rows = [faults.FaultScenario(name="none")]
    lanes = {}
    for m, mkw in modes.items():
        for s, bin_c in sevs.items():
            base = dict(err_bin_c=bin_c, err_scale=0.0,
                        detect_frac=0.75, retry_ns=60.0, **mkw)
            lanes[(m, s)] = (len(rows), len(rows) + 1)
            rows.append(faults.FaultScenario(name=f"{m}.{s}", **base))
            rows.append(faults.FaultScenario(
                name=f"{m}.{s}.wd", wd_err_n=4, wd_probe=32,
                wd_recover_n=2, **base))
    return faults.FaultSpec(scenarios=tuple(rows), seed=11), lanes


def campaign(fast: bool = False, device: str | torch.device = "cuda",
             fault_uniforms=None, collect: tuple[str, ...] = ()) -> dict:
    """Build and replay the fault grid once.  Returns {"res": SimResult,
    "spec", "fspec", "lanes", "traces", "n_req", "seconds",
    "dispatches", "device"}."""
    from repro_torch.core.dram_sim import OPEN_FCFS, Policy
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.core.thermal import ThermalSpec, bursty, steady
    from repro_torch.core.timing import TimingParams

    n = 2048 if fast else 4096
    traces = (_mk_trace(n, 1), _mk_trace(n - n // 8, 2))
    span_ns = float(traces[0].arrival[-1])
    pols = (OPEN_FCFS,) if fast else (OPEN_FCFS, Policy(page="closed"))

    jedec = TimingParams(trcd=13.75, tras=35.0, twr=15.0, trp=13.75)
    # hot bins serve JEDEC outright: the adaptive win is the cold bins
    tuned = np.stack([
        TimingParams(trcd=10.0, tras=27.0, twr=11.0, trp=10.0).as_row(),
        TimingParams(trcd=12.0, tras=31.0, twr=13.0, trp=12.0).as_row(),
        jedec.as_row(), jedec.as_row()])
    tables = np.stack([tuned, np.tile(jedec.as_row(), (4, 1))])

    # cool control + hot bursts: 2 bursts per trace, 20% duty
    scens = (steady(50.0), bursty(48.0, 30.0, span_ns / 2.0, duty=0.2))
    if not fast:
        scens += (bursty(44.0, 34.0, span_ns / 3.0, duty=0.2),)
    thermal = ThermalSpec(scenarios=scens, temp_bins=(55.0, 70.0, 85.0))

    fspec, lanes = _fault_grid(fast, span_ns)
    engine = SimEngine(device=device)
    spec = SimSpec(traces=traces, timings=tables, policies=pols,
                   thermal=thermal, faults=fspec, collect=collect)
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = engine.run(spec, fault_uniforms=fault_uniforms)
    seconds = time.perf_counter() - t0
    n_req = (sum(tr.arrival.shape[0] for tr in traces)
             * len(pols) * len(scens))
    return {"res": res, "spec": spec, "fspec": fspec, "lanes": lanes,
            "traces": traces, "n_req": n_req, "seconds": seconds,
            "dispatches": engine.dispatch_count, "device": str(dev)}


def summarize(res, fspec, lanes, n_req: int, check: bool = True) -> dict:
    """Reduce a fault-grid result ([T, P, K, C, F] grids: K = (tuned,
    JEDEC), F = the `_fault_grid` rows) to the benchmark's numbers:
    {"reduction_none", "pairs", "bound_exact"}.  With `check` the
    acceptance bracket is asserted.  Takes any result object with the
    `SimResult` fields and counter accessors."""
    lat = np.asarray(res.mean_latency_ns)          # [T, P, K, C, F]
    lat_j = lat[:, :, 1, :, 0]                     # JEDEC table, no fault
    red = 1.0 - lat[:, :, 0] / lat_j[..., None]    # [T, P, C, F]
    red_f = red.mean(axis=(0, 1, 2))               # [F] reduction points

    wd_n = np.asarray(fspec.pack()[:, 12])         # WD_ERR_N per lane
    det, sil = (np.asarray(x) for x in (res.detected_errors,
                                        res.silent_errors))
    trips, probes = (np.asarray(x) for x in (res.wd_trips, res.wd_probes))
    # the watchdog bound is EXACT in every grid cell of every wd lane
    bound = wd_n * (trips + 1) + probes
    wd_on = wd_n > 0
    exact = bool((det[..., wd_on] <= bound[..., wd_on]).all())

    def tuned_cnt(a, f):
        return int(a[:, :, 0, :, f].sum())

    if check:
        assert exact, "watchdog detected-error bound violated"
        assert tuned_cnt(det, 0) == 0 and tuned_cnt(sil, 0) == 0
    pairs = {}
    for (m, s), (f_off, f_wd) in lanes.items():
        sil_off, sil_on = tuned_cnt(sil, f_off), tuned_cnt(sil, f_wd)
        det_off, det_on = tuned_cnt(det, f_off), tuned_cnt(det, f_wd)
        gb = float(red_f[0] - red_f[f_wd]) * 100.0  # points given back
        ratio = sil_off / max(sil_on, 1)
        rate_off = (det_off + sil_off) / n_req
        rate_on = (det_on + sil_on) / n_req
        if check:
            # watchdog-off keeps accumulating; watchdog-on is clamped
            assert sil_off >= 50, (m, s, sil_off)
            assert ratio >= 10.0, (m, s, sil_off, sil_on)
            assert gb <= 2.0, (m, s, gb)
            assert rate_on < rate_off, (m, s)
        pairs[f"{m}.{s}"] = {
            "silent_off": sil_off, "silent_on": sil_on,
            "detected_off": det_off, "detected_on": det_on,
            "trips": tuned_cnt(trips, f_wd),
            "probes": tuned_cnt(probes, f_wd),
            "err_rate_off": round(rate_off, 5),
            "err_rate_on": round(rate_on, 5),
            "giveback_pt": round(gb, 3),
            "silent_ratio": round(ratio, 1)}
    return {"reduction_none": float(red_f[0]), "pairs": pairs,
            "bound_exact": exact}


def run(fast: bool = False, device: str | torch.device = "cuda",
        fault_uniforms=None) -> dict:
    """The benchmark: one campaign, the acceptance bracket asserted, the
    same dict as `fault_bench.run`."""
    c = campaign(fast, device, fault_uniforms)
    dispatches = c["dispatches"]
    assert dispatches == 1, dispatches
    out = summarize(c["res"], c["fspec"], c["lanes"], c["n_req"])
    lat = c["res"].mean_latency_ns
    print(f"port_fault_grid,{c['seconds'] * 1e6:.0f},"
          + "none:red={:.1%}|".format(out["reduction_none"])
          + "|".join(f"{k}:sil {d['silent_off']}->{d['silent_on']}"
                     f"/gb={d['giveback_pt']:.2f}pt/x{d['silent_ratio']:.0f}"
                     for k, d in out["pairs"].items())
          + f"|wd_bound=exact|dispatches={dispatches}|device={c['device']}",
          flush=True)
    return {
        "reduction_none": out["reduction_none"],
        "pairs": out["pairs"],
        "grid": {"traces": lat.shape[0], "policies": lat.shape[1],
                 "tables": lat.shape[2], "scenarios": lat.shape[3],
                 "faults": len(c["fspec"]), "requests": c["n_req"]},
        "dispatches": {"replay": dispatches, "total": dispatches},
    }


if __name__ == "__main__":
    import json
    import sys
    fast = "--full" not in sys.argv
    print(json.dumps(run(fast, device="cpu" if "--cpu" in sys.argv else "cuda",
                         fault_uniforms=(reference_uniforms(fast)
                                         if "--reference-uniforms" in sys.argv
                                         else None)), indent=1))

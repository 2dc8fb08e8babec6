"""Multi-channel, multi-tenant traffic benchmark of the PyTorch/CUDA port:
the grid of `benchmarks/traffic_bench.py` (the JAX package's) on
`repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_traffic_bench [--fast] [--cpu]

Replays multi-tenant streams (`perf_model.tenant_spec(n, n_streams,
seed=0)`: every stream a Dirichlet mix over the 70-entry workload pool,
each tenant with its own Poisson / bursty / diurnal arrival process),
materialized once before timing, or the `traces` given, under three
FR-FCFS-lite policies (window 16; row / cacheline / bank-XOR
interleave) x 8 timing rows from DDR3-1600 scaled 1.0 down to 0.68, on
1, 2 and 4 channels.  Each run of a channel count is one `SimEngine`
run: the FR-FCFS scheduler on the engine's device, then ONE replay
launch (asserted) — `replay_blocks` (a) on one channel, the
multi-channel variant (d) on two and four.  Full size: n = 8192 x 16
streams; `--fast`: n = 1024 x 8 streams x 4 rows.

Reported per channel count: the mean and p99 latency (each averaged
over the grid), the gap (the JEDEC row's mean latency over the
most-reduced row's), the median wall time of a run, the FR-FCFS
prepass's seconds (timed alone, `SimEngine.reorder_streams`), the
replay launches and the throughput (replayed requests per second).
The reference's sharded check has no counterpart: the port has no
campaign mesh (ROADMAP item 10b).  This module imports neither JAX nor
the reference package.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

CHANNEL_SWEEP = (1, 2, 4)
INTERLEAVES = ("row", "cacheline", "bank_xor")


def grid(fast: bool) -> tuple[int, int, int]:
    """(requests per stream, streams, timing rows)."""
    return (1024, 8, 4) if fast else (8192, 16, 8)


def timing_rows(n_rows: int) -> np.ndarray:
    """JEDEC standard (row 0) down to the AL-DRAM evaluation scale."""
    from repro_torch.core.timing import DDR3_1600, stack_timing
    return stack_timing([DDR3_1600.scaled(f, f, f, f)
                         for f in np.linspace(1.0, 0.68, n_rows)])


def policies():
    from repro_torch.core.dram_sim import Policy
    return tuple(Policy(reorder_window=16, interleave=il)
                 for il in INTERLEAVES)


def _launches() -> dict:
    from repro_torch.kernels.replay import ops
    fn = ops.replay_blocks
    return {"total": fn.launches, "multi": fn.launches_multi}


def _timed(fn, dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run(fast: bool = False, device: str | torch.device = "cuda",
        traces=None) -> dict:
    """The benchmark: per channel count a warm-up run, the prepass timed
    alone, then timed runs (2 fast, 3 full) of one replay launch each."""
    from repro_torch.core import perf_model
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n, n_streams, n_rows = grid(fast)
    reps = 2 if fast else 3
    if traces is None:
        traces = perf_model.tenant_spec(n=n, n_streams=n_streams,
                                        seed=0).materialize(dev)
    traces = tuple(traces)
    n = max(int(t.arrival.shape[0]) for t in traces)
    rows = timing_rows(n_rows)
    pols = policies()
    eng = SimEngine(device=dev)
    requests = len(traces) * len(pols) * n_rows * n
    per_c: dict[int, dict] = {}
    for n_ch in CHANNEL_SWEEP:
        spec = SimSpec(traces=traces, timings=rows, policies=pols,
                       n_channels=n_ch)
        eng.run(spec)                       # warm-up (builds the kernels)
        _, prepass = _timed(lambda: eng.reorder_streams(spec), dev)
        d0, l0 = eng.dispatch_count, _launches()
        walls = []
        for _ in range(reps):
            res, t = _timed(lambda: eng.run(spec), dev)
            walls.append(t)
        l1 = _launches()
        launches = {k: l1[k] - l0[k] for k in l1}
        replays = eng.dispatch_count - d0
        assert replays == reps, (replays, reps)
        if dev.type == "cuda":
            # one replay launch per run: (a) on one channel, (d) on more
            want = {"total": reps, "multi": reps if n_ch > 1 else 0}
            assert launches == want, (n_ch, launches, want)
        mean = res.mean_latency_ns                   # [T, P, S]
        wall = statistics.median(walls)
        per_c[n_ch] = {
            "mean_ns": float(mean.mean()),
            "p99_ns": float(res.p99_latency_ns.mean()),
            "static_vs_adaptive_gap": float(mean[..., 0].mean()
                                            / mean[..., -1].mean()),
            "wall_s": wall, "prepass_s": prepass,
            "prepass_share": prepass / wall,
            "throughput_req_s": requests / wall,
            "replays": replays, "launches": launches,
        }
    head, c1 = per_c[CHANNEL_SWEEP[-1]], per_c[CHANNEL_SWEEP[0]]
    print("port_traffic_campaign,{:.0f},requests={}|grid={}x{}x{}|n={}|"
          "throughput={:.3f}Mreq/s|p99_c1={:.1f}ns|p99_c{}={:.1f}ns|"
          "gap_c1={:.3f}x|gap_c{}={:.3f}x|prepass_c{}={:.3f}s|"
          "replays_per_run=1|device={}".format(
              head["wall_s"] * 1e6, requests, len(traces), len(pols),
              n_rows, n, head["throughput_req_s"] / 1e6, c1["p99_ns"],
              CHANNEL_SWEEP[-1], head["p99_ns"],
              c1["static_vs_adaptive_gap"], CHANNEL_SWEEP[-1],
              head["static_vs_adaptive_gap"], CHANNEL_SWEEP[-1],
              head["prepass_s"], dev.type), flush=True)
    return {
        "requests": requests, "n": n, "n_streams": len(traces),
        "n_rows": n_rows, "interleaves": len(pols), "devices": 1,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "throughput_req_s": head["throughput_req_s"],
        "per_channel": {str(c): d for c, d in per_c.items()},
        "gap_contention_slope": (head["static_vs_adaptive_gap"]
                                 - c1["static_vs_adaptive_gap"]),
        "wall_s": head["wall_s"],
        "dispatches": {"replay_per_run": 1},
    }


if __name__ == "__main__":
    import json
    import sys
    print(json.dumps(run("--fast" in sys.argv,
                         device="cpu" if "--cpu" in sys.argv else "cuda"),
                     indent=1))

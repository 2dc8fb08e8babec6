"""Multi-channel, multi-tenant traffic benchmark of the PyTorch/CUDA port:
the grid of `benchmarks/traffic_bench.py` (the JAX package's) on
`repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_traffic_bench [--fast] [--cpu]

Replays multi-tenant streams (`perf_model.tenant_spec(n, n_streams,
seed=0)`: every stream a Dirichlet mix over the 70-entry workload pool,
each tenant with its own Poisson / bursty / diurnal arrival process)
under three FR-FCFS-lite policies (window 16; row / cacheline / bank-XOR
interleave) x 8 timing rows from DDR3-1600 scaled 1.0 down to 0.68, on
1, 2 and 4 channels.  The `TenantSpec` is handed to `SimSpec` as a
declarative trace axis, materialized once before any timing (its
seconds reported as `synth_s`; the timed runs replay the cached
streams and draw none, asserted), on the campaign mesh
(`launch.mesh.make_campaign_mesh()`: every visible card; the CPU with
`--cpu`), each device reordering and replaying its shard of streams;
`traces` given replays those instead.  Each run of a channel count is
ONE `SimEngine` dispatch (asserted) — one launch per shard of
`replay_blocks` (a) on one channel, of the multi-channel variant (d)
on two and four.  Full size: n = 8192 x 16 streams;
`--fast`: n = 1024 x 8 streams x 4 rows.

Reported per channel count: the mean and p99 latency (each averaged
over the grid), the gap (the JEDEC row's mean latency over the
most-reduced row's), the median wall time of a run, the FR-FCFS
prepass's seconds (timed alone on one device,
`SimEngine.reorder_streams`), the replay launches and the throughput
(replayed requests per second).  Then one unsharded 4-channel run:
`sharded_rel`, the largest relative difference of the sharded run's
mean and p99 from it, must be 0 (the reference's bound is 1e-5; the
port's sharded run replays the same cells with the same operations).
This module imports neither JAX nor the reference package.
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
    alone, then timed runs (2 fast, 3 full) of one replay dispatch each,
    on the campaign mesh; then the sharded == unsharded check."""
    from repro_torch.core import perf_model
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_campaign_mesh

    dev = resolve_device(device)
    n, n_streams, n_rows = grid(fast)
    reps = 2 if fast else 3
    axis = (perf_model.tenant_spec(n=n, n_streams=n_streams, seed=0)
            if traces is None else tuple(traces))
    synth_s = 0.0
    if traces is None:
        _, synth_s = _timed(lambda: axis.materialize(dev), dev)
    n = max(int(t.arrival.shape[0]) for t in
            (axis.materialize(dev) if traces is None else axis))
    rows = timing_rows(n_rows)
    pols = policies()
    mesh = (make_campaign_mesh() if dev.type == "cuda"
            else make_campaign_mesh(devices=[dev]))
    eng = SimEngine(device=dev, mesh=mesh)
    requests = len(axis) * len(pols) * n_rows * n
    per_c: dict[int, dict] = {}
    for n_ch in CHANNEL_SWEEP:
        spec = SimSpec(traces=axis, timings=rows, policies=pols,
                       n_channels=n_ch)
        eng.run(spec)                       # warm-up (builds the kernels)
        _, prepass = _timed(lambda: SimEngine(device=dev).reorder_streams(
            spec), dev)
        d0, l0 = eng.dispatch_count, _launches()
        s0 = perf_model.synth_dispatch_count
        walls = []
        for _ in range(reps):
            res, t = _timed(lambda: eng.run(spec), dev)
            walls.append(t)
        l1 = _launches()
        launches = {k: l1[k] - l0[k] for k in l1}
        replays = eng.dispatch_count - d0
        synths = perf_model.synth_dispatch_count - s0
        assert replays == reps and synths == 0, (replays, synths)
        if dev.type == "cuda":
            # one launch per shard a run: (a) on one channel, (d) on more
            k = reps * mesh.size
            want = {"total": k, "multi": k if n_ch > 1 else 0}
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
    # the sharded statistics against one unsharded run of the last spec
    ref = SimEngine(device=dev).run(spec)
    sharded_rel = max(
        float(np.abs(res.mean_latency_ns / ref.mean_latency_ns - 1.0).max()),
        float(np.abs(res.p99_latency_ns / ref.p99_latency_ns - 1.0).max()))
    assert sharded_rel == 0.0, sharded_rel
    n_dev, t_local, n_local = eng.shard_shape
    head, c1 = per_c[CHANNEL_SWEEP[-1]], per_c[CHANNEL_SWEEP[0]]
    print("port_traffic_campaign,{:.0f},requests={}|grid={}x{}x{}|n={}|"
          "devices={}|shard={}x{}x{}|throughput={:.3f}Mreq/s|"
          "p99_c1={:.1f}ns|p99_c{}={:.1f}ns|gap_c1={:.3f}x|gap_c{}={:.3f}x|"
          "prepass_c{}={:.3f}s|synth={:.3f}s|sharded_rel={:.0e}|"
          "dispatches=1|device={}".format(
              head["wall_s"] * 1e6, requests, len(axis), len(pols),
              n_rows, n, n_dev, n_dev, t_local, n_local,
              head["throughput_req_s"] / 1e6, c1["p99_ns"],
              CHANNEL_SWEEP[-1], head["p99_ns"],
              c1["static_vs_adaptive_gap"], CHANNEL_SWEEP[-1],
              head["static_vs_adaptive_gap"], CHANNEL_SWEEP[-1],
              head["prepass_s"], synth_s, sharded_rel, dev.type),
          flush=True)
    return {
        "requests": requests, "n": n, "n_streams": len(axis),
        "n_rows": n_rows, "interleaves": len(pols), "devices": n_dev,
        "shard": [n_dev, t_local, n_local],
        "declarative": traces is None, "synth_s": synth_s,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "throughput_req_s": head["throughput_req_s"],
        "per_channel": {str(c): d for c, d in per_c.items()},
        "gap_contention_slope": (head["static_vs_adaptive_gap"]
                                 - c1["static_vs_adaptive_gap"]),
        "sharded_rel": sharded_rel,
        "wall_s": head["wall_s"],
        "dispatches": {"replay_per_run": 1, "synth_per_run": 0},
    }


if __name__ == "__main__":
    import json
    import sys
    print(json.dumps(run("--fast" in sys.argv,
                         device="cpu" if "--cpu" in sys.argv else "cuda"),
                     indent=1))

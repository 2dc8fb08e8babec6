"""Framework-layer benchmarks on the port, `benchmarks/framework.py` on
`repro_torch`: the straggler detector's win, the gradient compressor's
wire bytes and the adaptive prefetcher's depth, with the reference's CSV
lines (name,us_per_call,derived).

    PYTHONPATH=src python -m benchmarks.port_framework [--fast]
        [--device cuda|cpu]

`runtime.straggler.simulate` draws with numpy from the reference's
seeds, so its result is the reference's; the compressor runs on the
device (the card unless `--device cpu`) on a seeded [1024, 512] gradient
of the port's own draw (its bytes depend on the shape alone); the
prefetcher runs on the host.  This module imports neither JAX nor the
reference package.
"""

from __future__ import annotations

import argparse
import json

import torch

from benchmarks.port_common import emit, timed


def run_straggler(fast: bool = False, *, device="cuda") -> dict:
    """Static vs adaptive detection on a simulated cluster (host numpy;
    `device` is accepted for the harness)."""
    from repro_torch.runtime.straggler import simulate
    with timed("cpu") as t:
        res = simulate(n_nodes=32 if fast else 64,
                       warmup=150 if fast else 300,
                       steps=150 if fast else 300)
    emit("runtime_straggler_adaptive", t.us,
         "recall {:.0%}->{:.0%}|detect_excess {:.0f}ms->{:.0f}ms".format(
             res["static"]["recall"], res["adaptive"]["recall"],
             res["static"]["detect_excess_ms"],
             res["adaptive"]["detect_excess_ms"]))
    return res


def run_compression(fast: bool = False, *, device="cuda") -> dict:
    """Top-k (1 %) of one [1024, 512] float32 gradient on `device`: its
    wire bytes against the dense 2 MiB."""
    from repro_torch.runtime.compression import (topk_compress, topk_init,
                                                 topk_wire_bytes)
    gen = torch.Generator().manual_seed(0)
    g = {"w": torch.randn((1024, 512), generator=gen).to(device)}
    state = topk_init(g)
    with timed(device) as t:
        sent, state = topk_compress(g, state, ratio=0.01)
    dense = 4 * 1024 * 512
    wire = topk_wire_bytes(g, 0.01)
    emit("runtime_grad_compression", t.us,
         f"wire_bytes={wire}|dense={dense}|ratio={dense / wire:.0f}x")
    return {"wire": wire, "dense": dense}


def run_pipeline(fast: bool = False, *, device="cuda") -> dict:
    """The adaptive prefetcher's depth after 100 batches at a 2 ms step
    (host threads; `device` is accepted for the harness)."""
    from repro_torch.data.pipeline import AdaptivePrefetcher, SyntheticLM
    pf = AdaptivePrefetcher(iter(SyntheticLM(1000, 128, 8)),
                            static_depth=16, step_time_s=0.002)
    with timed("cpu") as t:
        for _ in range(100):
            pf.get()
    pf.refit()
    emit("data_adaptive_prefetch", t.us,
         f"depth={pf.depth}(static 16)|"
         f"memory_saving={1 - pf.depth / 16:.0%}")
    pf.stop()
    return {"depth": pf.depth}


def run(fast: bool = False, *, device="cuda") -> dict:
    return {
        "straggler": run_straggler(fast, device=device),
        "compression": run_compression(fast, device=device),
        "pipeline": run_pipeline(fast, device=device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.fast, device=args.device), indent=1,
                     default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

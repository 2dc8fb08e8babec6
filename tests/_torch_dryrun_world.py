"""Rank bodies of tests/test_torch_cost.py and tests/test_torch_dryrun.py:
a spawned gloo world of 4 ranks (through `_torch_mesh_world.run_world`)
and spawned processes that each hold one fake world of 256 or 512 ranks
(`repro_torch.launch.dryrun.fake_world`).  This module imports torch and
the port only."""

from __future__ import annotations

import queue
import traceback

import torch
import torch.multiprocessing as mp

TIMEOUT_S = 600              # a fake world's wall before it is killed (a
                             # full-width training cell takes ~100 s alone)


def collectives_body(_payload) -> dict:
    """Each rank of a 4-rank world: the counts of the all-gather of its
    [4, 8] float32 shard and of an elementwise op on a `DTensor` of
    those shards (counted on the local shard, once)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch import hlo_cost
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    d = DTensor.from_local(torch.ones(4, 8), mesh, [Shard(0)])
    gathered = hlo_cost.analyze(lambda x: x.full_tensor(), d)
    _, mode, _ = hlo_cost.count(lambda x: torch.atan2(x, x), d)
    return {"gather": gathered, "ops": mode.ops,
            "flops": mode.costs.flops}


def fake_world_cells(multi_pod: bool) -> dict:
    """In a fake world of 256 (or 512) ranks: argument bytes of every
    arch on train_4k and decode_32k on the production mesh, and (on
    16x16) the reference test's own cell, granite-moe-1b-a400m on
    decode_32k."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    mesh = dryrun.production_mesh(multi_pod)
    out = {"arg_bytes": {(a, s): dryrun.argument_bytes(
        dryrun.input_specs(a, s, mesh))
        for a in ARCHS for s in ("train_4k", "decode_32k")}}
    if not multi_pod:
        out["granite"] = dryrun.run_cell("granite-moe-1b-a400m",
                                         "decode_32k", False)
    return out


def full_cell(args) -> dict:
    """One full-width dry-run cell, (arch, shape, seq_parallel), on the
    16x16 mesh's fake world."""
    from repro_torch.launch import dryrun
    arch, shape, seq_parallel = args
    return dryrun.run_cell(arch, shape, False, seq_parallel=seq_parallel)


def sharded_compute(cfg) -> dict:
    """A training step of `cfg` (8 x 256 tokens, one microbatch) counted
    by one rank of fake worlds of 1 and 4 ranks on the (1, 1) and (1, 4)
    ("data", "model") meshes: {model ranks: (flops, temp_bytes)}."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import TrainConfig
    out = {}
    for m in (1, 4):
        dryrun.fake_world(m)
        mesh = make_mesh((1, m), ("data", "model"), "cpu")
        specs = dryrun.fake_inputs(cfg, "train", 8, 256, mesh)
        mode, mem = dryrun.count_step("train", cfg, specs,
                                      TrainConfig(accum_steps=1))
        out[m] = (mode.costs.flops, mem["temp_bytes"])
    return out


def _main(i, fn, arg, q) -> None:
    try:
        torch.set_num_threads(1)
        q.put((i, True, fn(arg)))
    except BaseException:
        q.put((i, False, traceback.format_exc()))


def run_fake(jobs) -> list:
    """`fn(arg)` of each (fn, arg) of `jobs` in a spawned process of its
    own (each may start a fake world), all at once; their results in
    order, or an AssertionError with a failed job's traceback.  Every
    process is joined or killed."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_main, args=(i, fn, arg, q))
             for i, (fn, arg) in enumerate(jobs)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            i, ok, out = q.get(timeout=TIMEOUT_S)
            if not ok:
                errors.append(out)
                break
            results[i] = out
    except queue.Empty:
        errors.append(f"no result in {TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=10 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[i] for i in range(len(procs))]

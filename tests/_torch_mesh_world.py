"""Rank bodies of tests/test_torch_mesh_world.py: spawned gloo worlds on
the CPU, one thread a rank, a `FileStore` under the test's `tmp_path`
(no TCP port).  This module imports torch and the port only: the
reference's side is computed in the test process and reaches the ranks
as numpy arrays."""

from __future__ import annotations

import datetime
import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 480              # a world's wall before its ranks are killed


def run_world(n: int, body, payload, tmp_path) -> list:
    """`body(payload)` on each rank of a spawned world of `n` gloo ranks;
    returns the ranks' results in rank order.  A rank that raises fails
    the world with its traceback; every rank is joined or killed."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store{n}_{body.__name__}")
    procs = [ctx.Process(target=_rank_main, args=(r, n, store, body,
                                                  payload, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(n):
            rank, ok, out = q.get(timeout=TIMEOUT_S)
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    except queue.Empty:
        errors.append(f"the world of {n} did not finish in {TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(n)]


def _rank_main(rank, n, store, body, payload, q):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
        q.put((rank, True, body(payload)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------- helpers
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _whole(tree):
    """Rank 0's numpy copy of a tree of `DTensor`s (every rank gathers)."""
    from torch.distributed.tensor import DTensor
    out = {}
    for name, x in _leaves(tree):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        out[name] = full.numpy().copy()
    return out if dist.get_rank() == 0 else None


def expected_block(full: np.ndarray, spec, mesh) -> np.ndarray:
    """The block of `full` this rank holds under the reference's spec (a
    tuple of None, names or tuples of names): along a dim sharded over
    axes (a1, a2, ...), block index = the rank's coordinates in mixed
    radix, a1 major."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = []
    for d, s in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        axes = () if s is None else ((s,) if isinstance(s, str) else s)
        n, j = 1, 0
        for a in axes:
            i = names.index(a)
            n *= mesh.size(i)
            j = j * mesh.size(i) + coord[i]
        step = full.shape[d] // n
        idx.append(slice(j * step, (j + 1) * step))
    return full[tuple(idx)]


def _meshes():
    from repro_torch.launch.mesh import make_mesh
    return {"2x2": make_mesh((2, 2), ("data", "model"), "cpu"),
            "2x1x2": make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")}


def _state_bytes(params, opt) -> int:
    """Bytes of parameters and moments (codes and scales) on this rank."""
    from repro_torch.launch.sharding import local, tree_leaves
    return sum(local(x).numel() * local(x).element_size()
               for x in tree_leaves((params, opt.m, opt.v)))


def _train(arch_in, mesh, opt, steps, ckpt=None, start=None):
    """`steps` float32 train steps (accum 2, remat) from the reference's
    parameters on `mesh`, or from a checkpoint (`start`: its dir); the
    metrics and rank 0's whole parameters.  With `ckpt` (a dir) the state
    after the first two steps is saved there."""
    from repro_torch import convert
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.launch import sharding as SH
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw8bit import adamw8_init
    from repro_torch.train.step import TrainConfig, train_step
    cfg = arch_in["cfg"]
    params = SH.distribute_params(convert.model_params(
        arch_in["params"], cfg, device="cpu"), cfg, mesh)
    state = (adamw8_init if opt == "adamw8bit" else adamw_init)(params)
    first = 0
    if start is not None:
        p_sh = SH.param_shardings(cfg, mesh, params)
        tree, first = load_checkpoint(
            start, {"params": params, "opt": state},
            shardings={"params": p_sh, "opt": SH.opt_shardings(p_sh, state)})
        params, state = tree["params"], tree["opt"]
    tcfg = TrainConfig(accum_steps=2, optimizer=opt, dtype=torch.float32)
    metrics = []
    for i in range(first, steps):
        toks = arch_in["tokens"][i]
        batch = {"tokens": torch.tensor(toks[:, :-1]),
                 "targets": torch.tensor(toks[:, 1:])}
        params, state, m = train_step(params, state, batch, cfg, tcfg)
        metrics.append({k: float(v) for k, v in m.items()})
        if ckpt is not None and i == 1:
            save_checkpoint(ckpt, 2, {"params": params, "opt": state})
            dist.barrier()
    return {"metrics": metrics, "params": _whole(params),
            "step": int(state.step)}


def _rows_whole(x, mesh):
    """Rank 0's numpy copy of a [B, ...] tensor whose rows are split over
    the mesh's data-parallel dims (every rank gathers)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.pspec import dp_dims
    dims = dp_dims(mesh)
    where = [Shard(0) if i in dims else Replicate()
             for i in range(mesh.ndim)]
    return DTensor.from_local(x, mesh, where,
                              run_check=False).full_tensor().numpy()


def _serve(arch_in, mesh, shape):
    """float32 prefill of the arch's prompt and decode steps on `mesh`:
    each call's logits (whole) and the sequence length of a rank's
    block of the first attention cache (None without attention)."""
    from repro_torch import convert
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as TF
    prompt, decodes, max_len = shape
    cfg = arch_in["cfg"]
    params = SH.distribute_params(convert.model_params(
        arch_in["params"], cfg, device="cpu"), cfg, mesh)
    toks = torch.tensor(arch_in["serve_tokens"])

    def place(t):
        return SH.place(t, SH.NamedSharding(mesh, SH.sanitize(
            SH.batch_sharding(mesh).spec, tuple(t.shape), mesh)))

    with torch.no_grad():
        lg, cache = TF.prefill(params, place(toks[:, :prompt]), cfg,
                               max_len=max_len, dtype=torch.float32)
        out = [_rows_whole(lg, mesh)]
        for i in range(decodes):
            step = place(toks[:, prompt + i:prompt + i + 1].contiguous())
            lg, cache = TF.decode_step(params, cache, step, prompt + i, cfg,
                                       dtype=torch.float32)
            out.append(_rows_whole(lg, mesh))
    kv = [c["k"] for c in cache.values() if "k" in c]
    return {"logits": out,
            "cache_seq_block": kv[0].to_local().shape[2] if kv else None}


# ------------------------------------------------------------ the worlds
def world4(payload) -> dict:
    """Layouts, training and resharding on (2, 2) and (2, 1, 2) meshes."""
    from repro_torch import convert
    from repro_torch.launch import sharding as SH
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw8bit import adamw8_init
    from repro_torch.runtime.elastic import make_mesh_for, reshard_state
    meshes = _meshes()
    out: dict = {"layout": {}, "bytes": {}, "train": {}}
    for mname, mesh in meshes.items():
        for arch in payload["specs"][mname]:
            a = payload["archs"][arch]
            whole = convert.model_params(a["params"], a["cfg"], device="cpu")
            placed = SH.distribute_params(whole, a["cfg"], mesh)
            bad = []
            for (name, full), (_, dt) in zip(_leaves(whole), _leaves(placed)):
                want = expected_block(full.numpy(),
                                      payload["specs"][mname][arch][name],
                                      mesh)
                got = dt.to_local().numpy()
                if got.shape != want.shape or not np.array_equal(got, want):
                    bad.append(name)
                if not torch.equal(dt.full_tensor(), full):
                    bad.append(name + " (gathered)")
            out["layout"][(mname, arch)] = bad
            out["bytes"][(mname, arch)] = {
                opt: _state_bytes(placed, init(placed))
                for opt, init in (("adamw", adamw_init),
                                  ("adamw8bit", adamw8_init))}
    for (mname, arch, opt) in payload["runs"]:
        ckpt = payload["ckpt"] if (mname, arch, opt) == payload["ckpt_run"] \
            else None
        out["train"][(mname, arch, opt)] = _train(
            payload["archs"][arch], meshes[mname], opt, 3, ckpt=ckpt)

    # reshard (2, 2) -> (4, 1): bitwise, each block where the rules put it
    arch = payload["reshard_arch"]
    a = payload["archs"][arch]
    whole = convert.model_params(a["params"], a["cfg"], device="cpu")
    old = SH.distribute_params(whole, a["cfg"], meshes["2x2"])
    new_mesh = make_mesh_for(4, model_parallel=1, device="cpu")
    new = reshard_state(old, a["cfg"], new_mesh, whole)
    sh = SH.param_shardings(a["cfg"], new_mesh, whole)
    bad = []
    for (name, full), (_, dt), (_, s) in zip(
            _leaves(whole), _leaves(new), _leaves(sh)):
        want = expected_block(full.numpy(), s.spec, new_mesh)
        if dt.device_mesh != new_mesh or not np.array_equal(
                dt.to_local().numpy(), want):
            bad.append(name)
    out["reshard"] = {"mesh": tuple(new_mesh.shape), "bad": bad}

    return out if dist.get_rank() == 0 else None


def world4_tp(payload) -> dict:
    """The variants of tensor parallelism trained on (2, 2) (whether a
    run's MoE gathered routing groups across ranks is recorded), and
    the served models' prefill and decode steps."""
    from repro_torch import pspec
    meshes = _meshes()
    out: dict = {"train": {}}
    gathered = []
    dp_gather = pspec.dp_gather

    def counted(x, dim):                # MoE groups spanning ranks
        gathered.append(tuple(x.shape))
        return dp_gather(x, dim)

    pspec.dp_gather = counted
    try:
        for (mname, arch, opt) in payload["tp_runs"]:
            gathered.clear()
            run = _train(payload["archs"][arch], meshes[mname], opt, 3)
            run["spans"] = bool(gathered)
            out["train"][(mname, arch, opt)] = run
    finally:
        pspec.dp_gather = dp_gather
    out["serve"] = {arch: _serve(payload["archs"][arch], meshes["2x2"],
                                 payload["serve_shape"])
                    for arch in payload["serve"]}
    return out if dist.get_rank() == 0 else None


def world2(payload) -> dict:
    """The checkpoint of the 4-rank run restored on make_mesh_for(2,
    model_parallel=2) and trained on to the third step."""
    from repro_torch.runtime.elastic import make_mesh_for
    mesh = make_mesh_for(2, model_parallel=2, device="cpu")
    _, arch, opt = payload["ckpt_run"]
    out = _train(payload["archs"][arch], mesh, opt, 3,
                 start=payload["ckpt"])
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return out if dist.get_rank() == 0 else None

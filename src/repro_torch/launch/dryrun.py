"""Multi-pod dry run of the port (`repro.launch.dryrun`).

For every (architecture x input shape x mesh) cell this runs the port's
real step (`train_step`, `prefill`, `serve_step`) on fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`: shapes and dtypes, no
storage) in a fake world of 256 (16x16) or 512 (2x16x16) ranks (the
"fake" process-group backend: collectives complete at once and move
nothing), as rank 0 of that world, and records what that rank would
run: per-rank flops, HBM bytes and collective bytes from the cost
counter (`launch.hlo_cost`), and its memory: the bytes of its inputs'
local shards (`argument_bytes`), of what the step returns
(`output_bytes`), and at the step's peak (`peak_bytes` = arguments +
the most bytes the step's own tensors hold at once, `temp_bytes`).
Nothing is allocated.  This is the counterpart of the reference forcing
512 host devices: fake CPU tensors on a CPU mesh.

What the port runs, a rank of it runs at production size:
  * train (`train.step`): each layer gathers its parameters' shards over
    the data-parallel axes where it runs (inside its remat region) and
    keeps their "model" shards; the layer partitions its activations
    over "model" (heads, MLP hidden, experts, Mamba channels; scores by
    key positions where the heads do not divide); each data-parallel
    rank takes its slice of every microbatch; the gather's backward
    reduce-scatters the gradients into the parameters' shards; AdamW
    (or 8-bit AdamW) runs on the shards in place, as the `Trainer` runs
    it; `accum_steps = max(1, global_batch // dp)`, as the reference
    sets it;
  * prefill and decode (`models.transformer.prefill`, `decode_step` on
    the placed bf16 parameters, tokens and cache): the same per-layer
    gathers and "model" partitions, the rank's data-parallel rows, the
    decode cache split by sequence over "model" (each shard's softmax
    maximum and sum reduced, the cache never gathered), a prefill's
    cache written into the rank's block.
Attention runs the plain path (`use_flash=False`), as the reference's
cells do; Mamba and RWKV6 layers count their kernels as one op each,
on the rank's heads or channels.

The record keeps the reference's keys, with `trace_s` (the seconds the
run on fake tensors took) for its `lower_s` / `compile_s`, and
`generated_code_bytes` None.  `cost_xla` is absent: it was XLA's own
`cost_analysis()`, which undercounts loops, and eager torch has no
counterpart.  A `long_500k` cell of an architecture outside
`LONG_CONTEXT_ARCHS` is the reference's skip record.  `seq_parallel`
splits the residual stream between layer groups by sequence over
"model" (`models.transformer`); `mamba_unroll` is recorded and has no
effect on one scan kernel.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --both-meshes --out chiprun_out/dryrun_results.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import (ARCHS, LONG_CONTEXT_ARCHS, SHAPES,
                                          get_config, input_shapes)
from repro_torch.launch import hlo_cost
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw8bit import adamw8_init
from repro_torch.train.step import TrainConfig, serve_step, train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------ fake worlds
def fake_world(n: int) -> None:
    """A default process group of `n` ranks on the "fake" backend, this
    process rank 0; a fake world of another size is torn down first, a
    real world raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run needs a fake world; this "
                               f"process runs a {dist.get_backend()!r} one")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def production_mesh(multi_pod: bool):
    """The production mesh in a fake world of its size, on the CPU."""
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


# ------------------------------------------------------------------ inputs
def _fake_like(tree, mode: FakeTensorMode, dtype=None):
    """Fake CPU tensors of a tree's shapes (and dtypes, or `dtype` for
    its float32 leaves)."""
    def one(x):
        dt = dtype if dtype is not None and x.dtype == torch.float32 \
            else x.dtype
        with mode:
            return torch.empty(x.shape, dtype=dt)
    return SH.tree_map(one, tree)


def _placed(tree, shardings, mesh):
    """`tree` placed by a matching tree of `NamedSharding`s, or as it is
    without a mesh."""
    if mesh is None:
        return tree
    return SH.tree_map_with_path(
        lambda path, x: SH.place(x, SH.at(shardings, path)), tree)


def _batch_sh(mesh, shape):
    return SH.NamedSharding(mesh, SH.sanitize(SH.batch_sharding(mesh).spec,
                                              shape, mesh))


def fake_inputs(cfg, kind: str, batch: int, seq: int, mesh=None,
                optimizer: str = "adamw", param_dtype: str = "float32",
                mode: FakeTensorMode | None = None) -> dict:
    """Every input of one step as fake CPU tensors, placed on `mesh` by
    `launch.sharding` (or plain tensors without one): {"params",
    "opt_state", "batch", "_grad_sh"} for "train", {"params", "tokens"}
    for "prefill", {"params", "cache", "tokens", "pos", "_cfg_ctx"} for
    "decode", and "_fake_mode", under which the step must run."""
    mode = mode or FakeTensorMode()
    shapes = TF.init_params(torch.Generator(), cfg, device="meta")
    p_sh = SH.param_shardings(cfg, mesh, shapes) if mesh is not None \
        else None

    def tokens(shape):
        with mode:
            x = torch.empty(shape, dtype=torch.int32)
        return x if mesh is None else SH.place(x, _batch_sh(mesh, shape))

    if kind == "train":
        params = _placed(_fake_like(shapes, mode, DTYPES[param_dtype]),
                         p_sh, mesh)
        with mode:
            opt = (adamw8_init if optimizer == "adamw8bit"
                   else adamw_init)(params)
        return {"params": params, "opt_state": opt,
                "batch": {"tokens": tokens((batch, seq)),
                          "targets": tokens((batch, seq))},
                "_grad_sh": p_sh, "_fake_mode": mode}
    params = _placed(_fake_like(shapes, mode, torch.bfloat16), p_sh, mesh)
    if kind == "prefill":
        return {"params": params, "tokens": tokens((batch, seq)),
                "_fake_mode": mode}
    cfg_ctx = dataclasses.replace(cfg, max_seq_len=seq)
    c_shapes = TF.init_cache(cfg_ctx, batch, seq, device="meta")
    cache = _placed(_fake_like(c_shapes, mode), None if mesh is None else
                    SH.cache_shardings(cfg, mesh, c_shapes, batch), mesh)
    with mode:
        pos = torch.empty((), dtype=torch.int32)
    if mesh is not None:
        pos = SH.place(pos, SH.replicated(mesh))
    return {"params": params, "cache": cache, "tokens": tokens((batch, 1)),
            "pos": pos, "_cfg_ctx": cfg_ctx, "_fake_mode": mode}


def input_specs(arch: str, shape_name: str, mesh, cfg=None,
                optimizer: str = "adamw",
                param_dtype: str = "float32") -> dict:
    """Fake stand-ins for every input of the cell's step (params,
    optimizer state, batch, caches), each a `DTensor` placed by
    `launch.sharding` on `mesh` (the reference's `input_specs`)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    return fake_inputs(cfg, shape.kind, shape.global_batch, shape.seq_len,
                       mesh, optimizer, param_dtype)


def argument_bytes(specs: dict) -> int:
    """Bytes of the local shards of a cell's inputs (one rank's)."""
    return hlo_cost.local_bytes({k: v for k, v in specs.items()
                                 if not k.startswith("_")})


# ------------------------------------------------------------------- steps
def count_step(kind: str, cfg, specs: dict, tcfg: TrainConfig | None = None,
               grad_shardings=None):
    """Run one step on `specs` (`fake_inputs`) under the cost counter:
    (the `hlo_cost.CostMode`, the memory dict of `hlo_cost.count`)."""
    with specs["_fake_mode"]:
        if kind == "train":
            _, mode, mem = hlo_cost.count(
                train_step, specs["params"], specs["opt_state"],
                specs["batch"], cfg, tcfg, grad_shardings=grad_shardings,
                inplace=True)
        elif kind == "prefill":
            _, mode, mem = hlo_cost.count(TF.prefill, specs["params"],
                                          specs["tokens"], cfg)
        else:
            _, mode, mem = hlo_cost.count(
                serve_step, specs["params"], specs["cache"],
                specs["tokens"], specs["pos"], specs["_cfg_ctx"])
    return mode, mem


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             accum_override: int | None = None,
             attn_impl: str | None = None,
             mamba_unroll: int | None = None,
             optimizer: str = "adamw",
             grad_rs: bool = False,
             param_dtype: str = "float32",
             grad_dtype: str = "float32",
             attn_dtype: str | None = None,
             seq_parallel: bool = False, cfg=None,
             multiply: bool = True) -> dict:
    """One cell's record (see the module docstring); `cfg` overrides the
    arch's config (a reduced one, in the tests), and `multiply` (see
    `count_train`) may trace a long step's microbatches in part."""
    cfg = cfg or get_config(arch)
    if seq_parallel:
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if mamba_unroll:
        cfg = dataclasses.replace(cfg, mamba_unroll=mamba_unroll)
    if attn_dtype:
        cfg = dataclasses.replace(cfg, attn_dtype=attn_dtype)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "ok": False}
    for k, v in (("attn_impl", attn_impl), ("mamba_unroll", mamba_unroll),
                 ("optimizer", optimizer if optimizer != "adamw" else None),
                 ("grad_rs", grad_rs or None),
                 ("param_dtype", param_dtype if param_dtype != "float32"
                  else None),
                 ("grad_dtype", grad_dtype if grad_dtype != "float32"
                  else None),
                 ("attn_dtype", attn_dtype),
                 ("seq_parallel", seq_parallel or None)):
        if v:
            rec[k] = v

    if (shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS):
        rec.update(ok=True, skipped="pure full-attention arch (DESIGN.md §5)")
        return rec

    t0 = time.time()
    mesh = production_mesh(multi_pod)
    specs = fake_inputs(cfg, shape.kind, shape.global_batch, shape.seq_len,
                        mesh, optimizer, param_dtype)
    if shape.kind == "train":
        dp = math.prod(size for name, size in
                       zip(mesh.mesh_dim_names, mesh.shape)
                       if name != "model")
        accum = accum_override or max(1, shape.global_batch // dp)
        rec["accum_steps"] = accum
        costs, mem, multiplied = count_train(
            cfg, specs, shape.global_batch, shape.seq_len, accum, mesh,
            optimizer, param_dtype, grad_dtype, grad_rs, multiply)
        if multiplied:
            rec["microbatch_multiplied"] = True
    else:
        cfg_run = specs["_cfg_ctx"] if shape.kind == "decode" else cfg
        mode, mem = count_step(shape.kind, cfg_run, specs)
        costs = mode.costs
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["memory"] = dict(mem, generated_code_bytes=None)
    rec["cost"] = hlo_cost.result(costs)
    rec["collectives"] = rec["cost"].pop("collectives")
    rec["ok"] = True
    return rec


def count_train(cfg, specs: dict, batch: int, seq: int, accum: int, mesh,
                optimizer: str = "adamw", param_dtype: str = "float32",
                grad_dtype: str = "float32", grad_rs: bool = False,
                multiply: bool = True):
    """One training step of `accum` microbatches of a `batch`-row batch
    on `specs` (`fake_inputs`) under the counter: (its `hlo_cost.Costs`,
    its memory dict, whether it was multiplied).  With `multiply` and
    more than 3 microbatches the step is traced at 2 and at 3
    microbatches of the same rows (batches of 2 and 3 microbatches'
    rows, on inputs like `specs`), and its counts are the first's plus
    (accum - 2) times their difference, the third microbatch's: every
    microbatch after the first runs the same ops, and the batch's own
    gathers grow with its rows (the port's counterpart of the
    reference's `known_trip_count`).  Its memory is the 3-microbatch
    step's, with `specs`' own argument bytes."""
    def tcfg(a):
        return TrainConfig(accum_steps=a, optimizer=optimizer,
                           grad_dtype=DTYPES[grad_dtype])
    gsh = specs["_grad_sh"] if grad_rs else None
    if not multiply or accum <= 3:
        mode, mem = count_step("train", cfg, specs, tcfg(accum), gsh)
        return mode.costs, mem, False
    rows = batch // accum
    runs = []
    for a in (2, 3):
        sp = fake_inputs(cfg, "train", a * rows, seq, mesh, optimizer,
                         param_dtype, specs["_fake_mode"])
        runs.append(count_step("train", cfg, sp, tcfg(a), gsh))
    (m2, _), (m3, mem) = runs
    costs = hlo_cost.Costs()
    costs.add(m2.costs)
    costs.add(m3.costs, accum - 2)
    costs.add(m2.costs, -(accum - 2))
    arg = argument_bytes(specs)
    mem = dict(mem, argument_bytes=arg, peak_bytes=arg + mem["temp_bytes"])
    return costs, mem, True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--attn-impl", default=None,
                    choices=(None, "einsum", "online"))
    ap.add_argument("--mamba-unroll", type=int, default=None)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adamw8bit"))
    ap.add_argument("--grad-rs", action="store_true",
                    help="reduce microbatch grads to the FSDP sharding")
    ap.add_argument("--param-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--grad-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--attn-dtype", default=None, choices=(None, "f32", "bf16"))
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cells: list[tuple[str, str, bool]] = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    for a in archs:
        shapes = ([args.shape] if args.shape
                  else [s.name for s in input_shapes(a)]
                  + (["long_500k"] if a not in LONG_CONTEXT_ARCHS else []))
        for s in shapes:
            if args.both_meshes:
                cells += [(a, s, False), (a, s, True)]
            else:
                cells += [(a, s, args.multi_pod)]
    # one fake world at a time: every cell of one mesh, then the other's
    cells.sort(key=lambda c: c[2])

    results = []
    for a, s, mp in cells:
        label = f"{a} x {s} x {'2x16x16' if mp else '16x16'}"
        print(f"=== {label}", flush=True)
        try:
            rec = run_cell(a, s, mp, args.accum, args.attn_impl,
                           args.mamba_unroll, args.optimizer, args.grad_rs,
                           args.param_dtype, args.grad_dtype,
                           args.attn_dtype, args.seq_parallel)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": a, "shape": s,
                   "mesh": "2x16x16" if mp else "16x16", "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        results.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                         default=str), flush=True)
        if args.out:                       # what finished, as it finishes
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)

    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells ok", flush=True)
    if n_ok != len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Training step of the port (`repro.train.step`): cross-entropy loss,
gradient accumulation over microbatches into `grad_dtype` buffers, a
warm-up-cosine learning rate and AdamW (or 8-bit AdamW).

Gradients are taken through per-layer autograd leaves that share storage
with the stacked [R, ...] parameters, each with its `.grad` preset to
the matching slice of the accumulation buffer, so every microbatch's
backward adds into the buffer in place: no per-microbatch copy of the
gradients and no full-size zero tensor per layer (what indexing the
stacked leaf would give in its backward).  With `inplace` (the
`Trainer`'s choice) the optimizer updates the parameters and moments
where they lie; at rwkv6-3b's full width that keeps the state at 16 bytes
a parameter (57.6 GB), which a functional update would not fit on 80 GB.

Parameters may be `DTensor`s on a mesh (`launch.sharding`, ZeRO-3):
each step gathers them to whole tensors for compute (on a mesh of one
rank those share the shards' storage, and the step is the mesh-free
one), each data-parallel rank takes its slice of every microbatch, and
each microbatch's gradients are summed over the data-parallel ranks and
scattered into buffers placed like the parameters (or first to
`grad_shardings`), then divided by the data-parallel size: the mean over
the global batch, as the reference's loss.  Ranks along "model" hold the
same batch slice, so their gradients are replicas and are not summed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch import pspec
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import gather, local
from repro_torch.models import transformer as TF
from repro_torch.models.layers import widen
from repro_torch.optim import adamw_update, warmup_cosine
from repro_torch.optim.adamw import sharded_sums, tree_leaves, tree_map
from repro_torch.optim.adamw8bit import adamw8_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1           # microbatches per step
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10000
    aux_weight: float = 0.01
    remat: bool = True
    use_flash: bool = False
    optimizer: str = "adamw"       # 'adamw' | 'adamw8bit'
    dtype: Any = torch.bfloat16
    grad_dtype: Any = torch.float32


def microbatch_loss(params, tokens, targets, cfg: ModelConfig,
                    tcfg: TrainConfig) -> torch.Tensor:
    logits, aux = TF.apply(params, tokens, cfg, use_flash=tcfg.use_flash,
                           remat=tcfg.remat, dtype=tcfg.dtype)
    logp = torch.log_softmax(widen(logits), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean() + tcfg.aux_weight * aux


def _trainable(params, bufs):
    """Autograd leaves sharing storage with `params`, the stacked stage
    leaves [R, ...] as lists of R per-layer leaves.  A leaf whose buffer
    has its dtype gets the buffer (slice) as its `.grad`; with `bufs`
    None no leaf gets one."""
    def leaf(t, g):
        x = t.detach().requires_grad_()
        if g is not None and g.dtype == t.dtype:
            x.grad = g
        return x

    def stacked(t, g):
        return [leaf(t[i], None if g is None else g[i])
                for i in range(t.shape[0])]

    return {k: tree_map(stacked if k == "stage" else leaf, params[k],
                        bufs[k] if bufs is not None
                        else tree_map(lambda _: None, params[k]))
            for k in params}


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `a` starts where `b` does in the same storage (compared
    by storage, not address: a fake tensor has none)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def _fold(work, bufs) -> None:
    """Add the gradients of leaves without a preset buffer into theirs
    (cast to the buffer's dtype) and clear them."""
    def per_leaf(x, g):
        for xi, gi in (zip(x, g) if isinstance(x, list) else ((x, g),)):
            if xi.grad is not None and not _shares(xi.grad, gi):
                gi.add_(xi.grad.to(gi.dtype))
                xi.grad = None

    tree_map(per_leaf, work, bufs)


def _fold_sharded(work, bufs, grad_shardings, dp_dims) -> None:
    """Sum each leaf's gradient (whole on every rank) over the mesh dims
    `dp_dims`, scatter it to its `grad_shardings` placements, then to the
    buffer's, and add it into the buffer's local shard; one reduction per
    parameter leaf (a stacked leaf's R layers together)."""
    def per_leaf(x, buf, gsh):
        xs = x if isinstance(x, list) else [x]
        gs = [xi.grad if xi.grad is not None else torch.zeros_like(xi)
              for xi in xs]
        g = torch.stack(gs) if isinstance(x, list) else gs[0]
        for xi in xs:
            xi.grad = None
        mesh = buf.device_mesh
        src = [Partial() if i in dp_dims else Replicate()
               for i in range(mesh.ndim)]
        dst = buf.placements if gsh is None else gsh.placements
        r = DTensor.from_local(g, mesh, src, run_check=False)
        r = r.redistribute(mesh, dst).redistribute(mesh, buf.placements)
        buf.to_local().add_(r.to_local().to(buf.dtype))

    tree_map(per_leaf, work, bufs,
             grad_shardings if grad_shardings is not None
             else tree_map(lambda _: None, bufs))


def _mesh_of(params):
    """The mesh of a param tree's `DTensor` leaves, or None."""
    leaf = tree_leaves(params)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def _dp_rows(x, mesh, dims: list[int], a: int) -> torch.Tensor:
    """This rank's rows of each of the `a` microbatches of a [B, ...]
    batch (whole, or a `DTensor`): [a, B / (a n), ...], the slice of
    microbatch i that falls to its place along the n ranks of the
    data-parallel dims `dims` (major first), so that the ranks' slices of
    microbatch i make the reference's microbatch i."""
    x = gather(x)
    n = math.prod(mesh.size(d) for d in dims)
    b = x.shape[0]
    if b % (a * n):
        raise ValueError(f"train_step: batch {b} is not a multiple of "
                         f"accum_steps {a} x {n} data-parallel rank(s)")
    if n == 1:
        return x.reshape(a, b // a, *x.shape[1:])
    j = 0
    for d in dims:
        j = j * mesh.size(d) + mesh.get_coordinate()[d]
    rows = b // (a * n)
    return x.reshape(a, b // a, *x.shape[1:])[:, j * rows:(j + 1) * rows]


def accumulate_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig,
                     grad_shardings=None):
    """The loss and gradients of one step: `accum_steps` microbatches
    accumulated into `grad_dtype` buffers and divided by their count
    (one microbatch: the gradients in the parameters' dtype, as the
    reference).  With `DTensor` parameters the buffers are `DTensor`s
    placed like them and the loss is the global batch's (see the module
    docstring).  Returns (grads, mean loss)."""
    a = tcfg.accum_steps
    mesh = _mesh_of(params)
    spread = mesh is not None and mesh.size() > 1
    dims = pspec.dp_dims(mesh) if spread else []
    mb_tok, mb_tgt = (_dp_rows(batch[k], mesh, dims, a)
                      for k in ("tokens", "targets"))

    def zeros(p):
        dt = tcfg.grad_dtype if a > 1 else p.dtype
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    bufs = tree_map(zeros, params)
    if spread:
        work = _trainable(tree_map(gather, params), None)
    else:
        work = _trainable(tree_map(local, params), tree_map(local, bufs))
    loss = 0.0
    with pspec.set_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext():
        for i in range(a):
            mb_loss = microbatch_loss(work, mb_tok[i], mb_tgt[i], cfg, tcfg)
            mb_loss.backward()
            if spread:
                _fold_sharded(work, bufs, grad_shardings, dims)
            else:
                _fold(work, tree_map(local, bufs))
            loss = loss + mb_loss.detach()
    n = math.prod(mesh.size(d) for d in dims)
    if n > 1:
        for d in dims:
            dist.all_reduce(loss, group=mesh.get_group(d))
        loss = loss / n
        for g in tree_leaves(bufs):
            local(g).div_(n)
    if a > 1:
        for g in tree_leaves(bufs):
            local(g).div_(a)
        loss = loss / a
    return bufs, loss


def global_grad_norm(grads) -> torch.Tensor:
    """The metric's norm: sqrt of the sum over the leaves of each leaf's
    sum of squares, in the gradients' dtype (the reference's); on a mesh
    every element counts once."""
    return torch.sqrt(sum(sharded_sums(
        tree_leaves(grads), lambda g: torch.sum(torch.square(g)))))


def _synced_clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_step(params, opt_state, batch, cfg: ModelConfig,
               tcfg: TrainConfig, grad_shardings=None,
               inplace: bool = False, times: list | None = None):
    """batch: {'tokens', 'targets'}: [global_batch, S] integer tensors on
    the parameters' device.  Returns (params, opt_state, metrics) with
    metrics {'loss', 'lr', 'grad_norm'} (0-d tensors): `accumulate_grads`,
    then `warmup_cosine` and AdamW or 8-bit AdamW.  With `inplace` the
    parameters and the optimizer state are updated where they lie.  With
    a list `times` the step synchronizes the device before and after
    each half and appends {'grads_s', 'update_s'}: the seconds of the
    gradients (forward and backward) and of the optimizer.  On a mesh the
    batch is whole on every rank or placed by `batch_sharding`, and
    `grad_shardings` (a tree of `NamedSharding`s like the parameters) is
    where each microbatch's gradients are reduced to before they are
    added into the buffers."""
    dev = batch["tokens"].device
    t0 = _synced_clock(dev) if times is not None else 0.0
    grads, loss = accumulate_grads(params, batch, cfg, tcfg, grad_shardings)
    t1 = _synced_clock(dev) if times is not None else 0.0
    lr = warmup_cosine(opt_state.step, tcfg.peak_lr, tcfg.warmup,
                       tcfg.total_steps)
    update = adamw8_update if tcfg.optimizer == "adamw8bit" else adamw_update
    new_params, new_opt = update(grads, opt_state, params, lr,
                                 inplace=inplace)
    if times is not None:
        times.append({"grads_s": t1 - t0,
                      "update_s": _synced_clock(dev) - t1})
    return new_params, new_opt, {"loss": loss, "lr": lr,
                                 "grad_norm": global_grad_norm(grads)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """`train_step` with the configs bound."""
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg)


# ---------------------------------------------------------------- serving
def prefill_step(params, tokens, cfg: ModelConfig, dtype=torch.bfloat16):
    return TF.prefill(params, tokens, cfg, dtype=dtype)


def serve_step(params, cache, tokens, pos, cfg: ModelConfig,
               dtype=torch.bfloat16):
    """One decode step."""
    return TF.decode_step(params, cache, tokens, pos, cfg, dtype=dtype)

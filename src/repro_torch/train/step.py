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
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.models.layers import widen
from repro_torch.optim import adamw_update, warmup_cosine
from repro_torch.optim.adamw import tree_leaves, tree_map
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
    has its dtype gets the buffer (slice) as its `.grad`."""
    def leaf(t, g):
        x = t.detach().requires_grad_()
        if g.dtype == t.dtype:
            x.grad = g
        return x

    def stacked(t, g):
        return [leaf(t[i], g[i]) for i in range(t.shape[0])]

    return {k: tree_map(stacked if k == "stage" else leaf, params[k],
                        bufs[k]) for k in params}


def _fold(work, bufs) -> None:
    """Add the gradients of leaves without a preset buffer into theirs
    (cast to the buffer's dtype) and clear them."""
    def per_leaf(x, g):
        for xi, gi in (zip(x, g) if isinstance(x, list) else ((x, g),)):
            if xi.grad is not None and xi.grad.data_ptr() != gi.data_ptr():
                gi.add_(xi.grad.to(gi.dtype))
                xi.grad = None

    tree_map(per_leaf, work, bufs)


def accumulate_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """The loss and gradients of one step: `accum_steps` microbatches
    accumulated into `grad_dtype` buffers and divided by their count
    (one microbatch: the gradients in the parameters' dtype, as the
    reference).  Returns (grads, mean loss)."""
    tokens, targets = batch["tokens"], batch["targets"]
    a = tcfg.accum_steps
    b = tokens.shape[0]
    if b % a:
        raise ValueError(f"train_step: batch {b} is not a multiple of "
                         f"accum_steps {a}")
    bufs = tree_map(lambda p: torch.zeros(
        p.shape, dtype=tcfg.grad_dtype if a > 1 else p.dtype,
        device=p.device), params)
    work = _trainable(params, bufs)
    mb_tok = tokens.reshape(a, b // a, -1)
    mb_tgt = targets.reshape(a, b // a, -1)
    loss = 0.0
    for i in range(a):
        mb_loss = microbatch_loss(work, mb_tok[i], mb_tgt[i], cfg, tcfg)
        mb_loss.backward()
        _fold(work, bufs)
        loss = loss + mb_loss.detach()
    if a > 1:
        for g in tree_leaves(bufs):
            g.div_(a)
        loss = loss / a
    return bufs, loss


def global_grad_norm(grads) -> torch.Tensor:
    """The metric's norm: sqrt of the sum over the leaves of each leaf's
    sum of squares, in the gradients' dtype (the reference's)."""
    return torch.sqrt(sum(torch.sum(torch.square(g))
                          for g in tree_leaves(grads)))


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
    gradients (forward and backward) and of the optimizer."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "train_step: grad_shardings needs the model half of "
            "launch/sharding.py (ROADMAP queue A, \"LLM scaffold, what PR "
            "16-17 left\": the model half of launch/mesh.py and "
            "launch/sharding.py)")
    dev = batch["tokens"].device
    t0 = _synced_clock(dev) if times is not None else 0.0
    grads, loss = accumulate_grads(params, batch, cfg, tcfg)
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

"""Blockwise-quantised AdamW with 8-bit moments (port of
`repro.optim.adamw8bit`).

Each moment is stored int8 with a float32 absmax per row of its last
axis, on a power-law code (power 2 for m, 4 for v): q = round(127 *
(|x| / absmax)^(1 / power)) * sign.  `torch.round` rounds half to even,
as `jnp.round` does; `x ** (1 / power)` may differ from XLA's in the last
bit, which can move a code by one (the CPU tests count such flips).
With `inplace` the codes, scales and parameters are written where they
lie, row slices at a time (`adamw.slices`).

On a mesh the codes take their parameters' placements and a row scale
replicates the dims that shard its parameter's last axis; where "model"
(or "data") shards that axis, each rank sees part of a row, so the row's
absmax is reduced over those mesh dims and the codes are the unsharded
ones."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.sharding import distribute, local
from repro_torch.optim.adamw import (_clone, bias_corrections, clip_scale,
                                     locals_of, slices, tree_leaves,
                                     tree_map)

class QTensor(NamedTuple):
    q: torch.Tensor          # int8, the parameter's shape
    scale: torch.Tensor      # float32 [..., 1] (absmax along the last axis)


def _quant(x: torch.Tensor, power: float = 2.0, row_groups=()) -> QTensor:
    """`row_groups`: the process groups over which a row's absmax is
    taken (the mesh dims that shard the last axis)."""
    x2 = x if x.dim() >= 1 else x.reshape(1)
    absmax = x2.abs().amax(-1, keepdim=True)
    for g in row_groups:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=g)
    absmax = torch.clamp_min(absmax, 1e-24)
    r = (x2.abs() / absmax) ** (1.0 / power)
    q = (torch.sign(x2) * torch.clamp(torch.round(127.0 * r), 0, 127)
         ).to(torch.int8)
    return QTensor(q.reshape(x.shape), absmax)


def _dequant(t: QTensor, shape, size=None, power: float = 2.0):
    qf = t.q.float()
    qr = qf if qf.dim() >= 1 else qf.reshape(1)
    mag = (qr.abs() / 127.0) ** power * t.scale
    return (torch.sign(qr) * mag).reshape(shape)


class AdamW8State(NamedTuple):
    step: torch.Tensor
    m: Any                   # tree of QTensor
    v: Any


def _row_groups(p) -> list:
    """The process groups of the mesh dims (size > 1) that shard the last
    axis of a `DTensor` parameter."""
    if not isinstance(p, DTensor) or p.dim() == 0:
        return []
    m = p.device_mesh
    return [m.get_group(i) for i, pl in enumerate(p.placements)
            if pl == Shard(p.dim() - 1) and m.size(i) > 1]


def adamw8_init(params) -> AdamW8State:
    def zq(p):
        sshape = (*p.shape[:-1], 1) if p.dim() >= 1 else (1,)
        scale = torch.full(sshape, 1e-12, dtype=torch.float32,
                           device=p.device)
        if isinstance(p, DTensor):
            last = Shard(p.dim() - 1)
            return QTensor(torch.zeros_like(p, dtype=torch.int8),
                           distribute(scale, p.device_mesh, tuple(
                               Replicate() if pl == last else pl
                               for pl in p.placements)))
        return QTensor(torch.zeros(p.shape, dtype=torch.int8,
                                   device=p.device), scale)

    dev = tree_leaves(params)[0].device
    return AdamW8State(step=torch.zeros((), dtype=torch.int32, device=dev),
                       m=tree_map(zq, params), v=tree_map(zq, params))


@torch.no_grad()
def adamw8_update(grads, state: AdamW8State, params, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1,
                  grad_clip: float | None = 1.0, inplace: bool = False):
    """Returns (new_params, new_state), in the reference's order of
    operations; see `adamw.adamw_update` for `inplace`."""
    if not inplace:
        params = tree_map(_clone, params)
        state = AdamW8State(state.step, tree_map(_clone, state.m),
                            tree_map(_clone, state.v))
    step = state.step + 1
    scale = clip_scale(grads, grad_clip)
    b1c, b2c = bias_corrections(step, b1, b2)

    def upd(p, g, mq, vq, groups):
        wd = weight_decay if p.dim() >= 2 else 0.0
        # a row of the codes shares one scale: slice whole rows only
        parts = (slices(p, g, mq.q, mq.scale, vq.q, vq.scale)
                 if p.dim() >= 2 else [(p, g, mq.q, mq.scale, vq.q,
                                        vq.scale)])
        for ps, gs, mqs, mss, vqs, vss in parts:
            gs = gs.float()
            if scale is not None:
                gs = gs * scale
            m = b1 * _dequant(QTensor(mqs, mss), ps.shape, power=2.0) \
                + (1 - b1) * gs
            v = b2 * _dequant(QTensor(vqs, vss), ps.shape, power=4.0) \
                + (1 - b2) * gs * gs
            v = torch.clamp_min(v, 0.0)
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            pf = ps.float()
            ps.copy_(pf - lr * (u + wd * pf))
            for (q, s), new in (((mqs, mss), _quant(m, 2.0, groups)),
                                ((vqs, vss), _quant(v, 4.0, groups))):
                q.copy_(new.q)
                s.copy_(new.scale)

    for p, g, mq, vq in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.m), tree_leaves(state.v)):
        p_l, g_l, q_m, q_v = locals_of(p, g, mq.q, vq.q)
        upd(p_l, g_l, QTensor(q_m, local(mq.scale)),
            QTensor(q_v, local(vq.scale)), _row_groups(p))
    return params, AdamW8State(step=step, m=state.m, v=state.v)

"""Blockwise-quantised AdamW with 8-bit moments (port of
`repro.optim.adamw8bit`).

Each moment is stored int8 with a float32 absmax per row of its last
axis, on a power-law code (power 2 for m, 4 for v): q = round(127 *
(|x| / absmax)^(1 / power)) * sign.  `torch.round` rounds half to even,
as `jnp.round` does; `x ** (1 / power)` may differ from XLA's in the last
bit, which can move a code by one (the CPU tests count such flips).
With `inplace` the codes, scales and parameters are written where they
lie, row slices at a time (`adamw.slices`)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import (_clone, bias_corrections, clip_scale,
                                     slices, tree_leaves, tree_map)

class QTensor(NamedTuple):
    q: torch.Tensor          # int8, the parameter's shape
    scale: torch.Tensor      # float32 [..., 1] (absmax along the last axis)


def _quant(x: torch.Tensor, power: float = 2.0) -> QTensor:
    x2 = x if x.dim() >= 1 else x.reshape(1)
    absmax = torch.clamp_min(x2.abs().amax(-1, keepdim=True), 1e-24)
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


def adamw8_init(params) -> AdamW8State:
    def zq(p):
        sshape = (*p.shape[:-1], 1) if p.dim() >= 1 else (1,)
        return QTensor(torch.zeros(p.shape, dtype=torch.int8,
                                   device=p.device),
                       torch.full(sshape, 1e-12, dtype=torch.float32,
                                  device=p.device))

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

    def upd(p, g, mq, vq):
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
            for (q, s), new in (((mqs, mss), _quant(m, power=2.0)),
                                ((vqs, vss), _quant(v, power=4.0))):
                q.copy_(new.q)
                s.copy_(new.scale)

    for p, g, mq, vq in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.m), tree_leaves(state.v)):
        upd(p, g, mq, vq)
    return params, AdamW8State(step=step, m=state.m, v=state.v)

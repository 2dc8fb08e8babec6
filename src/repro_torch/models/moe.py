"""Mixture-of-Experts FFN of the port (`repro.models.moe`): top-k
routing with grouped, capacity-based one-hot dispatch (GShard-style).

Tokens are routed in fixed-size groups of `group_size(cfg)`; the last
group is padded with zero tokens, which are routed like any other token
(their slots claim capacity) and sliced off at the end.  Within a group
the capacity loop assigns slot 0 of every token before slot 1, and so
on: an expert's positions come from a cumulative sum over the group,
offset by the slots it has already admitted.  A choice past the
expert's capacity is dropped.  Dispatch and combine are one-hot
contractions and the experts are SwiGLU products, all plain matrix
products, as in the reference.

Top-k breaks ties towards the lower expert index, as `jax.lax.top_k`
does (a stable descending sort; `torch.topk` orders ties otherwise, and
a padded token's probabilities are all equal).  Dtypes follow the
reference: the router product in x's dtype, widened to float32 for the
softmax and top-k; `dispatch` in x's dtype; `combine` in float32, cast
to x's dtype before the last contraction.  The gradient reaches the
router through the gate values and the auxiliary loss' mean
probabilities; the one-hot masks and positions carry none.

Under a mesh the groups are the reference's, over the global batch's
tokens.  Where a rank's tokens make whole groups, each data-parallel
rank routes its own (the reference's `constrain(xg, "dp", None, None)`,
moe.py:70, with its groups split over "dp"), the experts' top-1
fractions are averaged over those ranks (`pspec.dp_mean`; they carry no
gradient), and the auxiliary loss is linear in the mean probabilities,
so the ranks' mean loss is the global batch's.  Where a group spans
ranks, the ranks' tokens are gathered (`pspec.dp_gather`), every rank
routes every group, as the reference's replicated groups, and keeps
its own rows.  Routing is replicated over "model"; the experts are
split over it (expert parallelism, the reference's constraints of the
expert inputs and outputs, moe.py:101 and :106): a rank dispatches to
and combines from its own experts, and the outputs are summed over
"model".

Covers arctic-480b (128e top-2 + parallel dense residual),
granite-moe-1b-a400m (32e top-8) and jamba (16e top-2, every 2nd layer).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import pspec
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict[str, Any]

CAPACITY_FACTOR = 1.25


def moe_init(gen, cfg: ModelConfig, dense_residual: bool, lead=(), *,
             device) -> Params:
    """One MoE FFN's parameters; `lead` prepends stacking axes."""
    d = cfg.d_model
    dff = cfg.moe_dff or cfg.d_ff
    e = cfg.n_experts
    p = {
        "router": L._init(gen, (d, e), lead, device),
        "w_gate": L._init(gen, (e, d, dff), lead, device),
        "w_up": L._init(gen, (e, d, dff), lead, device),
        "w_down": L._init(gen, (e, dff, d), lead, device, scale=dff ** -0.5),
    }
    if dense_residual:
        p["residual"] = L.mlp_init(gen, d, cfg.d_ff, lead, device=device)
    return p


def group_size(cfg: ModelConfig) -> int:
    """Dispatch-overhead-bounded routing group (~<=20% of expert GEMMs)."""
    dff = cfg.moe_dff or cfg.d_ff
    return int(min(4096, max(256, dff)))


def capacity(s: int, n_experts: int, top_k: int,
             factor: float = CAPACITY_FACTOR) -> int:
    """Slots per expert and group: s * top_k * factor / n_experts, plus
    one, rounded up to a multiple of 8 (at least 8)."""
    c = int(s * top_k * factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index (as `jax.lax.top_k`)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`F.one_hot(idx, n)` in `dtype`, as `jax.nn.one_hot` computes it
    (idx[..., None] == arange(n)): the same ops on every device and on
    fake tensors, where `F.one_hot` checks its indices' range on real
    tensors alone (a host synchronisation on the card); an index past
    n - 1 gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], auxiliary loss, a 0-d tensor)."""
    b, s_len, d = x.shape
    t = b * s_len
    e, k = cfg.n_experts, cfg.top_k
    if not 0 < k <= e:
        raise ValueError(f"moe_apply: top_k {k} must lie in [1, n_experts "
                         f"{e}]")
    dp = pspec.dp_size()
    s = min(group_size(cfg), dp * t)
    spans = dp > 1 and t % s != 0       # a group spans data-parallel ranks
    dt = x.dtype
    xt = x.reshape(t, d)
    if spans:
        xt = pspec.dp_gather(xt, 0)     # every rank's tokens, in order
        t = dp * t
    pad = (-t) % s
    g = (t + pad) // s
    c = capacity(s, e, k)

    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(g, s, d)

    logits = L.widen(xg @ p["router"].to(dt))                  # [G,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                      # [G,S,K]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # load-balancing auxiliary loss (Switch-style), over all G * S rows
    me = probs.mean((0, 1))                                    # [E]
    ce = one_hot(gate_idx[..., 0], e, logits.dtype).mean((0, 1))
    aux = e * torch.sum(me * ce if spans else me * pspec.dp_mean(ce))

    es = pspec.split(e)                 # this rank's experts, or None
    if es is not None:
        gate_vals = pspec.tp_enter(gate_vals)
    dispatch = torch.zeros((g, s, e, c), dtype=dt, device=x.device)
    combine = torch.zeros((g, s, e, c), dtype=logits.dtype, device=x.device)
    used = torch.zeros((g, e), dtype=logits.dtype, device=x.device)
    for slot in range(k):
        mask = one_hot(gate_idx[..., slot], e, logits.dtype)
        pos_in_e = torch.cumsum(mask, dim=1) - 1 + used[:, None, :]
        my_pos = (pos_in_e * mask).sum(-1)                     # [G,S]
        ok = my_pos < c
        pos_oh = one_hot(torch.where(ok, my_pos, c).long(), c,
                         logits.dtype)                         # [G,S,C]
        admitted = mask * ok[..., None]
        sel = admitted[..., None] * pos_oh[..., None, :]       # [G,S,E,C]
        dispatch = dispatch + sel.to(dt)
        combine = combine + sel * gate_vals[..., slot][..., None, None]
        used = used + admitted.sum(1)
    if es is not None:
        dispatch = dispatch[:, :, es[0]:es[1]]
        combine = combine[:, :, es[0]:es[1]]
        xg = pspec.tp_enter(xg)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)          # [G,E,C,d]
    h = (F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt)))
         * torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt)))
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    out = torch.einsum("gsec,gecd->gsd", combine.to(dt), ye)
    if es is not None:
        out = pspec.tp_exit(out)
    out = out.reshape(t + pad, d)[:t]
    if spans:
        out = pspec.dp_rows(out, 0)

    if "residual" in p:
        out = out + L.mlp_apply(p["residual"], x.reshape(-1, d), cfg.d_ff)
    return out.reshape(b, s_len, d), aux

"""Attention-free sequence mixers of the port (`repro.models.ssm`):
RWKV6 ("Finch", data-dependent decay) and Mamba-1 (for the Jamba
hybrid).  Pure functions over parameter dicts of tensors.

The WKV recurrence (the reference's chunked scan `wkv_chunked`, whose
copy is `repro_torch.kernels.rwkv6.ref`) and the
selective scan run through their kernel wrappers
(`repro_torch.kernels.rwkv6.ops.wkv`, `repro_torch.kernels.mamba_scan.
ops.mamba_scan`): a CUDA tensor launches the hand-written kernel, a CPU
tensor runs its plain version.  RWKV6's single-token decode keeps the
reference's one-step einsum; Mamba's decode is the scan at T = 1 from
the cached state.  Token shift, projections, decay, conv, softplus,
D-skip, gate and norms stay plain torch, in the reference's order.

Under a mesh (`pspec.set_mesh`) a layer runs on its parameters' "model"
shards where `launch.sharding.param_spec` splits them: RWKV6 on the
rank's heads (wr/wk/wv/wg column-parallel, u, the WKV kernel and its
state on those heads, wo row-parallel and its output summed), Mamba on
the rank's inner channels (in_proj gathered whole and cut to the
channels' x and z columns, the conv, dt_proj, A, the scan kernel and
its states on those channels, x_proj row-parallel with its B/C/dt
inputs summed, out_proj row-parallel).  Where the heads or channels do
not divide the "model" ranks (rwkv6-3b's 40 heads on 16) the layer runs
whole on every rank.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import pspec
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import layers as L

Params = dict[str, Any]
LORA = 64                 # rank of RWKV6's data-dependent decay


# ===========================================================- RWKV6 (Finch)
def rwkv6_init(gen, cfg: ModelConfig, lead=(), *, device) -> Params:
    """One RWKV6 layer's parameters; `lead` prepends stacking axes."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    if h * dh != d:
        raise ValueError(f"rwkv6: n_heads * head_dim {h * dh} != d_model {d}")

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=device)

    p: Params = {f"mu_{c}": full((d,), 0.5) for c in "rkvgw"}
    # head-structured ([d, h, dh]), as the reference
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = L._init(gen, (d, h, dh), lead, device)
    p["wo"] = L._init(gen, (h, dh, d), lead, device, scale=d ** -0.5)
    # data-dependent decay (the defining RWKV6 feature): w0 + LoRA
    p["w0"] = full((d,), -6.0)
    p["w_lora_a"] = L._init(gen, (d, LORA), lead, device)
    p["w_lora_b"] = L._init(gen, (LORA, d), lead, device, scale=0.01)
    p["u"] = L._init(gen, (h, dh), lead, device, scale=1.0)
    p["ln_out"] = {"scale": full((h, dh), 1.0)}             # per-head GN
    return p


def rwkv6_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """x: [B, S, d].  state: {'x_prev': [B, 1, d], 'wkv': [B, H, Dk, Dv]}
    (zeros when None).  Returns (out, new_state); s == 1 with a state
    takes the one-step decode, otherwise the chunked scan (the WKV
    kernel on the card)."""
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    dt = x.dtype

    if state is not None:
        x_prev = torch.cat([state["x_prev"].to(dt), x[:, :-1]], dim=1)
    else:
        x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]

    def mix(mu):
        return x + (x_prev - x) * mu.to(dt)

    xr, xk, xv, xg, xw = (mix(p[f"mu_{c}"]) for c in "rkvgw")
    hs = pspec.split(h)                 # this rank's heads, or None
    w0, lora_b, ln_out = p["w0"], p["w_lora_b"], p["ln_out"]
    if hs is not None:
        xr, xk, xv, xg = (pspec.tp_enter(a) for a in (xr, xk, xv, xg))
        ch = slice(hs[0] * dh, hs[1] * dh)
        w0 = pspec.tp_enter(w0)[ch]
        lora_b = pspec.tp_enter(lora_b)[:, ch]
        ln_out = {"scale": pspec.tp_enter(ln_out["scale"])[hs[0]:hs[1]]}
        h = hs[1] - hs[0]
    r = L._proj(xr, p["wr"])
    k = L._proj(xk, p["wk"])
    v = L._proj(xv, p["wv"])
    g = F.silu(L._proj(xg, p["wg"]))
    # data-dependent decay: log w = -exp(w0 + lora(xw))  (<= 0 always)
    lora = torch.tanh(xw @ p["w_lora_a"].to(dt))
    if hs is not None:
        lora = pspec.tp_enter(lora)
    lora = lora @ lora_b.to(dt)
    w_log = -torch.exp(torch.clamp(L.widen(w0) + L.widen(lora),
                                   -12.0, 2.0))
    w_log = w_log.reshape(b, s, h, dh)
    u = L.widen(p["u"])

    if s == 1 and state is not None:   # decode: single-step recurrence
        wkv = state["wkv"]                                  # [B,H,Dk,Dv]
        rf, kf, vf = (L.widen(a)[:, 0] for a in (r, k, v))
        o = torch.einsum("bhd,bhde->bhe", rf,
                         wkv + u[None, :, :, None]
                         * kf[..., None] * vf[:, :, None, :])
        wkv = (torch.exp(w_log[:, 0])[..., None] * wkv
               + kf[..., None] * vf[:, :, None, :])
        out = o[:, None]                                    # [B,1,H,Dh]
    else:
        s0 = None if state is None else state["wkv"]
        out, wkv = wkv_ops.wkv(L.widen(r), L.widen(k), L.widen(v), w_log,
                               u, state=s0)
    new_state = {"x_prev": x[:, -1:], "wkv": wkv}

    # per-head group-norm, gate, head-merging output projection
    out = L.rmsnorm(ln_out, out.to(dt), cfg.norm_eps) * g
    out = L._out_proj(out, p["wo"], dt)
    return (pspec.tp_exit(out) if hs is not None else out), new_state


# ================================================================== Mamba-1
def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def mamba_init(gen, cfg: ModelConfig, lead=(), *, device) -> Params:
    """One Mamba layer's parameters; `lead` prepends stacking axes."""
    d = cfg.d_model
    di = cfg.expand * d
    ds, dc = cfg.d_state, cfg.d_conv
    r = _dt_rank(cfg)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device).tile(di, 1))
    return {
        "in_proj": L._init(gen, (d, 2 * di), lead, device),
        "conv_w": L._init(gen, (dc, di), lead, device, scale=dc ** -0.5),
        "conv_b": torch.zeros((*lead, di), dtype=torch.float32,
                              device=device),
        "x_proj": L._init(gen, (di, r + 2 * ds), lead, device),
        "dt_proj": L._init(gen, (r, di), lead, device, scale=r ** -0.5),
        "dt_bias": torch.full((*lead, di), -4.6, dtype=torch.float32,
                              device=device),            # softplus^-1(0.01)
        "a_log": a_log.expand(*lead, di, ds).clone(),
        "d_skip": torch.ones((*lead, di), dtype=torch.float32,
                             device=device),
        "out_proj": L._init(gen, (di, d), lead, device, scale=di ** -0.5),
    }


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """x: [B, S, d].  state: {'conv': [B, d_conv-1, di], 'h': [B, di,
    d_state]} (zeros when None).  One code path serves the forward pass,
    prefill (returns the final state) and decode (s = 1): the selective
    scan kernel on the card in each."""
    b, s, d = x.shape
    di = cfg.expand * d
    ds, dc = cfg.d_state, cfg.d_conv
    r = _dt_rank(cfg)
    dt = x.dtype

    cs = pspec.split(di)                # this rank's channels, or None
    if cs is None:
        xz = x @ p["in_proj"].to(dt)
        xi, z = xz[..., :di], xz[..., di:]
    else:                               # in_proj is whole here
        x = pspec.tp_enter(x)
        w = p["in_proj"]
        xi = x @ w[:, cs[0]:cs[1]].to(dt)
        z = x @ w[:, di + cs[0]:di + cs[1]].to(dt)
        di = cs[1] - cs[0]

    # causal depthwise conv (carried tail = the conv state)
    prev = (state["conv"].to(dt) if state is not None
            else torch.zeros((b, dc - 1, di), dtype=dt, device=x.device))
    conv_in = torch.cat([prev, xi], dim=1)
    new_conv = conv_in[:, -(dc - 1):]
    xc = sum(conv_in[:, i:i + s] * p["conv_w"][i].to(dt)
             for i in range(dc)) + p["conv_b"].to(dt)
    xc = F.silu(xc)

    proj = xc @ p["x_proj"].to(dt)
    if cs is not None:                  # row-parallel, read by channels
        proj = pspec.tp_sum(proj)
    dt_in, bmat, cmat = (proj[..., :r], proj[..., r:r + ds],
                         proj[..., r + ds:])
    # softplus as JAX writes it (log(1 + e^x) without a threshold)
    pre = dt_in @ p["dt_proj"].to(dt) + p["dt_bias"].to(dt)
    delta = torch.logaddexp(pre, torch.zeros((), dtype=dt,
                                             device=x.device))   # [B,S,di]
    a = -torch.exp(p["a_log"].float())                            # [di,ds]

    h0 = None if state is None else state["h"]
    y, h_final = scan_ops.mamba_scan(xc.float(), delta.float(),
                                     bmat.float(), cmat.float(), a, h0=h0)
    y = y.to(dt) + xc * p["d_skip"].to(dt)
    out = (y * F.silu(z)) @ p["out_proj"].to(dt)
    if cs is not None:
        out = pspec.tp_exit(out)
    return out, {"conv": new_conv.float(), "h": h_final}

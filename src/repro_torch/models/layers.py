"""Core layer library of the port (`repro.models.layers`): RMSNorm, RoPE,
GQA attention (full / sliding / decode-with-cache), SwiGLU MLP.  Pure
functions over parameter dicts of tensors; initialisers return nested
dicts of float32 tensors.

Attention parameters are head-structured ([d, H, dh]) as in the
reference.  The reference's mesh annotations (`pspec.constrain`,
`axis_size`) do nothing on one device and are left out.

Attention has two prefill paths with identical math: the plain path
below (`sdpa_ref`, or `sdpa_online` when `cfg.attn_impl == "online"`)
and the flash kernel (`repro_torch.kernels.flash_attention`), which a
CUDA tensor reaches with `use_flash=True`.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = dict[str, Any]

NEG_INF = -1e30
_QBLOCK = 2048          # query blocks beyond this sequence length


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 device: str | torch.device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF draw, as
    `torch.nn.init.trunc_normal_`), times `scale`; float32, drawn from
    `gen` on `device`.  The reference's distribution, not its bits."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2, 2))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    return t.erfinv_().mul_(math.sqrt(2.0) * scale).clamp_(-2 * scale,
                                                           2 * scale)


def _init(gen, shape, lead, device, scale=None):
    scale = scale if scale is not None else shape[0] ** -0.5
    return trunc_normal(gen, (*lead, *shape), scale, device)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, lead=(), *, device) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=device)}


def widen(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32 where the reference computes in float32, a
    float64 `x` kept as it is: a model run in float64 (the norms, the
    RWKV6 mixer, the logits and the loss) stays in float64, which is how
    the float64 witness of the training checks is computed."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = widen(x)
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


# -------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] (integer)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                   # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def attention_init(gen, cfg: ModelConfig, lead=(), *,
                   device) -> Params:
    """One attention layer's parameters; `lead` prepends stacking axes
    (the transformer's [R, ...])."""
    d, dh = cfg.d_model, cfg.head_dim
    p = {
        "wq": _init(gen, (d, cfg.n_heads, dh), lead, device),
        "wk": _init(gen, (d, cfg.n_kv_heads, dh), lead, device),
        "wv": _init(gen, (d, cfg.n_kv_heads, dh), lead, device),
        "wo": _init(gen, (cfg.n_heads, dh, d), lead, device,
                    scale=d ** -0.5),
    }
    if cfg.qkv_bias:
        for name, h in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((*lead, h, dh), dtype=torch.float32,
                                  device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, lead, device=device)
        p["k_norm"] = rmsnorm_init(dh, lead, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    dt = x.dtype
    q, k, v = (_proj(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores_block(q, k, v, mask, dh, score_dtype=torch.float32):
    """One (possibly full) query block.  q: [B,Sq,Hq,Dh];
    k/v: [B,Sk,Hkv,Dh]; mask: [Sq,Sk] bool.  score_dtype=bf16 stores
    scores and probabilities in bf16; the softmax row statistics stay
    float32."""
    b, sq, hq, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(score_dtype)
    scores = scores * torch.tensor(dh ** -0.5, dtype=score_dtype)
    scores = scores.reshape(b, hkv * g, sq, sk)
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(NEG_INF, dtype=score_dtype))
    m = scores.amax(-1, keepdim=True).float()
    p = torch.exp(scores.float() - m).to(score_dtype)
    denom = p.float().sum(-1, keepdim=True)
    probs = (p / denom.to(score_dtype)).to(v.dtype)
    probs = probs.reshape(b, hkv, g, sq, sk)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, hq, dh)


def sdpa_online(q, k, v, *, causal: bool = True, window: int | None = None,
                k_block: int = 512) -> torch.Tensor:
    """Streaming (online-softmax) attention in plain PyTorch: a loop over
    key blocks carrying (m, l, acc).  The same math as `sdpa_ref`, but
    the [Sq, Sk] score matrix is never materialised."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nk = -(-sk // k_block)
    qg = q.reshape(b, sq, hkv, g, dh).float() * (dh ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), device=q.device)
    for j in range(nk):
        kblk = k[:, j * k_block:(j + 1) * k_block].float()
        vblk = v[:, j * k_block:(j + 1) * k_block].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kblk)
        kpos = j * k_block + torch.arange(kblk.shape[1],
                                          device=q.device)[None, :]
        mask = torch.ones((sq, kblk.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, NEG_INF)
        m_c = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_c)
        p = torch.exp(s - m_c[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                    p, vblk)
        m = m_c
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def sdpa_ref(q, k, v, *, causal: bool = True, window: int | None = None,
             q_offset: int = 0, q_block: int = _QBLOCK,
             score_dtype=torch.float32) -> torch.Tensor:
    """Reference GQA attention.  q: [B,Sq,Hq,Dh], k/v: [B,Sk,Hkv,Dh].
    Long queries are processed in blocks of `q_block` to bound the score
    tensor at [B, H, q_block, Sk]; a query length above `q_block` must
    be a multiple of it (the reference asserts it; this raises
    ValueError)."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    kpos = torch.arange(sk, device=q.device)[None, :]

    def mask_for(qpos):
        m = (kpos <= qpos if causal
             else torch.ones((qpos.shape[0], sk), dtype=torch.bool,
                             device=q.device))
        if window is not None:
            m = m & (kpos > qpos - window)
        return m

    def qpos_from(lo, n):
        return torch.arange(n, device=q.device)[:, None] + lo + q_offset

    if sq <= q_block:
        return _scores_block(q, k, v, mask_for(qpos_from(0, sq)), dh,
                             score_dtype)
    if sq % q_block:
        raise ValueError(f"sdpa_ref: query length {sq} above q_block "
                         f"{q_block} must be a multiple of it "
                         f"{(sq, q_block)}")
    return torch.cat([
        _scores_block(q[:, i:i + q_block], k, v,
                      mask_for(qpos_from(i, q_block)), dh, score_dtype)
        for i in range(0, sq, q_block)], dim=1)


def decode_attend(q, ck, cv, valid, dh):
    """Decode attention over a cache.  q: [B,1,Hq,Dh]; ck/cv:
    [B,S,Hkv,Dh]; valid: [S] bool."""
    b, _, hq, _ = q.shape
    hkv = ck.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          ck.to(qg.dtype)).float()
    scores = scores * (dh ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cv)
    return out.reshape(b, 1, hq, dh)


def attend(p: Params, q, k, v, x_dtype, cfg: ModelConfig,
           window: int | None, use_flash: bool) -> torch.Tensor:
    """Causal attention of a whole prompt and the output projection:
    q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh] -> [B,S,d]."""
    if use_flash:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    elif cfg.attn_impl == "online":
        out = sdpa_online(q, k, v, causal=True, window=window)
    else:
        sdt = torch.bfloat16 if cfg.attn_dtype == "bf16" else torch.float32
        out = sdpa_ref(q, k, v, causal=True, window=window, score_dtype=sdt)
    return _out_proj(out, p["wo"], x_dtype)


def _out_proj(out, wo, dt):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(dt).reshape(h * k, d)


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *, local: bool = False,
                    cache: Params | None = None,
                    use_flash: bool = False) -> tuple[torch.Tensor,
                                                      Params | None]:
    """Returns (out, updated_cache).  cache = {'k','v'}: [B,S,Hkv,Dh]
    buffers (a ring for local layers), updated IN PLACE at the decode
    position `positions[0, 0]` (uniform over the batch), read on the
    device without a host round trip.  As the reference's
    `dynamic_update_slice`, a position past the buffer writes its last
    slot."""
    dh = cfg.head_dim
    window = cfg.sliding_window if local else None
    q, k, v = _qkv(p, x, cfg, positions)
    if cache is None:
        return attend(p, q, k, v, x.dtype, cfg, window, use_flash), None

    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    pos = positions[0, 0]
    slot = pos % s_cache if window is not None else pos
    slot = torch.clamp(slot, 0, s_cache - 1).reshape(1)
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    kpos = torch.arange(s_cache, device=x.device)
    if window is not None:
        abs_pos = pos - ((pos - kpos) % s_cache)
        valid = (abs_pos >= 0) & (pos - abs_pos < min(window, s_cache))
    else:
        valid = kpos <= pos
    out = decode_attend(q, ck, cv, valid, dh)
    return _out_proj(out, p["wo"], x.dtype), cache


# ------------------------------------------------------------------ SwiGLU
def mlp_init(gen, d: int, d_ff: int, lead=(), *, device) -> Params:
    return {
        "w_gate": _init(gen, (d, d_ff), lead, device),
        "w_up": _init(gen, (d, d_ff), lead, device),
        "w_down": _init(gen, (d_ff, d), lead, device, scale=d_ff ** -0.5),
    }


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = (F.silu(x @ p["w_gate"].to(x.dtype))
         * (x @ p["w_up"].to(x.dtype)))
    return h @ p["w_down"].to(x.dtype)

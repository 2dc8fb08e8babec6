"""Core layer library of the port (`repro.models.layers`): RMSNorm, RoPE,
GQA attention (full / sliding / decode-with-cache), SwiGLU MLP.  Pure
functions over parameter dicts of tensors; initialisers return nested
dicts of float32 tensors.

Attention parameters are head-structured ([d, H, dh]) as in the
reference.  Under a mesh (`pspec.set_mesh`) each function runs on the
rank's parameter shards and partitions its activations over "model"
where the reference constrains them (Megatron-style, `pspec`): the
heads (`wq` column-parallel, `wo` row-parallel and its output summed,
the reference's layers.py:138, :195, :290), or, where the heads do not
divide the "model" ranks (qwen2.5's 40, arctic's 56 on 16), the scores'
key positions (:125, :129); the MLP hidden (:306); a decode cache split
by sequence (:266-267), whose softmax takes each shard's maximum and
sum and reduces them.  With GQA the K/V projections are replicated over
"model" and each rank projects the KV heads its q heads read.  On one
device, or a mesh of one rank, every collective is the identity and the
ops are the mesh-free ones.

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

from repro_torch import pspec
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


def _kv_heads(cfg: ModelConfig):
    """The KV heads that this rank's q heads read, as an index of the
    KV axis (a slice where they group evenly, else one KV head per q
    head), or None where the q heads are not split over "model"."""
    hs = pspec.split(cfg.n_heads)
    if hs is None:
        return None
    lo, hi = hs
    g = cfg.n_heads // cfg.n_kv_heads
    if lo // g == (hi - 1) // g or (lo % g == 0 and hi % g == 0):
        return slice(lo // g, (hi - 1) // g + 1)
    return torch.tensor([h // g for h in range(lo, hi)])


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, positions,
         whole_kv: bool = False):
    """q of this rank's heads (all without a split) and k/v of the KV
    heads they read (`_kv_heads`), or of every KV head with `whole_kv`
    (the decode cache holds them all)."""
    dt = x.dtype
    sel = _kv_heads(cfg)
    if sel is not None:
        x = pspec.tp_enter(x)
    wk, wv, bk, bv = (p.get(n) for n in ("wk", "wv", "bk", "bv"))
    if sel is not None:                 # replicated, read in part
        wk, wv = pspec.tp_enter(wk), pspec.tp_enter(wv)
        if cfg.qkv_bias:
            bk, bv = pspec.tp_enter(bk), pspec.tp_enter(bv)
        if not whole_kv:
            wk, wv = wk[:, sel], wv[:, sel]
            if cfg.qkv_bias:
                bk, bv = bk[sel], bv[sel]
    q, k, v = (_proj(x, w) for w in (p["wq"], wk, wv))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if sel is not None:
            qn, kn = ({"scale": pspec.tp_enter(n["scale"])} for n in (qn, kn))
        q = rmsnorm(qn, q, cfg.norm_eps)
        k = rmsnorm(kn, k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def kv_for_heads(k, v, cfg: ModelConfig):
    """From k/v of every KV head, those this rank's q heads read."""
    sel = _kv_heads(cfg)
    return (k, v) if sel is None else (k[:, :, sel], v[:, :, sel])


def _by_keys(cfg: ModelConfig) -> bool:
    """Whether scores split over "model" by key position: the heads do
    not divide its ranks (the reference's layers.py:128-129)."""
    return pspec.model_size() > 1 and pspec.split(cfg.n_heads) is None


def _scores_block(q, k, v, mask, dh, score_dtype=torch.float32,
                  by_keys: bool = False):
    """One (possibly full) query block.  q: [B,Sq,Hq,Dh];
    k/v: [B,Sk,Hkv,Dh]; mask: [Sq,Sk] bool.  score_dtype=bf16 stores
    scores and probabilities in bf16; the softmax row statistics stay
    float32.  With `by_keys` (and Sk split over "model") each rank
    scores its block of key positions: the row maxima and denominators
    are reduced over "model", and so is the output."""
    keys = pspec.split(k.shape[1]) if by_keys else None
    if keys is not None:
        q, k, v = (pspec.tp_enter(a) for a in (q, k, v))
        k, v, mask = (k[:, keys[0]:keys[1]], v[:, keys[0]:keys[1]],
                      mask[:, keys[0]:keys[1]])
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
    if keys is not None:
        m = pspec.tp_max(m)
    p = torch.exp(scores.float() - m).to(score_dtype)
    denom = p.float().sum(-1, keepdim=True)
    if keys is not None:
        denom = pspec.tp_sum(denom)
    probs = (p / denom.to(score_dtype)).to(v.dtype)
    probs = probs.reshape(b, hkv, g, sq, sk)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    out = out.reshape(b, sq, hq, dh)
    return pspec.tp_exit(out) if keys is not None else out


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
             score_dtype=torch.float32, by_keys: bool = False
             ) -> torch.Tensor:
    """Reference GQA attention.  q: [B,Sq,Hq,Dh], k/v: [B,Sk,Hkv,Dh].
    Long queries are processed in blocks of `q_block` to bound the score
    tensor at [B, H, q_block, Sk]; a query length above `q_block` must
    be a multiple of it (the reference asserts it; this raises
    ValueError).  `by_keys`: see `_scores_block`."""
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
                             score_dtype, by_keys)
    if sq % q_block:
        raise ValueError(f"sdpa_ref: query length {sq} above q_block "
                         f"{q_block} must be a multiple of it "
                         f"{(sq, q_block)}")
    return torch.cat([
        _scores_block(q[:, i:i + q_block], k, v,
                      mask_for(qpos_from(i, q_block)), dh, score_dtype,
                      by_keys)
        for i in range(0, sq, q_block)], dim=1)


def decode_attend(q, ck, cv, valid, dh, seq_split: bool = False):
    """Decode attention over a cache.  q: [B,1,Hq,Dh]; ck/cv:
    [B,S,Hkv,Dh]; valid: [S] bool.  With `seq_split` the cache is this
    rank's block of positions: the softmax's maximum and sum, and the
    output, are reduced over "model" (no cache is gathered)."""
    b, _, hq, _ = q.shape
    hkv = ck.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          ck.to(qg.dtype)).float()
    scores = scores * (dh ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    if seq_split:
        m = pspec.tp_max(scores.amax(-1, keepdim=True))
        e = torch.exp(scores - m)
        probs = (e / pspec.tp_sum(e.sum(-1, keepdim=True))).to(cv.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cv)
    out = out.reshape(b, 1, hq, dh)
    return pspec.tp_exit(out) if seq_split else out


def attend(p: Params, q, k, v, x_dtype, cfg: ModelConfig,
           window: int | None, use_flash: bool) -> torch.Tensor:
    """Causal attention of a whole prompt and the output projection:
    q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh] -> [B,S,d] (this rank's heads, and
    the KV heads they read, under a split).  The flash kernel and the
    online path run whole heads; scores split by key positions run the
    plain path."""
    if use_flash:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    elif cfg.attn_impl == "online":
        out = sdpa_online(q, k, v, causal=True, window=window)
    else:
        sdt = torch.bfloat16 if cfg.attn_dtype == "bf16" else torch.float32
        out = sdpa_ref(q, k, v, causal=True, window=window, score_dtype=sdt,
                       by_keys=_by_keys(cfg))
    return _out_proj_tp(out, p["wo"], x_dtype, cfg)


def _out_proj(out, wo, dt):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(dt).reshape(h * k, d)


def _out_proj_tp(out, wo, dt, cfg: ModelConfig):
    """The output projection of this rank's heads, summed over "model"
    where they are split (row-parallel `wo`; the reference's
    `constrain(proj, "dp", None, None)`, layers.py:290)."""
    proj = _out_proj(out, wo, dt)
    return pspec.tp_exit(proj) if pspec.split(cfg.n_heads) else proj


def _write_row(buf, slot, row, seq):
    """Write `row` [B,1,...] at position `slot` (a [1] tensor) of a cache
    whose positions are this rank's block `seq` ([lo, hi)) of the whole,
    or all of it (None): only the rank that holds the slot changes its
    buffer, read on the device without a host round trip."""
    if seq is None:
        buf.index_copy_(1, slot, row.to(buf.dtype))
        return
    at = slot - seq[0]
    mine = (at >= 0) & (at < seq[1] - seq[0])
    at = torch.clamp(at, 0, seq[1] - seq[0] - 1)
    buf.index_copy_(1, at, torch.where(mine, row.to(buf.dtype),
                                       buf.index_select(1, at)))


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
    slot.  Under a mesh the cache may hold this rank's block of the
    sequence (`launch.sharding.cache_shardings`): a buffer shorter than
    the config's (`cfg.max_seq_len`, or the window) is that block."""
    dh = cfg.head_dim
    window = cfg.sliding_window if local else None
    if cache is None:
        q, k, v = _qkv(p, x, cfg, positions)
        return attend(p, q, k, v, x.dtype, cfg, window, use_flash), None

    q, k, v = _qkv(p, x, cfg, positions, whole_kv=True)
    ck, cv = cache["k"], cache["v"]
    s_local = ck.shape[1]
    whole = (min(cfg.sliding_window, cfg.max_seq_len) if local
             else cfg.max_seq_len)
    seq = pspec.split(whole) if s_local != whole else None
    if seq is not None and seq[1] - seq[0] != s_local:
        raise ValueError(f"attention_apply: a cache block of {s_local} "
                         f"positions is not this rank's block {seq} of "
                         f"the config's {whole}")
    s_cache = s_local if seq is None else whole
    pos = positions[0, 0]
    slot = pos % s_cache if window is not None else pos
    slot = torch.clamp(slot, 0, s_cache - 1).reshape(1)
    _write_row(ck, slot, k, seq)
    _write_row(cv, slot, v, seq)
    kpos = torch.arange(s_local, device=x.device) + (0 if seq is None
                                                     else seq[0])
    if window is not None:
        abs_pos = pos - ((pos - kpos) % s_cache)
        valid = (abs_pos >= 0) & (pos - abs_pos < min(window, s_cache))
    else:
        valid = kpos <= pos
    if seq is None:
        out = decode_attend(q, *kv_for_heads(ck, cv, cfg), valid, dh)
    else:                       # every head over this rank's positions
        heads = pspec.split(cfg.n_heads)
        qa = pspec.tp_gather(q, 2) if heads else q
        out = decode_attend(qa, ck, cv, valid, dh, seq_split=True)
        if heads:
            out = out[:, :, heads[0]:heads[1]]
    return _out_proj_tp(out, p["wo"], x.dtype, cfg), cache


# ------------------------------------------------------------------ SwiGLU
def mlp_init(gen, d: int, d_ff: int, lead=(), *, device) -> Params:
    return {
        "w_gate": _init(gen, (d, d_ff), lead, device),
        "w_up": _init(gen, (d, d_ff), lead, device),
        "w_down": _init(gen, (d_ff, d), lead, device, scale=d_ff ** -0.5),
    }


def mlp_apply(p: Params, x: torch.Tensor,
              d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU.  `d_ff`, the whole hidden width, tells whether the hidden
    is split over "model" (column-parallel `w_gate`/`w_up`, row-parallel
    `w_down`, the output summed; the reference's layers.py:306); None:
    the parameters are whole."""
    tp = d_ff is not None and pspec.split(d_ff) is not None
    if tp:
        x = pspec.tp_enter(x)
    h = (F.silu(x @ p["w_gate"].to(x.dtype))
         * (x @ p["w_up"].to(x.dtype)))
    out = h @ p["w_down"].to(x.dtype)
    return pspec.tp_exit(out) if tp else out

"""Decoder-LM assembly of the port (`repro.models.transformer`): init /
forward / prefill / decode over the stage structure from ModelConfig,
a Python loop over the R stacked layers of each stage.

    apply(params, tokens, cfg)                 -> logits, aux  (training)
    loss_fn(params, tokens, targets, cfg)      -> loss
    prefill(params, tokens, cfg, max_len)      -> logits, cache
    decode_step(params, cache, tok, pos, cfg)  -> logits, cache (1 token)

Params keep the reference's tree: `stage` leaves are stacked [R, ...],
as are the cache leaves (K/V [R, B, S, Hkv, Dh]; Mamba {conv, h}; RWKV6
{x_prev, wkv}), so `repro_torch.convert.model_params` carries the
reference's params across one to one.  Every mixer (attention, Mamba,
RWKV6) and every FFN (dense, MoE, MoE with a dense residual) of the
reference is ported; a MoE layer's auxiliary load-balancing loss is
summed over the layers into `apply`'s `aux`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import ssm as SSM

Params = dict[str, Any]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ------------------------------------------------------------------- init
def init_layer(gen, spec: LayerSpec, cfg: ModelConfig, lead=(), *,
               device) -> Params:
    init = {"attn": L.attention_init, "attn_local": L.attention_init,
            "mamba": SSM.mamba_init, "rwkv6": SSM.rwkv6_init}
    if spec.mixer not in init or spec.ffn not in ("dense", "moe",
                                                   "moe_dense"):
        raise ValueError(f"init_layer: unknown layer {spec}")
    mixer = init[spec.mixer](gen, cfg, lead, device=device)
    if spec.ffn == "dense":
        ffn = L.mlp_init(gen, cfg.d_model, cfg.d_ff, lead, device=device)
    else:
        ffn = MoE.moe_init(gen, cfg, spec.ffn == "moe_dense", lead,
                           device=device)
    return {"norm1": L.rmsnorm_init(cfg.d_model, lead, device=device),
            "norm2": L.rmsnorm_init(cfg.d_model, lead, device=device),
            "mixer": mixer, "ffn": ffn}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: str | torch.device = "cuda") -> Params:
    """Random float32 parameters drawn from `gen` on `device` (the
    generator must live there): embedding N(0, 0.02^2), weights
    truncated normal on [-2, 2] times the reference's scale, norm scales
    1, biases 0.  The reference's distribution, not its bits."""
    dev = resolve_device(device)
    group = cfg.group_spec()
    lead = (cfg.n_layers // len(group),)
    params: Params = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             device=dev) * 0.02,
        "final_norm": L.rmsnorm_init(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._init(gen, (cfg.d_model, cfg.vocab_size), (),
                                    dev)
    params["stage"] = {f"l{i}": init_layer(gen, spec, cfg, lead, device=dev)
                       for i, spec in enumerate(group)}
    return params


# ----------------------------------------------------------------- layers
def _attn_prefill_cache(k, v, cfg: ModelConfig, local: bool) -> Params:
    """The decode cache after a prefill pass: K/V of the whole prompt
    written into a max_seq_len buffer (ring-sized for local layers, the
    last `size` positions at slots pos % size)."""
    s = k.shape[1]
    size = (min(cfg.sliding_window, cfg.max_seq_len) if local
            else cfg.max_seq_len)
    if local and s >= size:
        start = (s - size) % size
        return {"k": torch.roll(k[:, -size:], start, dims=1),
                "v": torch.roll(v[:, -size:], start, dims=1)}
    pad = (0, 0, 0, 0, 0, size - s)
    return {"k": torch.nn.functional.pad(k, pad),
            "v": torch.nn.functional.pad(v, pad)}


def _ssm_apply(p, x, cfg, spec: LayerSpec, cache, mode):
    """Mamba / RWKV6 mixer.  Prefill returns the final states as the new
    cache; decode writes them into `cache` in place, as attention writes
    its K/V."""
    apply_fn = SSM.mamba_apply if spec.mixer == "mamba" else SSM.rwkv6_apply
    out, state = apply_fn(p, x, cfg, state=cache)
    if mode == "train":
        return out, None
    if mode == "decode":
        for leaf, new in state.items():
            cache[leaf].copy_(new)
        return out, cache
    return out, state


def _mixer_apply(p, x, cfg, spec: LayerSpec, positions, cache, mode,
                 use_flash):
    """The layer's mixer.  Attention in prefill mode projects Q/K/V once
    and K/V also fill the decode cache (the reference projects them
    twice, with the same result)."""
    if spec.mixer in ("mamba", "rwkv6"):
        return _ssm_apply(p, x, cfg, spec, cache, mode)
    local = spec.mixer == "attn_local"
    if mode == "decode":
        return L.attention_apply(p, x, cfg, positions, local=local,
                                 cache=cache)
    if mode != "prefill":
        return L.attention_apply(p, x, cfg, positions, local=local,
                                 use_flash=use_flash)
    q, k, v = L._qkv(p, x, cfg, positions)
    window = cfg.sliding_window if local else None
    out = L.attend(p, q, k, v, x.dtype, cfg, window, use_flash)
    return out, _attn_prefill_cache(k, v, cfg, local)


def layer_apply(p: Params, x, cfg, spec: LayerSpec, positions, cache, mode,
                use_flash=False):
    h, new_cache = _mixer_apply(p["mixer"],
                                L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                                cfg, spec, positions, cache, mode, use_flash)
    x = x + h
    hn = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        f, aux = L.mlp_apply(p["ffn"], hn), 0.0
    else:
        f, aux = MoE.moe_apply(p["ffn"], hn, cfg)
    return x + f, new_cache, aux


# ------------------------------------------------------------- stage loop
def _group_apply(group_p, x, cfg, positions, use_flash):
    """One repeat of the layer group in training mode: (x, aux)."""
    aux = 0.0
    for i, spec in enumerate(cfg.group_spec()):
        x, _, a = layer_apply(group_p[f"l{i}"], x, cfg, spec, positions,
                              None, "train", use_flash)
        aux = aux + a
    return x, aux


def _stage_scan(params, x, cfg, positions, caches, mode, use_flash,
                remat: bool = False):
    """The reference's scan over the stacked layers as a Python loop.
    Decode updates `caches` in place and returns it; prefill returns the
    new caches stacked [R, ...].  In training mode with `remat` (and
    grad enabled) each repeat of the layer group runs under
    `torch.utils.checkpoint` (non-reentrant): its activations are
    recomputed in the backward pass, as the reference's `jax.checkpoint`
    of the scan body.  A stage leaf may also be a list of R per-layer
    tensors (`repro_torch.train.step` trains through such views)."""
    group = cfg.group_spec()
    repeats = cfg.n_layers // len(group)
    aux = 0.0
    new_cs: dict[str, list] = {f"l{i}": [] for i in range(len(group))}
    for r in range(repeats):
        group_p = {name: _tree_map(lambda t: t[r], params["stage"][name])
                   for name in params["stage"]}
        if mode == "train":
            if remat and torch.is_grad_enabled():
                x, a = torch.utils.checkpoint.checkpoint(
                    _group_apply, group_p, x, cfg, positions, use_flash,
                    use_reentrant=False)
            else:
                x, a = _group_apply(group_p, x, cfg, positions, use_flash)
            aux = aux + a
            continue
        for i, spec in enumerate(group):
            name = f"l{i}"
            c = (None if caches is None
                 else _tree_map(lambda t: t[r], caches[name]))
            x, nc, a = layer_apply(group_p[name], x, cfg, spec, positions, c,
                                   mode, use_flash)
            aux = aux + a
            if mode == "prefill":
                new_cs[name].append(nc)
    if mode == "prefill":
        caches = {name: {leaf: torch.stack([c[leaf] for c in cs])
                         for leaf in cs[0]}
                  for name, cs in new_cs.items()}
    return x, aux, caches


# ------------------------------------------------------------ entry points
def _logits(params, x, cfg):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.widen(x @ head.to(x.dtype))


def _embed(params, tokens, dtype):
    return params["embed"][tokens.long()].to(dtype)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor | None = None, use_flash: bool = False,
          remat: bool = True, dtype=torch.bfloat16):
    """Training forward: tokens [B,S] -> (logits [B,S,V] float32, aux).
    `remat` recomputes each layer group's activations in the backward
    pass (`_stage_scan`)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, dtype)
    x, aux, _ = _stage_scan(params, x, cfg, positions, None, "train",
                            use_flash, remat)
    return _logits(params, x, cfg), aux


def loss_fn(params: Params, tokens, targets, cfg: ModelConfig,
            aux_weight: float = 0.01, **kw):
    """Mean next-token cross-entropy plus `aux_weight` times the
    auxiliary loss; `kw` goes to `apply`."""
    logits, aux = apply(params, tokens, cfg, **kw)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean() + aux_weight * aux


# ----- serving -----
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> Params:
    """Zeroed decode caches matching the stage structure ([R, ...]): K/V
    in `dtype`, Mamba's conv and scan states and RWKV6's WKV state in
    float32, RWKV6's shifted token in `dtype` (the reference's types)."""
    dev = resolve_device(device)
    group = cfg.group_spec()
    repeats = cfg.n_layers // len(group)

    def one(spec: LayerSpec):
        if spec.mixer == "mamba":
            di = cfg.expand * cfg.d_model
            return {"conv": torch.zeros((repeats, batch, cfg.d_conv - 1, di),
                                        device=dev),
                    "h": torch.zeros((repeats, batch, di, cfg.d_state),
                                     device=dev)}
        if spec.mixer == "rwkv6":
            dh = cfg.head_dim
            return {"x_prev": torch.zeros((repeats, batch, 1, cfg.d_model),
                                          dtype=dtype, device=dev),
                    "wkv": torch.zeros((repeats, batch, cfg.n_heads, dh,
                                        dh), device=dev)}
        size = (min(cfg.sliding_window, max_len)
                if spec.mixer == "attn_local" else max_len)
        shp = (repeats, batch, size, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shp, dtype=dtype, device=dev),
                "v": torch.zeros(shp, dtype=dtype, device=dev)}

    return {f"l{i}": one(spec) for i, spec in enumerate(group)}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, use_flash: bool = False,
            dtype=torch.bfloat16):
    """Prompt pass: returns (last-token logits [B,V], decode cache).
    max_len overrides cfg.max_seq_len for the cache size.  With
    `use_flash` every attention layer goes through the flash kernel; Mamba
    and RWKV6 layers always go through their kernel wrappers."""
    b, s = tokens.shape
    if max_len is not None and max_len != cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=max_len)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, dtype)
    x, _, caches = _stage_scan(params, x, cfg, positions, None, "prefill",
                               use_flash)
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos, cfg: ModelConfig, dtype=torch.bfloat16):
    """One decode step: tokens [B,1] at absolute position `pos` (an int
    or a 0-d integer tensor).  Returns (logits [B,V], cache), the cache
    updated in place."""
    b = tokens.shape[0]
    if isinstance(pos, torch.Tensor):
        positions = pos.to(tokens.device, torch.long).reshape(1, 1)
    else:                   # a fill on the device: no host-to-device copy
        positions = torch.full((1, 1), int(pos), dtype=torch.long,
                               device=tokens.device)
    positions = positions.expand(b, 1)
    x = _embed(params, tokens, dtype)
    x, _, cache = _stage_scan(params, x, cfg, positions, cache, "decode",
                              False)
    return _logits(params, x, cfg)[:, 0], cache

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

On a mesh (parameters that are `DTensor`s placed by
`launch.sharding`, or `Local` views of their shards, which the train
step makes) each layer gathers its parameters over the data-parallel
axes where it runs (`pspec.gather_param`; inside a remat group, so the
backward gathers them again), keeping their "model" shards, and the
layers partition their activations over "model" (`layers`, `ssm`,
`moe`).  The embedding is looked up in the rank's vocabulary block and
summed, the logits are computed on it and joined.  With
`cfg.seq_parallel` the residual stream between layer groups (the remat
stash) is split by sequence over "model" (the reference's
transformer.py:130-134) and made whole inside each group.  A prefill's
attention cache holds the rank's block of positions, a decode step
writes and reads such a block, and the entry points return caches
placed by `launch.sharding.cache_shardings`.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Any

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Shard

from repro_torch import pspec
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SH
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
    last `size` positions at slots pos % size); under a mesh the rank's
    block of the buffer's positions where "model" splits them."""
    s = k.shape[1]
    size = (min(cfg.sliding_window, cfg.max_seq_len) if local
            else cfg.max_seq_len)
    if local and s >= size:
        start = (s - size) % size
        cache = {"k": torch.roll(k[:, -size:], start, dims=1),
                 "v": torch.roll(v[:, -size:], start, dims=1)}
    else:
        pad = (0, 0, 0, 0, 0, size - s)
        cache = {"k": torch.nn.functional.pad(k, pad),
                 "v": torch.nn.functional.pad(v, pad)}
    seq = pspec.split(size)
    if seq is not None:
        cache = {n: c[:, seq[0]:seq[1]].contiguous() for n, c in cache.items()}
    return cache


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
    q, k, v = L._qkv(p, x, cfg, positions, whole_kv=True)
    window = cfg.sliding_window if local else None
    out = L.attend(p, q, *L.kv_for_heads(k, v, cfg), x.dtype, cfg, window,
                   use_flash)
    return out, _attn_prefill_cache(k, v, cfg, local)


def layer_apply(p: Params, x, cfg, spec: LayerSpec, positions, cache, mode,
                use_flash=False):
    h, new_cache = _mixer_apply(p["mixer"],
                                L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                                cfg, spec, positions, cache, mode, use_flash)
    x = x + h
    hn = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        f, aux = L.mlp_apply(p["ffn"], hn, cfg.d_ff), 0.0
    else:
        f, aux = MoE.moe_apply(p["ffn"], hn, cfg)
    return x + f, new_cache, aux


# ------------------------------------------------------------- stage loop
def _seq_split(cfg: ModelConfig, mode: str, s: int) -> bool:
    """Whether the residual stream between layer groups is split by
    sequence over "model" (`seq_parallel`, not in decode)."""
    return (cfg.seq_parallel and mode != "decode"
            and pspec.split(s) is not None)


def _group_apply(group_p, x, cfg, positions, use_flash, seq_split=False):
    """One repeat of the layer group in training mode: (x, aux).  The
    layers' parameters are gathered here, inside the remat region."""
    aux = 0.0
    if seq_split:
        x = pspec.tp_gather(x, 1)
    for i, spec in enumerate(cfg.group_spec()):
        p = _tree_map(pspec.gather_param, group_p[f"l{i}"])
        x, _, a = layer_apply(p, x, cfg, spec, positions, None, "train",
                              use_flash)
        aux = aux + a
    if seq_split:
        x = pspec.tp_slice(x, 1)
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
    tensors or `Local` views (`repro_torch.train.step` trains through
    such views); a layer's parameters are gathered where it runs."""
    group = cfg.group_spec()
    repeats = cfg.n_layers // len(group)
    aux = 0.0
    seq_split = _seq_split(cfg, mode, x.shape[1])
    if seq_split:
        x = pspec.tp_slice(x, 1)
    new_cs: dict[str, dict] = {}
    for r in range(repeats):
        group_p = {name: _tree_map(lambda t: t[r], params["stage"][name])
                   for name in params["stage"]}
        if mode == "train":
            if remat and torch.is_grad_enabled():
                x, a = torch.utils.checkpoint.checkpoint(
                    _group_apply, group_p, x, cfg, positions, use_flash,
                    seq_split, use_reentrant=False)
            else:
                x, a = _group_apply(group_p, x, cfg, positions, use_flash,
                                    seq_split)
            aux = aux + a
            continue
        if seq_split:
            x = pspec.tp_gather(x, 1)
        for i, spec in enumerate(group):
            name = f"l{i}"
            c = (None if caches is None
                 else _tree_map(lambda t: t[r], caches[name]))
            p = _tree_map(pspec.gather_param, group_p[name])
            x, nc, a = layer_apply(p, x, cfg, spec, positions, c, mode,
                                   use_flash)
            aux = aux + a
            if mode == "prefill":       # into [R, ...] buffers, no stack
                if r == 0:
                    new_cs[name] = {leaf: c.new_empty((repeats, *c.shape))
                                    for leaf, c in nc.items()}
                for leaf, c in nc.items():
                    new_cs[name][leaf][r].copy_(c)
        if seq_split:
            x = pspec.tp_slice(x, 1)
    if seq_split:
        x = pspec.tp_gather(x, 1)
    if mode == "prefill":
        caches = new_cs
    return x, aux, caches


# ------------------------------------------------------------ entry points
def _logits(params, x, cfg):
    """Logits [.., V] (float32): the head's vocabulary block of this rank
    where "model" splits it, joined."""
    x = L.rmsnorm(_tree_map(pspec.gather_param, params["final_norm"]), x,
                  cfg.norm_eps)
    head = (pspec.gather_param(params["embed"]).T if cfg.tie_embeddings
            else pspec.gather_param(params["lm_head"]))
    if pspec.split(cfg.vocab_size) is None:
        return L.widen(x @ head.to(x.dtype))
    logits = L.widen(pspec.tp_enter(x) @ head.to(x.dtype))
    return pspec.tp_gather(logits, logits.dim() - 1)


def _embed(params, tokens, cfg, dtype):
    """The embedding rows of `tokens`: looked up in this rank's block of
    the vocabulary where "model" splits it (zeros outside it), summed."""
    emb = pspec.gather_param(params["embed"])
    vs = pspec.split(cfg.vocab_size)
    if vs is None:
        return emb[tokens.long()].to(dtype)
    idx = tokens.long() - vs[0]
    mine = (idx >= 0) & (idx < vs[1] - vs[0])
    rows = emb[torch.clamp(idx, 0, vs[1] - vs[0] - 1)] * mine[..., None]
    return pspec.tp_exit(rows).to(dtype)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor | None = None, use_flash: bool = False,
          remat: bool = True, dtype=torch.bfloat16):
    """Training forward: tokens [B,S] -> (logits [B,S,V] float32, aux).
    `remat` recomputes each layer group's activations in the backward
    pass (`_stage_scan`).  On a mesh, this runs under the mesh
    (`pspec.set_mesh`) on the rank's rows of `tokens`, with the
    parameters as `Local` views (`launch.sharding.layer_views`)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg, dtype)
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
def _cache_layout(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16) -> Params:
    """The decode caches' (shape, dtype) leaves ([R, ...])."""
    group = cfg.group_spec()
    repeats = cfg.n_layers // len(group)

    def one(spec: LayerSpec):
        if spec.mixer == "mamba":
            di = cfg.expand * cfg.d_model
            return {"conv": ((repeats, batch, cfg.d_conv - 1, di),
                             torch.float32),
                    "h": ((repeats, batch, di, cfg.d_state), torch.float32)}
        if spec.mixer == "rwkv6":
            dh = cfg.head_dim
            return {"x_prev": ((repeats, batch, 1, cfg.d_model), dtype),
                    "wkv": ((repeats, batch, cfg.n_heads, dh, dh),
                            torch.float32)}
        size = (min(cfg.sliding_window, max_len)
                if spec.mixer == "attn_local" else max_len)
        shp = (repeats, batch, size, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shp, dtype), "v": (shp, dtype)}

    return {f"l{i}": one(spec) for i, spec in enumerate(group)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> Params:
    """Zeroed decode caches matching the stage structure ([R, ...]): K/V
    in `dtype`, Mamba's conv and scan states and RWKV6's WKV state in
    float32, RWKV6's shifted token in `dtype` (the reference's types)."""
    dev = resolve_device(device)
    return {name: {leaf: torch.zeros(shp, dtype=dt, device=dev)
                   for leaf, (shp, dt) in c.items()}
            for name, c in _cache_layout(cfg, batch, max_len, dtype).items()}


def mesh_of(tree):
    """The mesh of a tree's first `DTensor` leaf, or None."""
    leaf = SH.tree_leaves(tree)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def _row_dims(x) -> list[int]:
    """The mesh dims that split a `DTensor` batch's rows, major first."""
    return [i for i, p in enumerate(x.placements)
            if p == Shard(0) and x.device_mesh.size(i) > 1]


def _placed_caches(cfg: ModelConfig, mesh, caches, batch: int):
    """A rank's cache shards as `DTensor`s placed by `cache_shardings`
    (of a cache of `batch` rows and `cfg.max_seq_len` positions)."""
    whole = {name: {leaf: types.SimpleNamespace(shape=torch.Size(shp))
                    for leaf, (shp, _) in c.items()}
             for name, c in _cache_layout(cfg, batch,
                                          cfg.max_seq_len).items()}
    sh = SH.cache_shardings(cfg, mesh, whole, batch)

    def one(path, c):
        shape, where = SH.at(whole, path).shape, SH.at(sh, path).placements
        block = list(shape)
        for i, p in enumerate(where):
            if isinstance(p, Shard):
                block[p.dim] //= mesh.size(i)
        if list(c.shape) != block:
            raise ValueError(f"prefill: the rank's cache block "
                             f"{tuple(c.shape)} at {SH.path_str(path)} is "
                             f"not the one cache_shardings places, "
                             f"{tuple(block)}; the batch's rows must split "
                             "over the data-parallel axes as the cache's do")
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(c, mesh, where, run_check=False,
                                  shape=shape, stride=stride)
    return SH.tree_map_with_path(one, caches)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, use_flash: bool = False,
            dtype=torch.bfloat16):
    """Prompt pass: returns (last-token logits [B,V], decode cache).
    max_len overrides cfg.max_seq_len for the cache size.  With
    `use_flash` every attention layer goes through the flash kernel; Mamba
    and RWKV6 layers always go through their kernel wrappers.  With
    `DTensor` parameters (and tokens placed by `batch_sharding`, or whole)
    the pass runs on their mesh: the logits of the rank's rows, and a
    cache of `DTensor`s placed by `cache_shardings`."""
    if max_len is not None and max_len != cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=max_len)
    mesh = mesh_of(params)
    if mesh is None:
        return _prefill(params, tokens, cfg, use_flash, dtype)
    dims = _row_dims(tokens) if isinstance(tokens, DTensor) else []
    with pspec.set_mesh(mesh, dims):
        logits, caches = _prefill(SH.layer_views(params), SH.local(tokens),
                                  cfg, use_flash, dtype)
    return logits, _placed_caches(cfg, mesh, caches, tokens.shape[0])


def _prefill(params, tokens, cfg, use_flash, dtype):
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg, dtype)
    x, _, caches = _stage_scan(params, x, cfg, positions, None, "prefill",
                               use_flash)
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos, cfg: ModelConfig, dtype=torch.bfloat16):
    """One decode step: tokens [B,1] at absolute position `pos` (an int
    or a 0-d integer tensor).  Returns (logits [B,V], cache), the cache
    updated in place.  With `DTensor` parameters the step runs on their
    mesh, on a cache placed by `cache_shardings` (of its own length,
    which replaces `cfg.max_seq_len`): the logits of the rank's rows."""
    mesh = mesh_of(params)
    if mesh is None:
        return _decode(params, cache, tokens, pos, cfg, dtype), cache
    lens = [c[n].shape[2] for c in cache.values() for n in ("k", "v")
            if n in c]
    if lens:
        cfg = dataclasses.replace(cfg, max_seq_len=max(lens))
    dims = _row_dims(tokens) if isinstance(tokens, DTensor) else []
    with pspec.set_mesh(mesh, dims):
        logits = _decode(SH.layer_views(params),
                         SH.tree_map(SH.local, cache), SH.local(tokens),
                         SH.local(pos), cfg, dtype)
    return logits, cache


def _decode(params, cache, tokens, pos, cfg, dtype):
    b = tokens.shape[0]
    if isinstance(pos, torch.Tensor):
        positions = pos.to(tokens.device, torch.long).reshape(1, 1)
    else:                   # a fill on the device: no host-to-device copy
        positions = torch.full((1, 1), int(pos), dtype=torch.long,
                               device=tokens.device)
    positions = positions.expand(b, 1)
    x = _embed(params, tokens, cfg, dtype)
    x, _, cache = _stage_scan(params, x, cfg, positions, cache, "decode",
                              False)
    return _logits(params, x, cfg)[:, 0]

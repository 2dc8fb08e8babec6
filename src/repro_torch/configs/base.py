"""ModelConfig — one flexible decoder-LM config covering the ten
architectures of the reference (dense / MoE / SSM / hybrid / audio / VLM
backbones); the port's own copy of `repro.configs.base`, pure Python.

The model is expressed as a sequence of *stages*; each stage is a
homogeneous group of layers repeated R times over stacked parameters
(leaves [R, ...]).  Heterogeneous archs (gemma3's 5 local:1 global,
jamba's 7 mamba:1 attn with alternating MoE) use a *group* of distinct
layers as the repeated body.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

LayerKind = Literal["attn", "attn_local", "mamba", "rwkv6"]
FFNKind = Literal["dense", "moe", "moe_dense"]   # moe_dense = MoE + parallel dense residual (arctic)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a repeated group: mixer + FFN kind."""

    mixer: LayerKind = "attn"
    ffn: FFNKind = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None         # default d_model // n_heads
    qkv_bias: bool = False            # qwen2.5
    qk_norm: bool = False             # chameleon
    rope_theta: float = 1e4

    # sliding-window pattern (gemma3): window size + one global layer
    # every `global_every` layers (pattern repeats)
    sliding_window: int | None = None
    global_every: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int | None = None        # expert FFN width (defaults d_ff)
    dense_residual: bool = False      # arctic: dense FFN in parallel
    moe_every: int = 1                # jamba: MoE on every 2nd layer

    # SSM
    ssm_kind: str | None = None       # 'rwkv6' | 'mamba'
    d_state: int = 16                 # mamba state dim
    d_conv: int = 4                   # mamba conv width
    expand: int = 2                   # mamba inner expansion
    attn_every: int = 0               # jamba: 1 attn layer per `attn_every`

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ----- execution knobs -----
    attn_impl: str = "einsum"     # 'einsum' | 'online' (k-block streaming)
    attn_dtype: str = "f32"       # 'f32' | 'bf16' score/prob storage
    seq_parallel: bool = False    # shard residual stream seq over 'model'
    mamba_unroll: int = 1         # scan unroll: carry stays in registers

    # ----- serving / shapes -----
    max_seq_len: int = 131072

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # ------------------------------------------------------------- structure
    def stages(self) -> list[tuple[tuple[LayerSpec, ...], int]]:
        """[(group_layer_specs, repeats)] covering all n_layers."""
        group = self.group_spec()
        g = len(group)
        assert self.n_layers % g == 0, (self.name, self.n_layers, g)
        return [(group, self.n_layers // g)]

    def group_spec(self) -> tuple[LayerSpec, ...]:
        """The repeating layer group."""
        def ffn_kind(i: int) -> FFNKind:
            if self.n_experts == 0:
                return "dense"
            if (i + 1) % self.moe_every != 0:
                return "dense"
            return "moe_dense" if self.dense_residual else "moe"

        if self.attn_every:                      # hybrid (jamba)
            kinds = []
            for i in range(self.attn_every):
                mixer = "attn" if i == self.attn_every // 2 else "mamba"
                kinds.append(LayerSpec(mixer, ffn_kind(i)))
            return tuple(kinds)
        if self.ssm_kind == "rwkv6":
            return (LayerSpec("rwkv6", ffn_kind(0)),)
        if self.sliding_window and self.global_every:
            kinds = []
            for i in range(self.global_every):
                mixer = "attn" if i == self.global_every - 1 else "attn_local"
                kinds.append(LayerSpec(mixer, ffn_kind(i)))
            return tuple(kinds)
        if self.n_experts and self.moe_every > 1:
            return tuple(LayerSpec("attn", ffn_kind(i))
                         for i in range(self.moe_every))
        return (LayerSpec("attn", ffn_kind(0)),)

    # ------------------------------------------------------------ accounting
    @property
    def head_dim(self) -> int:
        return self.d_head  # type: ignore[return-value]

    def param_count(self) -> int:
        """Total parameters (embedding + per-layer), exact per family."""
        d, dh = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb + d  # final norm
        for spec in self.group_spec():
            n_rep = self.n_layers // len(self.group_spec())
            p = d  # pre-norm
            if spec.mixer in ("attn", "attn_local"):
                qkv = d * dh * (self.n_heads + 2 * self.n_kv_heads)
                if self.qkv_bias:
                    qkv += dh * (self.n_heads + 2 * self.n_kv_heads)
                p += qkv + self.n_heads * dh * d
            elif spec.mixer == "mamba":
                di = self.expand * d
                p += (2 * d * di                      # in_proj (x, z)
                      + di * self.d_conv               # depthwise conv
                      + di * (2 * self.d_state + 1)    # B, C, dt proj (rank 1)
                      + di * self.d_state              # A
                      + di + di * d)                   # D + out_proj
            elif spec.mixer == "rwkv6":
                p += 6 * d * d + 8 * d                 # r,k,v,g,o,w + mixes
            p += d  # post-mixer norm
            if spec.ffn == "dense":
                p += 3 * d * self.d_ff
            else:
                dff = self.moe_dff or self.d_ff
                p += self.n_experts * 3 * d * dff + d * self.n_experts
                if spec.ffn == "moe_dense":
                    p += 3 * d * self.d_ff
            total += p * n_rep
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        dff = self.moe_dff or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * dff
        n_moe_layers = sum(
            1 for i, s in enumerate(self.group_spec()) if s.ffn != "dense"
        ) * (self.n_layers // len(self.group_spec()))
        return self.param_count() - inactive * n_moe_layers

    def flops_per_token(self, seq_len: int) -> float:
        """FORWARD flops per token: 2*N_active + attention score/value
        contractions (4*H*dh per attended position).  Training steps are
        3x this (fwd + 2x bwd)."""
        base = 2 * self.active_param_count()
        win = self.sliding_window or seq_len
        eff = 0.0
        for s in self.group_spec():
            if s.mixer == "attn":
                eff += min(seq_len, self.max_seq_len) / 2   # causal avg
            elif s.mixer == "attn_local":
                eff += min(win, seq_len)
        eff *= self.n_layers / len(self.group_spec())
        return base + 4 * self.n_heads * self.head_dim * eff

    def validate(self):
        assert self.n_heads % self.n_kv_heads == 0
        g = len(self.group_spec())
        assert self.n_layers % g == 0
        return self


def reduced(cfg: ModelConfig, n_layers: int | None = None,
            d_model: int = 128, n_heads: int = 4, d_ff: int = 256,
            vocab: int = 512, n_experts: int | None = None) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving the family
    structure (group pattern, MoE top-k, SSM kind, windowing)."""
    g = len(cfg.group_spec())
    nl = n_layers or (2 * g if cfg.attn_every or cfg.global_every else 2)
    nl = max(nl - nl % g, g)
    kv = max(1, min(cfg.n_kv_heads, n_heads // max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))))
    ne = cfg.n_experts and (n_experts if n_experts is not None
                            else min(cfg.n_experts, 8))
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=nl, d_model=d_model,
        n_heads=n_heads, n_kv_heads=max(1, min(kv, n_heads)),
        d_head=d_model // n_heads, d_ff=d_ff,
        moe_dff=(d_ff if cfg.moe_dff else None),
        vocab_size=vocab, n_experts=ne or 0,
        top_k=min(cfg.top_k, ne or 0),
        sliding_window=(64 if cfg.sliding_window else None),
        d_state=8, expand=2, max_seq_len=4096,
    )

"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2 — Mamba:attn 7:1 interleave, MoE every other
layer.  [arXiv:2403.19887]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, d_head=128,
    n_experts=16, top_k=2, moe_dff=24576, moe_every=2,
    ssm_kind="mamba", attn_every=8, d_state=16, d_conv=4, expand=2,
    rope_theta=1e6, max_seq_len=1048576,
).validate()

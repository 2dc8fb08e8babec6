"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, d_head=128,
    n_experts=128, top_k=2, moe_dff=4864, dense_residual=True,
    rope_theta=1e6,
).validate()

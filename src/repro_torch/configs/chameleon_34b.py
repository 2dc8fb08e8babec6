"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens in a shared vocabulary;
the VQ tokenizer frontend is a STUB (token ids arrive pre-quantised).
Uses qk-norm as in the paper.  [arXiv:2405.09818]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, d_head=128,
    qk_norm=True, rope_theta=1e4,
).validate()

"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — Finch, data-dependent decay.  [arXiv:2404.05892]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,  # wkv heads (d_head=64)
    d_ff=8960, vocab_size=65536, d_head=64,
    ssm_kind="rwkv6", max_seq_len=1048576,
).validate()

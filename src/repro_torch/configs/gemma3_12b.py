"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-12b-pt]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab_size=262144, d_head=256,
    sliding_window=1024, global_every=6,      # 5 local : 1 global
    rope_theta=1e6, max_seq_len=524288,
).validate()

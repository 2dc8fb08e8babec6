"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only backbone over EnCodec tokens; the EnCodec
frontend is a STUB: `input_specs()` provides precomputed frame
embeddings / token ids.  [arXiv:2306.05284]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, d_head=64,
    rope_theta=1e4,
).validate()

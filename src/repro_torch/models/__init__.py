"""Decoder-LM layers and assembly of the port (`repro.models`):
attention, RMSNorm, RoPE, SwiGLU and the transformer entry points."""

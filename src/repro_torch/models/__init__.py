"""Decoder-LM layers and assembly of the port (`repro.models`):
attention, RMSNorm, RoPE, SwiGLU, the RWKV6 and Mamba mixers, the MoE
FFN and the transformer entry points."""

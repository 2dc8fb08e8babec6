"""Kernel 4: causal GQA flash attention with an optional sliding window
(`flash_attention.cu`), its plain version (`ref.py`) and wrapper
(`ops.py`)."""

"""Kernel 6: the Mamba selective scan (`mamba_scan.cu`) and its
backward (`mamba_scan_bwd.cu`), their plain versions (`ref.py`) and
wrappers (`ops.py`)."""

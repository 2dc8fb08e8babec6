"""Kernel 6: the Mamba selective scan (`mamba_scan.cu`), its plain
version (`ref.py`) and wrapper (`ops.py`)."""

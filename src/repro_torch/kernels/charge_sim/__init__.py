"""Kernel 1: the dense (cells x combos) margin grid (`margin_grid.cu`),
its plain version (`ref.py`) and wrapper (`ops.py`)."""

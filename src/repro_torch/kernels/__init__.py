"""Hand-written CUDA kernels of the port, each beside its plain
PyTorch version (`ref.py`) and its wrapper (`ops.py`)."""

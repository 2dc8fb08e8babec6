"""PyTorch/CUDA port of the AL-DRAM reproduction (`repro`).

The package mirrors the JAX reference module for module
(`repro_torch.core.*`, `repro_torch.kernels.<name>.*`) and runs the
paper's main path on an NVIDIA Hopper card: sample a module population,
profile it in one fused margin sweep, build per-temperature timing
tables, check the zero-error invariant, and replay the workload pool
for the Fig. 4 speedups.  Two hand-written CUDA kernels carry it:
`kernels/charge_sim/margin_grid.cu` and `kernels/replay/replay.cu`.

Every entry point takes an explicit `device` (default "cuda"); without
a card the default raises instead of falling back to the CPU.  Pass
`device="cpu"` to run the plain PyTorch versions of the kernels.
"""

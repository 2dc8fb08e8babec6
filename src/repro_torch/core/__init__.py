"""The AL-DRAM system on PyTorch: timing, charge physics, population
sampling, profiling sweeps, timing tables and the trace-replay
simulator (counterpart of `repro.core`)."""

"""Kernel 2: batched trace replay (`replay.cu`), its plain version
(`ref.py`, over `repro_torch.core.dram_sim.replay_cells`) and wrapper
(`ops.py`)."""

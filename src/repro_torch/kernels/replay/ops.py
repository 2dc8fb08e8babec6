"""Wrappers of the replay kernel.

`replay_grid` keeps the reference's campaign contract
(`repro.kernels.replay.ops.replay_grid`): [T, P, N] request streams,
a [T, N] valid mask, [S, 6] timing rows and [P] closed-page flags in;
(lat [T, P, S, N], total [T, P, S]) out.  It flattens the (trace x
policy) axes into kernel cells and calls `replay_blocks`.

`replay_blocks` launches the CUDA kernel for CUDA tensors and runs the
plain version (`dram_sim.replay_cells`) for CPU tensors — chosen by the
tensors' device alone; a CUDA tensor never falls back.  Only the
module-row variant is ported: per-bank [S, banks, 6] timings, regions,
channels and faults raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dram_sim import check_prefix_valid, replay_cells
from repro_torch.kernels import build
from repro_torch.kernels.replay import ref


def _lib() -> ctypes.CDLL:
    lib = build.load("replay_blocks")
    lib.replay_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.replay_launch.restype = ctypes.c_int
    return lib


def replay_blocks(closed, arrival, bank, row, is_write, valid, timings_t,
                  n_banks: int = 8, mlp_window: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """closed [G] float32 (1 = closed page); arrival [G, N] float32;
    bank/row/is_write/valid [G, N] int32; timings_t [6, S] float32 ->
    (lat [G, N, S], total [G, S]).  CUDA tensors launch the kernel
    (counted in `replay_blocks.launches`); CPU tensors run
    `dram_sim.replay_cells`."""
    ins = (closed, arrival, bank, row, is_write, valid, timings_t)
    if all(x.device.type == "cpu" for x in ins):
        return replay_cells(arrival, bank, row, is_write.bool(),
                            valid.bool(), timings_t.T, closed > 0.5,
                            n_banks, mlp_window)
    dev = arrival.device
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError("replay_blocks: all inputs must be on one CUDA "
                         f"device, got {[str(x.device) for x in ins]}")
    g, n = arrival.shape
    expect = {"closed": (closed, torch.float32, (g,)),
              "arrival": (arrival, torch.float32, (g, n)),
              "bank": (bank, torch.int32, (g, n)),
              "row": (row, torch.int32, (g, n)),
              "is_write": (is_write, torch.int32, (g, n)),
              "valid": (valid, torch.int32, (g, n))}
    for name, (x, dtype, shape) in expect.items():
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"replay_blocks: {name} must be contiguous "
                             f"{dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if timings_t.dtype != torch.float32 or timings_t.dim() != 2 \
            or timings_t.shape[0] != 6 or not timings_t.is_contiguous():
        raise ValueError("replay_blocks: timings_t must be contiguous "
                         f"float32 [6, S], got {timings_t.dtype} "
                         f"{tuple(timings_t.shape)}")
    s = timings_t.shape[1]
    lat = torch.empty((g, n, s), dtype=torch.float32, device=dev)
    total = torch.empty((g, s), dtype=torch.float32, device=dev)
    if g == 0 or n == 0 or s == 0:
        return lat, total.zero_()
    if int(bank.min()) < 0 or int(bank.max()) >= n_banks:
        raise ValueError(f"replay_blocks: bank ids outside [0, {n_banks})")
    check_prefix_valid(valid, "replay_blocks")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().replay_launch(
            closed.data_ptr(), arrival.data_ptr(), bank.data_ptr(),
            row.data_ptr(), is_write.data_ptr(), valid.data_ptr(),
            timings_t.data_ptr(), lat.data_ptr(), total.data_ptr(),
            g, n, s, n_banks, mlp_window, stream)
    if rc != 0:
        raise RuntimeError(f"replay_blocks launch failed: cudaError {rc} "
                           f"(G={g}, N={n}, S={s})")
    replay_blocks.launches += 1
    return lat, total


replay_blocks.launches = 0


def replay_grid(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N] (prefix-true);
    timings [S, 6]; closed [P] bool -> (latency [T, P, S, N], total
    [T, P, S]), on the device of `arrival`."""
    if timings.dim() != 2:
        raise NotImplementedError(
            "per-bank / per-region timing stacks are not ported yet: "
            "ROADMAP queue B item 2(b)/(c)")
    check_prefix_valid(valid, "replay_grid")
    t, p, _ = arrival.shape
    cells = ref.to_cells(arrival, bank, row, is_write, valid, closed)
    timings_t = torch.as_tensor(timings, dtype=torch.float32,
                                device=arrival.device).T.contiguous()
    lat, total = replay_blocks(*cells, timings_t, n_banks, mlp_window)
    return ref.from_cells(lat, total, t, p)

"""Plain PyTorch version of the replay kernel under the campaign
contract: `repro_torch.core.dram_sim.replay_cells` over the flattened
(trace x policy) cells.  The CPU path of `ops` and the yardstick the
kernel is held to on the card."""

from __future__ import annotations

import torch

from repro_torch.core.dram_sim import replay_cells


def to_cells(arrival, bank, row, is_write, valid, closed):
    """[T, P, N] streams, [T, N] valid, [P] closed -> the kernel's
    flattened G = T*P cell layout: closed [G] float32, arrival [G, N]
    float32, bank/row/is_write/valid [G, N] int32 (contiguous)."""
    t, p, n = arrival.shape
    dev = arrival.device

    def cells(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype).reshape(
            t * p, n).contiguous()

    valid = torch.as_tensor(valid, device=dev).bool()
    closed = torch.as_tensor(closed, device=dev).bool()
    return (closed[None, :].expand(t, p).reshape(t * p).to(torch.float32),
            cells(arrival, torch.float32), cells(bank, torch.int32),
            cells(row, torch.int32), cells(is_write, torch.int32),
            valid[:, None, :].expand(t, p, n).reshape(t * p, n)
            .to(torch.int32))


def from_cells(lat, total, t: int, p: int):
    """Kernel layout (lat [G, N, S], total [G, S]) -> the campaign
    contract (lat [T, P, S, N], total [T, P, S])."""
    g, n, s = lat.shape
    return (lat.reshape(t, p, n, s).permute(0, 1, 3, 2),
            total.reshape(t, p, s))


def replay_grid(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N]; timings
    [S, 6]; closed [P] bool -> (latency [T, P, S, N], total [T, P, S])."""
    t, p, _ = arrival.shape
    closed_c, arr, bk, rw, wr, val = to_cells(arrival, bank, row, is_write,
                                              valid, closed)
    lat, total = replay_cells(arr, bk, rw, wr, val,
                              torch.as_tensor(timings, device=arr.device),
                              closed_c > 0.5, n_banks, mlp_window)
    return from_cells(lat, total, t, p)

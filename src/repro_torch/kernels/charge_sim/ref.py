"""Plain PyTorch version of the `margin_grid` kernel: the margin math of
`repro_torch.core.charge` evaluated densely under the kernel's own
contract, on whatever device the inputs live.  The CPU path of `ops`
and the yardstick the kernel is held to on the card.

The grid is evaluated in row chunks of at most `MAX_CHUNK_ELEMS`
elements, so the eager intermediates stay bounded (the full profiling
campaign is 1.5e9 elements: its outputs alone are 12 GB, and one eager
intermediate over the whole grid would be another 6 GB)."""

from __future__ import annotations

import torch

from repro_torch.core import charge

MAX_CHUNK_ELEMS = 1 << 25


def margin_grid(cells_t: torch.Tensor, combos_t: torch.Tensor,
                constants: charge.ChargeConstants = charge.DEFAULT_CONSTANTS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cells_t [7, n] (tau_r, xfer, tau_ret85, tau_p, tau_w, read and
    write tREFI overrides, <= 0 = use the combo's), combos_t [6, m]
    (trcd, tras, twr, trp, trefi, temp_c) -> (read, write) margins
    [n, m]."""
    n, m = cells_t.shape[1], combos_t.shape[1]
    cm = combos_t[:5].T[None, :, :]                          # [1, m, 5]
    temps = combos_t[5][None, :]                             # [1, m]
    read = torch.empty((n, m), dtype=torch.float32, device=cells_t.device)
    write = torch.empty_like(read)
    step = max(1, MAX_CHUNK_ELEMS // m)
    for lo in range(0, n, step):
        sl = slice(lo, min(lo + step, n))
        cell = charge.CellParams(*(cells_t[k, sl][:, None] for k in range(5)))
        ovr_r, ovr_w = cells_t[5, sl][:, None], cells_t[6, sl][:, None]
        tr = torch.where(ovr_r > 0.0, ovr_r, cm[..., 4])
        tw = torch.where(ovr_w > 0.0, ovr_w, cm[..., 4])
        read[sl] = charge.read_margin(cell, cm, temps, constants, tr)
        write[sl] = charge.write_margin(cell, cm, temps, constants, tw)
    return read, write

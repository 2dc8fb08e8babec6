"""Wrappers of the `margin_grid` kernel.

`margin_sweep` is the entry point the profiling front end
(`repro_torch.core.sweep.MarginEngine`) calls: a dense (cells x combos)
margin grid with a per-combo temperature column and per-cell, per-op
refresh-interval overrides, so a whole multi-temperature read+write
campaign is ONE launch.  It transposes the small parameter vectors into
the kernel's [7, n] / [6, m] layout and calls `margin_grid`.

`margin_grid` launches the CUDA kernel for CUDA tensors and runs the
plain version (`ref.margin_grid`) for CPU tensors — chosen by the
tensors' device alone; a CUDA tensor never falls back.  The kernel
masks its ragged edge, so nothing is padded: every element of the real
[n, m] grid equals what the reference's padded launch computes there.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.charge import ChargeConstants, DEFAULT_CONSTANTS
from repro_torch.kernels import build
from repro_torch.kernels.charge_sim import ref

# transcendental calls (expf/logf) per grid element: 3 before the fixed
# point, 2 per iteration, 1 after it, 3 in the write margin
TRANSCENDENTALS_PER_ELEM = 3 + 2 * 8 + 1 + 3


def _lib() -> ctypes.CDLL:
    lib = build.load("margin_grid")
    lib.margin_grid_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.margin_grid_launch.restype = ctypes.c_int
    return lib


def pack_inputs(cells: torch.Tensor, combos: torch.Tensor,
                temps_combo: torch.Tensor,
                trefi_read_cells: torch.Tensor | None = None,
                trefi_write_cells: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cells [n, 5], combos [m, 5], temps [m], optional [n] overrides
    -> the kernel's (cells_t [7, n], combos_t [6, m]) float32 layout
    (a missing override becomes -1: use the combo's tREFI)."""
    dev = cells.device
    n = cells.shape[0]

    def ovr(x):
        if x is None:
            return torch.full((n,), -1.0, dtype=torch.float32, device=dev)
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(n)

    cells_t = torch.cat([cells.to(torch.float32).T,
                         ovr(trefi_read_cells)[None],
                         ovr(trefi_write_cells)[None]], 0).contiguous()
    temps = torch.as_tensor(temps_combo, dtype=torch.float32,
                            device=dev).reshape(-1, 1)
    combos_t = torch.cat([combos.to(device=dev, dtype=torch.float32),
                          temps], 1).T.contiguous()
    return cells_t, combos_t


def margin_grid(cells_t: torch.Tensor, combos_t: torch.Tensor,
                constants: ChargeConstants = DEFAULT_CONSTANTS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cells_t [7, n], combos_t [6, m] float32 -> (read, write) margins
    [n, m].  CUDA tensors launch the kernel (counted in
    `margin_grid.launches`); CPU tensors run `ref.margin_grid`."""
    if cells_t.device.type == "cpu" and combos_t.device.type == "cpu":
        return ref.margin_grid(cells_t, combos_t, constants)
    if cells_t.device != combos_t.device or cells_t.device.type != "cuda":
        raise ValueError(f"margin_grid: inputs on {cells_t.device} and "
                         f"{combos_t.device}; need one CUDA device")
    for name, x, rows in (("cells_t", cells_t, 7), ("combos_t", combos_t, 6)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != rows \
                or not x.is_contiguous():
            raise ValueError(f"margin_grid: {name} must be a contiguous "
                             f"float32 [{rows}, k] tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
    n, m = cells_t.shape[1], combos_t.shape[1]
    read = torch.empty((n, m), dtype=torch.float32, device=cells_t.device)
    write = torch.empty_like(read)
    if n == 0 or m == 0:
        return read, write
    consts = (ctypes.c_float * 14)(*constants.as_tuple())
    with torch.cuda.device(cells_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().margin_grid_launch(
            cells_t.data_ptr(), combos_t.data_ptr(), read.data_ptr(),
            write.data_ptr(), n, m, consts, stream)
    if rc != 0:
        raise RuntimeError(f"margin_grid launch failed: cudaError {rc} "
                           f"(n={n}, m={m})")
    margin_grid.launches += 1
    return read, write


margin_grid.launches = 0


def margin_sweep(cells: torch.Tensor, combos: torch.Tensor,
                 temps_combo: torch.Tensor,
                 constants: ChargeConstants = DEFAULT_CONSTANTS,
                 trefi_read_cells: torch.Tensor | None = None,
                 trefi_write_cells: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cells [n, 5]; combos [m, 5]; temps_combo [m] per-combo test
    temperature; optional [n] per-cell read / write tREFI overrides ->
    (read, write) margins [n, m] in ONE `margin_grid` call, on the
    device of `cells`."""
    return margin_grid(*pack_inputs(cells, combos, temps_combo,
                                    trefi_read_cells, trefi_write_cells),
                       constants)


def combo_margins(cells: torch.Tensor, combos: torch.Tensor, temp_c: float,
                  constants: ChargeConstants = DEFAULT_CONSTANTS,
                  trefi_cells: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-temperature shim over `margin_sweep`."""
    temps = torch.full((combos.shape[0],), float(temp_c),
                       dtype=torch.float32, device=cells.device)
    return margin_sweep(cells, combos, temps, constants,
                        trefi_cells, trefi_cells)


def margin_grid_flops(n_cells: int, n_combos: int) -> int:
    """Approximate float32 operations of one margin grid (the
    reference's count: 30 per fixed-point iteration + 80)."""
    return int(n_cells) * int(n_combos) * (30 * 8 + 80)

"""Wrappers of the `margin_grid` kernel.

`margin_sweep` is the entry point the profiling front end
(`repro_torch.core.sweep.MarginEngine`) calls: a dense (cells x combos)
margin grid with a per-combo temperature column and per-cell, per-op
refresh-interval overrides, so a whole multi-temperature read+write
campaign is ONE launch.  It transposes the small parameter vectors into
the kernel's [7, n] / [6, m] layout and calls `margin_grid`.

`margin_grid` launches the CUDA kernel for CUDA tensors and runs the
plain version (`ref.margin_grid`) for CPU tensors — chosen by the
tensors' device alone; a CUDA tensor never falls back.  Before the
launch it factors the columns into their distinct read keys (tras, trp,
trefi, temp_c) and write keys (twr, trp, trefi, temp_c) (`key_groups`),
so the kernel runs one fixed point per (cell, read key) and one write
evaluation per (cell, write key), then streams the [n, m] outputs.  A
grid below `SEARCH_MIN_ELEMS` elements goes to the per-element kernel
instead (`launch`), which computes the same values bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.charge import ChargeConstants, DEFAULT_CONSTANTS
from repro_torch.kernels import build
from repro_torch.kernels.charge_sim import ref

# transcendental calls (expf/logf) per grid element: 3 before the fixed
# point, 2 per iteration, 1 after it, 3 in the write margin
TRANSCENDENTALS_PER_ELEM = 3 + 2 * 8 + 1 + 3
# float32 operations (each +, -, *, /, min, max, select, expf or logf one)
# the kernel needs per (cell, read key), per (cell, write key) and per
# element, counted from margin_grid.cu
OPS_PER_READ_KEY = 20 + 25 * 8 + 20
OPS_PER_WRITE_KEY = 54
OPS_PER_ELEM = 5
# below this many grid elements the host key search (about 1 ms a call
# beside an H100, with its device round trip) costs more than the fixed
# points it saves, and the per-element kernel takes the grid
SEARCH_MIN_ELEMS = 1 << 25


def _lib() -> ctypes.CDLL:
    lib = build.load("margin_grid")
    lib.margin_grid_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.margin_grid_launch.restype = ctypes.c_int
    lib.margin_grid_elem_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p]
    lib.margin_grid_elem_launch.restype = ctypes.c_int
    lib.margin_grid_group_bytes.restype = ctypes.c_int
    return lib


def _distinct(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """rows [4, m] float32 -> (keys [4, K], index [m] int32): the distinct
    columns, compared bit for bit and sorted by row 0, then row 1, ...
    (so with the most slowly varying row first, neighbouring columns get
    neighbouring keys), and each column's key."""
    bits = np.ascontiguousarray(rows, np.float32).view(np.int32)
    order = np.lexsort(bits[::-1])              # row 0 the primary key
    srt = bits[:, order]
    new = np.ones(srt.shape[1], bool)
    new[1:] = (srt[:, 1:] != srt[:, :-1]).any(axis=0)
    index = np.empty(srt.shape[1], np.int32)
    index[order] = np.cumsum(new) - 1
    return srt[:, new].view(np.float32), index


def combo_keys(combos: np.ndarray):
    """combos [6, m] float32 (trcd, tras, twr, trp, trefi, temp_c) ->
    (read keys [4, KR] (tras, trp, trefi, temp_c), write keys [4, KW]
    (twr, trp, trefi, temp_c), each column's read key and write key [m]
    int32), on the host."""
    # sort the keys by temp_c, trefi, then the swept timings (the
    # campaign's column order), then put the rows back in kernel order
    back = [2, 3, 1, 0]
    rkeys, r_idx = _distinct(combos[[5, 4, 1, 3]])
    wkeys, w_idx = _distinct(combos[[5, 4, 2, 3]])
    return rkeys[back], wkeys[back], r_idx, w_idx


class KeyGroups(NamedTuple):
    """The kernel's column factorisation: the columns cut into contiguous
    groups, each with its own distinct keys."""
    rkeys: torch.Tensor      # [4, KR] float32, every group's read keys
    wkeys: torch.Tensor      # [4, KW] float32, every group's write keys
    col_keys: torch.Tensor   # [m] int32: read key | write key << 16,
    #                          local to the column's group
    groups: torch.Tensor     # [G, 6] int32: col0, col1, first read key,
    #                          read keys, first write key, write keys
    n_groups: int
    max_keys: int            # max over groups of 2 KR_g + 3 KW_g floats


def key_groups(combos_t: torch.Tensor, max_bytes: int) -> KeyGroups:
    """Factor combos_t's columns into distinct read and write keys
    (`combo_keys`, on the host: `torch.unique` on the card is slow the
    first time a process calls it), cut into as few equal contiguous
    column groups as keep each group's tables (2 floats per read key, 3
    per write key) within `max_bytes`: one group for every campaign grid,
    more only for many distinct keys (e.g. random combos).  The tables
    go back to combos_t's device in one copy."""
    m = combos_t.shape[1]
    combos = combos_t.detach().cpu().numpy()
    g = 1
    while True:
        cuts = [m * i // g for i in range(g + 1)]
        parts = [combo_keys(combos[:, a:b]) for a, b in zip(cuts, cuts[1:])]
        floats = [2 * p[0].shape[1] + 3 * p[1].shape[1] for p in parts]
        if 4 * max(floats) <= max_bytes:
            break
        g = max(g + 1, -(-g * 4 * max(floats) // max_bytes))
    rows, kr0, kw0 = [], 0, 0
    for a, b, (rk, wk, _, _) in zip(cuts, cuts[1:], parts):
        rows.append([a, b, kr0, rk.shape[1], kw0, wk.shape[1]])
        kr0 += rk.shape[1]
        kw0 += wk.shape[1]
    rkeys = np.concatenate([p[0] for p in parts], 1)
    wkeys = np.concatenate([p[1] for p in parts], 1)
    col_keys = np.concatenate([p[2] | (p[3] << 16) for p in parts])
    flat = torch.from_numpy(np.concatenate([
        rkeys.view(np.int32).ravel(), wkeys.view(np.int32).ravel(),
        col_keys, np.asarray(rows, np.int32).ravel()])).to(combos_t.device)
    cut = [int(c) for c in np.cumsum([rkeys.size, wkeys.size, m])]
    return KeyGroups(flat[:cut[0]].view(torch.float32).view(4, kr0),
                     flat[cut[0]:cut[1]].view(torch.float32).view(4, kw0),
                     flat[cut[1]:cut[2]], flat[cut[2]:].view(g, 6), g,
                     max(floats))


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
    launch(cells_t, combos_t, constants, read, write,
           by_key=n * m >= SEARCH_MIN_ELEMS)
    margin_grid.launches += 1
    return read, write


margin_grid.launches = 0


def launch(cells_t: torch.Tensor, combos_t: torch.Tensor,
           constants: ChargeConstants, read: torch.Tensor,
           write: torch.Tensor, by_key: bool) -> None:
    """One launch into read / write [n, m] on checked CUDA inputs (n, m >
    0): the key kernel on the columns' factorisation (`by_key`) or the
    per-element kernel on combos_t itself.  `margin_grid` picks by size
    and counts the launch; this does not count."""
    n, m = cells_t.shape[1], combos_t.shape[1]
    consts = (ctypes.c_float * 14)(*constants.as_tuple())
    lib = _lib()
    with torch.cuda.device(cells_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        if by_key:
            kg = key_groups(combos_t, lib.margin_grid_group_bytes())
            rc = lib.margin_grid_launch(
                cells_t.data_ptr(), kg.rkeys.data_ptr(), kg.wkeys.data_ptr(),
                kg.col_keys.data_ptr(), combos_t.data_ptr(),
                kg.groups.data_ptr(), read.data_ptr(), write.data_ptr(), n, m,
                kg.rkeys.shape[1], kg.wkeys.shape[1], kg.n_groups,
                kg.max_keys, consts, stream)
        else:
            rc = lib.margin_grid_elem_launch(
                cells_t.data_ptr(), combos_t.data_ptr(), read.data_ptr(),
                write.data_ptr(), n, m, consts, stream)
    if rc != 0:
        raise RuntimeError(f"margin_grid launch failed: cudaError {rc} "
                           f"(n={n}, m={m}, by_key={by_key})")


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
    """Approximate float32 operations of one margin grid evaluated per
    element (the reference's count: 30 per fixed-point iteration + 80).
    What the kernel needs is `margin_grid_key_flops`."""
    return int(n_cells) * int(n_combos) * (30 * 8 + 80)


def margin_grid_key_flops(n_cells: int, n_rkeys: int, n_wkeys: int,
                          n_combos: int) -> int:
    """Float32 operations the factored grid needs: one fixed point per
    (cell, read key), one write evaluation per (cell, write key) and the
    final mins per element (`key_groups` gives the key counts)."""
    return int(n_cells) * (OPS_PER_READ_KEY * int(n_rkeys)
                           + OPS_PER_WRITE_KEY * int(n_wkeys)
                           + OPS_PER_ELEM * int(n_combos))

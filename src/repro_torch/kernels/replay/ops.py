"""Wrappers of the replay kernels.

`replay_grid` keeps the reference's campaign contract
(`repro.kernels.replay.ops.replay_grid`): [T, P, N] request streams,
a [T, N] valid mask, [S, 6] timing rows (or per-bank [S, banks, 6], or
the region store [S, U, 6] with a [banks * R] or [S, banks * R] index
map) and [P] closed-page flags in; (lat [T, P, S, N], total [T, P, S])
out.  It flattens the (trace x policy) axes into kernel cells and calls
`replay_blocks`.

`replay_grid_adaptive` keeps the reference's adaptive contract: table
stacks [K, S+1, 6] (or per-bank [K, S+1, banks, 6], or region-compressed
[K, S+1, U, 6] with a [banks * R] or [K, banks * R] index map; JEDEC row
last), bin edges [S], scenario rows [C, SCN_COLS] and the thermal-config
row [6]; the lane axis of `adaptive_blocks` carries the flattened
(table k, scenario c) pairs, l = k*C + c.

`replay_blocks` and `adaptive_blocks` launch the CUDA kernels for CUDA
tensors and run the plain versions (`dram_sim.replay_cells`,
`dram_sim.replay_adaptive_cells`) for CPU tensors — chosen by the
tensors' device alone; a CUDA tensor never falls back.  Module,
per-bank and region-compressed timing tiles are ported.

The region map's range is a property of the campaign: `SimSpec` checks
it once on the host and `SimEngine` launches with `validated=True`.  A
direct call without `validated` checks it, with the bank ids and the
rows, in one read of the device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dram_sim import (check_prefix_valid,
                                       replay_adaptive_cells, replay_cells)
from repro_torch.core.thermal import SCN_COLS
from repro_torch.kernels import build
from repro_torch.kernels.replay import ref

# heat registers per lane in adaptive.cu (`kMaxBanks`)
MAX_BANKS = 16


def _replay_lib() -> ctypes.CDLL:
    lib = build.load("replay_blocks")
    lib.replay_launch.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.replay_launch.restype = ctypes.c_int
    return lib


def _adaptive_lib() -> ctypes.CDLL:
    lib = build.load("adaptive_blocks")
    lib.adaptive_launch.argtypes = [ctypes.c_void_p] * 19 \
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.adaptive_launch.restype = ctypes.c_int
    return lib


def _on_cuda(name: str, tensors) -> torch.device | None:
    """None when every tensor lies on the CPU (run the plain version),
    else their one CUDA device; raise on a mix."""
    if all(x.device.type == "cpu" for x in tensors):
        return None
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(x.device) for x in tensors]}")
    return dev


def _check(name: str, x, dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")


def _check_streams(where: str, closed, arrival, bank, row, is_write,
                   valid) -> tuple[int, int]:
    if arrival.dim() != 2:
        raise ValueError(f"{where}: arrival must be [G, N], got "
                         f"{tuple(arrival.shape)}")
    g, n = arrival.shape
    _check(f"{where}: closed", closed, torch.float32, (g,))
    _check(f"{where}: arrival", arrival, torch.float32, (g, n))
    for nm, x in (("bank", bank), ("row", row), ("is_write", is_write),
                  ("valid", valid)):
        _check(f"{where}: {nm}", x, torch.int32, (g, n))
    return g, n


def check_data(where: str, bank, valid, n_banks: int, row=None,
               region_map=None, n_unique: int = 0) -> None:
    """The stream checks that read the data (and so wait for the device,
    once): bank ids within [0, n_banks), a prefix-true valid mask and,
    for a regioned launch (`row` and `region_map` given), non-negative
    rows and map entries within [0, n_unique)."""
    stats = [bank.min(), bank.max()]
    if row is not None:
        stats.append(row.min())
    if region_map is not None:
        stats += [region_map.min(), region_map.max()]
    vals = torch.stack([x.to(torch.int64) for x in stats]).tolist()
    if vals[0] < 0 or vals[1] >= n_banks:
        raise ValueError(f"{where}: bank ids outside [0, {n_banks})")
    if row is not None and vals[2] < 0:
        raise ValueError(f"{where}: negative row address")
    if region_map is not None and (vals[-2] < 0 or vals[-1] >= n_unique):
        raise ValueError(f"{where}: region_map entries outside "
                         f"[0, {n_unique}) (the unique-row store)")
    check_prefix_valid(valid, where)


def _check_map(where: str, region_map, n_banks: int, lanes: int) -> int:
    """Shape of a kernel-layout region map ([banks * R] or [banks * R,
    lanes] contiguous int32) -> R."""
    gm = region_map.shape[0] if region_map.dim() else 0
    if region_map.dtype != torch.int32 or not region_map.is_contiguous() \
            or region_map.dim() not in (1, 2) or gm == 0 \
            or gm % n_banks != 0 \
            or (region_map.dim() == 2 and region_map.shape[1] != lanes):
        raise ValueError(
            f"{where}: region_map must be contiguous int32 [{n_banks} * R] "
            f"or [{n_banks} * R, {lanes}], got {region_map.dtype} "
            f"{tuple(region_map.shape)}")
    return gm // n_banks


def replay_blocks(closed, arrival, bank, row, is_write, valid, timings_t,
                  n_banks: int = 8, mlp_window: int = 8,
                  validated: bool = False, region_map=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """closed [G] float32 (1 = closed page); arrival [G, N] float32;
    bank/row/is_write/valid [G, N] int32; timings_t [6, S] float32, the
    per-bank tile [n_banks, 6, S], or with `region_map` (int32 [banks *
    R] shared or [banks * R, S] per lane) the unique-row store
    [U, 6, S] -> (lat [G, N, S], total [G, S]).  CUDA tensors launch
    the kernel (counted in `replay_blocks.launches`, the per-bank tile
    also in `launches_banked`, the region store in `launches_regioned`);
    CPU tensors run `dram_sim.replay_cells`.  `validated=True` skips the
    data checks, which wait for the device (bank range, prefix mask and,
    regioned, row sign and map range): only for a caller that has
    checked these same inputs already."""
    regioned = region_map is not None
    ins = (closed, arrival, bank, row, is_write, valid, timings_t) \
        + ((region_map,) if regioned else ())
    dev = _on_cuda("replay_blocks", ins)
    banked = timings_t.dim() == 3
    if dev is None:
        tim = (timings_t.permute(2, 0, 1) if banked else timings_t.T)
        return replay_cells(arrival, bank, row, is_write.bool(),
                            valid.bool(), tim, closed > 0.5, n_banks,
                            mlp_window,
                            ref.lane_map(region_map) if regioned else None)
    g, n = _check_streams("replay_blocks", closed, arrival, bank, row,
                          is_write, valid)
    if timings_t.dtype != torch.float32 or not timings_t.is_contiguous() \
            or timings_t.dim() not in (2, 3) or timings_t.shape[-2] != 6 \
            or (banked and not regioned and timings_t.shape[0] != n_banks) \
            or (regioned and not banked):
        want = "[U, 6, S]" if regioned else f"[6, S] or [{n_banks}, 6, S]"
        raise ValueError("replay_blocks: timings_t must be contiguous "
                         f"float32 {want}, got {timings_t.dtype} "
                         f"{tuple(timings_t.shape)}")
    s = timings_t.shape[-1]
    n_regions = (_check_map("replay_blocks", region_map, n_banks, s)
                 if regioned else 0)
    lat = torch.empty((g, n, s), dtype=torch.float32, device=dev)
    total = torch.empty((g, s), dtype=torch.float32, device=dev)
    if g == 0 or n == 0 or s == 0:
        return lat, total.zero_()
    if not validated:
        check_data("replay_blocks", bank, valid, n_banks,
                   *((row, region_map, timings_t.shape[0]) if regioned
                     else ()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _replay_lib().replay_launch(
            closed.data_ptr(), arrival.data_ptr(), bank.data_ptr(),
            row.data_ptr(), is_write.data_ptr(), valid.data_ptr(),
            timings_t.data_ptr(),
            region_map.data_ptr() if regioned else None,
            lat.data_ptr(), total.data_ptr(), g, n, s, n_banks, mlp_window,
            int(banked), n_regions, int(regioned and region_map.dim() == 2),
            stream)
    if rc != 0:
        raise RuntimeError(f"replay_blocks launch failed: cudaError {rc} "
                           f"(G={g}, N={n}, S={s}, banked={banked}, "
                           f"regions={n_regions})")
    replay_blocks.launches += 1
    replay_blocks.launches_banked += int(banked and not regioned)
    replay_blocks.launches_regioned += int(regioned)
    return lat, total


replay_blocks.launches = 0
replay_blocks.launches_banked = 0
replay_blocks.launches_regioned = 0


def adaptive_blocks(closed, arrival, bank, row, is_write, valid, tables_t,
                    scn_t, bins, tcfg, n_banks: int = 8,
                    mlp_window: int = 8, emit_raw: bool = False,
                    validated: bool = False, region_map=None):
    """Closed-loop replay launch.  closed [G] float32; arrival [G, N]
    float32; bank/row/is_write/valid [G, N] int32; tables_t [S+1, 6, L]
    (lane l's table stack, JEDEC row last), the per-bank tile
    [n_banks, S+1, 6, L], or with `region_map` (int32 [banks * R]
    shared or [banks * R, L] per lane) the unique-column tile
    [U, S+1, 6, L]; scn_t [SCN_COLS, L] scenario rows per lane; bins
    [S] ascending edges; tcfg [6] `ThermalConfig.as_row`, all float32.

    Returns (lat [G, N, L], total [G, L], temp_max [G, L], temp_mean
    [G, L], bin_switches [G, L] int32, bank_heat [G, n_banks, L], temps
    [G, N, L] | None, bins [G, N, L] int32 | None): the raw sensed
    temperatures and selected bins only when `emit_raw`.  CUDA tensors
    launch the kernel (counted in `adaptive_blocks.launches`, the
    per-bank tile also in `launches_banked`, the region tile in
    `launches_regioned`); CPU tensors run
    `dram_sim.replay_adaptive_cells`.  `validated` as in
    `replay_blocks`."""
    regioned = region_map is not None
    ins = (closed, arrival, bank, row, is_write, valid, tables_t, scn_t,
           bins, tcfg) + ((region_map,) if regioned else ())
    dev = _on_cuda("adaptive_blocks", ins)
    banked = tables_t.dim() == 4
    if dev is None:
        lat, total, temps, sel, heat, diag = replay_adaptive_cells(
            arrival, bank, row, is_write.bool(), valid.bool(),
            ref.lane_stacks(tables_t), bins, scn_t.T, tcfg, closed > 0.5,
            n_banks, mlp_window,
            ref.lane_map(region_map) if regioned else None)
        return (lat, total, *diag, heat,
                temps if emit_raw else None, sel if emit_raw else None)
    g, n = _check_streams("adaptive_blocks", closed, arrival, bank, row,
                          is_write, valid)
    if bins.dim() != 1:
        raise ValueError(f"adaptive_blocks: bins must be [S], got "
                         f"{tuple(bins.shape)}")
    s = bins.shape[0]
    lanes = tables_t.shape[-1]
    if regioned and not banked:
        raise ValueError("adaptive_blocks: region_map needs the "
                         "[U, S+1, 6, L] unique-column tile")
    lead = tables_t.shape[0] if regioned else n_banks
    want = ((lead,) if banked else ()) + (s + 1, 6, lanes)
    if tuple(tables_t.shape) != want:
        raise ValueError(
            f"adaptive_blocks: tables_t must be {want} — {s} bin rows plus "
            f"the JEDEC row — got {tuple(tables_t.shape)}")
    _check("adaptive_blocks: tables_t", tables_t, torch.float32, want)
    _check("adaptive_blocks: scn_t", scn_t, torch.float32, (SCN_COLS, lanes))
    _check("adaptive_blocks: bins", bins, torch.float32, (s,))
    _check("adaptive_blocks: tcfg", tcfg, torch.float32, (6,))
    if not 1 <= n_banks <= MAX_BANKS:
        raise ValueError(f"adaptive_blocks: n_banks must lie in [1, "
                         f"{MAX_BANKS}], got {n_banks}")
    if g == 0 or n == 0 or lanes == 0:
        raise ValueError(f"adaptive_blocks: empty launch (G={g}, N={n}, "
                         f"L={lanes})")
    n_regions = (_check_map("adaptive_blocks", region_map, n_banks, lanes)
                 if regioned else 0)
    f32 = dict(dtype=torch.float32, device=dev)
    lat = torch.empty((g, n, lanes), **f32)
    total = torch.empty((g, lanes), **f32)
    tmax = torch.empty((g, lanes), **f32)
    tmean = torch.empty((g, lanes), **f32)
    sw = torch.empty((g, lanes), dtype=torch.int32, device=dev)
    heat = torch.empty((g, n_banks, lanes), **f32)
    temps = torch.empty((g, n, lanes), **f32) if emit_raw else None
    sel = (torch.empty((g, n, lanes), dtype=torch.int32, device=dev)
           if emit_raw else None)
    if not validated:
        check_data("adaptive_blocks", bank, valid, n_banks,
                   *((row, region_map, lead) if regioned else ()))
    # an empty edge set gets one +inf edge: `#edges < reading` stays 0
    edges = bins if s else torch.full((1,), torch.inf, **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _adaptive_lib().adaptive_launch(
            closed.data_ptr(), arrival.data_ptr(), bank.data_ptr(),
            row.data_ptr(), is_write.data_ptr(), valid.data_ptr(),
            tables_t.data_ptr(),
            region_map.data_ptr() if regioned else None,
            scn_t.data_ptr(), edges.data_ptr(),
            tcfg.data_ptr(), lat.data_ptr(), total.data_ptr(),
            tmax.data_ptr(), tmean.data_ptr(), sw.data_ptr(),
            heat.data_ptr(), temps.data_ptr() if emit_raw else None,
            sel.data_ptr() if emit_raw else None,
            g, n, lanes, edges.shape[0], s + 1, n_banks, mlp_window,
            int(banked), n_regions, int(regioned and region_map.dim() == 2),
            int(emit_raw), stream)
    if rc != 0:
        raise RuntimeError(f"adaptive_blocks launch failed: cudaError {rc} "
                           f"(G={g}, N={n}, L={lanes}, banked={banked}, "
                           f"regions={n_regions})")
    adaptive_blocks.launches += 1
    adaptive_blocks.launches_banked += int(banked and not regioned)
    adaptive_blocks.launches_regioned += int(regioned)
    return lat, total, tmax, tmean, sw, heat, temps, sel


adaptive_blocks.launches = 0
adaptive_blocks.launches_banked = 0
adaptive_blocks.launches_regioned = 0


def replay_grid(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8,
                validated: bool = False, region_map=None):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N] (prefix-true);
    timings [S, 6] or per-bank [S, n_banks, 6]; closed [P] bool ->
    (latency [T, P, S, N], total [T, P, S]), on the device of
    `arrival`.  With `region_map` ([banks * R] shared or [S, banks * R]
    per lane) `timings` is the [S, U, 6] unique-row store."""
    if timings.dim() not in (2, 3):
        raise ValueError(f"timings must be [S, 6] or [S, banks, 6], got "
                         f"{tuple(timings.shape)}")
    if region_map is not None and timings.dim() != 3:
        raise ValueError("region_map needs [S, U, 6] unique-row stores")
    if not validated:
        check_prefix_valid(valid, "replay_grid")
    t, p, _ = arrival.shape
    dev = arrival.device
    cells = ref.to_cells(arrival, bank, row, is_write, valid, closed)
    tile = ref.timing_tile(torch.as_tensor(timings, device=dev))
    lat, total = replay_blocks(
        *cells, tile, n_banks, mlp_window, validated=validated,
        region_map=(None if region_map is None
                    else ref.map_tile(region_map, dev)))
    return ref.from_cells(lat, total, t, p)


def replay_grid_adaptive(arrival, bank, row, is_write, valid, tables,
                         bins, scns, tcfg, closed, n_banks: int = 8,
                         mlp_window: int = 8, emit_raw: bool = False,
                         validated: bool = False, region_map=None):
    """Adaptive campaign: arrival/bank/row/is_write [T, P, N]; valid
    [T, N]; tables [K, S+1, 6] or per-bank [K, S+1, n_banks, 6] (JEDEC
    row last), or with `region_map` ([banks * R] shared or [K, banks *
    R] per stack) the unique-column stacks [K, S+1, U, 6]; bins [S];
    scns [C, SCN_COLS]; tcfg [6]; closed [P] ->
    (lat [T, P, K, C, N], total [T, P, K, C], temps | None, bins |
    None (both [T, P, K, C, N], only with `emit_raw`), bank_heat
    [T, P, K, C, n_banks], (temp_max, temp_mean, bin_switches) each
    [T, P, K, C], reduced inside the launch)."""
    dev = arrival.device
    tables = torch.as_tensor(tables, dtype=torch.float32, device=dev)
    scns = torch.as_tensor(scns, dtype=torch.float32, device=dev)
    if tables.dim() not in (3, 4):
        raise ValueError(f"tables must be [K, S+1, 6] or [K, S+1, banks, "
                         f"6], got {tuple(tables.shape)}")
    if region_map is not None and tables.dim() != 4:
        raise ValueError("region_map needs [K, S+1, U, 6] unique-column "
                         "stacks")
    if not validated:
        check_prefix_valid(valid, "replay_grid_adaptive")
    t, p, _ = arrival.shape
    k, c = tables.shape[0], scns.shape[0]
    cells = ref.to_cells(arrival, bank, row, is_write, valid, closed)
    out = adaptive_blocks(
        *cells, ref.table_tile(ref.lane_tables(tables, c)),
        ref.lane_scenarios(scns, k).T.contiguous(),
        torch.as_tensor(bins, dtype=torch.float32, device=dev).contiguous(),
        torch.as_tensor(tcfg, dtype=torch.float32, device=dev).contiguous(),
        n_banks, mlp_window, emit_raw=emit_raw, validated=validated,
        region_map=(None if region_map is None else ref.map_tile(
            ref.lane_stack_map(region_map, c, dev), dev)))
    return ref.from_lanes(out, t, p, k, c)

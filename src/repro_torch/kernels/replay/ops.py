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
per-bank and region-compressed timing tiles are ported, and the fault
axis (`repro_torch.core.faults`): `fault=` takes lane-tiled fault rows
[F_COLS, lanes], the issue-order uniforms [G, N] and, static, the
JEDEC column [6], and adds the [N_COUNTERS, G, lanes] int32 counters
(static faults take module rows only, as the reference's campaigns).
`replay_blocks` also takes a multi-channel geometry, `chan` =
(n_channels, n_ranks, t_burst) with a per-cell interleave code column
[G] (variant d, with any timing layout and with faults); the adaptive
kernel is single-channel, as the reference's.  Both kernels and their
grid wrappers take `block_lanes` (32, 64 or 128 chain lanes per block;
None keeps the kernel's own choice), the replay tuner's lever
(`core.autotune`): lanes are independent, so it changes no output.

The region map's range is a property of the campaign: `SimSpec` checks
it once on the host and `SimEngine` launches with `validated=True`.  A
direct call without `validated` checks it, with the bank ids and the
rows, in one read of the device.

`adaptive_stream_terms` runs the adaptive kernel's producer stage alone
(the terms it computes ahead of each lane's dependent chain; the plain
version `ref.adaptive_stream_terms` on the CPU), for tests.
`replay_chain_ops` / `replay_chain_cycles` count the loop-carried
dependent operations of each kernel variant's step: the least time a
step can take, whatever the bytes.  replay_blocks' loops are priced
with the bank state forwarded in registers and, faulted, the error
probability as a lane constant (static replay serves one of two rows):
what the work carries, not a shared-memory round trip or a division a
step.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import faults
from repro_torch.core.dram_sim import (check_prefix_valid,
                                       replay_adaptive_cells, replay_cells)
from repro_torch.core.thermal import SCN_COLS
from repro_torch.kernels import build
from repro_torch.kernels.replay import ref

# heat registers per lane in adaptive.cu (`kMaxBanks`)
MAX_BANKS = 16
# the shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# the chain lanes per block a caller may ask of replay.cu / adaptive.cu
# (`block_lanes=`; None keeps each kernel's default, at most 128)
BLOCK_LANES = (32, 64, 128)


def check_block_lanes(where: str, block_lanes) -> int:
    """`block_lanes` (None, 32, 64 or 128) -> the C entry point's cap (0:
    the kernel's default); anything else raises, on every device."""
    if block_lanes is None:
        return 0
    if isinstance(block_lanes, bool) or block_lanes not in BLOCK_LANES:
        raise ValueError(f"{where}: block_lanes must be None or one of "
                         f"{BLOCK_LANES}, got {block_lanes!r}")
    return int(block_lanes)


def _replay_lib() -> ctypes.CDLL:
    lib = build.load("replay_blocks")
    lib.replay_launch.argtypes = [ctypes.c_void_p] * 15 \
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.replay_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.replay_smem_bytes.restype = ctypes.c_int
    lib.replay_launch.restype = ctypes.c_int
    lib.replay_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.replay_plan.restype = None
    return lib


def replay_plan(s_rows: int, n_banks: int, mlp_window: int, n_cols: int,
                faulted: bool, n_channels: int = 1,
                n_ranks: int = 1, block_lanes: int | None = None) -> dict:
    """replay.cu's launch plan for these sizes (n_cols: 0 for module
    rows, else the tile's columns): the chunk of requests per buffer,
    whether the lanes' timing tile is staged in shared memory, the
    shared bytes, the threads per block (chain lanes + producer warps)
    and the chain lanes per block.  Needs the built library."""
    out = (ctypes.c_int * 5)()
    _replay_lib().replay_plan(s_rows, n_banks, mlp_window, n_cols,
                              int(faulted), n_channels, n_ranks,
                              check_block_lanes("replay_plan", block_lanes),
                              out)
    return {"chunk": out[0], "tile_staged": bool(out[1]),
            "smem_bytes": out[2], "threads": out[3], "lanes": out[4]}


def _adaptive_lib() -> ctypes.CDLL:
    lib = build.load("adaptive_blocks")
    lib.adaptive_launch.argtypes = [ctypes.c_void_p] * 22 \
        + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.adaptive_launch.restype = ctypes.c_int
    lib.adaptive_plan.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.adaptive_plan.restype = None
    lib.adaptive_terms_launch.argtypes = [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.adaptive_terms_launch.restype = ctypes.c_int
    return lib


def adaptive_plan(lanes: int, n_edges: int, n_rows: int, n_banks: int,
                  mlp_window: int, banked: bool, regioned: bool,
                  faulted: bool, block_lanes: int | None = None) -> dict:
    """adaptive.cu's launch plan for these sizes: the chunk of requests
    per shared-memory buffer, whether the lanes' table stacks are staged
    in shared memory, the shared bytes, the threads per block (chain
    lanes + producer warps) and the chain lanes per block.  Needs the
    built library."""
    out = (ctypes.c_int * 5)()
    _adaptive_lib().adaptive_plan(
        lanes, n_edges, n_rows, n_banks, mlp_window, int(banked),
        int(regioned), int(faulted),
        check_block_lanes("adaptive_plan", block_lanes), out)
    return {"chunk": out[0], "tables_staged": bool(out[1]),
            "smem_bytes": out[2], "threads": out[3], "lanes": out[4]}


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


def _check_fault(where: str, fault, lanes: int, g: int, n: int,
                 static: bool):
    """Shape, dtype and contiguity of a kernel-layout fault tuple: the
    [F_COLS, lanes] fault tile, the static replay's [6] JEDEC column
    and the [G, N] uniforms."""
    want = "(fault_t, jedec, u)" if static else "(fault_t, u)"
    if not isinstance(fault, (tuple, list)) \
            or len(fault) != want.count(",") + 1:
        raise ValueError(f"{where}: fault must be a tuple {want}")
    _check(f"{where}: fault tile", fault[0], torch.float32,
           (faults.F_COLS, lanes))
    if static:
        _check(f"{where}: JEDEC column", fault[1], torch.float32, (6,))
    _check(f"{where}: fault uniforms", fault[-1], torch.float32, (g, n))


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
                  validated: bool = False, region_map=None, fault=None,
                  chan=(1, 1, 5.0), ileave=None, block_lanes=None):
    """closed [G] float32 (1 = closed page); arrival [G, N] float32;
    bank/row/is_write/valid [G, N] int32; timings_t [6, S] float32, the
    per-bank tile [n_banks, 6, S], or with `region_map` (int32 [banks *
    R] shared or [banks * R, S] per lane) the unique-row store
    [U, 6, S] -> (lat [G, N, S], total [G, S]).  `fault` = (fault tile
    [F_COLS, S], JEDEC column [6], uniforms [G, N], all float32) with
    module rows adds the [N_COUNTERS, G, S] int32 counters (variant e).
    `chan` = (n_channels, n_ranks, t_burst) with C*R > 1 replays each
    cell on C*R*n_banks bank slots behind C buses, cell g under
    interleave code `ileave[g]` (int32 [G]; None: all 0) — variant (d),
    with any of the timing layouts and with faults; C*R == 1 ignores
    `ileave` and launches (a)-(c), (e) unchanged.
    CUDA tensors launch the kernel (counted in `replay_blocks.launches`;
    a multi-channel launch also in `launches_multi`, and otherwise an
    unfaulted per-bank tile in `launches_banked`, an unfaulted region
    store in `launches_regioned`, a faulted launch in
    `launches_faulted`); CPU tensors run `dram_sim.replay_cells`.  A
    geometry whose block state exceeds the card's shared memory
    (replay.cu `replay_smem_bytes` > 227 KB) is refused.
    `validated=True` skips the data checks, which wait for the device
    (bank range, prefix mask and, regioned, row sign and map range):
    only for a caller that has checked these same inputs already.
    `block_lanes` (32, 64 or 128) caps the chain lanes of a block; None
    keeps replay.cu's `block_lanes`.  Lanes are independent, so every
    output is bitwise the same at any block size; the plain version has
    no blocks, but any other value raises on every device."""
    cap = check_block_lanes("replay_blocks", block_lanes)
    regioned = region_map is not None
    faulted = fault is not None
    banked = timings_t.dim() == 3
    n_ch, n_rk, t_burst = int(chan[0]), int(chan[1]), float(chan[2])
    multi = n_ch * n_rk > 1
    if faulted and banked:
        raise ValueError("replay_blocks: a fault axis takes module rows "
                         "[6, S] (the JEDEC fallback is one row)")
    if n_ch < 1 or n_rk < 1:
        raise ValueError(f"replay_blocks: chan needs n_channels, n_ranks "
                         f">= 1, got {chan}")
    ins = (closed, arrival, bank, row, is_write, valid, timings_t) \
        + ((region_map,) if regioned else ()) \
        + (tuple(fault) if faulted else ()) \
        + ((ileave,) if multi and ileave is not None else ())
    dev = _on_cuda("replay_blocks", ins)
    if dev is None:
        tim = (timings_t.permute(2, 0, 1) if banked else timings_t.T)
        return replay_cells(arrival, bank, row, is_write.bool(),
                            valid.bool(), tim, closed > 0.5, n_banks,
                            mlp_window,
                            ref.lane_map(region_map) if regioned else None,
                            (fault[0].T, fault[1], fault[2]) if faulted
                            else None, n_ch, n_rk, ileave, t_burst)
    g, n = _check_streams("replay_blocks", closed, arrival, bank, row,
                          is_write, valid)
    if multi:
        if ileave is None:
            ileave = torch.zeros(g, dtype=torch.int32, device=dev)
        _check("replay_blocks: ileave", ileave, torch.int32, (g,))
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
    if faulted:
        _check_fault("replay_blocks", fault, s, g, n, static=True)
    smem = _replay_lib().replay_smem_bytes(s, n_banks, mlp_window,
                                           int(faulted), n_ch, n_rk, cap)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"replay_blocks: {n_ch} channels x {n_rk} ranks x {n_banks} "
            f"banks at {s} timing rows need {smem} bytes of shared memory "
            f"per block, over the card's {SMEM_LIMIT}")
    lat = torch.empty((g, n, s), dtype=torch.float32, device=dev)
    total = torch.empty((g, s), dtype=torch.float32, device=dev)
    cnt = (torch.zeros((faults.N_COUNTERS, g, s), dtype=torch.int32,
                       device=dev) if faulted else None)
    if g == 0 or n == 0 or s == 0:
        return (lat, total.zero_()) + ((cnt,) if faulted else ())
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
            *((fault[0].data_ptr(), fault[1].data_ptr(),
               fault[2].data_ptr()) if faulted else (None,) * 3),
            ileave.data_ptr() if multi else None,
            lat.data_ptr(), total.data_ptr(),
            cnt.data_ptr() if faulted else None, g, n, s, n_banks,
            mlp_window, timings_t.shape[0] if banked else 0, n_regions,
            int(regioned and region_map.dim() == 2), n_ch, n_rk, t_burst,
            cap, stream)
    if rc != 0:
        raise RuntimeError(f"replay_blocks launch failed: cudaError {rc} "
                           f"(G={g}, N={n}, S={s}, banked={banked}, "
                           f"regions={n_regions}, faulted={faulted}, "
                           f"channels={n_ch}x{n_rk})")
    replay_blocks.launches += 1
    replay_blocks.launches_multi += int(multi)
    replay_blocks.launches_banked += int(banked and not regioned
                                         and not multi)
    replay_blocks.launches_regioned += int(regioned and not multi)
    replay_blocks.launches_faulted += int(faulted and not multi)
    return (lat, total) + ((cnt,) if faulted else ())


replay_blocks.launches = 0
replay_blocks.launches_banked = 0
replay_blocks.launches_regioned = 0
replay_blocks.launches_faulted = 0
replay_blocks.launches_multi = 0


def adaptive_blocks(closed, arrival, bank, row, is_write, valid, tables_t,
                    scn_t, bins, tcfg, n_banks: int = 8,
                    mlp_window: int = 8, emit_raw: bool = False,
                    validated: bool = False, region_map=None, fault=None,
                    block_lanes=None):
    """Closed-loop replay launch.  closed [G] float32; arrival [G, N]
    float32; bank/row/is_write/valid [G, N] int32; tables_t [S+1, 6, L]
    (lane l's table stack, JEDEC row last), the per-bank tile
    [n_banks, S+1, 6, L], or with `region_map` (int32 [banks * R]
    shared or [banks * R, L] per lane) the unique-column tile
    [U, S+1, 6, L]; scn_t [SCN_COLS, L] scenario rows per lane; bins
    [S] ascending edges; tcfg [6] `ThermalConfig.as_row`, all float32.
    `fault` = (fault tile [F_COLS, L], uniforms [G, N], float32) runs
    the faulted sensor and the watchdog on every lane (variant d, any
    table layout).

    Returns (lat [G, N, L], total [G, L], temp_max [G, L], temp_mean
    [G, L], bin_switches [G, L] int32, bank_heat [G, n_banks, L], temps
    [G, N, L] | None, bins [G, N, L] int32 | None): the raw sensed (or,
    faulted, read) temperatures and selected (served) bins only when
    `emit_raw`; with `fault` also the [N_COUNTERS, G, L] int32
    counters.  CUDA tensors launch the kernel (counted in
    `adaptive_blocks.launches`, an unfaulted per-bank tile also in
    `launches_banked`, an unfaulted region tile in `launches_regioned`,
    a faulted launch in `launches_faulted`); CPU tensors run
    `dram_sim.replay_adaptive_cells`.  `validated` and `block_lanes`
    as in `replay_blocks`."""
    cap = check_block_lanes("adaptive_blocks", block_lanes)
    regioned = region_map is not None
    faulted = fault is not None
    ins = (closed, arrival, bank, row, is_write, valid, tables_t, scn_t,
           bins, tcfg) + ((region_map,) if regioned else ()) \
        + (tuple(fault) if faulted else ())
    dev = _on_cuda("adaptive_blocks", ins)
    banked = tables_t.dim() == 4
    if dev is None:
        out = replay_adaptive_cells(
            arrival, bank, row, is_write.bool(), valid.bool(),
            ref.lane_stacks(tables_t), bins, scn_t.T, tcfg, closed > 0.5,
            n_banks, mlp_window,
            ref.lane_map(region_map) if regioned else None,
            (fault[0].T, fault[1]) if faulted else None)
        lat, total, temps, sel, heat, diag = out[:6]
        return (lat, total, *diag, heat, temps if emit_raw else None,
                sel if emit_raw else None) + out[6:]
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
    if faulted:
        _check_fault("adaptive_blocks", fault, lanes, g, n, static=False)
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
    cnt = (torch.empty((faults.N_COUNTERS, g, lanes), dtype=torch.int32,
                       device=dev) if faulted else None)
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
            scn_t.data_ptr(), edges.data_ptr(), tcfg.data_ptr(),
            *((fault[0].data_ptr(), fault[1].data_ptr()) if faulted
              else (None, None)),
            lat.data_ptr(), total.data_ptr(),
            tmax.data_ptr(), tmean.data_ptr(), sw.data_ptr(),
            heat.data_ptr(), temps.data_ptr() if emit_raw else None,
            sel.data_ptr() if emit_raw else None,
            cnt.data_ptr() if faulted else None,
            g, n, lanes, edges.shape[0], s + 1, n_banks, mlp_window,
            int(banked), n_regions, int(regioned and region_map.dim() == 2),
            int(emit_raw), cap, stream)
    if rc != 0:
        raise RuntimeError(f"adaptive_blocks launch failed: cudaError {rc} "
                           f"(G={g}, N={n}, L={lanes}, banked={banked}, "
                           f"regions={n_regions}, faulted={faulted})")
    adaptive_blocks.launches += 1
    adaptive_blocks.launches_banked += int(banked and not regioned
                                           and not faulted)
    adaptive_blocks.launches_regioned += int(regioned and not faulted)
    adaptive_blocks.launches_faulted += int(faulted)
    return (lat, total, tmax, tmean, sw, heat, temps, sel) \
        + ((cnt,) if faulted else ())


adaptive_blocks.launches = 0
adaptive_blocks.launches_banked = 0
adaptive_blocks.launches_regioned = 0
adaptive_blocks.launches_faulted = 0


def adaptive_stream_terms(arrival, valid, scn_t, tcfg, fault_t=None):
    """The adaptive kernel's producer stage alone: arrival [G, N]
    float32, valid [G, N] int32, scn_t [SCN_COLS, L], tcfg [6] and
    optionally the fault tile [F_COLS, L] (float32) -> the stream terms
    of every (cell, request, lane), the dict `ref.adaptive_stream_terms`
    returns.  CUDA tensors launch `adaptive_terms_kernel` (the same
    device code as the replay's producer warps; counted in
    `adaptive_stream_terms.launches`); CPU tensors run the plain
    version."""
    ins = (arrival, valid, scn_t, tcfg) + (() if fault_t is None
                                           else (fault_t,))
    dev = _on_cuda("adaptive_stream_terms", ins)
    if dev is None:
        return ref.adaptive_stream_terms(arrival, valid, scn_t, tcfg,
                                         fault_t)
    if arrival.dim() != 2:
        raise ValueError(f"adaptive_stream_terms: arrival must be [G, N], "
                         f"got {tuple(arrival.shape)}")
    g, n = arrival.shape
    lanes = scn_t.shape[-1]
    _check("adaptive_stream_terms: arrival", arrival, torch.float32, (g, n))
    _check("adaptive_stream_terms: valid", valid, torch.int32, (g, n))
    _check("adaptive_stream_terms: scn_t", scn_t, torch.float32,
           (SCN_COLS, lanes))
    _check("adaptive_stream_terms: tcfg", tcfg, torch.float32, (6,))
    if fault_t is not None:
        _check("adaptive_stream_terms: fault tile", fault_t, torch.float32,
               (faults.F_COLS, lanes))
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"dt": torch.empty((g, n), **f32),
           "decay": torch.empty((g, n), **f32),
           "ambient": torch.empty((g, n, lanes), **f32)}
    if fault_t is not None:
        out["alpha"] = torch.empty((g, n, lanes), **f32)
        out["noise"] = torch.empty((g, n, lanes), **f32)
        out["flags"] = torch.empty((g, n, lanes), dtype=torch.int32,
                                   device=dev)
    ptr = {k: v.data_ptr() for k, v in out.items()}
    with torch.cuda.device(dev):
        rc = _adaptive_lib().adaptive_terms_launch(
            arrival.data_ptr(), valid.data_ptr(), scn_t.data_ptr(),
            tcfg.data_ptr(), None if fault_t is None else fault_t.data_ptr(),
            ptr["dt"], ptr["decay"], ptr["ambient"], ptr.get("alpha"),
            ptr.get("noise"), ptr.get("flags"), g, n, lanes,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adaptive_stream_terms launch failed: cudaError "
                           f"{rc} (G={g}, N={n}, L={lanes})")
    adaptive_stream_terms.launches += 1
    return out


adaptive_stream_terms.launches = 0


# The chain model: latency in cycles of a float32 (or int32) add, mul,
# max, compare or select ("alu"); of a true float32 division ("div": the
# MUFU reciprocal and its dependent refinement, ~20 + 4 x 4); of a
# shared-memory load ("smem") and of an L1 hit ("l1").
CHAIN_LATENCY = {"alu": 4, "div": 36, "smem": 30, "l1": 35}
EDGE_REGS = 8       # adaptive.cu `kEdgeRegs`: edges counted by a tree


def _bank_loop(multi: bool = False, forwarded: bool = False) -> dict:
    """`service_math` from one step's bank state to the next: the
    state's shared-memory round trip, then (gate,) start = max(max(t,
    ready), gate), the conflict start, + tRP, + tRCD, + tCL, the
    precharge start (two maxes), + tRP and the page-policy select.
    `forwarded` (replay_blocks): the next step's state is
    loaded while this one computes, and the one select that forwards
    this step's registers where the slot repeats takes the round trip's
    place; (d)'s bus adds one operation to the gate either way."""
    if forwarded:
        return {"alu": 11 + int(multi)}
    return {"smem": 1, "alu": 10 + int(multi)}


def _watchdog_loop(table: str | None, static: bool = False) -> dict:
    """Detected error -> watchdog -> next step's served row -> its
    reduction -> error probability -> detected error: the probe gate (2),
    the served-row select (1), (the row's load,) the reduction's three
    adds, division, 1 - x and max (5 + div), error_prob (sub, max, mul,
    add, clamp: 6), the draw (compare, the detected fraction's mul,
    compare and and: 4) and wd_update (budget add, trip compare and or,
    tripped select: 4).  `static` (replay_blocks (e) and faulted (d)):
    the served row is the lane's own or JEDEC, so the probability and
    its detected threshold are two lane constants — the probe gate (2),
    the served-row select (1), the probability's select (1), the draw's
    two compares and and (3), wd_update (4)."""
    if static:
        return {"alu": 2 + 1 + 1 + 3 + 4}
    out = {"alu": 2 + 1 + 5 + 6 + 4 + 4, "div": 1}
    if table is not None:
        out[table] = 1
    return out


def _heat_loop(n_banks: int, n_edges: int, table: str,
               faulted: bool) -> dict:
    """Bank heats -> reading -> bin -> table row -> access energy ->
    deposit -> bank heats: decay (1), the sum bank 0 first (n_banks - 1),
    + ambient (1), (d: the faulted sensor — lag sub, mul, add and select,
    the lag select, + drift, + noise, the stuck-at and dropout selects,
    the quantization's division, rint, mul and select: 12 + div —, the
    watchdog's served-bin select: 1), + hysteresis (1), the edge compare
    (1) and the count (a tree of 3 adds up to EDGE_REGS edges, else one
    add per edge), max(up, min(cur, down)) (2), the row address (1) and
    load, the energy (mul, add, mul, add: 4), the deposit's mul and add
    (2)."""
    count = 3 if n_edges <= EDGE_REGS else n_edges
    alu = 1 + (n_banks - 1) + 1 + 1 + 1 + count + 2 + 1 + 4 + 2
    out = {"alu": alu, table: 1}
    if faulted:
        out["alu"] += 12 + 1
        out["div"] = 1
    return out


def replay_chain_ops(variant: str, n_banks: int = 8, n_edges: int = 5,
                     table: str = "smem", faulted: bool = False) -> dict:
    """The loop-carried dependent operations of one step of a replay
    kernel variant, by latency class (`CHAIN_LATENCY`): the longest of
    the dependency loops that close from one request to the next.

    variant: "2a"-"2e" (replay_blocks: module rows, per-bank tile,
    region store, multi-channel, faulted module rows) or "3a"-"3d"
    (adaptive_blocks: module, per-bank and region tables, faulted);
    n_banks / n_edges: banks per lane and bin edges (adaptive only);
    table: where the adaptive step reads its table row ("smem" when the
    stacks are staged, "l1" otherwise); faulted: replay_blocks (d) under
    a fault axis.

    replay_blocks, priced for the work the replay needs: the
    bank state's loop with the state forwarded in registers (11
    dependent operations; (d) 12 with the channel bus in the gate), and
    for (e) and faulted (d) the static watchdog's loop, whose error
    probability is a lane constant (11; the bank loop is the one
    returned where they tie).  Neither the shared round trip a step (70
    cycles) nor (e)'s per-step division (124), which an earlier kernel
    did, is work the replay needs, so the model no longer prices them.
    adaptive_blocks: the heat loop, longer than the bank state's (a
    shared round trip a step there) and (d) the watchdog's, whose
    served row follows the bin, so its division is real."""
    kernel, v = variant[:1], variant[1:]
    if kernel == "2" and v in ("a", "b", "c", "d", "e"):
        loops = [_bank_loop(multi=v == "d", forwarded=True)]
        if v == "e" or faulted:
            loops.append(_watchdog_loop(None, static=True))
    elif kernel == "3" and v in ("a", "b", "c", "d"):
        if table not in ("smem", "l1"):
            raise ValueError(f"table must be 'smem' or 'l1', got {table!r}")
        loops = [_bank_loop(), _heat_loop(n_banks, n_edges, table, v == "d")]
        if v == "d":
            loops.append(_watchdog_loop(table))
    else:
        raise ValueError(f"unknown replay kernel variant {variant!r} "
                         "(2a-2e, 3a-3d)")
    return max(loops, key=_cycles)


def _cycles(ops: dict) -> int:
    return sum(CHAIN_LATENCY[k] * c for k, c in ops.items())


def replay_chain_cycles(variant: str, n_banks: int = 8, n_edges: int = 5,
                        table: str = "smem", faulted: bool = False) -> int:
    """Cycles per step of `replay_chain_ops` at `CHAIN_LATENCY`: times
    N requests over the SM clock, the least time of a launch (its lanes'
    chains run side by side)."""
    return _cycles(replay_chain_ops(variant, n_banks, n_edges, table,
                                    faulted))


def replay_grid(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8,
                validated: bool = False, region_map=None, fault=None,
                chan=(1, 1, 5.0), ileave=None, block_lanes=None):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N] (prefix-true);
    timings [S, 6] or per-bank [S, n_banks, 6]; closed [P] bool ->
    (latency [T, P, S, N], total [T, P, S]), on the device of
    `arrival`.  With `region_map` ([banks * R] shared or [S, banks * R]
    per lane) `timings` is the [S, U, 6] unique-row store.  `fault` =
    (fault rows [S, F_COLS], JEDEC row [6], uniforms [T, N]) with
    module rows adds the [T, P, S, NC] int32 counters.  `chan` =
    (n_channels, n_ranks, t_burst) with the [P] interleave codes
    `ileave` (None: all 0) is the channel geometry (variant d);
    `block_lanes` as in `replay_blocks`."""
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
    if fault is not None:
        fault = (ref.fault_tile(torch.as_tensor(fault[0], device=dev)),
                 torch.as_tensor(fault[1], dtype=torch.float32,
                                 device=dev).contiguous(),
                 ref.cell_uniforms(torch.as_tensor(fault[2], device=dev), p))
    out = replay_blocks(
        *cells, tile, n_banks, mlp_window, validated=validated,
        region_map=(None if region_map is None
                    else ref.map_tile(region_map, dev)), fault=fault,
        chan=chan, ileave=ref.cell_codes(ileave, t, p, dev),
        block_lanes=block_lanes)
    return ref.from_cells(*out[:2], t, p, *out[2:])


def replay_grid_adaptive(arrival, bank, row, is_write, valid, tables,
                         bins, scns, tcfg, closed, n_banks: int = 8,
                         mlp_window: int = 8, emit_raw: bool = False,
                         validated: bool = False, region_map=None,
                         fault=None, block_lanes=None):
    """Adaptive campaign: arrival/bank/row/is_write [T, P, N]; valid
    [T, N]; tables [K, S+1, 6] or per-bank [K, S+1, n_banks, 6] (JEDEC
    row last), or with `region_map` ([banks * R] shared or [K, banks *
    R] per stack) the unique-column stacks [K, S+1, U, 6]; bins [S];
    scns [C, SCN_COLS]; tcfg [6]; closed [P] ->
    (lat [T, P, K, C, N], total [T, P, K, C], temps | None, bins |
    None (both [T, P, K, C, N], only with `emit_raw`), bank_heat
    [T, P, K, C, n_banks], (temp_max, temp_mean, bin_switches) each
    [T, P, K, C], reduced inside the launch).  `fault` = (fault rows
    [F, F_COLS], uniforms [T, N]) rides the lanes innermost, l = (k*C +
    c)*F + f: every grid gains F after C, and the return the
    [T, P, K, C, F, NC] int32 counters.  `block_lanes` as in
    `replay_blocks`."""
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
    nf = None if fault is None else fault[0].shape[0]
    reps = c * (nf or 1)
    cells = ref.to_cells(arrival, bank, row, is_write, valid, closed)
    if fault is not None:
        fault = (ref.fault_tile(ref.lane_faults(
                     torch.as_tensor(fault[0], device=dev), k * c)),
                 ref.cell_uniforms(torch.as_tensor(fault[1], device=dev), p))
    out = adaptive_blocks(
        *cells, ref.table_tile(ref.lane_tables(tables, reps)),
        ref.lane_scenarios(scns, k, nf or 1).T.contiguous(),
        torch.as_tensor(bins, dtype=torch.float32, device=dev).contiguous(),
        torch.as_tensor(tcfg, dtype=torch.float32, device=dev).contiguous(),
        n_banks, mlp_window, emit_raw=emit_raw, validated=validated,
        region_map=(None if region_map is None else ref.map_tile(
            ref.lane_stack_map(region_map, reps, dev), dev)), fault=fault,
        block_lanes=block_lanes)
    return ref.from_lanes(out, t, p, k, c, nf)

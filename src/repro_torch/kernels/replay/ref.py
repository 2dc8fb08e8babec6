"""Plain PyTorch versions of the replay kernels under the campaign
contract: `repro_torch.core.dram_sim.replay_cells` (static) and
`replay_adaptive_cells` (closed thermal loop) over the flattened
(trace x policy) cells.  The CPU path of `ops` and the yardstick the
kernels are held to on the card."""

from __future__ import annotations

import torch

from repro_torch.core.dram_sim import replay_adaptive_cells, replay_cells


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


def timing_tile(timings) -> torch.Tensor:
    """[S, 6] rows -> the kernel's [6, S] tile; per-bank [S, banks, 6]
    (or the region store [S, U, 6]) -> [banks | U, 6, S] (contiguous
    float32)."""
    tim = timings.to(torch.float32)
    return (tim.T if tim.dim() == 2 else tim.permute(1, 2, 0)).contiguous()


def map_tile(region_map, device) -> torch.Tensor:
    """A region index map in the campaign layout — [banks * R] shared,
    or [lanes, banks * R] per lane — -> the kernel's layout: [banks * R]
    or [banks * R, lanes] (contiguous int32)."""
    rm = torch.as_tensor(region_map, device=device).to(torch.int32)
    return (rm.T if rm.dim() == 2 else rm).contiguous()


def lane_map(map_t) -> torch.Tensor:
    """Inverse of `map_tile`."""
    return map_t.T if map_t.dim() == 2 else map_t


def lane_tables(tables, c: int) -> torch.Tensor:
    """[K, S+1, 6] (or per-bank [K, S+1, B, 6], or region-compressed
    [K, S+1, U, 6]) table stacks -> one stack per lane l = k*C + c:
    [K*C, S+1, (B | U,) 6]."""
    return tables.to(torch.float32).repeat_interleave(c, dim=0)


def lane_stack_map(region_map, c: int, device):
    """A region map per table stack ([K, banks * R]) -> one per lane
    l = k*C + c ([K*C, banks * R]); a shared [banks * R] map (or None)
    passes through."""
    if region_map is None:
        return None
    rm = torch.as_tensor(region_map, device=device)
    return rm.repeat_interleave(c, dim=0) if rm.dim() == 2 else rm


def lane_scenarios(scns, k: int) -> torch.Tensor:
    """[C, SCN_COLS] scenario rows -> one row per lane l = k*C + c:
    [K*C, SCN_COLS]."""
    return scns.to(torch.float32).repeat(k, 1)


def table_tile(lane_tabs) -> torch.Tensor:
    """Per-lane stacks [L, S+1, 6] -> the kernel's [S+1, 6, L] tile;
    per-bank [L, S+1, B, 6] -> [B, S+1, 6, L] (contiguous)."""
    if lane_tabs.dim() == 3:
        return lane_tabs.permute(1, 2, 0).contiguous()
    return lane_tabs.permute(2, 1, 3, 0).contiguous()


def lane_stacks(tables_t) -> torch.Tensor:
    """Inverse of `table_tile`."""
    if tables_t.dim() == 3:
        return tables_t.permute(2, 0, 1)
    return tables_t.permute(3, 1, 0, 2)


def from_lanes(out, t: int, p: int, k: int, c: int):
    """Kernel layout of `adaptive_blocks`' outputs -> the campaign
    contract: [G, N, L] -> [T, P, K, C, N], [G, L] -> [T, P, K, C],
    heat [G, B, L] -> [T, P, K, C, B]; None stays None."""
    lat, total, tmax, tmean, sw, heat, temps, bins = out

    def grid4(x):
        return x.reshape(t, p, k, c)

    def grid5(x):
        if x is None:
            return None
        n = x.shape[1]
        return x.reshape(t, p, n, k, c).permute(0, 1, 3, 4, 2)

    return (grid5(lat), grid4(total), grid5(temps), grid5(bins),
            grid5(heat), (grid4(tmax), grid4(tmean), grid4(sw)))


def replay_grid(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8, region_map=None):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N]; timings
    [S, 6] or per-bank [S, banks, 6]; closed [P] bool -> (latency
    [T, P, S, N], total [T, P, S]).  With `region_map` ([banks * R]
    shared or [S, banks * R] per lane) `timings` is the [S, U, 6]
    unique-row store (`dram_sim.replay_cells`)."""
    t, p, _ = arrival.shape
    closed_c, arr, bk, rw, wr, val = to_cells(arrival, bank, row, is_write,
                                              valid, closed)
    lat, total = replay_cells(arr, bk, rw, wr, val,
                              torch.as_tensor(timings, device=arr.device),
                              closed_c > 0.5, n_banks, mlp_window,
                              region_map)
    return from_cells(lat, total, t, p)


def replay_grid_adaptive(arrival, bank, row, is_write, valid, tables,
                         bins, scns, tcfg, closed, n_banks: int = 8,
                         mlp_window: int = 8, region_map=None):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N]; tables
    [K, S+1, 6] or per-bank [K, S+1, banks, 6] (JEDEC row last); bins
    [S]; scns [C, SCN_COLS]; tcfg [6]; closed [P] -> (lat [T, P, K, C,
    N], total [T, P, K, C], temps [T, P, K, C, N], bins [T, P, K, C, N]
    int32, bank_heat [T, P, K, C, banks], (temp_max, temp_mean,
    bin_switches) each [T, P, K, C]).  With `region_map` ([banks * R]
    shared by every stack or [K, banks * R] per stack) `tables` is the
    [K, S+1, U, 6] unique-column stack."""
    t, p, _ = arrival.shape
    dev = arrival.device
    tables = torch.as_tensor(tables, device=dev)
    scns = torch.as_tensor(scns, device=dev)
    k, c = tables.shape[0], scns.shape[0]
    closed_c, arr, bk, rw, wr, val = to_cells(arrival, bank, row, is_write,
                                              valid, closed)
    lat, total, temps, sel, heat, (tmax, tmean, sw) = replay_adaptive_cells(
        arr, bk, rw, wr, val, lane_tables(tables, c), bins,
        lane_scenarios(scns, k), tcfg, closed_c > 0.5, n_banks, mlp_window,
        lane_stack_map(region_map, c, dev))
    return from_lanes((lat, total, tmax, tmean, sw, heat, temps, sel),
                      t, p, k, c)

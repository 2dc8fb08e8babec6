"""Plain PyTorch versions of the replay kernels under the campaign
contract: `repro_torch.core.dram_sim.replay_cells` (static) and
`replay_adaptive_cells` (closed thermal loop) over the flattened
(trace x policy) cells, unfaulted or with a fault axis.  The CPU path
of `ops` and the yardstick the kernels are held to on the card; and
`adaptive_stream_terms`, the part of each adaptive step that the
kernel's producer warps compute ahead of the dependent chain."""

from __future__ import annotations

import torch

from repro_torch.core import faults
from repro_torch.core.dram_sim import replay_adaptive_cells, replay_cells
from repro_torch.core.thermal import ambient_at


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


def from_cells(lat, total, t: int, p: int, cnt=None):
    """Kernel layout (lat [G, N, S], total [G, S], counters [NC, G, S])
    -> the campaign contract (lat [T, P, S, N], total [T, P, S],
    counters [T, P, S, NC] when given)."""
    g, n, s = lat.shape
    out = (lat.reshape(t, p, n, s).permute(0, 1, 3, 2),
           total.reshape(t, p, s))
    if cnt is None:
        return out
    return out + (cnt.reshape(-1, t, p, s).permute(1, 2, 3, 0),)


def cell_codes(ileave, t: int, p: int, device) -> torch.Tensor:
    """[P] per-policy interleave codes (or None: all 0) -> one per
    kernel cell g = t*P + p: [T*P] int32 (contiguous)."""
    il = (torch.zeros(p, dtype=torch.int32, device=device) if ileave is None
          else torch.as_tensor(ileave, device=device).to(torch.int32))
    return il[None, :].expand(t, p).reshape(t * p).contiguous()


def cell_uniforms(u, p: int) -> torch.Tensor:
    """[T, N] error uniforms -> one stream per kernel cell g = t*P + p:
    [T*P, N] float32 (contiguous; shared by a trace's policies)."""
    u = u.to(torch.float32)
    t, n = u.shape
    return u[:, None, :].expand(t, p, n).reshape(t * p, n).contiguous()


def fault_tile(f_rows) -> torch.Tensor:
    """Per-lane fault rows [L, F_COLS] -> the kernels' [F_COLS, L] tile
    (contiguous float32)."""
    return f_rows.to(torch.float32).T.contiguous()


def lane_faults(f_rows, kc: int) -> torch.Tensor:
    """[F, F_COLS] fault rows -> one row per adaptive lane l = (k*C +
    c)*F + f: [K*C*F, F_COLS]."""
    return f_rows.to(torch.float32).repeat(kc, 1)


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


def lane_scenarios(scns, k: int, nf: int = 1) -> torch.Tensor:
    """[C, SCN_COLS] scenario rows -> one row per lane l = (k*C + c)*F
    + f: [K*C*F, SCN_COLS]."""
    return scns.to(torch.float32).repeat_interleave(nf, dim=0).repeat(k, 1)


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


def from_lanes(out, t: int, p: int, k: int, c: int, nf: int | None = None):
    """Kernel layout of `adaptive_blocks`' outputs -> the campaign
    contract: [G, N, L] -> [T, P, K, C, N], [G, L] -> [T, P, K, C],
    heat [G, B, L] -> [T, P, K, C, B]; None stays None.  With a fault
    axis of `nf` rows every grid gains F after C, and the [NC, G, L]
    counters (a ninth output) become [T, P, K, C, F, NC]."""
    lat, total, tmax, tmean, sw, heat, temps, bins = out[:8]
    lanes = (k, c) if nf is None else (k, c, nf)

    def grid4(x):
        return x.reshape(t, p, *lanes)

    def grid5(x):
        if x is None:
            return None
        n = x.shape[1]
        r = len(lanes)
        return x.reshape(t, p, n, *lanes).permute(
            0, 1, *range(3, 3 + r), 2)

    res = (grid5(lat), grid4(total), grid5(temps), grid5(bins),
           grid5(heat), (grid4(tmax), grid4(tmean), grid4(sw)))
    if nf is None:
        return res
    cnt = out[8].reshape(-1, t, p, *lanes)
    return res + (cnt.permute(*range(1, cnt.dim()), 0),)


def replay_grid(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8, region_map=None,
                fault=None, chan=(1, 1, 5.0), ileave=None):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N]; timings
    [S, 6] or per-bank [S, banks, 6]; closed [P] bool -> (latency
    [T, P, S, N], total [T, P, S]).  With `region_map` ([banks * R]
    shared or [S, banks * R] per lane) `timings` is the [S, U, 6]
    unique-row store (`dram_sim.replay_cells`).  `fault` = (fault rows
    [S, F_COLS], JEDEC row [6], uniforms [T, N]) adds the [T, P, S, NC]
    counters.  `chan` = (n_channels, n_ranks, t_burst) with the [P]
    interleave codes `ileave` is the channel geometry."""
    t, p, _ = arrival.shape
    closed_c, arr, bk, rw, wr, val = to_cells(arrival, bank, row, is_write,
                                              valid, closed)
    if fault is not None:
        fault = (fault[0], fault[1], cell_uniforms(
            torch.as_tensor(fault[2], device=arr.device), p))
    out = replay_cells(arr, bk, rw, wr, val,
                       torch.as_tensor(timings, device=arr.device),
                       closed_c > 0.5, n_banks, mlp_window, region_map,
                       fault, chan[0], chan[1],
                       cell_codes(ileave, t, p, arr.device), chan[2])
    return from_cells(*out[:2], t, p, *out[2:])


def replay_grid_adaptive(arrival, bank, row, is_write, valid, tables,
                         bins, scns, tcfg, closed, n_banks: int = 8,
                         mlp_window: int = 8, region_map=None, fault=None,
                         chan=(1, 1, 5.0), ileave=None):
    """arrival/bank/row/is_write [T, P, N]; valid [T, N]; tables
    [K, S+1, 6] or per-bank [K, S+1, banks, 6] (JEDEC row last); bins
    [S]; scns [C, SCN_COLS]; tcfg [6]; closed [P] -> (lat [T, P, K, C,
    N], total [T, P, K, C], temps [T, P, K, C, N], bins [T, P, K, C, N]
    int32, bank_heat [T, P, K, C, banks], (temp_max, temp_mean,
    bin_switches) each [T, P, K, C]).  With `region_map` ([banks * R]
    shared by every stack or [K, banks * R] per stack) `tables` is the
    [K, S+1, U, 6] unique-column stack.  `fault` = (fault rows [F,
    F_COLS], uniforms [T, N]) rides the lanes innermost: every grid
    gains F after C and the return the [T, P, K, C, F, NC] counters.
    `chan` and `ileave` as in `replay_grid`: with C*R > 1 the heat is
    [T, P, K, C, C*R*banks].  The engine runs this plain version, on
    its device, for a multi-channel adaptive campaign (the adaptive
    kernel is single-channel, as the reference's)."""
    t, p, _ = arrival.shape
    dev = arrival.device
    tables = torch.as_tensor(tables, device=dev)
    scns = torch.as_tensor(scns, device=dev)
    k, c = tables.shape[0], scns.shape[0]
    nf = None if fault is None else fault[0].shape[0]
    reps = c * (nf or 1)
    closed_c, arr, bk, rw, wr, val = to_cells(arrival, bank, row, is_write,
                                              valid, closed)
    lane_fault = None
    if fault is not None:
        lane_fault = (lane_faults(torch.as_tensor(fault[0], device=dev),
                                  k * c),
                      cell_uniforms(torch.as_tensor(fault[1], device=dev), p))
    out = replay_adaptive_cells(
        arr, bk, rw, wr, val, lane_tables(tables, reps), bins,
        lane_scenarios(scns, k, nf or 1), tcfg, closed_c > 0.5, n_banks,
        mlp_window, lane_stack_map(region_map, reps, dev), lane_fault,
        n_channels=chan[0], n_ranks=chan[1],
        ileave=cell_codes(ileave, t, p, dev), t_burst=chan[2])
    lat, total, temps, sel, heat, (tmax, tmean, sw) = out[:6]
    return from_lanes((lat, total, tmax, tmean, sw, heat, temps, sel)
                      + out[6:], t, p, k, c, nf)


def adaptive_stream_terms(arrival, valid, scn_t, tcfg, fault_t=None):
    """The stream terms of the adaptive replay, as `adaptive.cu`'s
    producer warps compute them: everything a step needs that depends
    only on the request stream and the lane's scenario or fault row.

    arrival [G, N] float32; valid [G, N]; scn_t [SCN_COLS, L]; tcfg [6];
    fault_t [F_COLS, L] or None -> dict of
      dt [G, N]: max(t - t_prev, 0), t_prev the previous VALID request's
        arrival (0 before the first), as the plain step loop keeps it;
      decay [G, N]: exp(-dt / tau);
      ambient [G, N, L]: `thermal.ambient_at` of the lane's scenario;
    and with `fault_t` ([G, N, L] each) the sensor's lag factor
      alpha (`faults.fault_sensor`'s 1 - exp(-dt / tau_lag), 1 without
      lag), the noise term noise * (2 hash01(seed, k) - 1) (the draw
      skipped, h = 0, where noise is 0), and int32 flags: 1 the stuck-at
      sensor is active, 2 the dropout draw hash01(seed + 1, k) < p.
    Every term is computed at padding requests too (the chain skips
    them)."""
    dev = arrival.device
    t = arrival.to(torch.float32)
    g, n = t.shape
    v = torch.as_tensor(valid, device=dev).bool()
    tcfg = torch.as_tensor(tcfg, dtype=torch.float32, device=dev)
    pos = torch.arange(n, device=dev).expand(g, n)
    last = torch.where(v, pos, -1).cummax(dim=1).values     # <= k
    before = torch.cat([torch.full((g, 1), -1, device=dev),
                        last[:, :-1]], dim=1)                # < k
    t_prev = torch.where(before >= 0, t.gather(1, before.clamp(min=0)),
                         torch.zeros((), device=dev))
    dt = torch.maximum(t - t_prev, torch.zeros((), device=dev))
    out = {"dt": dt, "decay": torch.exp(-dt / tcfg[0]),
           "ambient": ambient_at(scn_t.to(torch.float32), t[..., None])}
    if fault_t is None:
        return out
    fp = fault_t.to(torch.float32)[:, None, None, :]         # [F, 1, 1, L]
    k = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    tl, dl = t[..., None], dt[..., None]
    tau = fp[faults.LAG_TAU]
    lag = torch.exp(-torch.clamp(dl, min=0.0) / torch.clamp(tau, min=1e-9))
    h = torch.where(fp[faults.NOISE] != 0.0, faults.hash01(fp[faults.SEED], k),
                    0.0)
    stuck = (fp[faults.STUCK_FROM] >= 0.0) & (tl >= fp[faults.STUCK_FROM])
    drop = (fp[faults.DROP_P] > 0.0) \
        & (faults.hash01(fp[faults.SEED] + 1.0, k) < fp[faults.DROP_P])
    out["alpha"] = torch.where(tau > 0.0, 1.0 - lag, 1.0).expand(g, n, -1)
    out["noise"] = (fp[faults.NOISE] * (2.0 * h - 1.0)).expand(g, n, -1)
    out["flags"] = (stuck.to(torch.int32)
                    + 2 * drop.to(torch.int32)).expand(g, n, -1)
    return out

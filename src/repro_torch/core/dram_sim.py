"""Trace-driven DRAM bank-timing simulator (port of `repro.core.dram_sim`,
single channel, no faults, FCFS order).

Models an in-order memory controller over `n_banks` banks on one
rank/channel, honoring tRCD / tRAS / tRP / tWR / tCL.  Service latency
per request under the default open-page policy:

  row hit      : tCL
  row empty    : tRCD + tCL
  row conflict : (tRAS remainder) + tRP + tRCD + tCL
  write reuse  : a following conflict additionally waits out tWR

`replay_cells` is the plain version of the `replay_blocks` CUDA kernel
(`repro_torch.kernels.replay`): G request streams replayed under S
timing rows each — module rows [S, 6], per-bank rows [S, banks, 6]
gathered per request from its bank, or the mask-compressed subarray
region store [S, U, 6] gathered through an index map from the request's
(bank, `region_of(row)`) slot — one Python step per request over
[G, ..., S] lane tensors, updating the controller state in place.
`replay_rows` (one stream, S rows) and `replay_one` (one stream, one
row) are its single-stream views.  The arithmetic is float32 add, max
and select only, so every layout is bitwise equal to the JAX reference.

`replay_adaptive_cells` is the plain version of the `adaptive_blocks`
CUDA kernel: the closed thermal loop (`repro_torch.core.thermal`) over
G streams x L lanes, each lane a (timing-table stack, thermal
scenario) pair that re-selects its temperature bin per request, with
module, per-bank or region-compressed table stacks; `replay_adaptive`
is its single-stream view.  The bank state and the per-bank heat stay
per bank whatever the table's spatial layout: only the timing gather
goes through the region map.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.power import access_energy_from_terms
from repro_torch.core.thermal import ambient_at
from repro_torch.core.timing import TimingParams
from repro_torch.device import resolve_device


class Trace(NamedTuple):
    arrival: torch.Tensor    # [N] (or [T, N]) float32 ns, non-decreasing
    bank: torch.Tensor       # int32
    row: torch.Tensor        # int32
    is_write: torch.Tensor   # bool


@dataclasses.dataclass(frozen=True)
class Policy:
    """One memory-controller scheduling policy (a campaign axis).

    page: "open" (default) or "closed" (auto-precharge every access).
    Only FCFS order is ported: `reorder_window` > 1 (FR-FCFS-lite)
    raises.
    """

    page: str = "open"
    reorder_window: int = 0

    def __post_init__(self):
        if self.page not in ("open", "closed"):
            raise ValueError(f"page must be 'open' or 'closed': {self.page}")
        if self.reorder_window > 1:
            raise NotImplementedError(
                "FR-FCFS reordering (reorder_window > 1) is not ported "
                "yet: ROADMAP queue A items 4 and 10")

    @property
    def closed(self) -> bool:
        return self.page == "closed"


OPEN_FCFS = Policy()


def _row_pick(bank: torch.Tensor, new_row: torch.Tensor,
              reuse: torch.Tensor, n_banks: int) -> torch.Tensor:
    """Row-locality recurrence without a scan: request i's row is
    `new_row[j]` for j the LATEST non-reuse request <= i on the same
    bank, or 0 when no fresh access preceded it (a per-bank `cummax`
    over marked indices plus one gather)."""
    n = bank.shape[0]
    idx = torch.arange(n, device=bank.device)
    fresh = torch.where(reuse, torch.full_like(idx, -1), idx)       # [N]
    banks = torch.arange(n_banks, device=bank.device)
    marked = torch.where(bank.long()[None, :] == banks[:, None],
                         fresh[None, :], torch.full_like(fresh, -1))
    latest = torch.cummax(marked, dim=1).values                     # [B, N]
    j = latest[bank.long(), idx]
    return torch.where(j >= 0, new_row[j.clamp(min=0)],
                       torch.zeros_like(new_row))


def synth_trace(generator: torch.Generator, n: int, n_banks: int = 8,
                n_rows: int = 4096, row_hit: float = 0.6,
                write_frac: float = 0.3, inter_arrival_ns: float = 20.0,
                device: str | torch.device = "cuda") -> Trace:
    """Synthetic workload: per-bank row locality with geometric row
    reuse (hit prob `row_hit`), exponential inter-arrival gaps.  Drawn
    from `generator` (a CPU `torch.Generator`, so one seed gives the
    same trace on every device) and placed on `device`."""
    dev = resolve_device(device)
    bank = torch.randint(0, n_banks, (n,), generator=generator,
                         dtype=torch.int32)
    new_row = torch.randint(0, n_rows, (n,), generator=generator,
                            dtype=torch.int32)
    reuse = torch.rand(n, generator=generator) < row_hit
    row = _row_pick(bank, new_row, reuse, n_banks)
    gaps = torch.empty(n, dtype=torch.float32).exponential_(
        generator=generator) * inter_arrival_ns
    arrival = torch.cumsum(gaps, 0)
    is_write = torch.rand(n, generator=generator) < write_frac
    return Trace(arrival.to(dev), bank.to(dev), row.to(dev),
                 is_write.to(dev))


def check_prefix_valid(valid, where: str = "replay") -> None:
    """Enforce the padding-suffix invariant the replay ring gate relies
    on: each trace's `valid` mask is True on a prefix, False after."""
    v = np.asarray(torch.as_tensor(valid).cpu(), bool)
    v = v.reshape(-1, v.shape[-1])
    cnt = v.sum(-1)
    idx = np.arange(v.shape[-1])
    bad = (v != (idx[None, :] < cnt[:, None])).any(-1)
    if bad.any():
        t = int(np.argmax(bad))
        first_gap = int(np.argmin(v[t]))
        raise ValueError(
            f"{where}: `valid` must be a prefix-true mask (padding "
            f"strictly a suffix) — trace row {t} has {int(cnt[t])} valid "
            f"requests but an invalid slot at index {first_gap} is "
            "followed by valid ones")


# Rows per subarray (DDR3 512x512 mats): consecutive row addresses sit
# at consecutive physical positions within a subarray, so the region of
# a row is its position stripe — the same contiguous position -> region
# mapping `MarginEngine.sweep` reduces tail cells under.
SUBARRAY_ROWS = 512


def region_of(row: torch.Tensor, regions: int) -> torch.Tensor:
    """Subarray region id of a row address: which of `regions` equal
    position stripes the row's within-subarray offset falls in, in
    int32 arithmetic `(row mod 512) * regions // 512` (a floored
    modulo, as the reference's).  Exact nesting across levels: l | R
    implies `region_of(r, l) == region_of(r, R) // (R // l)`."""
    r = row if row.dtype == torch.int32 else row.to(torch.int32)
    return torch.remainder(r, SUBARRAY_ROWS) * regions // SUBARRAY_ROWS


def _region_slots(bank, row, region_map, n_banks: int, lanes: int):
    """Validate a region index map ([banks * R] shared, or [lanes,
    banks * R] per lane) and return (map as int64 on the streams'
    device, each request's (bank, region) slot b * R + region_of(row,
    R) as [G, N] int64)."""
    rmap = torch.as_tensor(region_map, device=bank.device).long()
    n_regions = rmap.shape[-1] // n_banks
    if rmap.dim() not in (1, 2) or n_regions < 1 \
            or rmap.shape[-1] != n_banks * n_regions:
        raise ValueError(f"region_map must be [banks * regions] or "
                         f"[lanes, banks * regions] with {n_banks} banks, "
                         f"got {tuple(rmap.shape)}")
    if rmap.dim() == 2 and rmap.shape[0] != lanes:
        raise ValueError(f"per-lane region_map {tuple(rmap.shape)} needs "
                         f"{lanes} lanes")
    slots = bank.long() * n_regions + region_of(row, n_regions).long()
    return rmap, slots


def service_math(t, gate, open_b, act_b, wrd_b, rdy_b, rf, w, trcd,
                 tras, twr, trp, tcl, closed):
    """The per-request timing arithmetic on already-gathered bank state,
    pure elementwise (shared by every replay layout; the CUDA kernel
    repeats it operation for operation).  `open_b`/`rf` carry the
    open-row id as float32 (-1 = precharged).  Returns (row_latched,
    act_new, wr_done_new, ready_new, done, latency, is_hit); latency
    runs from eligibility (the bounded-MLP gate), not the timestamp."""
    start = torch.maximum(torch.maximum(t, rdy_b), gate)
    is_hit = open_b == rf
    is_empty = open_b == -1
    # conflict: precharge only after tRAS from ACT and write recovery
    pre_ok = torch.maximum(act_b + tras, wrd_b)
    conflict_start = torch.maximum(start, pre_ok)
    act_new = torch.where(
        is_hit, act_b,
        torch.where(is_empty, start + 0.0, conflict_start + trp))
    data_start = torch.where(
        is_hit, start,
        torch.where(is_empty, start + trcd, conflict_start + trp + trcd))
    done = data_start + tcl
    wrd_new = torch.where(w, done + twr, wrd_b)
    # closed page: auto-precharge after the burst (after tRAS-from-ACT
    # and write recovery); the row is never left open
    pre_start = torch.maximum(torch.maximum(done, act_new + tras), wrd_new)
    ready_new = torch.where(closed, pre_start + trp, done)
    row_latched = torch.where(closed, torch.full_like(rf, -1), rf)
    return (row_latched, act_new, wrd_new, ready_new, done,
            done - torch.maximum(t, gate), is_hit)


class BankState(NamedTuple):
    """Controller state of G streams x S timing lanes (updated in place
    by `_service`)."""

    bank: torch.Tensor        # [G, B, 4, S] open_row, act, wr_done, ready
    done_ring: torch.Tensor   # [G, W, S] completion times, ring buffer
    idx: torch.Tensor         # [G] int64 served-request counter


def _bank_state0(g: int, n_banks: int, mlp_window: int, s: int,
                 device) -> BankState:
    bank = torch.zeros((g, n_banks, 4, s), dtype=torch.float32,
                       device=device)
    bank[:, :, 0] = -1.0
    return BankState(bank, torch.zeros((g, mlp_window, s),
                                       dtype=torch.float32, device=device),
                     torch.zeros((g,), dtype=torch.int64, device=device))


def _service(st: BankState, t, b, rf, w, v, tc, closed, mlp_window: int):
    """Service one request of every stream ([G] fields) under every
    timing lane: gather the request's bank row and ring gate, apply
    `service_math`, write the update back where the request is valid.
    `tc` = (trcd, tras, twr, trp, tcl), each [S] or per stream [G, S].
    Returns the [G, S] latency (0 at padding) and the [G, S] row-hit
    flags."""
    g_ix = torch.arange(st.bank.shape[0], device=st.bank.device)
    rowb = st.bank[g_ix, b]                          # [G, 4, S]
    slot = st.idx % mlp_window
    gate = st.done_ring[g_ix, slot]                  # [G, S]
    (latched, act_new, wrd_new, rdy_new, done, lat,
     is_hit) = service_math(t[:, None], gate, rowb[:, 0], rowb[:, 1],
                            rowb[:, 2], rowb[:, 3], rf[:, None], w[:, None],
                            *tc, closed[:, None])
    new_row = torch.stack([latched.expand_as(act_new), act_new, wrd_new,
                           rdy_new], dim=1)
    vv = v[:, None]
    st.bank[g_ix, b] = torch.where(vv[:, :, None], new_row, rowb)
    st.done_ring[g_ix, slot] = torch.where(vv, done, gate)
    st.idx.add_(v.to(torch.int64))
    return torch.where(vv, lat, torch.zeros_like(lat)), is_hit


def _timing_cols(tp):
    """(trcd, tras, twr, trp, tcl) of [..., 6] timing rows."""
    return tp[..., 0], tp[..., 1], tp[..., 2], tp[..., 3], tp[..., 5]


def replay_cells(arrival, bank, row, is_write, valid, timings, closed,
                 n_banks: int = 8, mlp_window: int = 8, region_map=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay G request streams, each under every one of S timing rows.

    arrival [G, N] float32; bank/row [G, N] int; is_write/valid [G, N]
    bool (valid False on a padding suffix); timings [S, 6]
    (`TimingParams.as_row` columns) or per-bank [S, n_banks, 6] (each
    request replays under its bank's row); closed [G] bool.  With
    `region_map` (int, [banks * R] shared by every lane or [S, banks *
    R] per lane) `timings` is the unique-row store [S, U, 6] and each
    request replays under row map[bank * R + region_of(row, R)]; R is
    the map length // n_banks.  Returns (latency [G, N, S] with zeros
    at padding, total runtime [G, S]: the module is busy until its last
    ready time or write recovery)."""
    g, n = arrival.shape
    timings = timings.to(torch.float32)
    s_rows = timings.shape[0]
    banked = timings.dim() == 3
    if region_map is not None:
        if not banked:
            raise ValueError("region_map needs [S, U, 6] unique-row stores")
        rmap, slots = _region_slots(bank, row, region_map, n_banks, s_rows)
        lane_i = torch.arange(s_rows, device=arrival.device)
    elif banked and timings.shape[1] != n_banks:
        raise ValueError(f"per-bank timings {tuple(timings.shape)} need "
                         f"{n_banks} banks")
    by_col = timings.permute(1, 0, 2) if banked else None    # [B|U, S, 6]
    tc = None if banked else _timing_cols(timings)
    st = _bank_state0(g, n_banks, mlp_window, s_rows, arrival.device)
    arrival = arrival.to(torch.float32)
    b_all = bank.long()
    rf_all = row.to(torch.float32)
    w_all = is_write.bool()
    v_all = valid.bool()
    closed = closed.bool()
    lat = torch.empty((g, n, s_rows), dtype=torch.float32,
                      device=arrival.device)
    for k in range(n):
        b = b_all[:, k]
        if region_map is None:
            tk = _timing_cols(by_col[b]) if banked else tc
        elif rmap.dim() == 1:
            tk = _timing_cols(by_col[rmap[slots[:, k]]])     # [G, S, 6]
        else:
            tk = _timing_cols(timings[lane_i, rmap[:, slots[:, k]].T])
        lat[:, k] = _service(st, arrival[:, k], b, rf_all[:, k],
                             w_all[:, k], v_all[:, k], tk, closed,
                             mlp_window)[0]
    total = torch.maximum(st.bank[:, :, 3].amax(1), st.bank[:, :, 2].amax(1))
    return lat, total


def replay_rows(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8, region_map=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One trace ([N] fields) under a [S, 6] (or per-bank [S, banks,
    6], or with `region_map` the [S, U, 6] unique-row store, as in
    `replay_cells`) stack of timing rows; `closed` a bool.  Returns
    (latency [S, N], total [S])."""
    closed_t = torch.as_tensor(bool(closed), device=arrival.device)[None]
    lat, total = replay_cells(arrival[None], bank[None], row[None],
                              is_write[None], valid[None], timings,
                              closed_t, n_banks, mlp_window, region_map)
    return lat[0].T, total[0]


def replay_one(arrival, bank, row, is_write, valid, tp_row, closed,
               n_banks: int = 8, mlp_window: int = 8, region_map=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One trace under one [6] timing row (or [banks, 6] per-bank rows,
    or with a [banks * R] `region_map` the [U, 6] unique-row store) ->
    (latency [N], total [])."""
    lat, total = replay_rows(arrival, bank, row, is_write, valid,
                             tp_row[None], closed, n_banks, mlp_window,
                             region_map)
    return lat[0], total[0]


class AdaptiveState(NamedTuple):
    """Closed-loop replay state of G streams x L lanes: the controller
    plus the thermal loop (updated in place by `replay_adaptive_cells`)."""

    bank: BankState
    heat: torch.Tensor         # [G, B, L] per-bank overheat above ambient, C
    cur_bin: torch.Tensor      # [G, L] int64, currently selected bin
    t_prev: torch.Tensor       # [G] last valid request's arrival (ns)


def replay_adaptive_cells(arrival, bank, row, is_write, valid, tables,
                          bins, scns, tcfg, closed, n_banks: int = 8,
                          mlp_window: int = 8, region_map=None):
    """Closed-loop replay of G request streams under L lanes, each lane
    a (timing-table stack, thermal scenario) pair with its own
    controller and RC heat.

    arrival [G, N] float32; bank/row [G, N] int; is_write/valid [G, N]
    bool (valid False on a padding suffix); tables [L, S+1, 6] or
    per-bank [L, S+1, n_banks, 6] float32 (one row per temperature bin,
    the JEDEC fallback row last); bins [S] ascending edges; scns
    [L, SCN_COLS] scenario rows; tcfg [6] `ThermalConfig.as_row`;
    closed [G] bool.  With `region_map` (int, [banks * R] shared or
    [L, banks * R] per lane) `tables` is the unique-column stack
    [L, S+1, U, 6] and each request reads column map[bank * R +
    region_of(row, R)] at its selected bin.

    Per valid request every lane (1) decays its per-bank heat over the
    arrival gap, heat * exp(-dt / tau); (2) senses ambient_at(t) + the
    decayed heats summed bank 0 first, left to right; (3) re-selects
    its bin: up = #edges < reading, down = #edges < reading + hyst,
    new = max(up, min(cur, down)) — index S is the JEDEC row;
    (4) services the request under row (new bin[, request's bank or
    region column]);
    (5) deposits c_heat * access energy (a miss pays ACT/PRE plus the
    selected tRAS window) on the accessed bank.  A padding request
    leaves every state untouched.

    Returns (lat [G, N, L], total [G, L], temps [G, N, L] (0 at
    padding), bins [G, N, L] int32 (-1 at padding), bank heat
    [G, n_banks, L], (temp_max, temp_mean, bin_switches) each [G, L]).
    The diagnostics accumulate in the loop in request order: temp_max
    from -inf, temp_mean as a running float32 sum divided by the valid
    count, bin_switches counting new != current bin on valid requests
    after the first."""
    g, n = arrival.shape
    dev = arrival.device
    tables = tables.to(torch.float32)
    banked = tables.dim() == 4
    lanes = tables.shape[0]
    if region_map is not None:
        if not banked:
            raise ValueError("region_map needs [L, S+1, U, 6] unique-column "
                             "stacks")
        rmap, slots = _region_slots(bank, row, region_map, n_banks, lanes)
    elif banked and tables.shape[2] != n_banks:
        raise ValueError(f"per-bank tables {tuple(tables.shape)} need "
                         f"{n_banks} banks")
    bins = torch.as_tensor(bins, dtype=torch.float32, device=dev)
    if tables.shape[1] != bins.shape[0] + 1:
        raise ValueError(f"tables {tuple(tables.shape)} need "
                         f"{bins.shape[0]} + 1 rows (JEDEC last)")
    tcfg = torch.as_tensor(tcfg, dtype=torch.float32, device=dev)
    scn_t = torch.as_tensor(scns, dtype=torch.float32, device=dev).T
    tau, c_heat, hyst_c, e_burst, e_act_pre, p_as = (tcfg[i]
                                                     for i in range(6))
    hyst = hyst_c * scn_t[8]                             # [L]
    lane = torch.arange(lanes, device=dev)
    g_ix = torch.arange(g, device=dev)
    st = AdaptiveState(
        bank=_bank_state0(g, n_banks, mlp_window, lanes, dev),
        heat=torch.zeros((g, n_banks, lanes), dtype=torch.float32,
                         device=dev),
        cur_bin=torch.zeros((g, lanes), dtype=torch.int64, device=dev),
        t_prev=torch.zeros((g,), dtype=torch.float32, device=dev))
    arrival = arrival.to(torch.float32)
    b_all = bank.long()
    rf_all = row.to(torch.float32)
    w_all = is_write.bool()
    v_all = valid.bool()
    closed = closed.bool()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lat = torch.empty((g, n, lanes), dtype=torch.float32, device=dev)
    temps = torch.empty_like(lat)
    sel = torch.empty((g, n, lanes), dtype=torch.int32, device=dev)
    tmax = torch.full((g, lanes), -torch.inf, dtype=torch.float32,
                      device=dev)
    tsum = torch.zeros((g, lanes), dtype=torch.float32, device=dev)
    switches = torch.zeros((g, lanes), dtype=torch.int32, device=dev)
    for k in range(n):
        t, b, v = arrival[:, k], b_all[:, k], v_all[:, k]
        dt = torch.maximum(t - st.t_prev, zero)
        heat = st.heat * torch.exp(-dt / tau)[:, None, None]
        hsum = heat[:, 0]
        for j in range(1, n_banks):
            hsum = hsum + heat[:, j]
        reading = ambient_at(scn_t, t[:, None]) + hsum       # [G, L]
        up = (bins < reading[..., None]).sum(-1)
        down = (bins < (reading + hyst)[..., None]).sum(-1)
        new_bin = torch.maximum(up, torch.minimum(st.cur_bin, down))
        if region_map is None:
            col = b[:, None] if banked else None
        elif rmap.dim() == 1:
            col = rmap[slots[:, k]][:, None]                 # [G, 1]
        else:
            col = rmap[lane, slots[:, k][:, None]]           # [G, L]
        tp = (tables[lane, new_bin, col] if banked
              else tables[lane, new_bin])                    # [G, L, 6]
        tc = _timing_cols(tp)
        lat[:, k], is_hit = _service(st.bank, t, b, rf_all[:, k],
                                     w_all[:, k], v, tc, closed,
                                     mlp_window)
        energy = access_energy_from_terms(
            e_burst, e_act_pre, p_as, 1.0 - is_hit.to(torch.float32), tc[1])
        heat[g_ix, b] = heat[g_ix, b] + c_heat * energy
        vv = v[:, None]
        st.heat.copy_(torch.where(vv[:, :, None], heat, st.heat))
        switches += (vv & (new_bin != st.cur_bin) & (k > 0)).to(torch.int32)
        st.cur_bin.copy_(torch.where(vv, new_bin, st.cur_bin))
        st.t_prev.copy_(torch.where(v, t, st.t_prev))
        temps[:, k] = torch.where(vv, reading, zero)
        sel[:, k] = torch.where(vv, new_bin, -1).to(torch.int32)
        tmax = torch.maximum(tmax, torch.where(vv, reading, -torch.inf))
        tsum = tsum + torch.where(vv, reading, zero)
    bst = st.bank.bank
    total = torch.maximum(bst[:, :, 3].amax(1), bst[:, :, 2].amax(1))
    tmean = tsum / v_all.sum(-1).to(torch.float32)[:, None]
    return lat, total, temps, sel, st.heat, (tmax, tmean, switches)


def replay_adaptive(arrival, bank, row, is_write, valid, table, bins,
                    scn_row, tcfg_row, closed, n_banks: int = 8,
                    mlp_window: int = 8, n_channels: int = 1,
                    n_ranks: int = 1, ileave=None, t_burst: float = 5.0,
                    fault=None, region_map=None):
    """Closed-loop replay of one trace ([N] fields) under one table
    stack ([S+1, 6] or per-bank [S+1, n_banks, 6], JEDEC row last; with
    a `region_map` of [banks * R] or [banks, R] the unique-column stack
    [S+1, U, 6]) and one scenario row ([SCN_COLS]); `closed` a bool.
    Returns (latency [N], total runtime, sensed temperature [N],
    selected bin [N] int32 (-1 at padding), end-of-trace per-bank
    overheat [n_banks]).  With
    `c_heat = 0` and a steady scenario it equals `replay_one` of the
    selected constant row, bit for bit."""
    if n_channels * n_ranks != 1:
        raise NotImplementedError(
            "multi-channel adaptive replay is not ported yet: ROADMAP "
            "queue A item 10")
    if fault is not None:
        raise NotImplementedError(
            "faulted adaptive replay is not ported yet: ROADMAP queue A "
            "item 9")
    dev = arrival.device
    if region_map is not None:
        region_map = torch.as_tensor(region_map, device=dev).reshape(-1)
    closed_t = torch.as_tensor(bool(closed), device=dev)[None]
    lat, total, temps, sel, heat, _ = replay_adaptive_cells(
        arrival[None], bank[None], row[None], is_write[None], valid[None],
        torch.as_tensor(table, device=dev)[None], bins,
        torch.as_tensor(scn_row, device=dev)[None], tcfg_row, closed_t,
        n_banks, mlp_window, region_map)
    return (lat[0, :, 0], total[0, 0], temps[0, :, 0], sel[0, :, 0],
            heat[0, :, 0])


def simulate(trace: Trace, tp: TimingParams, n_banks: int = 8,
             mlp_window: int = 8, policy: Policy = OPEN_FCFS,
             device: str | torch.device = "cuda") -> dict:
    """Replay one trace under one set of timing parameters (a 1x1x1
    `SimEngine` campaign with host statistics)."""
    from repro_torch.core import sim_engine
    res = sim_engine.SimEngine(stats="host", device=device).run(
        sim_engine.SimSpec(traces=(trace,), timings=tp, policies=(policy,),
                           n_banks=n_banks, mlp_window=mlp_window,
                           collect=("latencies",)))
    return {
        "mean_latency_ns": res.mean_latency_ns[0, 0, 0],
        "p99_latency_ns": res.p99_latency_ns[0, 0, 0],
        "total_ns": res.total_ns[0, 0, 0],
        "latencies": res.latencies[0, 0, 0],
    }

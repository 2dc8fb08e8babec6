"""Trace-driven DRAM bank-timing simulator (port of `repro.core.dram_sim`,
single channel, no faults, no subarray regions, FCFS order).

Models an in-order memory controller over `n_banks` banks on one
rank/channel, honoring tRCD / tRAS / tRP / tWR / tCL.  Service latency
per request under the default open-page policy:

  row hit      : tCL
  row empty    : tRCD + tCL
  row conflict : (tRAS remainder) + tRP + tRCD + tCL
  write reuse  : a following conflict additionally waits out tWR

`replay_cells` is the plain version of the `replay_blocks` CUDA kernel
(`repro_torch.kernels.replay`): G request streams replayed under S
timing rows each, one Python step per request over [G, ..., S] lane
tensors, updating the controller state in place.  `replay_rows` (one
stream, S rows) and `replay_one` (one stream, one row) are its
single-stream views.  The arithmetic is float32 add, max and select
only, so every layout is bitwise equal to the JAX reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

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
    `tc` = (trcd, tras, twr, trp, tcl), each [S].  Returns the [G, S]
    latency (0 at padding)."""
    g_ix = torch.arange(st.bank.shape[0], device=st.bank.device)
    rowb = st.bank[g_ix, b]                          # [G, 4, S]
    slot = st.idx % mlp_window
    gate = st.done_ring[g_ix, slot]                  # [G, S]
    (latched, act_new, wrd_new, rdy_new, done, lat,
     _) = service_math(t[:, None], gate, rowb[:, 0], rowb[:, 1],
                       rowb[:, 2], rowb[:, 3], rf[:, None], w[:, None],
                       *tc, closed[:, None])
    new_row = torch.stack([latched.expand_as(act_new), act_new, wrd_new,
                           rdy_new], dim=1)
    vv = v[:, None]
    st.bank[g_ix, b] = torch.where(vv[:, :, None], new_row, rowb)
    st.done_ring[g_ix, slot] = torch.where(vv, done, gate)
    st.idx.add_(v.to(torch.int64))
    return torch.where(vv, lat, torch.zeros_like(lat))


def replay_cells(arrival, bank, row, is_write, valid, timings, closed,
                 n_banks: int = 8, mlp_window: int = 8
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay G request streams, each under every one of S timing rows.

    arrival [G, N] float32; bank/row [G, N] int; is_write/valid [G, N]
    bool (valid False on a padding suffix); timings [S, 6]
    (`TimingParams.as_row` columns); closed [G] bool.  Returns (latency
    [G, N, S] with zeros at padding, total runtime [G, S]: the module
    is busy until its last ready time or write recovery)."""
    g, n = arrival.shape
    timings = timings.to(torch.float32)
    tc = (timings[:, 0], timings[:, 1], timings[:, 2], timings[:, 3],
          timings[:, 5])
    st = _bank_state0(g, n_banks, mlp_window, timings.shape[0],
                      arrival.device)
    arrival = arrival.to(torch.float32)
    b_all = bank.long()
    rf_all = row.to(torch.float32)
    w_all = is_write.bool()
    v_all = valid.bool()
    closed = closed.bool()
    lat = torch.empty((g, n, timings.shape[0]), dtype=torch.float32,
                      device=arrival.device)
    for k in range(n):
        lat[:, k] = _service(st, arrival[:, k], b_all[:, k], rf_all[:, k],
                             w_all[:, k], v_all[:, k], tc, closed,
                             mlp_window)
    total = torch.maximum(st.bank[:, :, 3].amax(1), st.bank[:, :, 2].amax(1))
    return lat, total


def replay_rows(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One trace ([N] fields) under a [S, 6] stack of timing rows;
    `closed` a bool.  Returns (latency [S, N], total [S])."""
    closed_t = torch.as_tensor(bool(closed), device=arrival.device)[None]
    lat, total = replay_cells(arrival[None], bank[None], row[None],
                              is_write[None], valid[None], timings,
                              closed_t, n_banks, mlp_window)
    return lat[0].T, total[0]


def replay_one(arrival, bank, row, is_write, valid, tp_row, closed,
               n_banks: int = 8, mlp_window: int = 8
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One trace under one [6] timing row -> (latency [N], total [])."""
    lat, total = replay_rows(arrival, bank, row, is_write, valid,
                             tp_row[None], closed, n_banks, mlp_window)
    return lat[0], total[0]


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

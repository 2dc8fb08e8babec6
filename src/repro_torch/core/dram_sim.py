"""Trace-driven DRAM bank-timing simulator (port of `repro.core.dram_sim`).

Models an in-order memory controller over `n_banks` banks per rank,
honoring tRCD / tRAS / tRP / tWR / tCL.  Service latency per request
under the default open-page policy:

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

Both replays take an optional `fault` (`repro_torch.core.faults`): per
lane fault rows, the issue-order error uniforms and, for the static
replay, the JEDEC row.  A faulted lane carries a watchdog that serves
the JEDEC row while tripped, draws a margin-conditioned error per
request (a detected one pays a retry surcharge) and counts detected and
silent errors, trips, degraded requests and probes; the adaptive replay
also reads its temperature through the faulted sensor.  `fault=None`
runs the exact unfaulted arithmetic.

Every replay also takes a multi-channel, multi-rank geometry
(`n_channels`, `n_ranks`, `t_burst`) with a per-stream interleave code
(`ILEAVE_CODES`): each request maps to a (channel, rank) through
`chan_rank`, the bank state grows to C*R*n_banks slots indexed (ch*R +
rank)*n_banks + bank, and a request's issue also waits for its
channel's data bus, busy for `t_burst` ns from each burst start.
Timing tables stay keyed on the rank-level bank.  C*R == 1 runs the
exact single-channel arithmetic.

FR-FCFS-lite reordering (`Policy.reorder_window` > 1) issues, within a
bounded window of pending requests, the oldest one that hits its
bank's open row: `frfcfs_order` is the host oracle, `frfcfs_reorder`
its content-cached host pass, `frfcfs_perm` the device scheduler (one
step per request over a [cells, window] pending buffer) and
`replay_rows_frfcfs` the scheduler merged into the static replay.
`SynthSpec` and `TenantSpec` are declarative trace batches (the
workload pool's knobs, or multi-tenant mixes) that the engine
replays through their cached materialization.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.power import access_energy_from_terms
from repro_torch.core.thermal import ambient_at
from repro_torch.core.timing import TimingParams
from repro_torch.device import resolve_device


class Trace(NamedTuple):
    arrival: torch.Tensor    # [N] (or [T, N]) float32 ns, non-decreasing
    bank: torch.Tensor       # int32
    row: torch.Tensor        # int32
    is_write: torch.Tensor   # bool


# address-interleaving policies: how a request's (bank, row) address maps
# onto the channels of a multi-channel module — "row" keeps whole rows on
# one channel, "cacheline" stripes consecutive addresses across channels,
# "bank_xor" hashes the bank into the channel pick
ILEAVE_CODES = {"row": 0, "cacheline": 1, "bank_xor": 2}


def chan_rank(bank, row, ileave, n_channels: int, n_ranks: int,
              n_banks: int = 8):
    """Elementwise (channel, rank) of each request under interleave
    code(s) `ileave` (broadcast against bank/row), in int32 arithmetic
    with floored modulo and division, as the reference's."""
    c = n_channels
    b = bank if bank.dtype == torch.int32 else bank.to(torch.int32)
    r = row if row.dtype == torch.int32 else row.to(torch.int32)
    il = torch.as_tensor(ileave, dtype=torch.int32, device=b.device)
    addr = r * n_banks + b                         # flat address proxy
    ch = torch.where(il == 0, torch.remainder(r, c),
                     torch.where(il == 1, torch.remainder(addr, c),
                                 torch.remainder(torch.bitwise_xor(b, r), c)))
    rank = torch.remainder(torch.div(r, c, rounding_mode="floor"), n_ranks)
    return ch.to(torch.int32), rank.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Policy:
    """One memory-controller scheduling policy (a campaign axis).

    page: "open" (default) or "closed" (auto-precharge every access).
    reorder_window: FR-FCFS-lite lookahead; <= 1 keeps FCFS order.
    reorder_slack_ns: a row hit is promoted over the head request only
    when it arrives within this slack of the head (waiting longer for a
    hit costs more than the conflict it avoids).
    interleave: address-interleaving policy of a multi-channel campaign
    (one of `ILEAVE_CODES`; inert on one channel).
    """

    page: str = "open"
    reorder_window: int = 0
    reorder_slack_ns: float = 30.0
    interleave: str = "row"

    def __post_init__(self):
        if self.page not in ("open", "closed"):
            raise ValueError(f"page must be 'open' or 'closed': {self.page}")
        if self.interleave not in ILEAVE_CODES:
            raise ValueError(f"interleave must be one of "
                             f"{tuple(ILEAVE_CODES)}: {self.interleave}")

    @property
    def closed(self) -> bool:
        return self.page == "closed"

    @property
    def ileave_code(self) -> int:
        return ILEAVE_CODES[self.interleave]


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


def _trace_generator(seed: int, offset: int) -> torch.Generator:
    """Independent CPU generator of trace `offset` under `seed`: every
    declarative trace row draws from its own, so any subset of rows
    synthesizes bit for bit as its slice of the whole batch."""
    state = np.random.SeedSequence([seed, offset]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _stack_rows(rows, device) -> Trace:
    """Stack per-row [n] traces into one [t, n] batch on `device`."""
    return Trace(*(torch.stack(f).to(device) for f in zip(*rows)))


def _materialize(spec, device) -> tuple[Trace, ...]:
    """The shared `materialize` of the declarative trace specs: the
    rows are drawn once on the host (cached on the spec and counted as
    ONE `perf_model.synth_dispatch_count` synthesis), then copied to
    `device` (cached per device)."""
    dev = resolve_device(device)
    cache = spec._cache
    if "traces" not in cache:
        from repro_torch.core import perf_model        # lazy: no cycle
        perf_model.synth_dispatch_count += 1
        tb = spec.synth("cpu")
        cache["traces"] = tuple(Trace(*(f[i] for f in tb))
                                for i in range(len(spec)))
    key = str(dev)
    if key not in cache:
        cache[key] = (cache["traces"] if dev.type == "cpu" else tuple(
            Trace(*(f.to(dev) for f in t)) for t in cache["traces"]))
    return cache[key]


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """A declarative trace batch: the `synth_trace` knobs of every
    stream instead of materialized tensors.  `sim_engine.SimSpec`
    accepts one as its `traces` axis; the engine replays its cached
    materialization.

    Row i is `synth_trace(_trace_generator(seed, offsets[i]), n,
    n_banks, row_hits[i], write_fracs[i], inter_arrivals[i])`, drawn on
    the host, so a seed gives one trace on every device and the rows
    equal `perf_model.trace_batch`'s bit for bit.  Each row has its own
    generator, so any shard of rows synthesizes bit for bit as its
    slice of the whole batch.

    `materialize()` draws the batch once (cached on the instance,
    counted as ONE `perf_model.synth_dispatch_count` synthesis) and
    returns it as a tuple of `Trace`s."""

    n: int
    offsets: tuple[int, ...]
    row_hits: tuple[float, ...]
    write_fracs: tuple[float, ...]
    inter_arrivals: tuple[float, ...]
    seed: int = 0
    n_banks: int = 8

    def __post_init__(self):
        for f in ("offsets", "row_hits", "write_fracs", "inter_arrivals"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
            if len(getattr(self, f)) != len(self.offsets):
                raise ValueError(f"{f}: {len(getattr(self, f))} entries for "
                                 f"{len(self.offsets)} streams")
        object.__setattr__(self, "_cache", {})

    def __len__(self) -> int:
        return len(self.offsets)

    def stream_knobs(self):
        """The per-stream knob tensors ([T]-leading, CPU; the knobs are
        kept in float64 so each row sees its Python float exactly):
        the tree a sharded campaign splits across devices."""
        f64 = torch.float64
        return (torch.tensor(self.offsets, dtype=torch.int64),
                torch.tensor(self.row_hits, dtype=f64),
                torch.tensor(self.write_fracs, dtype=f64),
                torch.tensor(self.inter_arrivals, dtype=f64))

    def synth_traced(self, knobs, device: str | torch.device = "cuda"
                     ) -> Trace:
        """The [t, n] `Trace` batch of (a shard of) `stream_knobs()`
        rows (on any device: the draws run on the host) on `device`."""
        offs, rhs, wfs, ias = (k.tolist() for k in knobs)
        return _stack_rows(
            [synth_trace(_trace_generator(self.seed, o), self.n,
                         n_banks=self.n_banks, row_hit=rh, write_frac=wf,
                         inter_arrival_ns=ia, device="cpu")
             for o, rh, wf, ia in zip(offs, rhs, wfs, ias)],
            resolve_device(device))

    def synth(self, device: str | torch.device = "cuda") -> Trace:
        """The whole [T, n] batch on `device`."""
        return self.synth_traced(self.stream_knobs(), device)

    def materialize(self, device: str | torch.device = "cuda"
                    ) -> tuple[Trace, ...]:
        """The streams as a tuple of [n] `Trace`s on `device`."""
        return _materialize(self, device)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """A multi-tenant trace batch: each stream is a mixture of tenants
    drawn per request from a shared pool, each tenant with its own
    locality / write / inter-arrival knobs and arrival-rate process
    (`thermal.rate_scenario` rows read by `ambient_at` as a rate
    multiplier).  Like `SynthSpec` it is a declarative trace axis of
    `sim_engine.SimSpec`, replayed through its cached materialization.

    Pool axes ([K] tenants): `row_hits`, `write_fracs`,
    `inter_arrivals`, and `arrivals` — each tenant's rate-scenario row
    ([K][SCN_COLS], `ThermalScenario`s or "poisson" / "bursty" /
    "diurnal"; one entry is cycled over the pool).  Stream axis ([T]):
    `mixes`, the [T][K] tenant weights (normalized by the draw), and
    `offsets`, the per-stream generator ids (default the stream index).

    Per stream and request: a tenant is drawn from the mix, the
    request's locality and write knobs are its tenant's, exponential
    gaps are scaled by the tenant's inter-arrival time and divided by
    its rate (floored at 0.05) at the unmodulated cumulative time.
    Each stream draws from its own CPU `torch.Generator` (seeded from
    `seed` and the stream's offset, as `perf_model.trace_batch` seeds
    its traces): the bits are the port's own, not the reference's
    threefry streams."""

    n: int
    mixes: tuple
    row_hits: tuple[float, ...]
    write_fracs: tuple[float, ...]
    inter_arrivals: tuple[float, ...]
    arrivals: tuple = ("poisson",)
    offsets: tuple[int, ...] = ()
    seed: int = 0
    n_banks: int = 8
    n_rows: int = 4096

    def __post_init__(self):
        from repro_torch.core import thermal
        k = len(self.row_hits)
        mixes = tuple(tuple(float(x) for x in m) for m in self.mixes)
        if not mixes or any(len(m) != k for m in mixes):
            raise ValueError(f"mixes must be [T][{k}] tenant weights")
        rows = []
        for a in (self.arrivals if len(self.arrivals) > 1
                  else tuple(self.arrivals) * k):
            if isinstance(a, str):
                a = thermal.rate_scenario(a)
            if isinstance(a, thermal.ThermalScenario):
                a = a.as_row()
            rows.append(tuple(float(x) for x in np.asarray(a)))
        if len(rows) != k:
            raise ValueError(f"arrivals: {len(rows)} rows for {k} tenants")
        offsets = (tuple(range(len(mixes))) if not self.offsets
                   else tuple(int(o) for o in self.offsets))
        if len(offsets) != len(mixes):
            raise ValueError(f"offsets: {len(offsets)} for {len(mixes)} "
                             "streams")
        object.__setattr__(self, "mixes", mixes)
        object.__setattr__(self, "arrivals", tuple(rows))
        object.__setattr__(self, "offsets", offsets)
        for f in ("row_hits", "write_fracs", "inter_arrivals"):
            object.__setattr__(
                self, f, tuple(float(x) for x in getattr(self, f)))
            if len(getattr(self, f)) != k:
                raise ValueError(f"{f}: {len(getattr(self, f))} for {k} "
                                 "tenants")
        object.__setattr__(self, "_cache", {})

    def __len__(self) -> int:
        return len(self.mixes)

    def stream_knobs(self):
        """The per-stream rows ([T]-leading, CPU): offsets and the
        float64 [T, K] mixes, the tree a sharded campaign splits."""
        return (torch.tensor(self.offsets, dtype=torch.int64),
                torch.tensor(self.mixes, dtype=torch.float64))

    def _stream(self, offset: int, mix: torch.Tensor) -> Trace:
        gen = _trace_generator(self.seed, offset)
        f32 = torch.float32
        rhs = torch.tensor(self.row_hits, dtype=f32)
        wfs = torch.tensor(self.write_fracs, dtype=f32)
        ias = torch.tensor(self.inter_arrivals, dtype=f32)
        scn = torch.tensor(self.arrivals, dtype=f32)            # [K, SCN]
        tenant = torch.multinomial(mix + 1e-9, self.n, replacement=True,
                                   generator=gen)
        bank = torch.randint(0, self.n_banks, (self.n,), generator=gen,
                             dtype=torch.int32)
        new_row = torch.randint(0, self.n_rows, (self.n,), generator=gen,
                                dtype=torch.int32)
        reuse = torch.rand(self.n, generator=gen) < rhs[tenant]
        row = _row_pick(bank, new_row, reuse, self.n_banks)
        is_write = torch.rand(self.n, generator=gen) < wfs[tenant]
        gaps = torch.empty(self.n, dtype=f32).exponential_(
            generator=gen) * ias[tenant]
        rate = ambient_at(scn[tenant].T, torch.cumsum(gaps, 0))
        arrival = torch.cumsum(gaps / torch.clamp(rate, min=0.05), 0)
        return Trace(arrival, bank, row, is_write)

    def synth_traced(self, knobs, device: str | torch.device = "cuda"
                     ) -> Trace:
        """The [t, n] `Trace` batch of (a shard of) `stream_knobs()`
        rows (on any device: the draws run on the host) on `device`."""
        offs, mixes = (k.cpu() for k in knobs)
        return _stack_rows([self._stream(int(o), m)
                            for o, m in zip(offs.tolist(), mixes)],
                           resolve_device(device))

    def synth(self, device: str | torch.device = "cuda") -> Trace:
        """The whole [T, n] batch on `device`."""
        return self.synth_traced(self.stream_knobs(), device)

    def materialize(self, device: str | torch.device = "cuda"
                    ) -> tuple[Trace, ...]:
        """The streams as a tuple of [n] `Trace`s on `device`."""
        return _materialize(self, device)


# the declarative trace axes `sim_engine.SimSpec` accepts
SYNTH_SPECS = (SynthSpec, TenantSpec)


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


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def frfcfs_order(trace: Trace, window: int, slack_ns: float = 30.0,
                 max_defer: int | None = None) -> np.ndarray:
    """Issue-order permutation of FR-FCFS-lite, the host oracle: among
    the next `window` pending requests, issue the oldest one hitting
    its bank's open row (else the oldest request).  A candidate is
    promoted only when it arrives within `slack_ns` of the head
    request, and a starvation cap forces the head out after
    `max_defer` (default 4 * window) consecutive deferrals.  The
    horizon arithmetic is float32, as `frfcfs_perm`'s."""
    arrival = _host(trace.arrival).astype(np.float32)
    bank = _host(trace.bank)
    row = _host(trace.row)
    n = arrival.shape[0]
    cap = 4 * window if max_defer is None else max_defer
    slack = np.float32(slack_ns)
    order = np.empty(n, np.int64)
    open_row: dict[int, int] = {}
    pend = list(range(n))
    defer = 0
    for k in range(n):
        pick = 0
        if defer < cap:
            horizon = np.float32(arrival[pend[0]] + slack)
            for j in range(min(window, len(pend))):
                idx = pend[j]
                if (arrival[idx] <= horizon and
                        open_row.get(int(bank[idx]), -1) == int(row[idx])):
                    pick = j
                    break
        idx = pend.pop(pick)
        defer = defer + 1 if pick > 0 else 0
        open_row[int(bank[idx])] = int(row[idx])
        order[k] = idx
    return order


# Host-reorder results cached across `SimSpec.pack()` calls, keyed on a
# content digest of the trace (not its identity: an array mutated in place
# must not hit a stale permutation) plus the policy knobs; LRU-evicted.
_REORDER_CACHE: "dict[tuple, Trace]" = {}
_REORDER_CACHE_MAX = 128


def _trace_digest(trace: Trace) -> bytes:
    """Content digest of every request field."""
    h = hashlib.blake2b(digest_size=16)
    for f in trace:
        a = np.ascontiguousarray(_host(f))
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.digest()


def frfcfs_reorder(trace: Trace, window: int, slack_ns: float = 30.0,
                   max_defer: int | None = None) -> Trace:
    """FR-FCFS-lite on the host (`frfcfs_order`): the requests keep
    their arrival times, only the issue order changes.  Returns a
    `Trace` of read-only numpy arrays, cached on (content digest,
    window, slack, cap): a returned trace is shared by later equal
    lookups, so mutating it raises.  `window <= 1` returns `trace`."""
    if window <= 1:
        return trace
    key = (_trace_digest(trace), window, float(slack_ns), max_defer)
    hit = _REORDER_CACHE.pop(key, None)
    if hit is not None:
        _REORDER_CACHE[key] = hit             # refresh the LRU position
        return hit
    order = frfcfs_order(trace, window, slack_ns, max_defer)
    fields = []
    for f in trace:
        a = _host(f)[order]
        a.flags.writeable = False
        fields.append(a)
    out = Trace(*fields)
    while len(_REORDER_CACHE) >= _REORDER_CACHE_MAX:
        _REORDER_CACHE.pop(next(iter(_REORDER_CACHE)))
    _REORDER_CACHE[key] = out
    return out


def frfcfs_perm(arrival, bank, row, valid, window, slack_ns, cap,
                max_window: int, n_banks: int = 8) -> torch.Tensor:
    """The device scheduler of `frfcfs_order`: the issue-order
    permutation (int64) of each padded stream, computed on the streams'
    device with one step per request over a [cells, max_window] buffer
    of the first pending requests (the only candidates FR-FCFS-lite
    ever promotes), the per-bank open rows and the starvation counter.

    arrival/bank/row/valid [N] or [cells, N]; `window`, `slack_ns` and
    `cap` scalars or one per cell; `max_window` the buffer size (>=
    every cell's window, <= N).  `window <= 1` gives the identity.
    Padding (`valid` False) must be a suffix: padded slots are never
    promoted, so they drain in order after the last real request.
    Plain torch: the reference formulation is a `lax.scan`, never a
    Pallas kernel."""
    single = arrival.dim() == 1
    if single:
        arrival, bank, row, valid = (x[None] for x in (arrival, bank, row,
                                                       valid))
    c, n = arrival.shape
    w = int(max_window)
    if not 1 <= w <= n:
        raise ValueError(f"max_window {w} must lie in [1, {n}]")
    dev = arrival.device

    def per_cell(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).reshape(-1) \
            .expand(c)

    window = per_cell(window, torch.int64)
    slack = per_cell(slack_ns, torch.float32)
    cap = per_cell(cap, torch.int32)
    # the streams with one sentinel column at index n: the refill once
    # the stream runs dry, never valid, so it drains in order
    def ext(x, fill):
        return torch.cat([x, fill], 1)

    a = ext(arrival.to(torch.float32), arrival[:, -1:].to(torch.float32))
    b = ext(bank.long(), bank[:, -1:].long())
    r = ext(row.to(torch.int32), row[:, -1:].to(torch.int32))
    v = ext(valid.bool(), torch.zeros((c, 1), dtype=torch.bool, device=dev))
    slots = torch.arange(w, device=dev)
    slot_ok = slots[None, :] < window[:, None]
    i_buf = slots[None, :].expand(c, w).contiguous()    # stream indices
    open_row = torch.full((c, n_banks), -1, dtype=torch.int32, device=dev)
    defer = torch.zeros(c, dtype=torch.int32, device=dev)
    perm = torch.empty((c, n), dtype=torch.int64, device=dev)
    for k in range(n):
        b_buf = b.gather(1, i_buf)
        r_buf = r.gather(1, i_buf)
        a_buf = a.gather(1, i_buf)
        hit = open_row.gather(1, b_buf) == r_buf
        horizon = a_buf[:, :1] + slack[:, None]
        elig = hit & (a_buf <= horizon) & v.gather(1, i_buf) & slot_ok
        promo = elig.any(1) & (defer < cap)
        pick = torch.where(promo, elig.to(torch.uint8).argmax(1),
                           0)[:, None]
        perm[:, k] = i_buf.gather(1, pick)[:, 0]
        open_row.scatter_(1, b_buf.gather(1, pick), r_buf.gather(1, pick))
        defer = torch.where(pick[:, 0] > 0, defer + 1, 0)
        # shift the buffer left past the picked slot; the freed last
        # slot refills from the stream (the sentinel once it runs dry)
        fill = torch.full((c, 1), min(w + k, n), dtype=torch.int64,
                          device=dev)
        i_buf = torch.cat([i_buf, fill], 1).gather(
            1, slots[None, :] + (slots[None, :] >= pick))
    return perm[0] if single else perm


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
    by `_service`); the bank axis holds C*R*n_banks slots."""

    bank: torch.Tensor        # [G, slots, 4, S] open_row, act, wr_done, ready
    done_ring: torch.Tensor   # [G, W, S] completion times, ring buffer
    idx: torch.Tensor         # [G] int64 served-request counter
    chan_free: torch.Tensor | None = None   # [G, C, S] bus free (C*R > 1)


def _bank_state0(g: int, n_slots: int, mlp_window: int, s: int,
                 device, n_channels: int = 0) -> BankState:
    """Zero state; `n_channels` > 0 adds the per-channel bus-free row."""
    bank = torch.zeros((g, n_slots, 4, s), dtype=torch.float32,
                       device=device)
    bank[:, :, 0] = -1.0
    cf = (torch.zeros((g, n_channels, s), dtype=torch.float32,
                      device=device) if n_channels else None)
    return BankState(bank, torch.zeros((g, mlp_window, s),
                                       dtype=torch.float32, device=device),
                     torch.zeros((g,), dtype=torch.int64, device=device), cf)


def _chan_slots(bank, row, ileave, chan, n_banks: int):
    """Each request's channel and global bank slot ((ch*R + rank)*B +
    bank), both [G, N] int64, for `chan` = (C, R, t_burst) with C*R > 1;
    `ileave` is one code or one per stream ([G])."""
    il = torch.as_tensor(0 if ileave is None else ileave, device=bank.device)
    if il.dim():
        il = il[:, None]
    ch, rk = chan_rank(bank, row, il, chan[0], chan[1], n_banks)
    return ch.long(), (ch.long() * chan[1] + rk.long()) * n_banks \
        + bank.long()


def _service(st: BankState, t, b, rf, w, v, tc, closed, mlp_window: int,
             surcharge=None, ch=None, t_burst: float = 0.0):
    """Service one request of every stream ([G] fields) under every
    timing lane: gather the request's bank row and ring gate, apply
    `service_math`, write the update back where the request is valid.
    `b` is the request's bank slot; `tc` = (trcd, tras, twr, trp, tcl),
    each [S] or per stream [G, S].  `surcharge` ([G, S], optional) is
    the detected-error retry delay, added to the completion, the
    latency, a write's recovery and the bank's readiness (the bank stays
    busy through the re-issue).  With `ch` ([G] channels) the issue
    also waits for the channel's bus, which then stays busy for
    `t_burst` from the burst start (done - tCL).  Returns the [G, S]
    latency (0 at padding) and the [G, S] row-hit flags."""
    g_ix = torch.arange(st.bank.shape[0], device=st.bank.device)
    rowb = st.bank[g_ix, b]                          # [G, 4, S]
    slot = st.idx % mlp_window
    gate0 = st.done_ring[g_ix, slot]                 # [G, S]
    gate = gate0
    if ch is not None:
        cf_b = st.chan_free[g_ix, ch]
        gate = torch.maximum(gate0, cf_b)
    (latched, act_new, wrd_new, rdy_new, done, lat,
     is_hit) = service_math(t[:, None], gate, rowb[:, 0], rowb[:, 1],
                            rowb[:, 2], rowb[:, 3], rf[:, None], w[:, None],
                            *tc, closed[:, None])
    if surcharge is not None:
        done = done + surcharge
        lat = lat + surcharge
        wrd_new = torch.where(w[:, None], wrd_new + surcharge, wrd_new)
        rdy_new = rdy_new + surcharge
    new_row = torch.stack([latched.expand_as(act_new), act_new, wrd_new,
                           rdy_new], dim=1)
    vv = v[:, None]
    st.bank[g_ix, b] = torch.where(vv[:, :, None], new_row, rowb)
    st.done_ring[g_ix, slot] = torch.where(vv, done, gate0)
    if ch is not None:
        st.chan_free[g_ix, ch] = torch.where(vv, done - tc[4] + t_burst,
                                             cf_b)
    st.idx.add_(v.to(torch.int64))
    return torch.where(vv, lat, torch.zeros_like(lat)), is_hit


def _timing_cols(tp):
    """(trcd, tras, twr, trp, tcl) of [..., 6] timing rows."""
    return tp[..., 0], tp[..., 1], tp[..., 2], tp[..., 3], tp[..., 5]


def _counters0(shape, device):
    """The N_COUNTERS int32 fault counters, zero."""
    return tuple(torch.zeros(shape, dtype=torch.int32, device=device)
                 for _ in range(faults.N_COUNTERS))


def _fault_step(fp, wd, cnt, det, sil, is_probe, v, implaus=None):
    """The watchdog transition and counter update of one request ([G,
    L] fields; fault state kept where the request is padding).  Returns
    (wd', cnt')."""
    degraded = wd[4] > 0
    if implaus is None:
        implaus = torch.zeros_like(det)
    wd2, new_trip = faults.wd_update(fp, wd, det, implaus, is_probe)
    vv = v[:, None]
    wd2 = tuple(torch.where(vv, x, y) for x, y in zip(wd2, wd))
    return wd2, faults.counter_update(cnt, vv, det, sil, new_trip, degraded,
                                      is_probe)


def _red(tc, jed):
    """Fractional timing reduction of the served (trcd, tras, twr, trp,
    tcl) columns against the JEDEC row's, floored at 0 — a true division
    by the JEDEC sum tensor."""
    jsum = jed[0] + jed[1] + jed[2] + jed[3]
    return torch.clamp(1.0 - (tc[0] + tc[1] + tc[2] + tc[3]) / jsum, min=0.0)


def replay_cells(arrival, bank, row, is_write, valid, timings, closed,
                 n_banks: int = 8, mlp_window: int = 8, region_map=None,
                 fault=None, n_channels: int = 1, n_ranks: int = 1,
                 ileave=None, t_burst: float = 5.0):
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
    ready time or write recovery).

    `fault` = (fault rows [S, F_COLS], JEDEC row [6], uniforms [G, N])
    replays lane s under fault row s: its watchdog serves the JEDEC row
    while tripped, each request draws an error from its uniform against
    `faults.error_prob(red, 0)`, and a detected error pays the JEDEC
    tCL + RETRY_NS.  The return then gains the [N_COUNTERS, G, S] int32
    counters (detected, silent, trips, degraded, probes).

    With `n_channels * n_ranks` > 1 the bank state holds C*R*n_banks
    slots and a [G, C, S] bus-free row: request (bank, row) of stream g
    maps through `chan_rank(ileave[g])` (`ileave` one code or [G]
    codes), waits for max(ring gate, its channel's bus) and leaves the
    bus busy until done - tCL + `t_burst`.  The timing gather stays on
    the rank-level bank."""
    g, n = arrival.shape
    dev = arrival.device
    timings = timings.to(torch.float32)
    s_rows = timings.shape[0]
    banked = timings.dim() == 3
    if region_map is not None:
        if not banked:
            raise ValueError("region_map needs [S, U, 6] unique-row stores")
        rmap, slots = _region_slots(bank, row, region_map, n_banks, s_rows)
        lane_i = torch.arange(s_rows, device=dev)
    elif banked and timings.shape[1] != n_banks:
        raise ValueError(f"per-bank timings {tuple(timings.shape)} need "
                         f"{n_banks} banks")
    by_col = timings.permute(1, 0, 2) if banked else None    # [B|U, S, 6]
    tc = None if banked else _timing_cols(timings)
    multi = n_channels * n_ranks > 1
    st = _bank_state0(g, n_channels * n_ranks * n_banks, mlp_window, s_rows,
                      dev, n_channels if multi else 0)
    if multi:
        ch_all, gb_all = _chan_slots(bank, row, ileave,
                                     (n_channels, n_ranks), n_banks)
    arrival = arrival.to(torch.float32)
    b_all = bank.long()
    rf_all = row.to(torch.float32)
    w_all = is_write.bool()
    v_all = valid.bool()
    closed = closed.bool()
    lat = torch.empty((g, n, s_rows), dtype=torch.float32, device=dev)
    if fault is not None:
        f_rows, j_row, u_all = fault
        fp = torch.as_tensor(f_rows, dtype=torch.float32, device=dev).T
        if tuple(fp.shape) != (faults.F_COLS, s_rows):
            raise ValueError(f"fault rows must be [{s_rows}, {faults.F_COLS}]"
                             f", got {tuple(f_rows.shape)}")
        jed = torch.as_tensor(j_row, dtype=torch.float32, device=dev)
        j5 = _timing_cols(jed)
        u_all = torch.as_tensor(u_all, dtype=torch.float32, device=dev)
        wd = faults.wd_state0((g, s_rows), device=dev)
        cnt = _counters0((g, s_rows), dev)
    for k in range(n):
        b = b_all[:, k]
        if region_map is None:
            tk = _timing_cols(by_col[b]) if banked else tc
        elif rmap.dim() == 1:
            tk = _timing_cols(by_col[rmap[slots[:, k]]])     # [G, S, 6]
        else:
            tk = _timing_cols(timings[lane_i, rmap[:, slots[:, k]].T])
        sur = None
        if fault is not None:
            is_probe, use_agg = faults.wd_gate(fp, wd)
            tk = tuple(torch.where(use_agg, a, jb) for a, jb in zip(tk, j5))
            p = faults.error_prob(fp, _red(tk, j5), 0.0)
            _, det, sil = faults.error_draw(fp, u_all[:, k, None], p)
            sur = torch.where(det, j5[4] + fp[faults.RETRY_NS], 0.0)
        lat[:, k] = _service(st, arrival[:, k],
                             gb_all[:, k] if multi else b, rf_all[:, k],
                             w_all[:, k], v_all[:, k], tk, closed,
                             mlp_window, surcharge=sur,
                             ch=ch_all[:, k] if multi else None,
                             t_burst=t_burst)[0]
        if fault is not None:
            wd, cnt = _fault_step(fp, wd, cnt, det, sil, is_probe,
                                  v_all[:, k])
    total = torch.maximum(st.bank[:, :, 3].amax(1), st.bank[:, :, 2].amax(1))
    if fault is not None:
        return lat, total, torch.stack(cnt)
    return lat, total


def replay_rows(arrival, bank, row, is_write, valid, timings, closed,
                n_banks: int = 8, mlp_window: int = 8, region_map=None,
                fault=None, n_channels: int = 1, n_ranks: int = 1,
                ileave=None, t_burst: float = 5.0):
    """One trace ([N] fields) under a [S, 6] (or per-bank [S, banks,
    6], or with `region_map` the [S, U, 6] unique-row store, as in
    `replay_cells`) stack of timing rows; `closed` a bool; `ileave` one
    interleave code.  Returns (latency [S, N], total [S]); with `fault`
    = (fault rows [S, F_COLS], JEDEC row [6], uniforms [N]) also the
    [N_COUNTERS, S] counters."""
    closed_t = torch.as_tensor(bool(closed), device=arrival.device)[None]
    if fault is not None:
        fault = (fault[0], fault[1],
                 torch.as_tensor(fault[2], device=arrival.device)[None])
    out = replay_cells(arrival[None], bank[None], row[None], is_write[None],
                       valid[None], timings, closed_t, n_banks, mlp_window,
                       region_map, fault, n_channels, n_ranks, ileave,
                       t_burst)
    if fault is not None:
        return out[0][0].T, out[1][0], out[2][:, 0]
    return out[0][0].T, out[1][0]


def replay_one(arrival, bank, row, is_write, valid, tp_row, closed,
               n_banks: int = 8, mlp_window: int = 8, region_map=None,
               fault=None, n_channels: int = 1, n_ranks: int = 1,
               ileave=None, t_burst: float = 5.0):
    """One trace under one [6] timing row (or [banks, 6] per-bank rows,
    or with a [banks * R] `region_map` the [U, 6] unique-row store) ->
    (latency [N], total []); with `fault` = (fault row [F_COLS], JEDEC
    row [6], uniforms [N]) also the [N_COUNTERS] counters.  The channel
    geometry is `replay_cells`'."""
    if fault is not None:
        fault = (torch.as_tensor(fault[0])[None], fault[1], fault[2])
    out = replay_rows(arrival, bank, row, is_write, valid, tp_row[None],
                      closed, n_banks, mlp_window, region_map, fault,
                      n_channels, n_ranks, ileave, t_burst)
    return tuple(x[..., 0] if i == 2 else x[0] for i, x in enumerate(out))


def replay_rows_frfcfs(arrival, bank, row, is_write, valid, timings,
                       closed, window, slack_ns, cap, max_window: int,
                       n_banks: int = 8, mlp_window: int = 8,
                       all_valid: bool = False, n_channels: int = 1,
                       n_ranks: int = 1, ileave=None, t_burst: float = 5.0,
                       fault=None, region_map=None):
    """FR-FCFS-lite merged into the static replay: one step per request
    both picks the request to issue (`frfcfs_perm`'s pending-buffer
    scheduler, operation for operation) and services it against
    `replay_rows`' lane-major state, so it equals `replay_rows` of the
    `frfcfs_perm`-permuted stream bit for bit.

    One stream ([N] fields); `timings` [S, 6], per-bank [S, banks, 6]
    or with `region_map` ([banks * R] or [S, banks * R]) the [S, U, 6]
    store; `closed` a bool; `window`, `slack_ns`, `cap` the policy's
    knobs (`window <= 1` is FCFS); `max_window` the buffer size.  The
    stream is packed [5, N+1] in float32 (bank and row ids exact below
    2**24) with a sentinel column whose row, -2, never matches an open
    row.  `all_valid=True` asserts no padding and runs the ring as a
    roll.  The scheduler keys its open rows on the rank-level bank; the
    service half carries the channel state of `replay_cells`.  `fault`
    = (fault rows [S, F_COLS], JEDEC row [6], uniforms [N]) consumes
    the uniforms by ISSUE step, as the prepass pipeline does.

    Returns (latency [S, N] in issue order, total [S]) and, with
    `fault`, the [N_COUNTERS, S] counters."""
    n = arrival.shape[0]
    w = int(max_window)
    if not 1 <= w <= n:
        raise ValueError(f"max_window {w} must lie in [1, {n}]")
    dev = arrival.device
    f32 = torch.float32
    timings = timings.to(f32)
    s_rows = timings.shape[0]
    banked = timings.dim() == 3
    multi = n_channels * n_ranks > 1
    if region_map is not None:
        if not banked:
            raise ValueError("region_map needs [S, U, 6] unique-row stores")
        rmap = torch.as_tensor(region_map, device=dev).long()
        n_regions = rmap.shape[-1] // n_banks
        lane_i = torch.arange(s_rows, device=dev)
    elif banked and timings.shape[1] != n_banks:
        raise ValueError(f"per-bank timings {tuple(timings.shape)} need "
                         f"{n_banks} banks")
    by_col = timings.permute(1, 0, 2) if banked else None    # [B|U, S, 6]
    tc0 = None if banked else _timing_cols(timings)
    il = torch.as_tensor(0 if ileave is None else ileave, dtype=torch.int32,
                         device=dev)
    closed_t = torch.as_tensor(bool(closed), device=dev)
    window = torch.as_tensor(window, device=dev)
    slack = torch.as_tensor(slack_ns, dtype=f32, device=dev)
    cap = torch.as_tensor(cap, device=dev)
    stream = torch.cat([
        torch.stack([arrival.to(f32), bank.to(f32), row.to(f32),
                     is_write.to(f32), valid.to(f32)]),
        torch.tensor([[0.0], [0.0], [-2.0], [0.0], [0.0]], device=dev)], 1)
    slots = torch.arange(w, device=dev)
    buf = stream[:, :w].clone()                       # pending buffer
    open_pred = torch.full((n_banks,), -1.0, device=dev)
    defer = torch.zeros((), dtype=torch.int32, device=dev)
    st = _bank_state0(1, n_channels * n_ranks * n_banks, mlp_window, s_rows,
                      dev, n_channels if multi else 0)
    lat = torch.empty((n, s_rows), dtype=f32, device=dev)
    if fault is not None:
        f_rows, j_row, u_all = fault
        fp = torch.as_tensor(f_rows, dtype=f32, device=dev).T
        jed = torch.as_tensor(j_row, dtype=f32, device=dev)
        j5 = _timing_cols(jed)
        u_all = torch.as_tensor(u_all, dtype=f32, device=dev)
        wd = faults.wd_state0((1, s_rows), device=dev)
        cnt = _counters0((1, s_rows), dev)
    for k in range(n):
        # scheduler: pick the issue slot (mirrors frfcfs_perm)
        b_int = buf[1].long()
        hit = open_pred[b_int] == buf[2]
        horizon = buf[0, 0] + slack
        elig = hit & (buf[0] <= horizon) & (buf[4] > 0) & (slots < window)
        promo = elig.any() & (defer < cap)
        pick = torch.where(promo, elig.to(torch.uint8).argmax(), 0)
        req = buf[:, pick]
        t, rf, v = req[0], req[2], req[4] > 0
        b = req[1].long()
        wr = req[3] > 0
        open_pred[b] = rf
        defer = torch.where(pick > 0, defer + 1, 0)
        shifted = torch.cat([buf[:, 1:], stream[:, min(w + k, n), None]], 1)
        buf = torch.where(slots[None, :] >= pick, shifted, buf)
        # service: replay_cells' state, one stream
        gb = b
        ch = None
        if multi:
            ch, rk = chan_rank(b.to(torch.int32), rf.to(torch.int32), il,
                               n_channels, n_ranks, n_banks)
            ch = ch.long()
            gb = (ch * n_ranks + rk.long()) * n_banks + b
        if region_map is not None:
            g_id = b * n_regions + region_of(rf, n_regions).long()
            tk = (_timing_cols(timings[lane_i, rmap[:, g_id]])
                  if rmap.dim() == 2 else _timing_cols(by_col[rmap[g_id]]))
        else:
            tk = _timing_cols(by_col[b]) if banked else tc0
        sur = None
        if fault is not None:
            is_probe, use_agg = faults.wd_gate(fp, wd)
            tk = tuple(torch.where(use_agg, a, jb) for a, jb in zip(tk, j5))
            p = faults.error_prob(fp, _red(tk, j5), 0.0)
            _, det, sil = faults.error_draw(fp, u_all[k], p)
            sur = torch.where(det, j5[4] + fp[faults.RETRY_NS], 0.0)
        if all_valid:
            st.idx.zero_()          # the gate is the rolled ring's head
        lat[k] = _service(st, t[None], gb[None], rf[None], wr[None],
                          v[None], tk, closed_t[None], mlp_window,
                          surcharge=sur,
                          ch=None if ch is None else ch[None],
                          t_burst=t_burst)[0][0]
        if all_valid:               # ring <- ring[1:] + [done]
            st.done_ring.copy_(st.done_ring.roll(-1, 1))
        if fault is not None:
            wd, cnt = _fault_step(fp, wd, cnt, det, sil, is_probe, v[None])
    total = torch.maximum(st.bank[0, :, 3].amax(0), st.bank[0, :, 2].amax(0))
    if fault is not None:
        return lat.T, total, torch.stack(cnt)[:, 0]
    return lat.T, total


class AdaptiveState(NamedTuple):
    """Closed-loop replay state of G streams x L lanes: the controller
    plus the thermal loop (updated in place by `replay_adaptive_cells`)."""

    bank: BankState
    heat: torch.Tensor         # [G, B, L] per-bank overheat above ambient, C
    cur_bin: torch.Tensor      # [G, L] int64, currently selected bin
    t_prev: torch.Tensor       # [G] last valid request's arrival (ns)


def replay_adaptive_cells(arrival, bank, row, is_write, valid, tables,
                          bins, scns, tcfg, closed, n_banks: int = 8,
                          mlp_window: int = 8, region_map=None, fault=None,
                          probs: bool = False, n_channels: int = 1,
                          n_ranks: int = 1, ileave=None,
                          t_burst: float = 5.0):
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

    `fault` = (fault rows [L, F_COLS], uniforms [G, N]): the reading
    of step (3) is `faults.fault_sensor` of the true sensed temperature
    (request counter = position k); the watchdog serves the JEDEC row
    (index S) while tripped, except on probes; each request draws an
    error against `faults.error_prob` of the served row's reduction vs
    the JEDEC row of its column and the TRUE temperature's excess over
    the served bin's upper edge (+inf for the JEDEC row); a detected
    error pays the JEDEC tCL + RETRY_NS; the implausibility check
    compares the reading with the previous one.  The emitted temps,
    temp_max/temp_mean report the reading, the bins the served bin, and
    bin_switches count the served bin against the previous served one.

    Returns (lat [G, N, L], total [G, L], temps [G, N, L] (0 at
    padding), bins [G, N, L] int32 (-1 at padding), bank heat
    [G, n_banks, L], (temp_max, temp_mean, bin_switches) each [G, L]).
    The diagnostics accumulate in the loop in request order: temp_max
    from -inf, temp_mean as a running float32 sum divided by the valid
    count, bin_switches counting changes on valid requests after the
    first.  With `fault` the return gains the [N_COUNTERS, G, L] int32
    counters and, with `probs`, the [G, N, L] error probabilities (0 at
    padding; a diagnostic).

    The channel geometry is `replay_cells`': with C*R > 1 the bank state
    and the heat grow to C*R*n_banks slots (the sensor sums all of
    them, slot 0 first, and the returned heat is [G, C*R*n_banks, L]),
    the timing gather stays on the rank-level bank, and each request
    also waits for its channel's bus.  The adaptive kernel is
    single-channel, as the reference's: a multi-channel campaign runs
    this plain step loop on its device."""
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
    multi = n_channels * n_ranks > 1
    n_slots = n_channels * n_ranks * n_banks
    st = AdaptiveState(
        bank=_bank_state0(g, n_slots, mlp_window, lanes, dev,
                          n_channels if multi else 0),
        heat=torch.zeros((g, n_slots, lanes), dtype=torch.float32,
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
    jedec = bins.shape[0]                                # the JEDEC row
    if fault is not None:
        f_rows, u_all = fault
        fp = torch.as_tensor(f_rows, dtype=torch.float32, device=dev).T
        if tuple(fp.shape) != (faults.F_COLS, lanes):
            raise ValueError(f"fault rows must be [{lanes}, {faults.F_COLS}]"
                             f", got {tuple(f_rows.shape)}")
        u_all = torch.as_tensor(u_all, dtype=torch.float32, device=dev)
        # bin s's upper edge; the JEDEC row has none
        edges_ext = torch.cat([bins, torch.full((1,), torch.inf,
                                                device=dev)])
        no_r = torch.full((g, lanes), faults.NO_READING, device=dev)
        lag, held, psen = no_r, no_r, no_r
        wd = faults.wd_state0((g, lanes), device=dev)
        cnt = _counters0((g, lanes), dev)
        pbin = torch.zeros((g, lanes), dtype=torch.int64, device=dev)
        p_out = torch.zeros_like(lat) if probs else None
    if multi:
        ch_all, gb_all = _chan_slots(bank, row, ileave,
                                     (n_channels, n_ranks), n_banks)
    for k in range(n):
        t, b, v = arrival[:, k], b_all[:, k], v_all[:, k]
        vv = v[:, None]
        dt = torch.maximum(t - st.t_prev, zero)
        heat = st.heat * torch.exp(-dt / tau)[:, None, None]
        hsum = heat[:, 0]
        for j in range(1, n_slots):
            hsum = hsum + heat[:, j]
        sensed = ambient_at(scn_t, t[:, None]) + hsum        # [G, L]
        reading = sensed
        if fault is not None:
            reading, lag2, held2 = faults.fault_sensor(
                fp, t[:, None], dt[:, None], sensed, lag, held,
                torch.tensor(k, dtype=torch.int32, device=dev))
        up = (bins < reading[..., None]).sum(-1)
        down = (bins < (reading + hyst)[..., None]).sum(-1)
        new_bin = torch.maximum(up, torch.minimum(st.cur_bin, down))
        use_bin = new_bin
        if fault is not None:
            is_probe, use_agg = faults.wd_gate(fp, wd)
            use_bin = torch.where(use_agg, new_bin, jedec)
        if region_map is None:
            col = b[:, None] if banked else None
        elif rmap.dim() == 1:
            col = rmap[slots[:, k]][:, None]                 # [G, 1]
        else:
            col = rmap[lane, slots[:, k][:, None]]           # [G, L]
        tp = (tables[lane, use_bin, col] if banked
              else tables[lane, use_bin])                    # [G, L, 6]
        tc = _timing_cols(tp)
        sur = None
        if fault is not None:
            jt = (tables[lane, jedec, col] if banked
                  else tables[:, jedec])                     # [.., L, 6]
            j5 = _timing_cols(jt)
            excess = torch.clamp(sensed - edges_ext[use_bin], min=0.0)
            p = faults.error_prob(fp, _red(tc, j5), excess)
            _, det, sil = faults.error_draw(fp, u_all[:, k, None], p)
            sur = torch.where(det, j5[4] + fp[faults.RETRY_NS], 0.0)
        gb = gb_all[:, k] if multi else b
        lat[:, k], is_hit = _service(st.bank, t, gb, rf_all[:, k],
                                     w_all[:, k], v, tc, closed,
                                     mlp_window, surcharge=sur,
                                     ch=ch_all[:, k] if multi else None,
                                     t_burst=t_burst)
        energy = access_energy_from_terms(
            e_burst, e_act_pre, p_as, 1.0 - is_hit.to(torch.float32), tc[1])
        heat[g_ix, gb] = heat[g_ix, gb] + c_heat * energy
        st.heat.copy_(torch.where(vv[:, :, None], heat, st.heat))
        if fault is None:
            switches += (vv & (new_bin != st.cur_bin)
                         & (k > 0)).to(torch.int32)
        else:
            jump = fp[faults.WD_JUMP_C]
            implaus = ((jump > 0.0) & (psen > 0.5 * faults.NO_READING)
                       & (torch.abs(reading - psen) > jump))
            wd, cnt = _fault_step(fp, wd, cnt, det, sil, is_probe, v,
                                  implaus)
            lag = torch.where(vv, lag2, lag)
            held = torch.where(vv, held2, held)
            psen = torch.where(vv, reading, psen)
            switches += (vv & (use_bin != pbin) & (k > 0)).to(torch.int32)
            pbin = torch.where(vv, use_bin, pbin)
            if probs:
                p_out[:, k] = torch.where(vv, p, zero)
        st.cur_bin.copy_(torch.where(vv, new_bin, st.cur_bin))
        st.t_prev.copy_(torch.where(v, t, st.t_prev))
        temps[:, k] = torch.where(vv, reading, zero)
        sel[:, k] = torch.where(vv, use_bin, -1).to(torch.int32)
        tmax = torch.maximum(tmax, torch.where(vv, reading, -torch.inf))
        tsum = tsum + torch.where(vv, reading, zero)
    bst = st.bank.bank
    total = torch.maximum(bst[:, :, 3].amax(1), bst[:, :, 2].amax(1))
    tmean = tsum / v_all.sum(-1).to(torch.float32)[:, None]
    out = (lat, total, temps, sel, st.heat, (tmax, tmean, switches))
    if fault is None:
        return out
    return out + (torch.stack(cnt),) + ((p_out,) if probs else ())


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
    overheat [n_banks]); with `fault` = (fault row [F_COLS], uniforms
    [N]) also the [N_COUNTERS] counters (the temperature and bin then
    report the reading and the served bin).  With `c_heat = 0` and a
    steady scenario it equals `replay_one` of the selected constant
    row, bit for bit.  With `n_channels * n_ranks` > 1 (one interleave
    code `ileave`) the overheat is [C*R*n_banks] (`replay_cells`'
    channel geometry)."""
    dev = arrival.device
    if region_map is not None:
        region_map = torch.as_tensor(region_map, device=dev).reshape(-1)
    if fault is not None:
        fault = (torch.as_tensor(fault[0], device=dev)[None],
                 torch.as_tensor(fault[1], device=dev)[None])
    closed_t = torch.as_tensor(bool(closed), device=dev)[None]
    out = replay_adaptive_cells(
        arrival[None], bank[None], row[None], is_write[None], valid[None],
        torch.as_tensor(table, device=dev)[None], bins,
        torch.as_tensor(scn_row, device=dev)[None], tcfg_row, closed_t,
        n_banks, mlp_window, region_map, fault, n_channels=n_channels,
        n_ranks=n_ranks, ileave=ileave, t_burst=t_burst)
    lat, total, temps, sel, heat = out[:5]
    res = (lat[0, :, 0], total[0, 0], temps[0, :, 0], sel[0, :, 0],
           heat[0, :, 0])
    return res + ((out[6][:, 0, 0],) if fault is not None else ())


def simulate(trace: Trace, tp: TimingParams, n_banks: int = 8,
             mlp_window: int = 8, policy: Policy = OPEN_FCFS,
             device: str | torch.device = "cuda") -> dict:
    """Replay one trace under one set of timing parameters (a 1x1x1
    `SimEngine` campaign with host statistics and host reordering)."""
    from repro_torch.core import sim_engine
    res = sim_engine.default_engine(device).run(sim_engine.SimSpec.single(
        trace, tp, policy, n_banks=n_banks, mlp_window=mlp_window,
        collect=("latencies",)))
    return {
        "mean_latency_ns": res.mean_latency_ns[0, 0, 0],
        "p99_latency_ns": res.p99_latency_ns[0, 0, 0],
        "total_ns": res.total_ns[0, 0, 0],
        "latencies": res.latencies[0, 0, 0],
    }

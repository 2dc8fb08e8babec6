"""Batched trace-replay campaigns (port of `repro.core.sim_engine`): the
paper's real-system evaluation (Sec. 6, Fig. 4) and its closed thermal
loop (Sec. 4) as ONE replay launch each, optionally under a fault axis,
on a multi-channel, multi-rank module.

A `SimSpec` declares the campaign axes — traces (padded to one length
with a validity mask), scheduling policies (open/closed page, FR-FCFS-lite
reordering, address interleave) and
stacked timing rows [S, 6], per-bank [S, banks, 6], or the
mask-compressed subarray-region store [S, U, 6] with its index map
(`region_map`) — and
`SimEngine.run` replays the whole (T x P x S) grid through
`repro_torch.kernels.replay.ops.replay_grid`: the CUDA kernel on a card,
its plain version on the CPU.  With a `thermal.ThermalSpec` attached the
timing axis is a stack of per-bin TABLES ([K, S+1, 6], [K, S+1, banks,
6] or with a region map [K, S+1, U, 6], JEDEC row last) and the
(T x P x K x C) grid replays through
`replay_grid_adaptive` (the `adaptive_blocks` kernel), which also
reduces the thermal diagnostics (temp_max / temp_mean / bin_switches)
in the launch.  `SimEngine.run_bracket` runs the adaptive campaign, the
worst-bin round-up and the static-worst-case campaign back to back on
the device.

A `faults.FaultSpec` attached as `SimSpec.faults` replays every cell
under every fault row in the same launch: static campaigns put the
(timing x fault) product on the lanes, l = s*F + f, with the last timing
row as the JEDEC fallback, and unflatten to [T, P, S, F, ...]; adaptive
campaigns carry F innermost, [T, P, K, C, F, ...].  `SimResult.
fault_counters` then holds the [..., F, N_COUNTERS] counters.  An
all-inert spec (`FaultSpec.none()`) runs the unfaulted launch and
repeats its result along F, with zero counters.

FR-FCFS-lite policies (`reorder_window` > 1, open page) replay their
issue orders: `reorder="device"` (default) computes them with
`dram_sim.frfcfs_perm` on the engine's device before the launch, one
scheduler run per window group over a pending buffer cut to the exact
slack-horizon bound (`_eff_window`); `reorder="host"` packs them through
`dram_sim.frfcfs_reorder`, the host oracle.  Fault uniforms stay in
issue position: request k of every policy's issue order draws u[t, k].
`n_channels`/`n_ranks` > 1 launches the multi-channel variant (d) of
`replay_blocks` with each policy's interleave code; the adaptive kernel
is single-channel, as the reference's, so a multi-channel adaptive
campaign runs the plain step loop (`replay.ref.replay_grid_adaptive`) on
the engine's device.

stats="device" (default) reduces masked mean and interpolated p99 on
the device (`_device_stats`, p99 from a `torch.topk` of static depth)
and moves only [T, P, S] summaries to the host; stats="host" is the
numpy reference (`_masked_stats`).  The two agree within 1e-5
relative; the latency grid itself is identical either way.

The trace axis may also be declarative, a `dram_sim.SynthSpec` (the
workload pool's knobs, `perf_model.synth_spec`) or `TenantSpec`: the
engine replays its materialization, drawn once on the host and cached
on the spec (one `synth_dispatch_count` synthesis, on first use), packed
and sharded like `Trace`s.  The draws run on CPU generators, so drawing
inside every run, as the reference's fused synthesis does on its
device, would only repeat host work.

`mesh` (`launch.mesh.make_campaign_mesh`) shards a campaign: the
[T]-leading per-stream tensors are padded to a multiple of the device count by repeating the last stream,
each mesh device reorders and replays its shard through the same static
or adaptive path as the unsharded run, and only the `want`-selected
per-shard statistics cross back, the padded rows sliced off after the
gather.  `run_bracket` takes the per-scenario temperature peak as an
exact max across shards before it picks the worst bins.  One run is one
`dispatch_count` however many shards it has; each shard is one kernel
launch.  Lanes and cells are independent, so a sharded run is bitwise
the unsharded one.

`backend` picks the replay core: "kernel" (default: the CUDA kernels on
a card, their plain versions on the CPU, as every `ops.py` wrapper
decides), "merged" (`dram_sim.replay_rows_frfcfs`, the FR-FCFS
scheduler merged into the plain static replay: plain PyTorch, so it
raises on a CUDA engine and is a candidate on the CPU only) or "auto"
(the attached `autotune.ReplayTuner`'s profiled choice, else "kernel").
`autotune` profiles the tuner's candidates, which on a card vary the
kernels' chain lanes per block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import faults as F
from repro_torch.core import timing as T
from repro_torch.core.autotune import ReplayConfig, ReplayTuner, replay_unit
from repro_torch.core.dram_sim import (OPEN_FCFS, SYNTH_SPECS, Policy,
                                       SynthSpec, TenantSpec, Trace,
                                       check_prefix_valid, frfcfs_perm,
                                       frfcfs_reorder)
from repro_torch.core.thermal import ThermalSpec
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import CampaignMesh
from repro_torch.launch.sharding import shard_campaign, tree_leaves, tree_map

COLLECTABLE = ("latencies", "temps", "bins")


def _as_rows(timings) -> np.ndarray:
    """Normalize the timing axis to a [S, 6] stacked-row matrix, or a
    per-bank [S, banks, 6] stack (each request replays under its bank's
    row)."""
    if isinstance(timings, T.TimingParams):
        return timings.as_row()[None, :]
    if isinstance(timings, (list, tuple)):
        return T.stack_timing(timings)
    arr = np.asarray(timings, np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim not in (2, 3) or arr.shape[-1] != 6:
        raise ValueError(f"timings must be [S, 6] or [S, banks, 6], got "
                         f"{arr.shape}")
    return arr


def _as_tables(timings, n_bins: int) -> np.ndarray:
    """Normalize the adaptive timing axis to [K, n_bins + 1, 6] table
    stacks (per-bin rows + the JEDEC fallback row last) or the per-bank
    [K, n_bins + 1, banks, 6] form.  A single per-bank stack must be
    passed 4-dim (`stack[None]`): a 3-dim input is read as K per-module
    stacks."""
    arr = np.asarray(timings, np.float32)
    if arr.ndim == 2:
        arr = arr[None, :, :]
    if arr.ndim not in (3, 4) or arr.shape[-1] != 6:
        raise ValueError(f"adaptive timings must be [K, S+1, 6] or [K, "
                         f"S+1, banks, 6], got {arr.shape}")
    if arr.shape[1] != n_bins + 1:
        raise ValueError(f"table stack needs {n_bins}+1 rows (JEDEC "
                         f"last), got {arr.shape}")
    return arr


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """A declarative trace-replay campaign: every trace runs under every
    policy and every timing row.  `traces` is a tuple of `Trace`s (any
    lengths; shorter ones are padded), a single `Trace` whose fields
    carry a leading batch axis, or a declarative `dram_sim.SynthSpec` /
    `TenantSpec`, replayed through its cached materialization.
    `collect` keeps raw per-request grids (moved to the host): "latencies" ([T, P, S, N] or [T, P, K, C, N]),
    and on the adaptive path "temps" and "bins".

    Attaching `thermal` switches to the closed-loop replay: `timings`
    is then a stack of per-bin tables ([K, S+1, 6] or per-bank
    [K, S+1, banks, 6]) and the grid is [T, P, K, C] (C = scenarios).

    `n_channels` x `n_ranks` independent bank groups, with each
    policy's `interleave` mapping requests to channels, and
    `t_burst_ns` the per-channel bus occupancy of one burst; 1 x 1 is
    the single-channel replay.

    `region_map` (int, [banks * R] shared, or [S, banks * R] / [K,
    banks * R] per timing row / table stack) switches the spatial axis
    of `timings` to the unique-row store ([S, U, 6] / [K, S+1, U, 6]):
    each request reads the row of its (bank, region_of(row, R)) slot
    through the map.  Its range is checked here, once per campaign, on
    the host."""

    traces: tuple[Trace, ...] | SynthSpec | TenantSpec
    # [S, 6] | per-bank [S, banks, 6] | region store [S, U, 6] |
    # adaptive [K, S+1, 6] | [K, S+1, banks, 6] | [K, S+1, U, 6]
    timings: np.ndarray
    policies: tuple[Policy, ...] = (OPEN_FCFS,)
    n_banks: int = 8
    mlp_window: int = 8
    collect: tuple[str, ...] = ()
    thermal: ThermalSpec | None = None
    region_map: np.ndarray | None = None
    faults: F.FaultSpec | None = None
    n_channels: int = 1
    n_ranks: int = 1
    t_burst_ns: float = 5.0

    def __post_init__(self):
        if self.thermal is not None and not isinstance(self.thermal,
                                                       ThermalSpec):
            raise TypeError(f"thermal must be a ThermalSpec, got "
                            f"{type(self.thermal).__name__}")
        if self.faults is not None and not isinstance(self.faults,
                                                      F.FaultSpec):
            raise TypeError(f"faults must be a FaultSpec, got "
                            f"{type(self.faults).__name__}")
        if self.n_channels < 1 or self.n_ranks < 1:
            raise ValueError(f"n_channels and n_ranks must be >= 1, got "
                             f"{self.n_channels} x {self.n_ranks}")
        tr = self.traces
        if isinstance(tr, Trace):
            tr = (tuple(Trace(*(f[i] for f in tr))
                        for i in range(tr.arrival.shape[0]))
                  if tr.arrival.ndim == 2 else (tr,))
        if isinstance(tr, (tuple, list)):
            tr = tuple(tr)
        elif not isinstance(tr, SYNTH_SPECS):
            raise TypeError(f"traces must be Traces, a SynthSpec or a "
                            f"TenantSpec, got {type(tr).__name__}")
        object.__setattr__(self, "traces", tr)
        object.__setattr__(
            self, "timings",
            _as_rows(self.timings) if self.thermal is None else
            _as_tables(self.timings, len(self.thermal.temp_bins)))
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "collect", tuple(self.collect))
        if not (self.traces and self.policies):
            raise ValueError("empty campaign")
        if not all(c in COLLECTABLE for c in self.collect):
            raise ValueError(f"collect {self.collect} not in {COLLECTABLE}")
        if self.thermal is None and set(self.collect) - {"latencies"}:
            raise ValueError("temps/bins are collected on the adaptive "
                             "(thermal) path only")
        spatial = self.timings.ndim == (3 if self.thermal is None else 4)
        if self.region_map is not None:
            rm = np.asarray(self.region_map)
            if not np.issubdtype(rm.dtype, np.integer):
                raise ValueError(f"region_map must be integer, got {rm.dtype}")
            rm = rm.astype(np.int32)
            object.__setattr__(self, "region_map", rm)
            if not spatial:
                raise ValueError("region_map needs a [.., U, 6] unique-row "
                                 "timing axis")
            if rm.ndim not in (1, 2) or rm.shape[-1] == 0 \
                    or rm.shape[-1] % self.n_banks:
                raise ValueError(f"region_map {rm.shape} must be [banks * "
                                 f"regions] or [rows, banks * regions] with "
                                 f"{self.n_banks} banks")
            if rm.ndim == 2 and rm.shape[0] != self.timings.shape[0]:
                raise ValueError(f"per-row region_map {rm.shape} vs timings "
                                 f"{self.timings.shape}")
            if int(rm.min()) < 0 or int(rm.max()) >= self.timings.shape[-2]:
                raise ValueError(f"region_map entries outside [0, "
                                 f"{self.timings.shape[-2]}) (the unique-"
                                 "row store)")
        elif spatial and self.timings.shape[-2] != self.n_banks:
            raise ValueError(f"per-bank timings {self.timings.shape} need "
                             f"{self.n_banks} banks")
        if self.fault_on and self.thermal is None and spatial:
            # the static faulted replay prices retries against ONE JEDEC
            # row, the last timing row; spatial stacks have none (the
            # adaptive tables carry their JEDEC rows)
            raise ValueError("fault axis + spatial (per-bank/per-region) "
                             "static timings unsupported")

    @classmethod
    def single(cls, trace: Trace, tp: T.TimingParams,
               policy: Policy = OPEN_FCFS, **kw) -> "SimSpec":
        return cls(traces=(trace,), timings=tp, policies=(policy,), **kw)

    @property
    def synth(self) -> SynthSpec | TenantSpec | None:
        """The declarative synthesis spec, when the trace axis is one."""
        return self.traces if isinstance(self.traces, SYNTH_SPECS) else None

    def trace_tuple(self, device="cpu") -> tuple[Trace, ...]:
        """The trace axis as `Trace`s (a declarative axis through its
        cached materialization, on `device`)."""
        return (self.traces.materialize(device) if self.synth is not None
                else self.traces)

    @property
    def fault_on(self) -> bool:
        """True when the fault axis can perturb the replay (an all-inert
        `FaultSpec` runs the unfaulted launch)."""
        return self.faults is not None and not self.faults.is_none

    @property
    def shape(self) -> tuple[int, ...]:
        base = (len(self.traces), len(self.policies), self.timings.shape[0])
        return (base if self.thermal is None else
                base + (len(self.thermal.scenarios),))

    @property
    def closed_flags(self) -> np.ndarray:
        return np.array([p.closed for p in self.policies])

    @property
    def multi(self) -> bool:
        return self.n_channels * self.n_ranks > 1

    @property
    def chan(self) -> tuple:
        """The channel geometry (n_channels, n_ranks, t_burst_ns)."""
        return (self.n_channels, self.n_ranks, float(self.t_burst_ns))

    @property
    def ileave_codes(self) -> np.ndarray:
        """Per-policy interleave codes [P] int32."""
        return np.array([p.ileave_code for p in self.policies], np.int32)

    def policy_knobs(self):
        """Per-policy FR-FCFS (window, slack, cap) columns.  Closed page
        auto-precharges after every access, so no row hit can be
        promoted: window 0 keeps closed-page and FCFS policies in
        arrival order."""
        windows = np.array([0 if p.closed or p.reorder_window <= 1
                            else p.reorder_window for p in self.policies],
                           np.int32)
        slacks = np.array([p.reorder_slack_ns for p in self.policies],
                          np.float32)
        caps = np.array([4 * max(int(w), 1) for w in windows], np.int32)
        return windows, slacks, caps

    def _pack(self, traces, device, lead: tuple):
        lens = [int(t.arrival.shape[0]) for t in self.trace_tuple()]
        n = max(lens)
        arrival = torch.zeros(lead + (n,), dtype=torch.float32,
                              device=device)
        bank = torch.zeros(lead + (n,), dtype=torch.int32, device=device)
        row = torch.zeros(lead + (n,), dtype=torch.int32, device=device)
        is_write = torch.zeros(lead + (n,), dtype=torch.bool, device=device)
        valid = np.zeros((len(lens), n), bool)
        for ix, t in traces:
            k = lens[ix[0]]
            valid[ix[0], :k] = True
            for dst, f in zip((arrival, bank, row, is_write), t):
                if not isinstance(f, torch.Tensor):
                    f = torch.from_numpy(np.array(f))
                dst[ix + (slice(0, k),)] = f.to(device)
        check_prefix_valid(valid, "SimSpec.pack")
        return arrival, bank, row, is_write, valid

    def pack_device(self, device: torch.device):
        """The FCFS streams: dense [T, N] request tensors on `device`
        plus the [T, N] validity mask (host numpy)."""
        return self._pack(((((i,), t) for i, t in
                            enumerate(self.trace_tuple(device)))),
                          device, (len(self.traces),))

    def pack(self, device: torch.device):
        """Dense [T, P, N] request tensors on `device`, each policy's
        in its FR-FCFS issue order computed on the host
        (`dram_sim.frfcfs_reorder`, cached by content; closed-page and
        FCFS policies keep arrival order), plus the [T, N] validity mask
        (host numpy) and the [P] closed-page flags."""
        windows, _, _ = self.policy_knobs()

        def cells():
            for i, t in enumerate(self.trace_tuple()):
                done: dict = {}
                for j, (p, w) in enumerate(zip(self.policies, windows)):
                    key = None if w <= 1 else (int(w), p.reorder_slack_ns)
                    if key not in done:
                        done[key] = t if key is None else frfcfs_reorder(
                            t, *key)
                    yield (i, j), done[key]

        return self._pack(cells(), device,
                          (len(self.traces), len(self.policies))) \
            + (self.closed_flags,)


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Result grid of one campaign; arrays lead with [T, P, S] =
    (traces, policies, timing rows), or [T, P, K, C] = (traces,
    policies, table stacks, thermal scenarios) on the adaptive path,
    followed by F (fault rows) when the spec has a fault axis.
    `latencies` ([..., N], 0 at padding), `temps` and `bins` (-1 at
    padding) are None unless the spec collected them; the thermal
    diagnostics and `bank_heat` are set on the adaptive path only;
    `fault_counters` ([..., F, N_COUNTERS] int32: detected, silent,
    trips, degraded, probes) with a fault axis only."""

    spec: SimSpec
    mean_latency_ns: np.ndarray     # [T, P, S] | [T, P, K, C] (+F)
    p99_latency_ns: np.ndarray      # same leading shape
    total_ns: np.ndarray            # same leading shape
    valid: np.ndarray               # [T, N]
    latencies: np.ndarray | None = None
    temps: np.ndarray | None = None         # [T, P, K, C, (F,) N] read C
    bins: np.ndarray | None = None          # [T, P, K, C, (F,) N] int32
    temp_max: np.ndarray | None = None      # [T, P, K, C (, F)]
    temp_mean: np.ndarray | None = None     # [T, P, K, C (, F)]
    bin_switches: np.ndarray | None = None  # [T, P, K, C (, F)]
    bank_heat: np.ndarray | None = None     # [T, P, K, C, (F,) banks] end C
    fault_counters: np.ndarray | None = None  # [..., F, N_COUNTERS]

    def _counter(self, i: int):
        return (None if self.fault_counters is None
                else self.fault_counters[..., i])

    @property
    def detected_errors(self):      # [..., F] int32
        return self._counter(0)

    @property
    def silent_errors(self):        # [..., F] int32
        return self._counter(1)

    @property
    def wd_trips(self):             # [..., F] int32
        return self._counter(2)

    @property
    def degraded_requests(self):    # [..., F] int32
        return self._counter(3)

    @property
    def wd_probes(self):            # [..., F] int32
        return self._counter(4)


def _p99_k(valid: np.ndarray) -> int:
    """Static top-k depth covering every trace's p99 order statistics
    (same float32 arithmetic as `_device_stats`)."""
    c = valid.sum(-1).astype(np.float32)
    lo = np.floor((np.float32(0.99) * (c - 1.0)).astype(np.float32))
    return int((c - lo).max())


def _device_stats(lat: torch.Tensor, valid: torch.Tensor, k: int):
    """Masked mean / interpolated p99 over the last axis, on the
    device.  The p99 order statistics come from a descending
    `torch.topk` of depth `k` (`_p99_k`): entry j is the (j+1)-th
    largest valid latency, so ascending position i is descending
    position cnt-1-i.  Same interpolation arithmetic as `_masked_stats`.

    The mean is summed in float64 and rounded once to float32: a float32
    sum's order depends on the tensor's layout and shape (PyTorch picks
    the reduction order per launch), so two campaigns replaying the same
    latencies — the adaptive and static halves of a bracket — would
    otherwise report means a last bit apart."""
    mid = (1,) * (lat.dim() - 2)
    v = valid.reshape((valid.shape[0],) + mid + (valid.shape[1],))
    cnt = valid.sum(-1).to(torch.float64).reshape((valid.shape[0],) + mid)
    mean = (torch.where(v, lat, torch.zeros_like(lat)).to(torch.float64)
            .sum(-1) / cnt).to(torch.float32)
    cnt = cnt.to(torch.float32)
    top = torch.topk(torch.where(v, lat, torch.full_like(lat, -torch.inf)),
                     k, dim=-1).values
    q = (0.99 * (cnt - 1.0)).to(torch.float32)
    lo = torch.floor(q)
    hi = torch.ceil(q)
    frac = q - lo
    di_lo = (cnt - 1.0 - lo).to(torch.int64)
    di_hi = (cnt - 1.0 - hi).to(torch.int64)
    shape = top.shape[:-1] + (1,)
    vlo = torch.gather(top, -1, di_lo[..., None].expand(shape))[..., 0]
    vhi = torch.gather(top, -1, di_hi[..., None].expand(shape))[..., 0]
    return mean, vlo + (vhi - vlo) * frac


def _device_thermal_diag(temps: torch.Tensor, bin_sel: torch.Tensor,
                         valid: torch.Tensor):
    """Thermal diagnostics over each trace's valid prefix, from the raw
    [T, ..., N] sensed temperatures and selected bins: (temp_max,
    temp_mean, bin_switches), each [T, ...].  max and switch counts are
    exact; the mean's summation order differs from the kernel's
    running sum."""
    mid = (1,) * (temps.dim() - 2)
    v = valid.reshape((valid.shape[0],) + mid + (valid.shape[1],))
    cnt = valid.sum(-1).to(torch.float32).reshape((valid.shape[0],) + mid)
    tmax = torch.where(v, temps, -torch.inf).amax(-1)
    tmean = torch.where(v, temps, torch.zeros_like(temps)).sum(-1) / cnt
    pair = v[..., 1:] & v[..., :-1]          # padding is a suffix
    switches = ((bin_sel[..., 1:] != bin_sel[..., :-1]) & pair).sum(-1)
    return tmax, tmean, switches


def _eff_window(arrival: np.ndarray, valid: np.ndarray, window: int,
                slack_ns: float) -> int:
    """The exact FR-FCFS buffer size: with non-decreasing arrivals,
    buffer slot j holds a request at stream distance >= j from the
    head, so it can be promoted only while j < cnt_i = |{k >= i :
    arr[k] <= arr[i] + slack}|; a buffer of max_i cnt_i gives the same
    permutation as the nominal window.  float32 horizons, as
    `frfcfs_perm`'s.  Decreasing arrivals in any valid prefix fall back
    to `window`."""
    eff = 1
    slack = np.float32(slack_ns)
    for t in range(arrival.shape[0]):
        c = int(valid[t].sum())
        if c == 0:
            continue
        arr = arrival[t, :c].astype(np.float32)
        if np.any(np.diff(arr) < 0):
            return window
        horizon = (arr + slack).astype(np.float32)
        cnt = np.searchsorted(arr, horizon, side="right") \
            - np.arange(c, dtype=np.int64)
        eff = max(eff, int(cnt.max()))
    return max(1, min(window, eff, arrival.shape[1]))


def _plan_entries(windows: np.ndarray, policies, arrival,
                  valid) -> tuple:
    """The reorder plan: one `(window, eff, policy indices)` entry per
    window > 1, the buffer cut to the `_eff_window` bound of the group's
    largest slack over the [T, N] arrivals (host numpy; a larger slack
    can only need a deeper buffer)."""
    groups: dict[int, list[int]] = {}
    for i, w in enumerate(windows.tolist()):
        if w > 1:
            groups.setdefault(int(w), []).append(i)
    plan = []
    for w, ix in sorted(groups.items()):
        slack = max(float(policies[i].reorder_slack_ns) for i in ix)
        plan.append((w, _eff_window(arrival, valid, w, slack), tuple(ix)))
    return tuple(plan)


def _reorder_prepass(arrival, bank, row, is_write, valid, slacks, caps,
                     plan: tuple, n_banks: int, n_policies: int):
    """[T, N] FCFS streams -> [T, P, N] per-policy issue orders on their
    device: each plan group runs `frfcfs_perm` over its (trace x
    policy) cells with the group's exact buffer; the other policies keep
    arrival order."""
    t, n = arrival.shape

    def bcast(x):
        return x[:, None, :].expand(t, n_policies, n)

    if not plan:
        return bcast(arrival), bcast(bank), bcast(row), bcast(is_write)
    dev = arrival.device
    perm = torch.arange(n, device=dev).expand(t, n_policies, n).clone()
    for window, eff, idx in plan:
        m = len(idx)

        def cells(x):
            return x[:, None, :].expand(t, m, n).reshape(t * m, n)

        sel = list(idx)
        perm[:, sel] = frfcfs_perm(
            cells(arrival), cells(bank), cells(row), cells(valid), window,
            torch.as_tensor(slacks[sel], device=dev).repeat(t),
            torch.as_tensor(caps[sel], device=dev).repeat(t), min(eff, n),
            n_banks).reshape(t, m, n)
    return tuple(torch.gather(bcast(x), 2, perm)
                 for x in (arrival, bank, row, is_write))


def _masked_stats(lat: np.ndarray, valid: np.ndarray):
    """Host reference of `_device_stats`: masked mean over each trace's
    valid prefix and the interpolated p99, in numpy float32.  The grid
    is made contiguous first: numpy sums a contiguous row pairwise and a
    strided one in another order."""
    lat = np.ascontiguousarray(lat)
    mid = (1,) * (lat.ndim - 2)
    v = valid.reshape((valid.shape[0],) + mid + (valid.shape[1],))
    cnt = valid.sum(-1).astype(np.float32).reshape((valid.shape[0],) + mid)
    mean = np.empty(lat.shape[:-1], np.float32)
    for t in range(lat.shape[0]):                    # padding is a suffix
        c = int(valid[t].sum())
        mean[t] = lat[t, ..., :c].sum(-1, dtype=np.float32) / np.float32(c)
    s = np.sort(np.where(v, lat, np.inf), axis=-1)
    q = (np.float32(0.99) * (cnt - 1.0)).astype(np.float32)
    lo = np.floor(q).astype(np.int64)
    hi = np.ceil(q).astype(np.int64)
    frac = q - lo.astype(np.float32)
    vlo = np.take_along_axis(
        s, np.broadcast_to(lo[..., None], s.shape[:-1] + (1,)), -1)[..., 0]
    vhi = np.take_along_axis(
        s, np.broadcast_to(hi[..., None], s.shape[:-1] + (1,)), -1)[..., 0]
    return mean, vlo + (vhi - vlo) * frac


def _shard_pad(tree, n_dev: int):
    """Pad every [T, ...]-leading tensor of a per-stream tree to a T
    divisible by the device count by repeating the last row (real work,
    so padded shards stay finite; the engine slices the extra rows off
    after the gather).  Returns (padded tree, real T)."""
    t = int(tree_leaves(tree)[0].shape[0])
    pad = (-t) % n_dev
    if pad == 0:
        return tree, t
    return tree_map(lambda x: torch.cat(
        [x, x[-1:].expand((pad,) + tuple(x.shape[1:]))], 0), tree), t


def _merged_replay(arrival, bank, row, is_write, valid, timings, closed,
                   spec: "SimSpec", plan: tuple, all_valid: bool,
                   fault=None, region_map=None):
    """The `backend="merged"` static core: [T, N] FCFS streams -> (lat
    [T, P, S, N], total [T, P, S] (, counters [T, P, S, NC])) with each
    reordering policy's FR-FCFS schedule merged into its replay
    (`dram_sim.replay_rows_frfcfs`, one stream at a time, its pending
    buffer cut to the group's `_eff_window` bound), and the other
    policies replayed in arrival order by the plain replay.  Latencies
    land in issue order, as the prepass pipeline's, so the two are
    bitwise equal cell for cell.  Plain PyTorch: the engine runs it on
    the CPU only.  `fault` = (fault rows [S, F_COLS], JEDEC row [6],
    uniforms [T, N]), consumed by issue step as the prepass's."""
    from repro_torch.core.dram_sim import replay_rows_frfcfs
    from repro_torch.kernels.replay import ops as replay_ops
    t, n = arrival.shape
    p, s = len(spec.policies), timings.shape[0]
    dev = arrival.device
    windows, slacks, caps = spec.policy_knobs()
    codes = spec.ileave_codes
    n_ch, n_rk, t_burst = spec.chan
    lat = torch.zeros((t, p, s, n), dtype=torch.float32, device=dev)
    total = torch.zeros((t, p, s), dtype=torch.float32, device=dev)
    cnt = (None if fault is None else torch.zeros(
        (t, p, s, F.N_COUNTERS), dtype=torch.int32, device=dev))
    grouped = {j for _, _, idx in plan for j in idx}
    ident = [j for j in range(p) if j not in grouped]
    if ident:
        def bcast(x):
            return x[:, None, :].expand(t, len(ident), n)

        out = replay_ops.replay_grid(
            bcast(arrival), bcast(bank), bcast(row), bcast(is_write), valid,
            timings, closed[ident], spec.n_banks, spec.mlp_window,
            validated=True, region_map=region_map, fault=fault,
            chan=spec.chan, ileave=torch.as_tensor(codes[ident]))
        lat[:, ident], total[:, ident] = out[0], out[1]
        if fault is not None:
            cnt[:, ident] = out[2]
    for window, eff, idx in plan:
        for ti in range(t):
            for j in idx:
                fl = (None if fault is None
                      else (fault[0], fault[1], fault[2][ti]))
                out = replay_rows_frfcfs(
                    arrival[ti], bank[ti], row[ti], is_write[ti], valid[ti],
                    timings, bool(closed[j]), window, float(slacks[j]),
                    int(caps[j]), min(eff, n), spec.n_banks,
                    spec.mlp_window, all_valid=all_valid, n_channels=n_ch,
                    n_ranks=n_rk, ileave=int(codes[j]), t_burst=t_burst,
                    fault=fl, region_map=region_map)
                lat[ti, j], total[ti, j] = out[0], out[1]
                if fault is not None:
                    cnt[ti, j] = out[2].T
    return (lat, total) + (() if fault is None else (cnt,))


@dataclasses.dataclass
class _Launch:
    """What every shard of one campaign launch shares: the spec, the
    resolved replay core and block, the reorder plan, the p99 depth,
    the outputs wanted and the replicated inputs (host arrays, or
    tensors on the engine's device for an unsharded launch), each
    placed on a shard's device by `on`."""

    spec: "SimSpec"
    backend: str
    block: int | None
    plan: tuple
    p99_k: int
    want: tuple
    timings: object
    region_map: object = None
    fault: tuple | None = None
    thermal: tuple | None = None          # (scns, bins, tcfg)
    base_row: object = None
    n_real: int = 0

    def on(self, x, dev, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                      device=dev)


def _issue_order(job: _Launch, streams, dev):
    """[t, N] FCFS streams -> [t, P, N] issue orders (the FR-FCFS
    prepass on `dev`); host-reordered [t, P, N] streams pass through."""
    arrival, bank, row, is_write, valid = streams
    if arrival.dim() == 3:
        return arrival, bank, row, is_write
    _, slacks, caps = job.spec.policy_knobs()
    return _reorder_prepass(arrival, bank, row, is_write, valid, slacks,
                            caps, job.plan, job.spec.n_banks,
                            len(job.spec.policies))


def _static_body(job: _Launch, dev, streams, timings=None) -> dict:
    """One shard's static replay on `dev`: every (trace, policy, timing
    row) cell, reduced to the `job.want` outputs ("stats": masked mean /
    p99; "lat": the raw grid); total runtime always, the fault counters
    with a fault axis."""
    from repro_torch.kernels.replay import ops as replay_ops
    spec = job.spec
    valid = streams[4]
    timings = job.on(job.timings if timings is None else timings, dev)
    closed = job.on(spec.closed_flags, dev)
    rmap = job.on(job.region_map, dev)
    if job.backend == "merged" and streams[0].dim() == 2:
        out = _merged_replay(*streams, timings, spec.closed_flags, spec,
                             job.plan, bool(valid.all()), job.fault, rmap)
    else:
        out = replay_ops.replay_grid(
            *_issue_order(job, streams, dev), valid, timings, closed,
            spec.n_banks, spec.mlp_window, validated=True, region_map=rmap,
            fault=job.fault, chan=spec.chan,
            ileave=job.on(spec.ileave_codes, dev), block_lanes=job.block)
    lat, total = out[:2]
    res = {"total": total}
    if "stats" in job.want:
        res["mean"], res["p99"] = _device_stats(lat, valid, job.p99_k)
    if "lat" in job.want:
        res["lat"] = lat
    if job.fault is not None:
        res["cnt"] = out[2]
    return res


def _adaptive_body(job: _Launch, dev, streams) -> dict:
    """One shard's closed-loop replay on `dev`: every (trace, policy,
    table stack, scenario) cell.  "stats" adds mean / p99 and the
    thermal diagnostics the kernel reduces; "diag" the diagnostics from
    the raw sensed temperatures and bins (the host-statistics path);
    "lat" / "temps" / "bins" the raw grids.  Total runtime and the
    end-of-trace bank heat always; the counters with a fault axis.  A
    multi-channel campaign runs the plain step loop (the adaptive
    kernel is single-channel, as the reference's)."""
    from repro_torch.kernels.replay import ops as replay_ops
    from repro_torch.kernels.replay import ref as replay_ref
    spec = job.spec
    valid = streams[4]
    scns, bins, tcfg = (job.on(x, dev) for x in job.thermal)
    tables = job.on(job.timings, dev)
    closed = job.on(spec.closed_flags, dev)
    rmap = job.on(job.region_map, dev)
    args = (*_issue_order(job, streams, dev), valid, tables, bins, scns,
            tcfg, closed, spec.n_banks, spec.mlp_window)
    if spec.multi:
        out = replay_ref.replay_grid_adaptive(
            *args, region_map=rmap, fault=job.fault, chan=spec.chan,
            ileave=job.on(spec.ileave_codes, dev))
    else:
        raw = bool({"temps", "bins", "diag"} & set(job.want))
        out = replay_ops.replay_grid_adaptive(
            *args, emit_raw=raw, validated=True, region_map=rmap,
            fault=job.fault, block_lanes=job.block)
    lat, total, temps, bin_sel, heat, diag = out[:6]
    res = {"total": total, "bank_heat": heat}
    if "diag" in job.want:
        diag = _device_thermal_diag(temps, bin_sel, valid)
    if "stats" in job.want:
        res["mean"], res["p99"] = _device_stats(lat, valid, job.p99_k)
    if {"stats", "diag"} & set(job.want):
        res.update(zip(("temp_max", "temp_mean", "bin_switches"), diag))
    for name, x in (("lat", lat), ("temps", temps), ("bins", bin_sel)):
        if name in job.want:
            res[name] = x
    if job.fault is not None:
        res["cnt"] = out[-1]
    return res


def _bracket(job: _Launch, shards: list) -> list:
    """The bracket over (device, streams) shards: every shard's adaptive
    half, the per-scenario temperature peak as an exact max across the
    shards (on the first shard's device) plus the hysteresis margin
    rounded up to worst-case bins (`torch.searchsorted`), then every
    shard's static half under the JEDEC base row and each scenario's
    worst-bin row — no host round trip in between.  Each shard's issue
    orders are computed once, for both halves."""
    shards = [(dev, _issue_order(job, st, dev) + (st[4],))
              for dev, st in shards]
    outs = [_adaptive_body(job, dev, st) for dev, st in shards]
    dev0 = shards[0][0]
    peak = torch.stack([o["temp_max"][:, :, 0, :job.n_real]
                        .amax(dim=(0, 1)).to(dev0) for o in outs]).amax(0)
    scns, bins, tcfg = (job.on(x, dev0) for x in job.thermal)
    worst = torch.searchsorted(bins, peak + tcfg[2], side="left")
    for (dev, st), o in zip(shards, outs):
        tab0 = job.on(job.timings, dev)[0]      # [S+1, (B,) 6], JEDEC last
        base = job.on(job.base_row, dev, torch.float32).expand(
            tab0.shape[1:])
        rows = torch.cat([base[None], tab0[worst.to(dev)]], dim=0)
        o.update({f"static_{k}": v for k, v in
                  _static_body(job, dev, st, rows).items()})
        o["worst_bin"], o["temp_peak"] = worst, peak
    return outs


_BODIES = {"static": _static_body, "adaptive": _adaptive_body}


@dataclasses.dataclass
class SimEngine:
    """Compiles a `SimSpec` into one replay launch on `device` (default
    "cuda"; raises without a card), or one launch per shard of a
    campaign `mesh`.  `dispatch_count` increments once per `run` (and
    `run_bracket`).  `reorder` says where FR-FCFS issue orders are
    computed: "device" (the scheduler on the engine's device, before
    the launch) or "host" (`dram_sim.frfcfs_reorder` while packing).
    `backend` ("kernel", "merged" or "auto"), `tuner` and `mesh` as in
    the module docstring; a mesh needs device statistics and device
    reordering, and carries no fault axis (the reference's fault
    campaigns are single-device)."""

    device: str | torch.device = "cuda"
    dispatch_count: int = 0
    stats: str = "device"
    reorder: str = "device"
    mesh: CampaignMesh | None = None
    backend: str = "kernel"
    tuner: ReplayTuner | None = None

    def __post_init__(self):
        if self.backend not in ("kernel", "merged", "auto"):
            raise ValueError(f"backend must be 'kernel', 'merged' or "
                             f"'auto': {self.backend}")
        if self.stats not in ("device", "host"):
            raise ValueError(f"stats must be 'device' or 'host': {self.stats}")
        if self.reorder not in ("device", "host"):
            raise ValueError(f"reorder must be 'device' or 'host': "
                             f"{self.reorder}")
        if self.mesh is not None:
            if not isinstance(self.mesh, CampaignMesh) \
                    or "campaign" not in self.mesh.axis_names:
                raise TypeError("mesh must be a launch.mesh.CampaignMesh "
                                "(make_campaign_mesh)")
            if self.stats != "device" or self.reorder != "device":
                raise ValueError("sharded campaigns need stats='device' "
                                 "and reorder='device'")
        if self.backend == "merged":
            self._check_merged()
        self.device = resolve_device(self.device)
        self.shard_shape = None     # (devices, streams a shard, N) last run

    def _check_merged(self) -> None:
        devs = [torch.device(self.device)] + list(
            self.mesh.devices if self.mesh is not None else ())
        if any(d.type == "cuda" for d in devs):
            raise ValueError(
                "backend 'merged' is the plain PyTorch replay: on a CUDA "
                "device it would send the card to the plain version of a "
                "ported kernel, which the port never does (ROADMAP North "
                "star, Kernels); use backend='kernel'")

    # ------------------------------------------------------------ tuning
    def _tuner_key(self, spec: SimSpec):
        """(campaign-kind unit, request count): the tuner table key.
        Region-compressed campaigns fold the region count into the size."""
        n = (spec.traces.n if spec.synth is not None else
             max(int(t.arrival.shape[0]) for t in spec.traces))
        adaptive = spec.thermal is not None
        banked = (spec.timings.ndim - (1 if adaptive else 0)) == 3
        regioned = spec.region_map is not None
        if regioned:
            n *= spec.region_map.shape[-1] // spec.n_banks
        return replay_unit(adaptive, banked, channels=spec.multi,
                           regioned=regioned), n

    def _resolve(self, spec: SimSpec, config: ReplayConfig | None = None):
        """(backend, block lanes) for one run: an explicit
        `config` wins; otherwise backend="auto" with a tuner answers
        with the profiled candidate of this campaign's (kind, size) bin
        (candidate 0 on unprofiled bins), and "auto" without one is the
        kernel at its default block."""
        from repro_torch.kernels.replay import ops as replay_ops
        cfg = config
        if cfg is None and self.backend == "auto" and self.tuner is not None:
            cfg = self.tuner.lookup(*self._tuner_key(spec))
        backend, bs = ((self.backend, None) if cfg is None
                       else (cfg.backend, cfg.block_rows))
        if backend == "auto":
            backend = "kernel"
        if backend == "merged":
            self._check_merged()
        replay_ops.check_block_lanes("SimEngine", bs)
        return backend, bs

    def autotune(self, spec: SimSpec, reps: int = 3) -> ReplayConfig:
        """Profile every candidate replay configuration on this campaign
        and record the winner in the tuner's table (persisted to disk),
        which `backend="auto"` consults on later runs of any campaign of
        the same kind and size bin.  Creates a `ReplayTuner` for the
        engine's platform when none is attached.  Every profiling run counts in `dispatch_count` like any
        other, so call this during warm-up, not in a measured section."""
        import time
        if self.tuner is None:
            self.tuner = ReplayTuner(platform=self.device.type)
        unit, n = self._tuner_key(spec)

        def measure(cfg: ReplayConfig) -> float:
            self.run(spec, config=cfg)            # build + warm
            best = np.inf
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                self.run(spec, config=cfg)        # ends on a host copy
                best = min(best, time.perf_counter() - t0)
            return best

        cfg, _ = self.tuner.tune(unit, n, measure)
        return cfg

    # ----------------------------------------------------------- streams
    def _streams(self, spec: SimSpec, where: str):
        """(per-stream tree, valid [T, N] host, reorder plan): the packed
        streams on the engine's device — [T, N] FCFS order, or [T, P, N]
        host-reordered — with the valid mask, checked once (bank range,
        prefix mask; rows for a region map)."""
        from repro_torch.kernels.replay import ops as replay_ops
        dev = self.device
        windows, _, _ = spec.policy_knobs()
        rows = spec.region_map is not None
        if self.reorder == "host":
            arrival, bank, row, is_write, valid, _ = spec.pack(dev)
            plan = ()
        else:
            arrival, bank, row, is_write, valid = spec.pack_device(dev)
            plan = (_plan_entries(windows, spec.policies,
                                  arrival.cpu().numpy(), valid)
                    if (windows > 1).any() else ())
        replay_ops.check_data(where, bank, valid, spec.n_banks,
                              row if rows else None)
        return ((arrival, bank, row, is_write,
                 torch.as_tensor(valid, device=dev)), valid, plan)

    def reorder_streams(self, spec: SimSpec, where: str = "SimEngine"):
        """The campaign's [T, P, N] request tensors in each policy's
        issue order on the engine's device, the [T, N] valid mask (host
        numpy) and the [P] closed-page flags (a declarative axis through
        its materialization)."""
        streams, valid, plan = self._streams(spec, where)
        job = _Launch(spec, "kernel", None, plan, 0, (), None)
        return _issue_order(job, streams, self.device) + (
            valid, spec.closed_flags)

    def _dispatch(self, kind: str, job: _Launch, per_stream) -> dict:
        """Run one campaign launch and bring its outputs to the host:
        on the engine's device, or — with a mesh — one shard per mesh
        device (the per-stream tree padded to a device multiple by
        repeating the last stream, each shard's streams moved to its
        device), the outputs gathered and the padded rows sliced off.
        Per-scenario outputs of the bracket are global."""
        if self.mesh is None:
            shards, t = [(self.device, per_stream)], None
        else:
            per_stream, t = _shard_pad(per_stream, self.mesh.size)
            t_pad = int(tree_leaves(per_stream)[0].shape[0])
            self.shard_shape = (self.mesh.size, t_pad // self.mesh.size,
                                int(per_stream[0].shape[-1]))
            shards = list(zip(self.mesh.devices,
                              shard_campaign(self.mesh, per_stream)))
        outs = (_bracket(job, shards) if kind == "bracket" else
                [_BODIES[kind](job, dev, st) for dev, st in shards])
        glob = {"worst_bin", "temp_peak"}
        return {k: (outs[0][k].cpu().numpy() if k in glob else np.concatenate(
                    [o[k].cpu().numpy() for o in outs], 0)[:t])
                for k in outs[0]}

    # --------------------------------------------------------------- run
    def run(self, spec: SimSpec, fault_uniforms=None,
            config: ReplayConfig | None = None) -> SimResult:
        """One replay launch over the whole campaign grid (one per shard
        under a mesh).  The streams are checked once, before the reorder
        and the launch (the region map was checked by `SimSpec`).  With
        a fault axis the error uniforms are a [T, N] float32 draw from a
        generator on the engine's device seeded with `FaultSpec.seed`,
        consumed by issue position; `fault_uniforms` ([T, N] at the
        padded stream length) replaces that draw.  `config` overrides
        the engine's backend for this run."""
        backend, bs = self._resolve(spec, config)
        if self.mesh is not None and spec.fault_on:
            raise ValueError("fault campaigns are single-device: run a "
                             "faulted spec on an engine without a mesh")
        per_stream, valid, plan = self._streams(spec, "SimEngine.run")
        dev = self.device
        fa = spec.faults
        nf = 0 if fa is None else len(fa)
        fault = None
        if spec.fault_on:
            if fault_uniforms is None:
                u = F.fault_uniforms(fa.seed, *valid.shape, device=dev)
            else:
                u = (fault_uniforms if isinstance(fault_uniforms,
                                                  torch.Tensor)
                     else torch.from_numpy(np.array(fault_uniforms,
                                                    np.float32)))
                u = u.to(device=dev, dtype=torch.float32)
                if tuple(u.shape) != valid.shape:
                    raise ValueError(f"fault_uniforms must be {valid.shape} "
                                     f"([T, N] padded), got {tuple(u.shape)}")
            fault = (torch.as_tensor(fa.pack(), device=dev), u)
        self.dispatch_count += 1
        job = _Launch(spec, backend, bs, plan, _p99_k(valid), (),
                      torch.as_tensor(spec.timings, device=dev),
                      region_map=spec.region_map)
        host = self.stats == "host"
        if spec.thermal is None:
            s_rows = spec.timings.shape[0]
            if fault is not None:
                # lane l = s*F + f replays timing row s under fault row f;
                # the last timing row is the JEDEC fallback
                job.timings = job.timings.repeat_interleave(nf, dim=0)
                job.fault = (fault[0].repeat(s_rows, 1), job.timings[-1],
                             fault[1])
            job.want = (("lat",) if host else ("stats",) + (
                ("lat",) if "latencies" in spec.collect else ()))
            out = self._dispatch("static", job, per_stream)
            extra = {}
        else:
            job.fault = fault
            job.thermal = spec.thermal.pack()
            job.want = (("lat", "temps", "bins", "diag") if host else
                        ("stats",) + tuple(
                            x for x, c in (("lat", "latencies"),
                                           ("temps", "temps"),
                                           ("bins", "bins"))
                            if c in spec.collect))
            out = self._dispatch("adaptive", job, per_stream)
            extra = {k: out[k] for k in ("temp_max", "temp_mean",
                                         "bin_switches", "bank_heat")}
            for name in ("temps", "bins"):
                if name in spec.collect:
                    extra[name] = out[name]
        if host:
            mean, p99 = _masked_stats(out["lat"], valid)
        else:
            mean, p99 = out["mean"], out["p99"]
        res = dict(mean_latency_ns=mean, p99_latency_ns=p99,
                   total_ns=out["total"],
                   latencies=(out["lat"] if "latencies" in spec.collect
                              else None), **extra)
        if fault is not None:
            res["fault_counters"] = out["cnt"]
            if spec.thermal is None:
                # unflatten the static (timing x fault) lanes:
                # [T, P, S*F, ...] -> [T, P, S, F, ...]
                res = {k: (None if x is None else
                           x.reshape(x.shape[:2] + (s_rows, nf)
                                     + x.shape[3:]))
                       for k, x in res.items()}
        elif fa is not None:
            # an all-inert spec: the unfaulted grid repeated along F
            # (after S, or after K, C) with zero counters
            ax = 3 if spec.thermal is None else 4
            res = {k: (None if x is None else
                       np.repeat(np.expand_dims(x, ax), nf, ax))
                   for k, x in res.items()}
            res["fault_counters"] = np.zeros(
                res["total_ns"].shape + (F.N_COUNTERS,), np.int32)
        return SimResult(spec=spec, valid=valid, **res)

    def run_bracket(self, spec: SimSpec, base_row,
                    n_real: int | None = None,
                    config: ReplayConfig | None = None) -> dict:
        """The adaptive-vs-static-worst-case bracket of
        `perf_model.evaluate_adaptive` as one engine call: the adaptive
        campaign runs, its per-scenario temperature peaks (max over
        traces and policies of the first `n_real` scenarios, default
        all; under a mesh an exact max across shards) plus the
        hysteresis margin round up to worst-case bins on the device
        (`torch.searchsorted`), and the static campaign replays
        `base_row` followed by each scenario's worst-bin row — two
        launches (per shard) with no host round trip between them (the
        streams are checked once, before the first).

        `spec` must be adaptive with one table stack.  Returns numpy
        dicts {"adaptive": mean/p99/total/temp_max/temp_mean/
        bin_switches/bank_heat, "static": mean/p99/total over the
        [1 + n_real] rows, "worst_bin" [n_real], "temp_peak" [n_real],
        "valid"}."""
        if spec.thermal is None or spec.timings.shape[0] != 1:
            raise ValueError("run_bracket needs an adaptive spec with one "
                             "table stack")
        if spec.fault_on:
            raise ValueError("run_bracket carries no fault axis: run() the "
                             "faulted spec")
        if spec.region_map is not None:
            raise ValueError("run_bracket replays per-module or per-bank "
                             "stacks, not a region map")
        backend, bs = self._resolve(spec, config)
        per_stream, valid, plan = self._streams(spec, "run_bracket")
        dev = self.device
        # every host-to-device copy before the first launch: a copy from
        # pageable host memory waits for the stream
        thermal = tuple(torch.as_tensor(x, device=dev)
                        for x in spec.thermal.pack())
        n_real = thermal[0].shape[0] if n_real is None else int(n_real)
        self.dispatch_count += 1
        job = _Launch(spec, backend, bs, plan, _p99_k(valid), ("stats",),
                      torch.as_tensor(spec.timings, device=dev),
                      thermal=thermal,
                      base_row=torch.as_tensor(base_row, dtype=torch.float32,
                                               device=dev), n_real=n_real)
        out = self._dispatch("bracket", job, per_stream)
        return {"adaptive": {k: out[k] for k in (
                    "mean", "p99", "total", "temp_max", "temp_mean",
                    "bin_switches", "bank_heat")},
                "static": {k: out[f"static_{k}"]
                           for k in ("mean", "p99", "total")},
                "worst_bin": out["worst_bin"], "temp_peak": out["temp_peak"],
                "valid": valid}


_DEFAULT: dict[str, SimEngine] = {}


def default_engine(device: str | torch.device = "cuda") -> SimEngine:
    """The shared engine of the `dram_sim.simulate` shim on `device`:
    the bitwise reference configuration (host statistics, host
    reordering)."""
    dev = resolve_device(device)
    if str(dev) not in _DEFAULT:
        _DEFAULT[str(dev)] = SimEngine(device=dev, stats="host",
                                       reorder="host")
    return _DEFAULT[str(dev)]

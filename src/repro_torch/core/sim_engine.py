"""Batched trace-replay campaigns (port of the single-channel, unfaulted
subset of `repro.core.sim_engine`): the paper's real-system evaluation
(Sec. 6, Fig. 4) and its closed thermal loop (Sec. 4) as ONE replay
launch each.

A `SimSpec` declares the campaign axes — traces (padded to one length
with a validity mask), scheduling policies (open/closed page, FCFS) and
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

stats="device" (default) reduces masked mean and interpolated p99 on
the device (`_device_stats`, p99 from a `torch.topk` of static depth)
and moves only [T, P, S] summaries to the host; stats="host" is the
numpy reference (`_masked_stats`).  The two agree within 1e-5
relative; the latency grid itself is identical either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.dram_sim import (OPEN_FCFS, Policy, Trace,
                                       check_prefix_valid)
from repro_torch.core.thermal import ThermalSpec
from repro_torch.device import resolve_device

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
    lengths; shorter ones are padded) or a single `Trace` whose fields
    carry a leading batch axis.  `collect` keeps raw per-request grids
    (moved to the host): "latencies" ([T, P, S, N] or [T, P, K, C, N]),
    and on the adaptive path "temps" and "bins".

    Attaching `thermal` switches to the closed-loop replay: `timings`
    is then a stack of per-bin tables ([K, S+1, 6] or per-bank
    [K, S+1, banks, 6]) and the grid is [T, P, K, C] (C = scenarios).

    `region_map` (int, [banks * R] shared, or [S, banks * R] / [K,
    banks * R] per timing row / table stack) switches the spatial axis
    of `timings` to the unique-row store ([S, U, 6] / [K, S+1, U, 6]):
    each request reads the row of its (bank, region_of(row, R)) slot
    through the map.  Its range is checked here, once per campaign, on
    the host."""

    traces: tuple[Trace, ...]
    # [S, 6] | per-bank [S, banks, 6] | region store [S, U, 6] |
    # adaptive [K, S+1, 6] | [K, S+1, banks, 6] | [K, S+1, U, 6]
    timings: np.ndarray
    policies: tuple[Policy, ...] = (OPEN_FCFS,)
    n_banks: int = 8
    mlp_window: int = 8
    collect: tuple[str, ...] = ()
    thermal: ThermalSpec | None = None
    region_map: np.ndarray | None = None
    # axes of the reference campaign that are not ported yet
    n_channels: int = 1
    n_ranks: int = 1
    faults: object = None

    def __post_init__(self):
        if self.thermal is not None and not isinstance(self.thermal,
                                                       ThermalSpec):
            raise TypeError(f"thermal must be a ThermalSpec, got "
                            f"{type(self.thermal).__name__}")
        if self.faults is not None:
            raise NotImplementedError(
                "SimSpec.faults is not ported yet: ROADMAP queue A item 9")
        if self.n_channels * self.n_ranks != 1:
            raise NotImplementedError(
                "multi-channel campaigns are not ported yet: ROADMAP "
                "queue A item 10")
        tr = self.traces
        if isinstance(tr, Trace):
            tr = (tuple(Trace(*(f[i] for f in tr))
                        for i in range(tr.arrival.shape[0]))
                  if tr.arrival.ndim == 2 else (tr,))
        if not isinstance(tr, (tuple, list)):
            raise NotImplementedError(
                "declarative trace axes (SynthSpec/TenantSpec) are not "
                "ported yet: ROADMAP queue A item 7")
        object.__setattr__(self, "traces", tuple(tr))
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

    @property
    def shape(self) -> tuple[int, ...]:
        base = (len(self.traces), len(self.policies), self.timings.shape[0])
        return (base if self.thermal is None else
                base + (len(self.thermal.scenarios),))

    @property
    def closed_flags(self) -> np.ndarray:
        return np.array([p.closed for p in self.policies])

    def pack(self, device: torch.device):
        """Pad the traces into dense [T, P, N] request tensors on
        `device` (FCFS order, shared by every policy) plus the [T, N]
        validity mask (host numpy) and the [P] closed-page flags."""
        lens = [int(t.arrival.shape[0]) for t in self.traces]
        n, nt, npol = max(lens), len(self.traces), len(self.policies)
        arrival = torch.zeros((nt, n), dtype=torch.float32, device=device)
        bank = torch.zeros((nt, n), dtype=torch.int32, device=device)
        row = torch.zeros((nt, n), dtype=torch.int32, device=device)
        is_write = torch.zeros((nt, n), dtype=torch.bool, device=device)
        valid = np.zeros((nt, n), bool)
        for i, t in enumerate(self.traces):
            k = lens[i]
            valid[i, :k] = True
            arrival[i, :k] = torch.as_tensor(t.arrival, device=device)
            bank[i, :k] = torch.as_tensor(t.bank, device=device)
            row[i, :k] = torch.as_tensor(t.row, device=device)
            is_write[i, :k] = torch.as_tensor(t.is_write, device=device)
        check_prefix_valid(valid, "SimSpec.pack")

        def per_policy(x):
            return x[:, None, :].expand(nt, npol, n)

        return (per_policy(arrival), per_policy(bank), per_policy(row),
                per_policy(is_write), valid, self.closed_flags)


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Result grid of one campaign; arrays lead with [T, P, S] =
    (traces, policies, timing rows), or [T, P, K, C] = (traces,
    policies, table stacks, thermal scenarios) on the adaptive path.
    `latencies` ([..., N], 0 at padding), `temps` and `bins` (-1 at
    padding) are None unless the spec collected them; the thermal
    diagnostics and `bank_heat` are set on the adaptive path only."""

    spec: SimSpec
    mean_latency_ns: np.ndarray     # [T, P, S] | [T, P, K, C]
    p99_latency_ns: np.ndarray      # same leading shape
    total_ns: np.ndarray            # same leading shape
    valid: np.ndarray               # [T, N]
    latencies: np.ndarray | None = None
    temps: np.ndarray | None = None         # [T, P, K, C, N] sensed C
    bins: np.ndarray | None = None          # [T, P, K, C, N] int32
    temp_max: np.ndarray | None = None      # [T, P, K, C]
    temp_mean: np.ndarray | None = None     # [T, P, K, C]
    bin_switches: np.ndarray | None = None  # [T, P, K, C]
    bank_heat: np.ndarray | None = None     # [T, P, K, C, banks] end C


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


def _masked_stats(lat: np.ndarray, valid: np.ndarray):
    """Host reference of `_device_stats`: masked mean over each trace's
    valid prefix and the interpolated p99, in numpy float32."""
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


@dataclasses.dataclass
class SimEngine:
    """Compiles a `SimSpec` into one replay launch on `device` (default
    "cuda"; raises without a card).  `dispatch_count` increments once
    per `run`."""

    device: str | torch.device = "cuda"
    dispatch_count: int = 0
    stats: str = "device"
    mesh: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.stats not in ("device", "host"):
            raise ValueError(f"stats must be 'device' or 'host': {self.stats}")
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded campaigns (mesh) are not ported yet: ROADMAP "
                "queue A item 10")

    def run(self, spec: SimSpec) -> SimResult:
        """One replay launch over the whole campaign grid.  The streams
        are checked once, before the launch (the region map was checked
        by `SimSpec`)."""
        from repro_torch.kernels.replay import ops as replay_ops
        arrival, bank, row, is_write, valid, closed = spec.pack(self.device)
        dev = self.device
        regioned = spec.region_map is not None
        replay_ops.check_data("SimEngine.run", bank, valid, spec.n_banks,
                              row if regioned else None)
        valid_d = torch.as_tensor(valid, device=dev)
        closed_d = torch.as_tensor(closed, device=dev)
        timings = torch.as_tensor(spec.timings, device=dev)
        rmap = (torch.as_tensor(spec.region_map, device=dev) if regioned
                else None)
        self.dispatch_count += 1
        if spec.thermal is None:
            lat, total = replay_ops.replay_grid(
                arrival, bank, row, is_write, valid_d, timings, closed_d,
                spec.n_banks, spec.mlp_window, validated=True,
                region_map=rmap)
            extra = {}
        else:
            scns, bins, tcfg = spec.thermal.pack()
            raw = self.stats == "host" or "temps" in spec.collect \
                or "bins" in spec.collect
            lat, total, temps, bin_sel, heat, diag = \
                replay_ops.replay_grid_adaptive(
                    arrival, bank, row, is_write, valid_d, timings, bins,
                    scns, tcfg, closed_d, spec.n_banks, spec.mlp_window,
                    emit_raw=raw, validated=True, region_map=rmap)
            if self.stats == "host":
                diag = _device_thermal_diag(temps, bin_sel, valid_d)
            extra = dict(zip(("temp_max", "temp_mean", "bin_switches"),
                             (x.cpu().numpy() for x in diag)))
            extra["bank_heat"] = heat.cpu().numpy()
            for name, x in (("temps", temps), ("bins", bin_sel)):
                if name in spec.collect:
                    extra[name] = x.cpu().numpy()
        if self.stats == "host":
            lat_h = lat.cpu().numpy()
            mean, p99 = _masked_stats(lat_h, valid)
        else:
            mean, p99 = (x.cpu().numpy()
                         for x in _device_stats(lat, valid_d, _p99_k(valid)))
            lat_h = (lat.cpu().numpy() if "latencies" in spec.collect
                     else None)
        return SimResult(spec=spec, mean_latency_ns=mean,
                         p99_latency_ns=p99, total_ns=total.cpu().numpy(),
                         valid=valid,
                         latencies=(lat_h if "latencies" in spec.collect
                                    else None), **extra)

    def run_bracket(self, spec: SimSpec, base_row,
                    n_real: int | None = None) -> dict:
        """The adaptive-vs-static-worst-case bracket of
        `perf_model.evaluate_adaptive` as one engine call: the adaptive
        campaign runs, its per-scenario temperature peaks (max over
        traces and policies of the first `n_real` scenarios, default
        all) plus the hysteresis margin round up to worst-case bins on
        the device (`torch.searchsorted`), and the static campaign
        replays `base_row` followed by each scenario's worst-bin row —
        two launches with no host round trip between them (the streams
        are checked once, before the first).

        `spec` must be adaptive with one table stack.  Returns numpy
        dicts {"adaptive": mean/p99/total/temp_max/temp_mean/
        bin_switches/bank_heat, "static": mean/p99/total over the
        [1 + n_real] rows, "worst_bin" [n_real], "temp_peak" [n_real],
        "valid"}."""
        from repro_torch.kernels.replay import ops as replay_ops
        if spec.thermal is None or spec.timings.shape[0] != 1:
            raise ValueError("run_bracket needs an adaptive spec with one "
                             "table stack")
        if spec.region_map is not None:
            raise ValueError("run_bracket replays per-module or per-bank "
                             "stacks, not a region map")
        dev = self.device
        arrival, bank, row, is_write, valid, closed = spec.pack(dev)
        replay_ops.check_data("run_bracket", bank, valid, spec.n_banks)
        valid_d = torch.as_tensor(valid, device=dev)
        closed_d = torch.as_tensor(closed, device=dev)
        tables = torch.as_tensor(spec.timings, device=dev)
        # every host-to-device copy before the first launch: a copy from
        # pageable host memory waits for the stream
        scns, bins, tcfg = (torch.as_tensor(x, device=dev)
                            for x in spec.thermal.pack())
        n_real = scns.shape[0] if n_real is None else int(n_real)
        tab0 = tables[0]                      # [S+1, (B,) 6], JEDEC last
        base = torch.as_tensor(base_row, dtype=torch.float32,
                               device=dev).expand(tab0.shape[1:])
        k = _p99_k(valid)
        self.dispatch_count += 1
        lat, total, _, _, heat, (tmax, tmean, sw) = \
            replay_ops.replay_grid_adaptive(
                arrival, bank, row, is_write, valid_d, tables, bins, scns,
                tcfg, closed_d, spec.n_banks, spec.mlp_window,
                validated=True)
        mean_a, p99_a = _device_stats(lat, valid_d, k)
        peak = tmax[:, :, 0, :n_real].amax(dim=(0, 1))
        worst = torch.searchsorted(bins, peak + tcfg[2], side="left")
        rows = torch.cat([base[None], tab0[worst]], dim=0)
        lat_s, total_s = replay_ops.replay_grid(
            arrival, bank, row, is_write, valid_d, rows, closed_d,
            spec.n_banks, spec.mlp_window, validated=True)
        mean_s, p99_s = _device_stats(lat_s, valid_d, k)

        def host(**d):
            return {name: x.cpu().numpy() for name, x in d.items()}

        return {"adaptive": host(mean=mean_a, p99=p99_a, total=total,
                                 temp_max=tmax, temp_mean=tmean,
                                 bin_switches=sw, bank_heat=heat),
                "static": host(mean=mean_s, p99=p99_s, total=total_s),
                "worst_bin": worst.cpu().numpy(),
                "temp_peak": peak.cpu().numpy(), "valid": valid}

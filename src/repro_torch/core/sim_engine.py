"""Batched trace-replay campaigns (port of the static subset of
`repro.core.sim_engine`): the paper's real-system evaluation (Sec. 6,
Fig. 4) as ONE replay launch.

A `SimSpec` declares the campaign axes — traces (padded to one length
with a validity mask), scheduling policies (open/closed page, FCFS) and
stacked timing rows [S, 6] — and `SimEngine.run` replays the whole
(T x P x S) grid through `repro_torch.kernels.replay.ops.replay_grid`:
the CUDA kernel on a card, its plain version on the CPU.

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
from repro_torch.device import resolve_device

COLLECTABLE = ("latencies",)


def _as_rows(timings) -> np.ndarray:
    """Normalize the timing axis to a [S, 6] stacked-row matrix."""
    if isinstance(timings, T.TimingParams):
        return timings.as_row()[None, :]
    if isinstance(timings, (list, tuple)):
        return T.stack_timing(timings)
    arr = np.asarray(timings, np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim == 3:
        raise NotImplementedError(
            "per-bank [S, banks, 6] timing stacks are not ported yet: "
            "ROADMAP queue A item 8")
    if arr.ndim != 2 or arr.shape[-1] != 6:
        raise ValueError(f"timings must be [S, 6], got {arr.shape}")
    return arr


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """A declarative trace-replay campaign: every trace runs under every
    policy and every timing row.  `traces` is a tuple of `Trace`s (any
    lengths; shorter ones are padded) or a single `Trace` whose fields
    carry a leading batch axis.  `collect=("latencies",)` keeps the raw
    [T, P, S, N] latency grid (moved to the host)."""

    traces: tuple[Trace, ...]
    timings: np.ndarray              # [S, 6]
    policies: tuple[Policy, ...] = (OPEN_FCFS,)
    n_banks: int = 8
    mlp_window: int = 8
    collect: tuple[str, ...] = ()
    # axes of the reference campaign that are not ported yet
    thermal: object = None
    n_channels: int = 1
    n_ranks: int = 1
    faults: object = None
    region_map: object = None

    def __post_init__(self):
        for name, todo in (("thermal", "6"), ("faults", "9"),
                           ("region_map", "8")):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"SimSpec.{name} is not ported yet: ROADMAP queue A "
                    f"item {todo}")
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
        object.__setattr__(self, "timings", _as_rows(self.timings))
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "collect", tuple(self.collect))
        if not (self.traces and self.policies):
            raise ValueError("empty campaign")
        if not all(c in COLLECTABLE for c in self.collect):
            raise ValueError(f"collect {self.collect} not in {COLLECTABLE}")

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
    (traces, policies, timing rows).  `latencies` ([T, P, S, N], 0 at
    padding) is None unless the spec collected it."""

    spec: SimSpec
    mean_latency_ns: np.ndarray     # [T, P, S]
    p99_latency_ns: np.ndarray      # [T, P, S]
    total_ns: np.ndarray            # [T, P, S]
    valid: np.ndarray               # [T, N]
    latencies: np.ndarray | None = None


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
    position cnt-1-i.  Same interpolation arithmetic as `_masked_stats`;
    only the summation order of the mean differs."""
    mid = (1,) * (lat.dim() - 2)
    v = valid.reshape((valid.shape[0],) + mid + (valid.shape[1],))
    cnt = valid.sum(-1).to(torch.float32).reshape((valid.shape[0],) + mid)
    mean = torch.where(v, lat, torch.zeros_like(lat)).sum(-1) / cnt
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
        from repro_torch.kernels.replay import ops as replay_ops
        arrival, bank, row, is_write, valid, closed = spec.pack(self.device)
        valid_d = torch.as_tensor(valid, device=self.device)
        self.dispatch_count += 1
        lat, total = replay_ops.replay_grid(
            arrival, bank, row, is_write, valid_d,
            torch.as_tensor(spec.timings, device=self.device),
            torch.as_tensor(closed, device=self.device),
            spec.n_banks, spec.mlp_window)
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
                                    else None))

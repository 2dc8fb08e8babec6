"""The AL-DRAM mechanism as a reusable library (port of
`repro.core.autotune`): per-unit, per-condition-bin adaptive parameter
tables with a guardband.

  unit       ~ DRAM module        -> worker node / host / kernel shape-bin
  condition  ~ temperature        -> load / congestion bin
  parameter  ~ tRCD/tRAS/tWR/tRP  -> timeout / prefetch depth / block size
  guardband  ~ one sweep step     -> quantile + k*sigma margin

The worst-case static value plays the role of the JEDEC timing:
`select` never returns something less safe than the profiled
guardbanded envelope, and unprofiled bins fall back to the static worst
case, the controller's own conservative semantics.

`ReplayTuner` turns the same table onto the simulator: the replay
configuration (`ReplayConfig`: the replay core and the chain lanes per
block of the CUDA replay kernels) is the adaptive
parameter, the campaign's (kind, log2-size) bin is the condition, and
candidate 0 (the kernel at its default block) is the static worst case
every unprofiled bin falls back to.  `SimEngine.autotune` profiles the
candidates and records winners here; `SimEngine(backend="auto")`
consults the table at run time.  No CUDA candidate routes a CUDA
tensor to the plain version of a ported kernel.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np


@dataclasses.dataclass
class AdaptiveTable:
    """Profile -> table -> guardbanded runtime selection."""

    condition_bins: tuple[float, ...]
    static_worst_case: float
    quantile: float = 0.999
    k_sigma: float = 3.0
    higher_is_safer: bool = True     # timeouts: larger = safer

    def __post_init__(self):
        self._table: dict[tuple[int, int], float] = {}
        self._samples: dict[tuple[int, int], list[float]] = {}

    def _bin(self, condition: float) -> int:
        """Smallest profiled bin >= condition; one past the end when the
        condition exceeds every bin (so `select` falls back to the
        static worst case, like the controller above its hottest bin)."""
        for i, b in enumerate(self.condition_bins):
            if condition <= b:
                return i
        return len(self.condition_bins)

    def observe(self, unit: int, condition: float, value: float):
        b = self._bin(condition)
        if b >= len(self.condition_bins):
            # beyond the profiled range `select` answers the static
            # worst case; such samples would only build unreachable
            # entries
            return
        self._samples.setdefault((unit, b), []).append(float(value))

    def fit(self, min_samples: int = 16):
        """Build the guardbanded table from observations.  `min_samples`
        is clamped to >= 2: a quantile + k*sigma guardband needs a
        spread.  Bins left unfitted stay out of the table, so `select`
        answers them with the static worst case."""
        min_samples = max(int(min_samples), 2)
        for key, vals in self._samples.items():
            if len(vals) < min_samples:
                continue
            v = np.asarray(vals)
            q = float(np.quantile(v, self.quantile))
            guard = q + self.k_sigma * float(v.std())
            if self.higher_is_safer:
                self._table[key] = min(guard, self.static_worst_case)
            else:
                self._table[key] = max(guard, self.static_worst_case)
        return self

    @classmethod
    def from_sweep(cls, result, op, static_worst_case: float
                   ) -> "AdaptiveTable":
        """A table from a `MarginEngine` campaign (`sweep.SweepResult`):
        the chosen per-module latency sums become the per-unit,
        per-condition-bin entries (condition = temperature bin), with
        the standard-timing latency sum as the static worst case.  The
        profiling guardband is already inside the sweep's combo choice,
        so no extra margin is applied."""
        t = cls(condition_bins=tuple(result.temps),
                static_worst_case=float(static_worst_case),
                higher_is_safer=True)
        sums = result.latency_sum[result.index(op)]    # [units, bins]
        for u in range(sums.shape[0]):
            for b in range(sums.shape[1]):
                t._table[(u, b)] = min(float(sums[u, b]),
                                       t.static_worst_case)
        return t

    def select(self, unit: int, condition: float) -> float:
        """Conservative: exact bin if profiled, else the next-safer
        profiled bin, else the static worst case (JEDEC fallback)."""
        b = self._bin(condition)
        for bb in range(b, len(self.condition_bins)):
            if (unit, bb) in self._table:
                return self._table[(unit, bb)]
        return self.static_worst_case

    def savings(self, unit: int, condition: float) -> float:
        """Fractional margin recovered vs the static worst case."""
        v = self.select(unit, condition)
        wc = self.static_worst_case
        return (wc - v) / wc if self.higher_is_safer else (v - wc) / wc


# --------------------------------------------------------------------
# Replay autotuning (SimEngine backend and block selection)
# --------------------------------------------------------------------

# the backends a `ReplayConfig` may name ("auto" is the engine's)
REPLAY_BACKENDS = ("kernel", "merged")


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """One replay configuration the tuner scores: the replay core
    ("kernel": the ported CUDA kernels on a card, their plain versions
    on the CPU; "merged": the FR-FCFS scheduler merged into the plain
    static replay, CPU only), the chain lanes per block of the replay
    kernels (32, 64 or 128; None = the kernel's default)."""

    backend: str = "kernel"
    block_rows: int | None = None

    def __post_init__(self):
        if self.backend not in REPLAY_BACKENDS:
            raise ValueError(f"backend must be one of {REPLAY_BACKENDS}, "
                             f"got {self.backend!r}")


def replay_unit(adaptive: bool, banked: bool,
                channels: bool = False, regioned: bool = False) -> int:
    """Campaign-kind unit of the tuner table: static / adaptive x
    per-module / per-bank x single / multi-channel x dense /
    region-compressed tune independently (the reference's numbering)."""
    return ((8 if regioned else 0) + (4 if channels else 0)
            + (2 if adaptive else 0) + (1 if banked else 0))


# log2(request count) bin edges: campaigns within a bin share a tuned
# config (a replay's time is dominated by N; the grid axes are lanes)
REPLAY_SIZE_BINS = (10.0, 12.0, 14.0, 17.0, 24.0)

# candidate 0 is ALWAYS the kernel at its default block: the static
# worst case unprofiled bins fall back to.  On a card every candidate
# launches the ported kernel (no plain version of a kernel runs there);
# on the CPU "kernel" is the plain version and "merged" the scheduler-
# merged plain replay.  The one lane cap a card profiles is 32: in
# paired timings on an H100 it ran the adaptive kernel 2 % faster at 72
# lanes and was never slower than the spread elsewhere but at 128
# lanes (1.44x); 64 lanes lost wherever it changed the block (1.24-1.65x)
_CANDIDATES = {
    "cuda": (ReplayConfig("kernel"),
             ReplayConfig("kernel", 32)),
    "cpu": (ReplayConfig("kernel"),
            ReplayConfig("merged")),
}


@dataclasses.dataclass
class ReplayTuner:
    """Profiled `ReplayConfig` per (campaign kind, size bin), with
    `AdaptiveTable` fallback semantics: `lookup` on an unprofiled bin
    answers candidate 0.

    The table persists as JSON: `path` wins, else the
    REPRO_TORCH_AUTOTUNE_PATH environment variable, else
    ~/.cache/repro_torch/replay_tune_<platform>.json (apart from the
    JAX package's tables); path="" disables the disk cache.  Stored
    entries whose candidate list differs from this tuner's are dropped
    on load."""

    platform: str = "cpu"
    path: str | None = None
    candidates: tuple[ReplayConfig, ...] = ()

    def __post_init__(self):
        if not self.candidates:
            if self.platform not in _CANDIDATES:
                raise ValueError(f"platform must be one of "
                                 f"{tuple(_CANDIDATES)}, got "
                                 f"{self.platform!r}")
            self.candidates = _CANDIDATES[self.platform]
        self.candidates = tuple(self.candidates)
        self.table = AdaptiveTable(condition_bins=REPLAY_SIZE_BINS,
                                   static_worst_case=0.0,
                                   higher_is_safer=False)
        self.timings: dict[tuple[int, int], list[float]] = {}
        self._load()

    def _resolve_path(self) -> str | None:
        if self.path == "":
            return None
        if self.path:
            return self.path
        env = os.environ.get("REPRO_TORCH_AUTOTUNE_PATH")
        if env:
            return env
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "repro_torch",
                            f"replay_tune_{self.platform}.json")

    def _load(self):
        p = self._resolve_path()
        if not p or not os.path.exists(p):
            return
        try:
            with open(p) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if data.get("candidates") != [dataclasses.asdict(c)
                                      for c in self.candidates]:
            return
        for key, idx in data.get("table", {}).items():
            u, b = (int(x) for x in key.split(","))
            if 0 <= int(idx) < len(self.candidates):
                self.table._table[(u, b)] = float(idx)

    def _save(self):
        p = self._resolve_path()
        if not p:
            return
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
        data = {
            "platform": self.platform,
            "candidates": [dataclasses.asdict(c) for c in self.candidates],
            "table": {f"{u},{b}": int(v) for (u, b), v
                      in self.table._table.items()},
        }
        with open(p, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)

    def _condition(self, n: int) -> float:
        return math.log2(max(int(n), 1))

    def lookup(self, unit: int, n: int) -> ReplayConfig:
        """The profiled config for a campaign of `n` requests —
        candidate 0 when the bin is unprofiled."""
        idx = int(self.table.select(unit, self._condition(n)))
        return self.candidates[idx]

    def tune(self, unit: int, n: int, measure
             ) -> tuple[ReplayConfig, list[float]]:
        """Score every candidate with `measure(config) -> seconds`
        (supplied by the engine), record the winner's index in the
        table, persist, and return (winning config, per-candidate
        seconds)."""
        times = [float(measure(cfg)) for cfg in self.candidates]
        best = int(np.argmin(times))
        b = self.table._bin(self._condition(n))
        if b < len(self.table.condition_bins):
            # beyond the last bin `select` always answers candidate 0
            self.table._table[(unit, b)] = float(best)
            self.timings[(unit, b)] = times
            self._save()
        return self.candidates[best], times

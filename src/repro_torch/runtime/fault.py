"""Fault tolerance: heartbeat failure detection + checkpoint/restart
(port of `repro.runtime.fault`).

`FaultTolerantLoop` wraps a train-step callable with:
  * periodic async checkpoints (CheckpointManager),
  * a simulated heartbeat monitor (nodes miss beats -> declared dead),
  * restart-from-checkpoint on failure (the reference's elastic
    re-mesh, `runtime/elastic.py`, waits for the model half of
    `launch/sharding.py`).

The heartbeat thresholds use the AL-DRAM adaptive table (per-node
profiles) rather than a single static miss budget.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.autotune import AdaptiveTable


@dataclasses.dataclass
class HeartbeatMonitor:
    n_nodes: int
    interval_ms: float = 100.0
    static_miss_budget: float = 10.0    # worst-case beats missed

    def __post_init__(self):
        self.tables = [
            AdaptiveTable((0.5, 1.0), self.static_miss_budget,
                          quantile=0.999, k_sigma=3.0)
            for _ in range(self.n_nodes)]
        # NaN = "never beaten": a node that has not reported yet must
        # not be measured against time 0.0 — a monitor started at
        # now_ms > budget would otherwise declare every node dead
        # before its first heartbeat
        self.last_beat = np.full(self.n_nodes, np.nan)

    def observe_gap(self, node: int, gap_beats: float):
        self.tables[node].observe(node, 1.0, gap_beats)

    def fit(self, min_samples: int = 16):
        """Fit every node table; degenerate sample counts (0/1 gap
        observations, or a `min_samples` of 0/1) are a no-op —
        `AdaptiveTable.fit` clamps to >= 2 and skips short bins, so
        `dead` keeps judging against the static miss budget."""
        for t in self.tables:
            t.fit(min_samples=min_samples)

    def dead(self, node: int, now_ms: float) -> bool:
        if np.isnan(self.last_beat[node]):      # never beaten: exempt
            return False
        missed = (now_ms - self.last_beat[node]) / self.interval_ms
        return missed > self.tables[node].select(node, 1.0)

    def beat(self, node: int, now_ms: float):
        if not np.isnan(self.last_beat[node]):
            gap = (now_ms - self.last_beat[node]) / self.interval_ms
            self.observe_gap(node, gap)
        self.last_beat[node] = now_ms


class FaultTolerantLoop:
    """step_fn(state, batch) -> state; failures injected via
    `failure_schedule` (a set of steps).  On failure the loop restores
    the last committed checkpoint and replays."""

    def __init__(self, step_fn: Callable, state, ckpt: CheckpointManager,
                 failure_schedule: set[int] | None = None):
        self.step_fn = step_fn
        self.state = state
        self.ckpt = ckpt
        self.failures = failure_schedule or set()
        self.restarts = 0
        self.steps_replayed = 0

    def run(self, batches, n_steps: int):
        step = 0
        self.ckpt.maybe_save(0, self.state, force=True)
        while step < n_steps:
            if step in self.failures:
                self.failures.discard(step)       # fail once per entry
                self.ckpt.wait()
                self.state, restored = self.ckpt.restore(self.state)
                self.restarts += 1
                self.steps_replayed += step - restored
                step = restored
                continue
            self.state = self.step_fn(self.state, batches(step))
            step += 1
            self.ckpt.maybe_save(step, self.state)
        self.ckpt.wait()
        return self.state, {"restarts": self.restarts,
                            "steps_replayed": self.steps_replayed,
                            "final_step": step}

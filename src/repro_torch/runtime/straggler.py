"""Straggler mitigation with AL-DRAM-style adaptive thresholds (port of
`repro.runtime.straggler`; numpy, as the reference).

The classic detector uses one static worst-case timeout (the "JEDEC
timing" of the cluster): slow-but-healthy nodes never trip it, and real
stragglers are detected late.  The adaptive detector profiles each
node's step-latency distribution into per-(node, load-bin) guardbanded
thresholds — the paper's mechanism with

    module -> node, temperature -> load bin,
    timing parameter -> timeout, guardband -> q0.999 + k*sigma.

`simulate()` quantifies the win on a synthetic heterogeneous cluster:
detection latency and false-positive rate, static vs adaptive — this
feeds the benchmarks and tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.autotune import AdaptiveTable

LOAD_BINS = (0.25, 0.5, 0.75, 1.0)


@dataclasses.dataclass
class ClusterModel:
    """Heterogeneous nodes: per-node base speed (process variation) +
    load-dependent slowdown (the 'temperature') + rare true stragglers."""

    n_nodes: int = 64
    base_sigma: float = 0.08       # lognormal node speed spread
    load_coeff: float = 0.35       # latency multiplier at full load
    straggle_prob: float = 0.01
    straggle_scale: float = 4.0
    base_ms: float = 100.0

    def sample(self, rng: np.random.Generator, steps: int):
        node_f = np.exp(rng.normal(0, self.base_sigma, self.n_nodes))
        load = rng.uniform(0, 1, (steps, self.n_nodes))
        lat = (self.base_ms * node_f[None, :]
               * (1 + self.load_coeff * load)
               * np.exp(rng.normal(0, 0.03, (steps, self.n_nodes))))
        straggle = rng.uniform(size=(steps, self.n_nodes)) < self.straggle_prob
        lat = np.where(straggle, lat * self.straggle_scale, lat)
        return lat, load, straggle


class StragglerDetector:
    def __init__(self, n_nodes: int, static_timeout_ms: float):
        self.static = static_timeout_ms
        self.tables = [AdaptiveTable(LOAD_BINS, static_timeout_ms,
                                     quantile=0.995, k_sigma=3.0)
                       for _ in range(n_nodes)]

    def observe(self, node: int, load: float, latency_ms: float):
        self.tables[node].observe(node, load, latency_ms)

    def fit(self, min_samples: int = 24):
        """Fit every node table; degenerate sample counts (0/1
        observations per bin, or a `min_samples` of 0/1) are a no-op —
        `AdaptiveTable.fit` clamps to >= 2 and skips short bins, so
        `threshold` keeps answering the static worst-case timeout."""
        for t in self.tables:
            t.fit(min_samples=min_samples)

    def threshold(self, node: int, load: float) -> float:
        return self.tables[node].select(node, load)

    def is_straggler(self, node: int, load: float, latency_ms: float
                     ) -> bool:
        return latency_ms > self.threshold(node, load)


def simulate(n_nodes: int = 64, warmup: int = 200, steps: int = 400,
             seed: int = 0) -> dict:
    """Static worst-case timeout vs adaptive per-node thresholds."""
    rng = np.random.default_rng(seed)
    model = ClusterModel(n_nodes=n_nodes)
    lat, load, truth = model.sample(rng, warmup + steps)

    # static timeout provisioned for the worst node at worst load + margin
    clean = lat[:warmup][~truth[:warmup]]
    static_timeout = float(clean.max() * 1.2)

    det = StragglerDetector(n_nodes, static_timeout)
    for t in range(warmup):
        for n in range(n_nodes):
            if not truth[t, n]:
                det.observe(n, load[t, n], lat[t, n])
    det.fit()

    res = {"static": {"tp": 0, "fp": 0, "fn": 0, "excess_ms": 0.0},
           "adaptive": {"tp": 0, "fp": 0, "fn": 0, "excess_ms": 0.0}}
    for t in range(warmup, warmup + steps):
        for n in range(n_nodes):
            is_true = bool(truth[t, n])
            for name, thr in (("static", static_timeout),
                              ("adaptive", det.threshold(n, load[t, n]))):
                flagged = lat[t, n] > thr
                if flagged and is_true:
                    res[name]["tp"] += 1
                    # detection latency: time waited beyond the healthy
                    # latency before the timeout fires
                    res[name]["excess_ms"] += thr - model.base_ms
                elif flagged and not is_true:
                    res[name]["fp"] += 1
                elif not flagged and is_true:
                    res[name]["fn"] += 1

    for name in res:
        r = res[name]
        r["recall"] = r["tp"] / max(r["tp"] + r["fn"], 1)
        r["detect_excess_ms"] = r["excess_ms"] / max(r["tp"], 1)
    res["static"]["timeout_ms"] = static_timeout
    res["adaptive"]["mean_threshold_ms"] = float(np.mean(
        [det.threshold(n, 0.5) for n in range(n_nodes)]))
    return res

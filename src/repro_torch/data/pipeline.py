"""Synthetic LM data pipeline with AL-DRAM-style adaptive prefetch (port
of `repro.data.pipeline`).

`SyntheticLM` makes the reference's draws: `np.random.default_rng(seed *
1_000_003 + step)` and one zipfian `choice` per batch, so a batch is bit
for bit the reference's.  The host-to-device prefetch queue is sized by
an `AdaptiveTable` profiled on batch-production latency, as in the
reference.  The reference's `shard_batch` places a batch under a device
sharding; the port's is a plain move to one device (the model half of
sharding waits for ROADMAP queue A, "LLM scaffold, what PR 16-17 left").
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.autotune import AdaptiveTable
from repro_torch.device import resolve_device

STATIC_WORST_CASE_DEPTH = 16


class SyntheticLM:
    """Deterministic synthetic token stream (seeded).  Tokens are
    zipfian, not uniform, so the loss has a unigram structure to learn."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** -zipf_a
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                          p=self._p).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def shard_batch(batch: dict[str, np.ndarray],
                device: str | torch.device = "cuda") -> dict:
    """The batch's arrays as tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


class AdaptivePrefetcher:
    """Background prefetch whose depth follows a profiled table:
    depth = ceil(guardbanded production latency / step time) + 1,
    clamped to the static worst case."""

    def __init__(self, it: Iterator, host_id: int = 0,
                 static_depth: int = STATIC_WORST_CASE_DEPTH,
                 step_time_s: float = 0.1):
        self.it = it
        self.host = host_id
        self.step_time = step_time_s
        self.table = AdaptiveTable(
            condition_bins=(0.5, 1.0, 2.0, 4.0),
            static_worst_case=float(static_depth),
            quantile=0.99, k_sigma=2.0, higher_is_safer=True)
        self.depth = static_depth
        self._q: queue.Queue = queue.Queue(maxsize=static_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._produced = 0
        self._thread.start()

    def _fill(self):
        for item in self.it:
            if self._stop.is_set():
                return
            t0 = time.monotonic()
            # condition: the normalised queue pressure
            pressure = 1.0 - self._q.qsize() / max(self._q.maxsize, 1)
            self._q.put(item)
            self.table.observe(self.host, pressure,
                               (time.monotonic() - t0) / self.step_time)
            self._produced += 1
            if self._produced % 64 == 0:
                self.refit()

    def refit(self):
        self.table.fit(min_samples=16)
        lat_ratio = self.table.select(self.host, 1.0)
        self.depth = int(min(max(1, np.ceil(lat_ratio) + 1),
                             self.table.static_worst_case))

    def get(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass

"""The port's runtime layer (`repro_torch.runtime.straggler`,
`runtime.fault`, `repro_torch.checkpoint`) on the CPU: the reference's
tests/test_runtime.py `TestStraggler`, `TestDegenerateFit`,
`TestCheckpoint`, `TestHeartbeat` and the fault-tolerant loop on the
port, the straggler simulation held to the reference's (both are numpy
on the same Generator, so the counts are equal), plus the checkpoint
cases the port adds: bfloat16 leaves (stored as their int16 bit view),
nested NamedTuples, a save started before an in-place update writing
the old values, a restore refusing a shape mismatch and a restore
placed with `device=`."""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from _torch_parity import one_thread as _one_thread  # noqa: F401


class TestStraggler:
    def test_adaptive_beats_static(self):
        from repro_torch.runtime.straggler import simulate
        res = simulate(n_nodes=24, warmup=150, steps=150)
        assert res["adaptive"]["recall"] >= res["static"]["recall"]
        assert (res["adaptive"]["detect_excess_ms"]
                <= res["static"]["detect_excess_ms"] + 1e-9)
        assert res["adaptive"]["fp"] <= 0.02 * 24 * 150

    def test_simulate_matches_reference(self):
        from repro.runtime.straggler import simulate as j_simulate
        from repro_torch.runtime.straggler import simulate
        for seed in (0, 3):
            assert simulate(n_nodes=16, warmup=100, steps=80, seed=seed) \
                == j_simulate(n_nodes=16, warmup=100, steps=80, seed=seed)


class TestDegenerateFit:
    def test_adaptive_table_clamps_min_samples(self):
        from repro_torch.core.autotune import AdaptiveTable
        t = AdaptiveTable((0.5, 1.0), static_worst_case=100.0)
        t.observe(0, 0.4, 10.0)
        t.fit(min_samples=0)
        assert t._table == {}
        assert t.select(0, 0.4) == 100.0
        t.observe(0, 0.4, 12.0)
        t.fit(min_samples=1)
        assert (0, 0) in t._table

    def test_straggler_fit_empty_is_noop(self):
        from repro_torch.runtime.straggler import StragglerDetector
        det = StragglerDetector(4, static_timeout_ms=500.0)
        det.fit()
        assert det.threshold(2, 0.3) == 500.0
        det.observe(2, 0.3, 120.0)
        det.fit(min_samples=0)
        assert det.threshold(2, 0.3) == 500.0

    def test_heartbeat_fit_empty_is_noop(self):
        from repro_torch.runtime.fault import HeartbeatMonitor
        mon = HeartbeatMonitor(n_nodes=3, static_miss_budget=10.0)
        mon.fit()
        mon.beat(1, 0.0)
        mon.fit(min_samples=1)
        assert not mon.dead(1, 5 * mon.interval_ms)
        assert mon.dead(1, 11 * mon.interval_ms)


class Inner(NamedTuple):
    w: torch.Tensor
    steps: list


class Outer(NamedTuple):
    inner: Inner
    bias: torch.Tensor
    meta: dict


class TestCheckpoint:
    def test_roundtrip_and_atomicity(self, tmp_path):
        g = torch.Generator().manual_seed(0)
        tree = {"w": torch.randn(8, 8, generator=g),
                "nested": {"b": torch.arange(5, dtype=torch.int32)}}
        save_checkpoint(str(tmp_path), 3, tree)
        # a partial (uncommitted) newer step must be ignored
        os.makedirs(tmp_path / "step_00000007")
        restored, step = load_checkpoint(str(tmp_path), tree)
        assert step == 3
        assert torch.equal(restored["w"], tree["w"])
        assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
        assert restored["nested"]["b"].dtype == torch.int32

    def test_fault_tolerant_loop_replays_to_same_state(self, tmp_path):
        from repro_torch.runtime.fault import FaultTolerantLoop

        def step_fn(state, batch):
            return {"x": state["x"] + batch}

        def batches(i):
            return torch.tensor(i + 1, dtype=torch.float32)

        clean = {"x": torch.tensor(0.0)}
        for i in range(12):
            clean = step_fn(clean, batches(i))

        loop = FaultTolerantLoop(
            step_fn, {"x": torch.tensor(0.0)},
            CheckpointManager(str(tmp_path), every=4),
            failure_schedule={6, 10})
        state, stats = loop.run(batches, 12)
        assert stats["restarts"] == 2
        assert stats["steps_replayed"] == (6 - 4) + (10 - 8)
        assert float(state["x"]) == float(clean["x"])

    def test_bfloat16_roundtrip_is_bitwise(self, tmp_path):
        g = torch.Generator().manual_seed(1)
        w = torch.randn(16, 5, generator=g).to(torch.bfloat16)
        save_checkpoint(str(tmp_path), 1, {"w": w, "f": w.float()})
        restored, _ = load_checkpoint(str(tmp_path),
                                      {"w": torch.empty_like(w),
                                       "f": torch.empty(16, 5)})
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16),
                           w.view(torch.int16))
        stored = np.load(tmp_path / "step_00000001" / "w.npy")
        assert stored.dtype == np.int16

    def test_nested_namedtuple_roundtrip(self, tmp_path):
        tree = Outer(inner=Inner(w=torch.ones(3, 2),
                                 steps=[torch.tensor(4), torch.tensor(7)]),
                     bias=torch.full((2,), -1.5, dtype=torch.float64),
                     meta={"scale": np.float32(0.25),
                           "ids": np.arange(4, dtype=np.int64)})
        save_checkpoint(str(tmp_path), 2, tree)
        like = Outer(inner=Inner(w=torch.zeros(3, 2),
                                 steps=[torch.tensor(0), torch.tensor(0)]),
                     bias=torch.zeros(2, dtype=torch.float64),
                     meta={"scale": np.float32(0.0),
                           "ids": np.zeros(4, np.int64)})
        out, step = load_checkpoint(str(tmp_path), like)
        assert step == 2 and isinstance(out, Outer)
        assert isinstance(out.inner, Inner) and isinstance(out.inner.steps,
                                                           list)
        assert torch.equal(out.inner.w, tree.inner.w)
        assert [int(s) for s in out.inner.steps] == [4, 7]
        assert out.bias.dtype == torch.float64
        assert torch.equal(out.bias, tree.bias)
        assert out.meta["scale"] == np.float32(0.25)
        np.testing.assert_array_equal(out.meta["ids"], np.arange(4))

    def test_async_save_writes_the_values_at_its_start(self, tmp_path):
        """A save started before an in-place update of the state writes
        the old values: every leaf is copied to the host before the
        writer thread starts."""
        state = {"w": torch.zeros(256, 256), "n": torch.zeros(3)}
        mgr = CheckpointManager(str(tmp_path), every=1)
        mgr.maybe_save(5, state)
        state["w"].add_(1.0)
        state["n"].fill_(9.0)
        mgr.wait()
        out, step = mgr.restore(state)
        assert step == 5
        assert float(out["w"].abs().max()) == 0.0
        assert float(out["n"].abs().max()) == 0.0

    def test_restore_refuses_a_shape_mismatch(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones(4, 3)})
        with pytest.raises(ValueError, match="shape"):
            load_checkpoint(str(tmp_path), {"w": torch.ones(3, 4)})

    def test_restore_places_on_the_given_device(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2, 2)})
        like = {"w": torch.empty(2, 2, dtype=torch.float64, device="meta")}
        out, _ = load_checkpoint(str(tmp_path), like, device="cpu")
        assert out["w"].device.type == "cpu"
        assert out["w"].dtype == torch.float64
        assert torch.equal(out["w"], torch.ones(2, 2, dtype=torch.float64))

    def test_manager_keeps_the_last_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
        for s in range(5):
            mgr.maybe_save(s, {"x": torch.tensor(float(s))})
        mgr.wait()
        mgr._gc()
        assert latest_step(str(tmp_path)) == 4
        assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                                "step_00000004"]
        out, step = mgr.restore({"x": torch.tensor(0.0)})
        assert step == 4 and float(out["x"]) == 4.0

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path / "none"), {"x": torch.zeros(1)})


class TestHeartbeat:
    def test_never_beaten_node_is_not_dead(self):
        from repro_torch.runtime.fault import HeartbeatMonitor
        hb = HeartbeatMonitor(4, interval_ms=100.0, static_miss_budget=2.5)
        assert not any(hb.dead(n, 1e9) for n in range(4))

    def test_silent_node_goes_dead_after_budget(self):
        from repro_torch.runtime.fault import HeartbeatMonitor
        hb = HeartbeatMonitor(2, interval_ms=100.0, static_miss_budget=2.5)
        for t in range(5):
            hb.beat(0, 100.0 * t)
            hb.beat(1, 100.0 * t)
        for t in range(5, 12):
            hb.beat(0, 100.0 * t)
        now = 100.0 * 11
        assert not hb.dead(0, now)
        assert hb.dead(1, now)

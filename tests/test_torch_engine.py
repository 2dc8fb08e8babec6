"""The port's campaign engine complete (`repro_torch.core.sim_engine`,
`core.autotune`, `launch.mesh`, `launch.sharding`): campaign sharding,
synthesis as a campaign axis, the replay backends and the replay tuner,
held to the JAX reference and to the port's own unsharded, materialized
and default runs, on the CPU.

Inputs are made with numpy from a seed and handed to both packages, or
drawn by the reference (`perf_model.synth_spec(n).materialize()`) and
handed to the port with `convert.trace`; the port's own declarative
axes draw with its own generators.

Tolerances: a sharded, declarative-axis or tuned run replays the same cells with
the same operations as the run it is held to (lanes and cells are
independent; device means are summed in float64, exactly, and rounded
once), so every output is held bitwise.  Against the reference: the
static replay is float32 add, max and select, so totals and host
statistics are held bitwise.  Device means (ROADMAP queue C): the
port's is the exact mean of its latencies rounded once to float32 (held
bitwise to that), the reference's a float32 pairwise sum, which may lie
up to ceil(log2 N) ulps from the exact sum of N terms; the two are held
to that many ulps (at [64, 128) ns one ulp is already 1.19e-7
relative, so a 1e-7 relative bound would be tighter than one float32
rounding)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import dram_sim as jdram
from repro.core import perf_model as jpm
from repro.core import sim_engine as jsim
from repro.core import thermal as JTH
from repro.core import timing as JT
from repro.launch.mesh import make_campaign_mesh as j_mesh
from repro_torch import convert
from repro_torch.core import autotune as ttune
from repro_torch.core import dram_sim as tdram
from repro_torch.core import perf_model as tpm
from repro_torch.core import sim_engine as tsim
from repro_torch.core import thermal as TTH
from repro_torch.core import timing as TT
from repro_torch.kernels.replay import ops as trops
from repro_torch.launch import sharding as tshard
from repro_torch.launch.mesh import CampaignMesh, make_campaign_mesh

N = 96
ROWS = JT.stack_timing([JT.DDR3_1600, JT.ALDRAM_55C_EVAL])
TAB = np.stack([JT.ALDRAM_55C_EVAL.as_row(), JT.DDR3_1600.as_row()])[None]
STAT = ("mean_latency_ns", "p99_latency_ns", "total_ns")
THERMAL = STAT + ("temp_max", "temp_mean", "bin_switches", "bank_heat")
CPU3 = ["cpu"] * 3


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))
    return np.array_equal(a, b)


def _device_means(port, ref, n: int):
    """Device means: within ceil(log2 n) float32 ulps of the
    reference's float32 reduction over n requests."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    gap = np.abs(port.astype(np.float64) - ref.astype(np.float64))
    ulps = gap / np.spacing(np.abs(ref)).astype(np.float64)
    assert ulps.max() <= np.ceil(np.log2(n)), float(ulps.max())


def _exact_means(lat, valid):
    """The exact mean of each valid prefix, rounded once to float32."""
    out = np.empty(lat.shape[:-1], np.float32)
    for t in range(lat.shape[0]):
        c = int(valid[t].sum())
        out[t] = (lat[t, ..., :c].astype(np.float64).sum(-1) / c).astype(
            np.float32)
    return out


def _same(a, b, fields=STAT):
    for f in fields:
        assert _equal(getattr(a, f), getattr(b, f)), f


def _same_bracket(a, b):
    for k in ("worst_bin", "temp_peak"):
        assert _equal(a[k], b[k]), k
    for half in ("adaptive", "static"):
        for k, v in a[half].items():
            assert _equal(v, b[half][k]), (half, k)


def _np_trace(n=N, seed=0, banks=8):
    """The reference tests' `_trace` (tests/test_traffic.py)."""
    rng = np.random.default_rng(seed)
    return (np.sort(rng.exponential(20.0, n)).astype(np.float32),
            rng.integers(0, banks, n).astype(np.int32),
            rng.integers(0, 512, n).astype(np.int32), rng.random(n) < 0.3)


def _traces(k, lens=None):
    raw = [_np_trace(n=N if lens is None else lens[s], seed=s)
           for s in range(k)]
    return (tuple(jdram.Trace(*r) for r in raw),
            tuple(convert.trace(*r, device="cpu") for r in raw))


def _pols(mod, interleave="row"):
    return (mod.OPEN_FCFS, mod.Policy(reorder_window=8,
                                      interleave=interleave))


def _thermal():
    kw = dict(tau_ns=5.0e3, c_heat=2.0e-4)
    j = JTH.ThermalSpec(scenarios=(JTH.steady(48.0),
                                   JTH.diurnal(40.0, 90.0, period_ns=2.0e4)),
                        temp_bins=(55.0,), config=JTH.ThermalConfig(**kw))
    t = TTH.ThermalSpec(tuple(convert.scenario(r) for r in j.pack()[0]),
                        (55.0,), TTH.ThermalConfig(**kw))
    return j, t


def _static_spec(traces, mod=tsim, n_channels=1, interleave="row", **kw):
    pols = _pols(tdram if mod is tsim else jdram, interleave)
    return mod.SimSpec(traces=traces, timings=ROWS, policies=pols,
                       n_channels=n_channels, **kw)


def _adaptive_spec(traces, thermal, mod=tsim, **kw):
    pol = (tdram if mod is tsim else jdram).Policy(reorder_window=4)
    return mod.SimSpec(traces=traces, timings=TAB, thermal=thermal,
                       policies=(pol,), **kw)


def _eng(mesh=None, **kw):
    return tsim.SimEngine(device="cpu", mesh=mesh, **kw)


def _small_synth(n=64, workloads=3):
    offs, rhs, wfs, ias = tpm._pool_knobs()
    return tdram.SynthSpec(n=n, offsets=offs[:workloads],
                           row_hits=rhs[:workloads],
                           write_fracs=wfs[:workloads],
                           inter_arrivals=ias[:workloads])


# ------------------------------------------------------ mesh and sharding

def test_campaign_mesh_and_sharding():
    """`make_campaign_mesh`: an explicit device list (repeats allowed),
    clamped to a prefix; the default is every CUDA device and raises
    without one.  `shard_campaign` splits [T]-leading trees into row
    blocks on each device; a T that the device count does not divide
    raises, and `_shard_pad` repeats the last row up to a multiple."""
    mesh = make_campaign_mesh(devices=CPU3)
    assert isinstance(mesh, CampaignMesh)
    assert mesh.axis_names == ("campaign",)
    assert mesh.shape == {"campaign": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert make_campaign_mesh(2, devices=CPU3).shape == {"campaign": 2}
    with pytest.raises(ValueError, match="n_devices"):
        make_campaign_mesh(4, devices=CPU3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_campaign_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_campaign_mesh(devices=["cuda:0"])
    assert tshard.campaign_spec() == ("campaign",)
    x = torch.arange(12).reshape(6, 2)
    tree = (x, {"v": x[:, 0] > 2})
    shards = tshard.shard_campaign(mesh, tree)
    assert len(shards) == 3
    for i, (a, d) in enumerate(shards):
        assert torch.equal(a, x[2 * i:2 * i + 2])
        assert torch.equal(d["v"], x[2 * i:2 * i + 2, 0] > 2)
    with pytest.raises(ValueError, match="multiple"):
        tshard.shard_campaign(mesh, (x[:5],))
    padded, t = tsim._shard_pad((x[:5], x[:5, 0]), 3)
    assert t == 5 and padded[0].shape == (6, 2)
    assert torch.equal(padded[0][5], x[4]) and int(padded[1][5]) == 8


class TestSingleDeviceMeshParity:
    """tests/test_traffic.py:105-155 on the port: a one-entry mesh runs
    the unsharded path's operations on the same values, so every output
    is bitwise the unsharded engine's."""

    def test_static_bit_identical(self):
        _, tr = _traces(3)
        spec = _static_spec(tr, n_channels=2, interleave="bank_xor")
        mesh = make_campaign_mesh(1, devices=CPU3)
        _same(_eng().run(spec), _eng(mesh).run(spec))

    def test_adaptive_bit_identical(self):
        _, tr = _traces(2)
        spec = _adaptive_spec(tr, _thermal()[1], n_channels=2)
        mesh = make_campaign_mesh(devices=["cpu"])
        _same(_eng().run(spec), _eng(mesh).run(spec), THERMAL)

    def test_bracket_bit_identical(self):
        _, tr = _traces(2)
        spec = _adaptive_spec(tr, _thermal()[1])
        base = JT.DDR3_1600.as_row()
        mesh = make_campaign_mesh(devices=["cpu"])
        _same_bracket(_eng().run_bracket(spec, base_row=base),
                      _eng(mesh).run_bracket(spec, base_row=base))

    def test_sharded_requires_device_stats(self):
        """The reference refuses host statistics under a mesh
        (an assert there, a ValueError here), and host reordering."""
        mesh = make_campaign_mesh(devices=["cpu"])
        with pytest.raises(ValueError, match="stats='device'"):
            _eng(mesh, stats="host", reorder="host")
        with pytest.raises(ValueError, match="reorder='device'"):
            _eng(mesh, reorder="host")

    def test_ragged_trace_axis_pads_and_slices(self):
        """T not divisible by the device count round-trips through
        `_shard_pad` without polluting the statistics."""
        _, tr = _traces(3)
        spec = tsim.SimSpec(traces=tr, timings=ROWS[:1], n_channels=2)
        eng = _eng(make_campaign_mesh(devices=["cpu"] * 2))
        res = eng.run(spec)
        assert res.mean_latency_ns.shape[0] == 3
        assert eng.shard_shape == (2, 2, N)
        _same(_eng().run(spec), res)

    def test_mesh_matches_the_reference_mesh(self):
        """The port's one-device mesh against the reference's, on the
        same streams: totals bitwise, device means within the float32
        reduction's ulps."""
        jtr, ttr = _traces(3)
        jspec = _static_spec(jtr, jsim, n_channels=2, interleave="bank_xor")
        tspec = _static_spec(ttr, n_channels=2, interleave="bank_xor")
        ref = jsim.SimEngine(mesh=j_mesh(1)).run(jspec)
        port = _eng(make_campaign_mesh(devices=["cpu"])).run(tspec)
        assert _equal(ref.total_ns, port.total_ns)
        _device_means(port.mean_latency_ns, ref.mean_latency_ns, N)


class TestRepeatedMesh:
    """Three shards on repeated CPU entries with T = 5 (padded to 6):
    bit for bit the unsharded run, one dispatch a run."""

    @pytest.mark.parametrize("c,r", [(1, 1), (2, 2)])
    def test_static_and_multi_channel_frfcfs(self, c, r):
        _, tr = _traces(5, lens=[N, N - 20, N, N - 7, N])
        spec = tsim.SimSpec(
            traces=tr, timings=ROWS, n_channels=c, n_ranks=r,
            policies=(tdram.OPEN_FCFS,
                      tdram.Policy(reorder_window=8, interleave="cacheline"),
                      tdram.Policy(page="closed", interleave="bank_xor"),
                      tdram.Policy(reorder_window=4, reorder_slack_ns=60.0,
                                   interleave="bank_xor")),
            collect=("latencies",))
        eng = _eng(make_campaign_mesh(devices=CPU3))
        d0 = eng.dispatch_count
        res = eng.run(spec)
        assert eng.dispatch_count - d0 == 1
        assert eng.shard_shape == (3, 2, N)
        _same(_eng().run(spec), res, STAT + ("latencies",))

    def test_adaptive(self):
        _, tr = _traces(5)
        spec = _adaptive_spec(tr, _thermal()[1], collect=("bins",))
        _same(_eng().run(spec), _eng(make_campaign_mesh(devices=CPU3))
              .run(spec), THERMAL + ("bins",))

    def test_multi_channel_adaptive(self):
        _, tr = _traces(5)
        spec = _adaptive_spec(tr, _thermal()[1], n_channels=2)
        _same(_eng().run(spec), _eng(make_campaign_mesh(devices=CPU3))
              .run(spec), THERMAL)

    def test_bracket_worst_bin_is_the_global_peak(self):
        """The per-scenario peak is an exact max across shards: the worst
        bins and every statistic equal the unsharded bracket's."""
        _, tr = _traces(5)
        spec = _adaptive_spec(tr, _thermal()[1])
        base = JT.DDR3_1600.as_row()
        eng = _eng(make_campaign_mesh(devices=CPU3))
        _same_bracket(_eng().run_bracket(spec, base_row=base),
                      eng.run_bracket(spec, base_row=base))

    def test_launches_one_per_shard_on_the_card(self):
        """On the CPU the wrappers run their plain versions: a sharded
        run counts no launch; the dispatch count moves by one."""
        _, tr = _traces(5)
        before = trops.replay_blocks.launches
        eng = _eng(make_campaign_mesh(devices=CPU3))
        eng.run(_static_spec(tr))
        assert trops.replay_blocks.launches == before
        assert eng.dispatch_count == 1

    def test_fault_campaigns_are_single_device(self):
        from repro_torch.core import faults as TF
        _, tr = _traces(2)
        spec = tsim.SimSpec(traces=tr, timings=ROWS, faults=TF.FaultSpec(
            scenarios=(TF.FaultScenario(name="e", err_scale=0.8,
                                        err_free_red=0.0),)))
        with pytest.raises(ValueError, match="single-device"):
            _eng(make_campaign_mesh(devices=CPU3)).run(spec)


# ------------------------------------------------------ synthesis fusion

class TestSynthFusion:
    """tests/test_fused_dispatch.py:42-103 on the port's own draws."""

    def test_synth_spec_materializes_trace_batch(self):
        tb = tpm.trace_batch(n=64, seed=0, device="cpu")
        mat = tpm.synth_spec(n=64, seed=0).materialize("cpu")
        assert len(mat) == tb.arrival.shape[0] == 70
        for i, tr in enumerate(mat):
            for a, b, name in zip(tr, tb, tdram.Trace._fields):
                assert torch.equal(a, b[i]), (i, name)

    def test_fused_run_bit_identical_one_dispatch(self):
        synth = _small_synth()
        mat = synth.materialize("cpu")
        kw = dict(timings=ROWS, policies=(tdram.OPEN_FCFS,
                                          tdram.Policy(reorder_window=8)))
        eng = _eng()
        res_m = eng.run(tsim.SimSpec(traces=mat, **kw))
        s0, d0 = tpm.synth_dispatch_count, eng.dispatch_count
        res_f = eng.run(tsim.SimSpec(traces=synth, **kw))
        assert eng.dispatch_count - d0 == 1
        assert tpm.synth_dispatch_count == s0, \
            "a run must replay the cached materialization, not draw again"
        _same(res_f, res_m)

    def test_first_run_materializes_the_axis_once(self):
        """A declarative axis not yet materialized is drawn by its first
        run (one synthesis) and replayed from the cache by the next (none),
        bitwise the materialized run, with the exact reorder buffer."""
        kw = dict(timings=ROWS, policies=(tdram.Policy(reorder_window=8),))
        spec = tsim.SimSpec(traces=_small_synth(), **kw)
        eng = _eng()
        with tpm.synth_dispatch_scope() as first:
            res_1 = eng.run(spec)
        with tpm.synth_dispatch_scope() as second:
            res_2 = eng.run(spec)
        assert (first.count, second.count, eng.dispatch_count) == (1, 0, 2)
        res_m = _eng().run(tsim.SimSpec(
            traces=_small_synth().materialize("cpu"), **kw))
        _same(res_1, res_m)
        _same(res_2, res_m)

    def test_fused_adaptive_matches_materialized(self):
        synth = _small_synth()
        mat = synth.materialize("cpu")
        thermal = _thermal()[1]
        eng = _eng()
        _same(eng.run(_adaptive_spec(synth, thermal)),
              eng.run(_adaptive_spec(mat, thermal)), THERMAL)

    def test_declarative_axis_under_a_mesh_is_sharded_like_traces(self):
        """A declarative axis is packed from its one materialization and
        sharded like `Trace`s, so a sharded run is the unsharded
        materialized one, bitwise; a TenantSpec axis too."""
        for synth in (_small_synth(workloads=5),
                      tpm.tenant_spec(n=64, n_streams=5, seed=2)):
            spec = _static_spec(synth, n_channels=2)
            eng = _eng(make_campaign_mesh(devices=CPU3))
            with tpm.synth_dispatch_scope() as scope:
                res = eng.run(spec)
                eng.run(spec)
            assert scope.count == 1 and eng.shard_shape == (3, 2, 64)
            _same(_eng().run(_static_spec(synth.materialize("cpu"),
                                          n_channels=2)), res)

    def test_synth_dispatch_scope(self):
        synth = _small_synth(n=32)
        with tpm.synth_dispatch_scope() as outer:
            synth.materialize("cpu")              # first call: 1 launch
            synth.materialize("cpu")              # cached: free
            with tpm.synth_dispatch_scope(reset=True) as inner:
                _small_synth(n=16).materialize("cpu")
            assert inner.count == 1
        assert outer.count == 1                   # inner was reset
        assert inner.count == 1                   # frozen at scope exit

    def test_trace_batch_counts_one_synthesis(self):
        with tpm.synth_dispatch_scope() as scope:
            tpm.trace_batch(n=8, device="cpu")
        assert scope.count == 1

    def test_synth_spec_shards_equal_slices_of_the_batch(self):
        synth = tpm.synth_spec(n=32, seed=3)
        whole = synth.synth("cpu")
        knobs = synth.stream_knobs()
        part = synth.synth_traced(tuple(k[10:13] for k in knobs), "cpu")
        for a, b in zip(part, whole):
            assert torch.equal(a, b[10:13])

    def test_reference_materialized_pool_matches_reference_fused(self):
        """The port's engine on the reference's materialized
        `synth_spec(n=256)` pool against the reference's engine on its
        fused `SynthSpec`: host statistics bitwise, totals bitwise,
        device means the exact means of the port's latencies, and within
        the reference's float32 reduction's ulps of its."""
        jsyn = jpm.synth_spec(n=256, seed=0)
        ttr = tuple(convert.trace(*(np.asarray(f) for f in t), device="cpu")
                    for t in jsyn.materialize())
        pols = _pols(jdram, "row")
        kw = dict(timings=ROWS)
        ref_d = jsim.SimEngine().run(jsim.SimSpec(traces=jsyn,
                                                  policies=pols, **kw))
        ref_h = jsim.SimEngine(stats="host", reorder="host").run(
            jsim.SimSpec(traces=jsyn, policies=pols, **kw))
        tspec = tsim.SimSpec(traces=ttr, policies=_pols(tdram), **kw)
        port_d = _eng().run(dataclasses.replace(tspec,
                                                collect=("latencies",)))
        port_h = _eng(stats="host").run(tspec)
        _same(ref_h, port_h)
        assert _equal(ref_d.total_ns, port_d.total_ns)
        assert _equal(port_d.mean_latency_ns,
                      _exact_means(port_d.latencies, port_d.valid))
        _device_means(port_d.mean_latency_ns, ref_d.mean_latency_ns, 256)


class TestRunBracket:
    def test_evaluate_adaptive_fused_parity_and_dispatches(self):
        """`evaluate_adaptive(fused=True)` runs `run_bracket`: 1 replay
        dispatch against 2 unfused, one synthesis of the pool either
        way, with the same worst bins and gmeans."""
        kw = dict(bins=(55.0,), scenarios=(TTH.steady(48.0), TTH.diurnal(
            40.0, 90.0, period_ns=2.0e4)),
                  config=TTH.ThermalConfig(tau_ns=5.0e3, c_heat=2.0e-4),
                  n=64, policies=(tdram.Policy(reorder_window=4),))
        runs = {}
        for fused in (False, True):
            eng = _eng()
            with tpm.synth_dispatch_scope() as scope:
                res = tpm.evaluate_adaptive(TAB[0], fused=fused, engine=eng,
                                            **kw)
            runs[fused] = (res, eng.dispatch_count, scope.count)
        res_d, replays_d, synths_d = runs[False]
        res_f, replays_f, synths_f = runs[True]
        assert (replays_d, synths_d) == (2, 1)
        assert (replays_f, synths_f) == (1, 1)
        assert np.array_equal(res_f["worst_bin"], res_d["worst_bin"])
        for pd_f, pd_d in zip(res_f["per_policy"], res_d["per_policy"]):
            for name in pd_f:
                for key in ("adaptive_gmean", "static_worst_gmean",
                            "oracle_gmean"):
                    np.testing.assert_allclose(pd_f[name][key],
                                               pd_d[name][key], rtol=1e-6,
                                               err_msg=(name, key))


# --------------------------------------------------- backends and tuner

class TestBackends:
    def test_static_backends_agree_bitwise(self):
        """tests/test_traffic.py:57 on the port: "merged" (the scheduler
        merged into the plain replay) is bitwise "kernel" (the prepass
        and the plain replay on the CPU), multi-channel, FR-FCFS."""
        _, tr = _traces(3)
        spec = _static_spec(tr, n_channels=2, n_ranks=2,
                            interleave="cacheline", collect=("latencies",))
        ref = _eng().run(spec)
        res = _eng(backend="merged").run(spec)
        _same(ref, res, STAT + ("latencies",))

    def test_merged_backend_bitwise_faulted(self):
        from repro_torch.core import faults as TF
        _, tr = _traces(2)
        spec = tsim.SimSpec(
            traces=tr, timings=ROWS, policies=_pols(tdram),
            faults=TF.FaultSpec(scenarios=(
                TF.FaultScenario(),
                TF.FaultScenario(name="err", err_scale=0.8, err_free_red=0.0,
                                 detect_frac=0.9, retry_ns=60.0)), seed=3))
        a, b = _eng().run(spec), _eng(backend="merged").run(spec)
        _same(a, b)
        assert np.array_equal(a.fault_counters, b.fault_counters)

    def test_merged_refuses_a_cuda_engine(self):
        """"merged" is plain PyTorch: a CUDA engine refuses it in its
        constructor, before any device is touched (ROADMAP North
        star)."""
        with pytest.raises(ValueError, match="North star"):
            tsim.SimEngine(device="cuda", backend="merged")
        with pytest.raises(ValueError, match="backend"):
            _eng(backend="scan")
        with pytest.raises(ValueError, match="block_lanes"):
            _eng().run(_static_spec(_traces(1)[1]),
                       config=ttune.ReplayConfig("kernel", 48))

    def test_every_cpu_candidate_bitwise(self):
        """Every CPU candidate gives candidate 0's outputs, bitwise, on
        a static and an adaptive campaign over a declarative axis."""
        synth = _small_synth(workloads=4)
        eng = _eng()
        tuner = ttune.ReplayTuner(platform="cpu", path="")
        for spec, fields in ((_static_spec(synth, n_channels=2,
                                           collect=("latencies",)),
                              STAT + ("latencies",)),
                             (_adaptive_spec(synth, _thermal()[1]), THERMAL)):
            base = eng.run(spec, config=tuner.candidates[0])
            for cfg in tuner.candidates[1:]:
                _same(base, eng.run(spec, config=cfg), fields)


class TestReplayTuner:
    """tests/test_fused_dispatch.py:189-236 on the port."""

    def test_roundtrip_and_fallback(self, tmp_path):
        path = str(tmp_path / "tune.json")
        tuner = ttune.ReplayTuner(platform="cpu", path=path)
        assert tuner.candidates[0] == ttune.ReplayConfig("kernel")
        unit = ttune.replay_unit(False, False)
        assert tuner.lookup(unit, 1024) == ttune.ReplayConfig("kernel")

        def measure(cfg):
            return 1.0 if cfg.backend == "merged" else 2.0

        best, times = tuner.tune(unit, 1024, measure)
        assert best == ttune.ReplayConfig("merged")
        assert len(times) == len(tuner.candidates)
        assert tuner.lookup(unit, 1024) == best
        assert tuner.lookup(ttune.replay_unit(True, False), 1024) == \
            ttune.ReplayConfig("kernel")
        again = ttune.ReplayTuner(platform="cpu", path=path)
        assert again.lookup(unit, 1024) == best
        stored = json.loads((tmp_path / "tune.json").read_text())
        assert stored["platform"] == "cpu" and stored["table"]
        other = ttune.ReplayTuner(platform="cpu", path=path, candidates=(
            ttune.ReplayConfig("kernel"),))
        assert other.lookup(unit, 1024) == ttune.ReplayConfig("kernel")
        # beyond the last size bin nothing is stored: candidate 0
        ttune.ReplayTuner(platform="cpu", path="").tune(unit, 2 ** 30,
                                                        measure)

    def test_unit_numbering_matches_the_reference(self):
        for args in ((False, False), (True, True), (False, True, True),
                     (True, False, False, True)):
            assert ttune.replay_unit(*args) == jtune.replay_unit(*args)
        assert ttune.REPLAY_SIZE_BINS == jtune.REPLAY_SIZE_BINS

    def test_cuda_candidates_launch_the_kernel(self):
        """On a card every candidate is the kernel (no plain version of
        a ported kernel runs there); candidate 0 is its default block."""
        cands = ttune.ReplayTuner(platform="cuda", path="").candidates
        assert cands[0] == ttune.ReplayConfig("kernel")
        assert all(c.backend == "kernel" for c in cands)
        assert {c.block_rows for c in cands} == {None, 32}
        with pytest.raises(ValueError, match="platform"):
            ttune.ReplayTuner(platform="tpu", path="")

    def test_default_path_is_the_ports_own(self, monkeypatch, tmp_path):
        monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_PATH", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        p = ttune.ReplayTuner(platform="cuda")._resolve_path()
        assert p == str(tmp_path / ".cache" / "repro_torch" /
                        "replay_tune_cuda.json")
        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_PATH", str(tmp_path / "x"))
        assert ttune.ReplayTuner()._resolve_path() == str(tmp_path / "x")

    def test_engine_auto_consults_tuner(self):
        synth = _small_synth()
        spec = tsim.SimSpec(traces=synth, timings=ROWS,
                            policies=(tdram.Policy(reorder_window=8),))
        eng = _eng(backend="auto",
                   tuner=ttune.ReplayTuner(platform="cpu", path=""))
        with tpm.synth_dispatch_scope() as scope:
            d0 = eng.dispatch_count
            tuned = eng.autotune(spec, reps=1)
            profiled = eng.dispatch_count - d0
        assert tuned in eng.tuner.candidates
        assert profiled == 2 * len(eng.tuner.candidates)
        assert scope.count == 1          # the one materialization
        assert eng._resolve(spec) == (tuned.backend, tuned.block_rows)
        _same(_eng().run(spec), eng.run(spec))

    def test_autotune_creates_a_platform_tuner(self, monkeypatch, tmp_path):
        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_PATH",
                           str(tmp_path / "t.json"))
        _, tr = _traces(2)
        eng = _eng()
        eng.autotune(_static_spec(tr), reps=1)
        assert eng.tuner.platform == "cpu"
        assert (tmp_path / "t.json").exists()


class TestAdaptiveTable:
    def test_guardbanded_selection_matches_the_reference(self):
        """tests/test_aldram.py:127 on the port, on the same draws."""
        vals = np.random.default_rng(0).normal(10, 1, 200)
        out = []
        for mod in (jtune, ttune):
            t = mod.AdaptiveTable((0.5, 1.0), static_worst_case=100.0,
                                  quantile=0.99, k_sigma=2.0)
            for v in vals:
                t.observe(0, 0.3, v)
            t.observe(0, 5.0, 1.0)                # beyond the bins: dropped
            t.fit()
            v = t.select(0, 0.3)
            assert 10 < v < 25, v
            assert t.select(0, 0.9) == 100.0
            assert t.select(1, 0.3) == 100.0
            assert 0.7 < t.savings(0, 0.3) < 0.95
            out.append(v)
        assert out[0] == out[1]

    def test_fit_needs_a_spread(self):
        t = ttune.AdaptiveTable((1.0,), static_worst_case=9.0)
        t.observe(0, 0.5, 1.0)
        assert t.fit(min_samples=0).select(0, 0.5) == 9.0

    def test_from_sweep_adaptive_table(self, small_pop):
        """tests/test_sweep.py:221 on the port's `SweepResult` of the
        reference's population."""
        from repro.core.calibration import CALIBRATED_CONSTANTS
        from repro_torch.core.profiler import Profiler
        from repro_torch.core.sweep import Op, SweepSpec
        prof = Profiler(convert.charge_constants(
            dataclasses.asdict(CALIBRATED_CONSTANTS)), grid_step=2.5,
            device="cpu")
        pop = convert.population(np.asarray(small_pop.cells), device="cpu")
        res = prof.engine.sweep(pop, SweepSpec.single(
            Op.READ, prof.combo_grid(Op.READ), (55.0, 85.0)))
        wc = TT.DDR3_1600.read_sum()
        t = ttune.AdaptiveTable.from_sweep(res, Op.READ, wc)
        sums = res.latency_sum[res.index(Op.READ)]
        for u in range(sums.shape[0]):
            v = t.select(u, 55.0)
            assert 0 < v <= wc and v == min(float(sums[u, 0]), wc)
        assert t.select(0, 99.0) == wc                       # above bins


def test_port_traffic_bench_on_a_mesh():
    """`port_traffic_bench.run(fast=True)` hands the TenantSpec to the
    engine as a declarative axis on a campaign mesh, materialized once
    before timing: one dispatch and no synthesis a run, sharded ==
    unsharded, and the same statistics as the run on the given
    materialized streams."""
    from benchmarks import port_traffic_bench as B
    n, n_streams, _ = B.grid(True)
    decl = B.run(fast=True, device="cpu")
    mat = B.run(fast=True, device="cpu", traces=tpm.tenant_spec(
        n=n, n_streams=n_streams, seed=0).materialize("cpu"))
    assert decl["declarative"] and not mat["declarative"]
    assert decl["synth_s"] > 0.0 == mat["synth_s"]
    assert decl["sharded_rel"] == mat["sharded_rel"] == 0.0
    assert decl["shard"] == [1, n_streams, n]
    for c in B.CHANNEL_SWEEP:
        a, b = decl["per_channel"][str(c)], mat["per_channel"][str(c)]
        assert a["replays"] == 2
        for k in ("mean_ns", "p99_ns", "static_vs_adaptive_gap"):
            assert a[k] == b[k], (c, k)


def test_simspec_single_and_default_engine():
    _, (tr,) = _traces(1)
    spec = tsim.SimSpec.single(tr, TT.DDR3_1600)
    assert spec.shape == (1, 1, 1) and spec.synth is None
    eng = tsim.default_engine("cpu")
    assert eng is tsim.default_engine("cpu")
    assert (eng.stats, eng.reorder) == ("host", "host")
    out = tdram.simulate(tr, TT.DDR3_1600, device="cpu")
    ref = jdram.simulate(jdram.Trace(*_np_trace(seed=0)), JT.DDR3_1600)
    assert _equal(out["mean_latency_ns"], ref["mean_latency_ns"])
    assert _equal(out["latencies"], ref["latencies"])

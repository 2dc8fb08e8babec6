"""Parity of the port's fleet recalibration service (`repro_torch.fleet`)
with the JAX reference (`repro.fleet`), on the CPU: every test of
tests/test_fleet.py on the port, each also running the reference in the
same test on the reference's population (handed across with
`repro_torch.convert.population`) and, for fleet-months, the
reference's trace pool and error uniforms.

What is held, and to what:
  * drifted cells, rates and VRT states bitwise (host numpy in float64
    on the same numpy Generators);
  * `ecc_events` and `event_penalty_ns` bitwise;
  * probe fail counts exactly, worst margins within 2e-4 (the margin
    grid's bound against its reference);
  * `run_policies` (plain, regions=4 and faulted fleets): every integer
    field, the event totals, the recal / relax / rejected epochs and the
    dispatch counts exactly; the served latencies within ceil(log2 N)
    float32 half-ulps relative (N requests a trace): the port's device
    means are the exact mean rounded once, the reference's a float32
    tree reduction;
  * `port_fleet_bench --fast` and `examples/port_aldram_fleet.py --fast`
    against the reference's runs in the same test.

The card's fleet-months against the CPU's are in
tests/test_torch_fleet_card.py, which imports no JAX.
"""

import dataclasses
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as JF
from repro.core.calibration import CALIBRATED_VARIATION as J_VAR
from repro.core.perf_model import trace_batch as j_trace_batch
from repro.core.variation import sample_population as j_sample
from repro.fleet import drift as JD
from repro.fleet import monitor as JM
from repro.fleet import recal as JR
from repro_torch import convert
from repro_torch.core.calibration import CALIBRATED_VARIATION as T_VAR
from repro_torch.fleet.drift import DriftConfig, DriftModel
from repro_torch.fleet.monitor import (ECCConfig, ErrorMonitor, ecc_events,
                                       event_penalty_ns)
from repro_torch.fleet.recal import (FleetEngine, FleetSpec, frontier,
                                     run_policies)
from _torch_parity import one_thread as _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]

TOL = 2e-4
LAT = ("lat_jedec_ns", "lat_fleet_ns", "eff_lat_ns")
EXACT = ("temp_c", "corr_events", "unc_events", "scrub_corr",
         "served_detected", "served_silent", "served_wd_trips",
         "compression_ratio", "tighten_steps", "version", "dead_modules",
         "straggler_fallbacks", "jedec_fallbacks")
SCALARS = ("recal_epochs", "relax_epochs", "relax_rejected",
           "replay_dispatches", "margin_dispatches")


def tiny_cfg(n_modules=4, n_cells=3):
    """(reference config, port config): the calibrated variation cut to
    `n_modules` x `n_cells`."""
    return (dataclasses.replace(J_VAR, n_modules=n_modules, n_cells=n_cells),
            dataclasses.replace(T_VAR, n_modules=n_modules, n_cells=n_cells))


def tiny_pop(n_modules=4, n_cells=3, seed=7):
    """(reference population, the port's on the CPU, same cells)."""
    jpop = j_sample(jax.random.PRNGKey(seed), tiny_cfg(n_modules, n_cells)[0])
    return jpop, convert.population(np.asarray(jpop.cells), device="cpu")


def ref_traces(n: int):
    """The reference's [70, n] pool as the port's `Trace`."""
    return convert.trace(*(np.asarray(f) for f in j_trace_batch(n, 0, 8)),
                         device="cpu")


def fast_profilers():
    """The 2.5 ns-grid profilers of the benches, reference and port."""
    from benchmarks.common import profiler as j_prof
    from benchmarks.port_common import profiler as t_prof
    return j_prof(True), t_prof(True, "cpu")


def lat_rtol(n_requests: int) -> float:
    """ceil(log2 N) float32 half-ulps: the float32 tree reduction's
    bound on the reference's device means of N requests."""
    return math.ceil(math.log2(n_requests)) * 2.0 ** -24


def red_tol(rtol: float, *reductions: float) -> float:
    """Bound on a sum of `1 - lf / lj` reductions whose latencies are
    each within `rtol`: the ratio within 2 rtol of itself."""
    return sum(2.0 * rtol * (1.0 + abs(r)) for r in reductions)


def assert_fleet_equal(ref, got, n_requests: int):
    """A port `FleetResult` against the reference's."""
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    for f in SCALARS:
        assert getattr(got, f) == getattr(ref, f), f
    rtol = lat_rtol(n_requests)
    for f in LAT:
        a, b = getattr(got, f), getattr(ref, f)
        rel = float(np.abs(a / b - 1.0).max())
        print(f"{got.spec.policy} {f}: max rel diff {rel:.3e} "
              f"(bound {rtol:.3e})")
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=f)
    s_ref, s_got = ref.summary(), got.summary()
    for k, v in s_ref.items():
        if k in ("raw_reduction", "eff_reduction"):
            assert abs(s_got[k] - v) <= red_tol(rtol, v), k
        else:
            assert s_got[k] == v, k
    np.testing.assert_array_equal(got.table.params, ref.table.params)
    assert got.table.version == ref.table.version


def assert_frontier_equal(fr_ref, fr_got, n_requests: int):
    """`frontier` of the port against the reference's: event totals
    exactly, reductions within `red_tol`."""
    rtol = lat_rtol(n_requests)
    raw_static = fr_ref["policies"]["static"]["raw_reduction"]
    for p, d in fr_ref["policies"].items():
        for k, v in d.items():
            got = fr_got["policies"][p][k]
            if k in ("errors_avoided", "total_unc"):
                assert got == v, (p, k)
            elif k == "latency_given_back":
                assert abs(got - v) <= red_tol(
                    rtol, raw_static, d["raw_reduction"]), (p, k, got, v)
            else:
                assert abs(got - v) <= red_tol(rtol, v), (p, k, got, v)


class TestDrift:
    def test_aging_is_monotone_toward_weak_side(self):
        jcfg, cfg = tiny_cfg()
        jpop, pop = tiny_pop()
        dm = DriftModel(pop, DriftConfig(vrt_prob=0.0), var_cfg=cfg)
        jdm = JD.DriftModel(jpop, JD.DriftConfig(vrt_prob=0.0), var_cfg=jcfg)
        st, jst = dm.init_state(), jdm.init_state()
        prev = dm.cells(st)
        signs = np.array([+1.0, -1.0, -1.0, +1.0, +1.0])
        for _ in range(3):
            st = dm.advance(st, days=5.0)
            jst = jdm.advance(jst, days=5.0)
            cur = dm.cells(st)
            assert (st.aged >= 0).all()
            d = signs * (np.log(cur.astype(np.float64))
                         - np.log(prev.astype(np.float64)))
            assert (d >= -1e-6).all()
            prev = cur
            np.testing.assert_array_equal(st.aged, jst.aged)
            np.testing.assert_array_equal(cur, jdm.cells(jst))

    def test_tail_cells_drift_fastest(self):
        from repro_torch.core.variation import weakness_score
        jcfg, cfg = tiny_cfg(8, 16)
        jpop, pop = tiny_pop(8, 16)
        dm = DriftModel(pop, var_cfg=cfg, seed=0)
        score = weakness_score(pop.cells, cfg)
        rate = dm.rates.mean(axis=-1).ravel()
        s = score.ravel()
        weak = rate[s > np.quantile(s, 0.9)]
        strong = rate[s < np.quantile(s, 0.1)]
        assert weak.mean() > strong.mean() * 1.5
        np.testing.assert_array_equal(
            dm.rates, JD.DriftModel(jpop, var_cfg=jcfg, seed=0).rates)

    def test_vrt_toggles_and_recovers(self):
        jcfg, cfg = tiny_cfg()
        jpop, pop = tiny_pop()
        kw = dict(vrt_prob=1.0, vrt_recover=1.0, vrt_drop=0.5)
        dm = DriftModel(pop, DriftConfig(**kw), var_cfg=cfg)
        jdm = JD.DriftModel(jpop, JD.DriftConfig(**kw), var_cfg=jcfg)
        st = dm.advance(dm.init_state())
        assert st.vrt.all()
        base = dm.base[..., 2] * np.exp(-st.aged[..., 2])
        np.testing.assert_allclose(dm.cells(st)[..., 2], base * 0.5,
                                   rtol=1e-5)
        st2 = dm.advance(st)
        assert not st2.vrt.any()
        jst2 = jdm.advance(jdm.advance(jdm.init_state()))
        np.testing.assert_array_equal(st2.vrt, jst2.vrt)
        np.testing.assert_array_equal(dm.cells(st2), jdm.cells(jst2))

    def test_temp_accelerates_aging_one_sided(self):
        jcfg, cfg = tiny_cfg()
        jpop, pop = tiny_pop()
        dm = DriftModel(pop, var_cfg=cfg)
        jdm = JD.DriftModel(jpop, var_cfg=jcfg)
        ref = dm.cfg.ref_temp_c
        assert dm.temp_factor(ref) == 1.0
        assert dm.temp_factor(ref - 20.0) == 1.0
        assert dm.temp_factor(ref + 10.0) > 1.0
        for t in (ref - 20.0, ref, ref + 3.7, ref + 10.0, ref + 31.0):
            assert dm.temp_factor(t) == jdm.temp_factor(t)

    def test_population_roundtrip_shape(self):
        jcfg, cfg = tiny_cfg()
        jpop, pop = tiny_pop()
        dm = DriftModel(pop, var_cfg=cfg)
        jdm = JD.DriftModel(jpop, var_cfg=jcfg)
        dpop = dm.population(dm.advance(dm.init_state(), temp_c=58.0))
        assert dpop.cells.shape == pop.cells.shape
        assert dpop.cells.dtype == torch.float32
        assert dpop.cells.device == pop.cells.device
        want = jdm.population(jdm.advance(jdm.init_state(), temp_c=58.0))
        np.testing.assert_array_equal(dpop.cells.numpy(),
                                      np.asarray(want.cells))


class TestECC:
    def test_uncorrectable_gated_exactly_zero_below_two(self):
        f = np.array([0, 1, 2, 5])
        corr, unc = ecc_events(f)
        assert corr[0] == 0.0
        assert corr[1] > 0.0 and corr[2] > 0.0
        assert unc[0] == 0.0 and unc[1] == 0.0
        assert unc[2] > 0.0 and unc[3] > unc[2]
        counts = np.random.default_rng(0).integers(0, 40, (6, 8, 4))
        for acc in (None, 2.5e4, np.full((6, 8, 4), 3.0e3)):
            for got, want in zip(ecc_events(counts, accesses=acc),
                                 JM.ecc_events(counts, accesses=acc)):
                np.testing.assert_array_equal(got, want)

    def test_rejects_float_counts(self):
        with pytest.raises(TypeError, match="integer counts"):
            ecc_events(np.array([1.0, 2.0]))

    def test_rejects_negative_counts(self):
        with pytest.raises(ValueError, match="non-negative"):
            ecc_events(np.array([1, -1, 2]))

    def test_event_penalty_units_contract(self):
        cfg = ECCConfig(corr_penalty_ns=2.0e3, unc_penalty_ns=5.0e6,
                        accesses_per_epoch=1.0e5)
        jcfg = JM.ECCConfig(corr_penalty_ns=2.0e3, unc_penalty_ns=5.0e6,
                            accesses_per_epoch=1.0e5)
        pen = event_penalty_ns(np.array([10.0]), np.array([2.0]), cfg)
        assert pen[0] == pytest.approx((10 * 2e3 + 2 * 5e6) / 1e5)
        pen2 = event_penalty_ns(np.array([10.0]), np.array([2.0]), cfg,
                                accesses=2.0e5)
        assert pen2[0] == pytest.approx(pen[0] / 2.0)
        corr, unc = JM.ecc_events(np.arange(12).reshape(3, 4), jcfg)
        for acc in (None, 2.0e5):
            np.testing.assert_array_equal(
                event_penalty_ns(corr, unc, cfg, accesses=acc),
                JM.event_penalty_ns(corr, unc, jcfg, accesses=acc))

    def test_monitor_probe_clean_on_undrifted_population(self):
        jcfg, cfg = tiny_cfg()
        jpop, pop = tiny_pop()
        eng = FleetEngine(pop, FleetSpec(n_epochs=1), var_cfg=cfg,
                          device="cpu")
        table = eng.controller.profile(pop)
        rows, idx = eng._rows_from_table(table)
        assert idx is None
        pr = ErrorMonitor(engine=eng.controller.engine).probe(
            pop, rows[:, 0], float(table.temp_bins[0]))
        assert pr.clean
        assert pr.worst_margin.min() > 0.0
        assert pr.fail_counts.shape == (pop.n_modules, pop.n_banks)
        jeng = JR.FleetEngine(jpop, JR.FleetSpec(n_epochs=1), var_cfg=jcfg)
        jrows, _ = jeng._rows_from_table(jeng.controller.profile(jpop))
        np.testing.assert_array_equal(rows, jrows)
        jpr = JM.ErrorMonitor(engine=jeng.controller.engine).probe(
            jpop, jrows[:, 0], float(table.temp_bins[0]))
        np.testing.assert_array_equal(pr.fail_counts, jpr.fail_counts)
        np.testing.assert_allclose(pr.worst_margin, jpr.worst_margin,
                                   rtol=0, atol=TOL)

    @pytest.mark.parametrize("regions", [None, 1, 3])
    def test_probe_matches_reference_on_drifted_cells(self, regions):
        """A scrub with failing cells: the drifted population under a
        cut deployed row set (every parameter at 0.8 of JEDEC, the
        refresh interval stretched 2x), per bank or per (bank, region)
        with region-varying rows, fail counts exact and worst margins
        within 2e-4 of the reference's, in one launch per module chunk
        (`max_grid_elems` set for 2-module chunks: 3 launches)."""
        from repro_torch.core import timing as T
        from repro_torch.core.sweep import MarginEngine
        from repro.core.sweep import MarginEngine as JMarginEngine
        jcfg, cfg = tiny_cfg(5, 6)
        jpop, pop = tiny_pop(5, 6)
        dm = DriftModel(pop, var_cfg=cfg, seed=3)
        st = dm.init_state()
        for _ in range(20):
            st = dm.advance(st, days=1.5, temp_c=60.0)
        cells = dm.cells(st)
        m, bk = pop.n_modules, pop.n_banks
        row = T.DDR3_1600.as_row().copy()
        row[:4] *= 0.8
        row[4] *= 2.0
        rg = regions or 1
        rows = np.broadcast_to(row, (m, bk, rg, 6)).copy()
        rows[..., :4] *= (1.0 + 0.05 * np.arange(rg))[:, None]
        if regions is None:
            rows = rows[:, :, 0]
        mon = ErrorMonitor(engine=MarginEngine(device="cpu"),
                           max_grid_elems=2 ** 2 * 6 * 8 * 8 * bk * rg)
        got = mon.probe(pop.with_cells(cells), rows, 62.0)
        jmon = JM.ErrorMonitor(engine=JMarginEngine(),
                               max_grid_elems=mon.max_grid_elems)
        want = jmon.probe(jpop.with_cells(cells), rows, 62.0)
        assert mon.engine.dispatch_count == jmon.engine.dispatch_count == 3
        assert got.fail_counts.dtype == np.int64
        assert got.fail_counts.sum() > 0
        np.testing.assert_array_equal(got.fail_counts, want.fail_counts)
        np.testing.assert_allclose(got.worst_margin, want.worst_margin,
                                   rtol=0, atol=TOL)


class TestTableLineage:
    def test_patch_bumps_version_and_rollback_restores(self):
        jcfg, cfg = tiny_cfg()
        _, pop = tiny_pop()
        eng = FleetEngine(pop, FleetSpec(n_epochs=1), var_cfg=cfg,
                          device="cpu")
        t0 = eng.controller.profile(pop)
        assert t0.version == 0
        t1 = t0.patch(safe_trefi_read=t0.safe_trefi_read * 0.5)
        assert t1.version == 1 and t1.parent is t0
        t2 = t1.patch(safe_trefi_read=t1.safe_trefi_read * 0.5)
        assert t2.version == 2
        assert t2.rollback() is t1 and t2.rollback().rollback() is t0
        assert t0.rollback() is t0
        np.testing.assert_allclose(t2.rollback().rollback().safe_trefi_read,
                                   t0.safe_trefi_read)

    def test_patch_rejects_unknown_fields(self):
        _, cfg = tiny_cfg()
        _, pop = tiny_pop()
        eng = FleetEngine(pop, FleetSpec(n_epochs=1), var_cfg=cfg,
                          device="cpu")
        t0 = eng.controller.profile(pop)
        with pytest.raises(ValueError, match="unknown fields"):
            t0.patch(temp_bins=(55.0,))

    def test_patch_resizes_only_the_unique_axis(self):
        """A region table's unique-row axis may resize under `patch`
        (re-compression after drift), no other axis may, and the
        reference decides every case the same way."""
        from repro.core.aldram import TimingTable as JTable
        from repro_torch.core.aldram import TimingTable
        rng = np.random.default_rng(0)
        m, nb, bk, rg, u = 3, 2, 4, 2, 5
        fields = dict(
            temp_bins=(55.0, 85.0),
            params=rng.uniform(5, 15, (m, nb, u, 4)).astype(np.float32),
            safe_trefi_read=np.full(m, 64.0, np.float32),
            safe_trefi_write=np.full(m, 64.0, np.float32),
            params_module=rng.uniform(5, 15, (m, nb, 4)).astype(np.float32),
            region_index=rng.integers(0, u, (m, nb, bk, rg)).astype(np.int32),
            params_bank=rng.uniform(5, 15, (m, nb, bk, 4)).astype(np.float32))
        t, jt = TimingTable(**fields), JTable(**fields)
        small = dict(params=fields["params"][:, :, :3].copy(),
                     region_index=np.minimum(fields["region_index"], 2))
        big = dict(params=np.concatenate([fields["params"]] * 2, axis=2))
        for upd in (small, big):
            got, want = t.patch(**upd), jt.patch(**upd)
            assert got.n_unique == want.params.shape[2] == \
                upd["params"].shape[2]
            assert got.version == want.version == 1
        bad = [dict(params=fields["params"][:2]),
               dict(params=fields["params"][:, :1]),
               dict(params=fields["params"][..., :3]),
               dict(params_bank=fields["params_bank"][:, :, :3]),
               dict(region_index=fields["region_index"][..., :1]),
               dict(params_module=fields["params_module"][:2]),
               dict(safe_trefi_read=fields["safe_trefi_read"][:2]),
               dict(params=fields["params"][:, :, :3])]   # index past U
        for upd in bad:
            with pytest.raises(ValueError):
                t.patch(**upd)
            with pytest.raises(ValueError):
                jt.patch(**upd)
        flat = dict(fields, params=fields["params_bank"], region_index=None,
                    params_bank=None)
        tb = TimingTable(**flat)
        with pytest.raises(ValueError, match="shape"):
            tb.patch(params=fields["params_bank"][:, :, :3])


@pytest.fixture(scope="module")
def month():
    """tests/test_fleet.py's fleet-month (6 modules x 4 cells, 20 epochs,
    module 2 failing at epoch 8) under the three policies, on the
    reference and on the port (the reference's population and pool)."""
    jcfg, cfg = tiny_cfg(6, 4)
    jpop, pop = tiny_pop(6, 4)
    kw = dict(n_epochs=20, workload_rows=(0,), n_requests=256,
              module_failures=((8, 2),), seed=0)
    ref = JR.run_policies(jpop, JR.FleetSpec(**kw), var_cfg=jcfg)
    got = run_policies(pop, FleetSpec(**kw), var_cfg=cfg, device="cpu",
                       traces=ref_traces(256))
    return dict(ref=ref, got=got, pop=pop, cfg=cfg, spec=FleetSpec(**kw))


@pytest.mark.slow
class TestFleetEngine:
    def test_policies_and_frontier(self, month):
        res, spec = month["got"], month["spec"]
        fr = frontier(res)
        err = res["error"].summary()
        sta = res["static"].summary()
        for r in res.values():
            assert r.replay_dispatches == spec.n_epochs
        assert err["total_unc"] == 0.0
        assert sta["total_events"] > 0.0
        assert sta["total_events"] > err["total_events"]
        assert err["eff_reduction"] > sta["eff_reduction"]
        assert (err["max_tighten_steps"] > 0 or err["n_recals"] > 0)
        assert err["final_version"] > 0
        dead = res["error"].dead_modules
        assert dead[-1] == 1 and dead[:8].max() == 0
        assert fr["policies"]["static"]["errors_avoided"] == 0.0
        assert fr["policies"]["error"]["errors_avoided"] > 0.0

    def test_run_policies_matches_reference(self, month):
        for p, ref in month["ref"].items():
            assert_fleet_equal(ref, month["got"][p], 256)
        assert_frontier_equal(JR.frontier(month["ref"]),
                              frontier(month["got"]), 256)

    def test_straggler_fallback_serves_jedec(self, month):
        from repro.runtime.straggler import ClusterModel as JCluster
        from repro_torch.runtime.straggler import ClusterModel
        eng = FleetEngine(month["pop"],
                          dataclasses.replace(month["spec"],
                                              policy="periodic"),
                          var_cfg=month["cfg"], device="cpu")
        rng = np.random.default_rng(0)
        cl = ClusterModel(n_nodes=eng.pop.n_modules)
        det = eng._straggler_detector(rng, cl)
        slow = eng._slow_recals(rng, cl, det)
        assert slow.shape == (eng.pop.n_modules,)
        assert slow.dtype == bool
        jrng = np.random.default_rng(0)
        jcl = JCluster(n_nodes=eng.pop.n_modules)
        jdet = JR.FleetEngine._straggler_detector(jrng, jcl)
        np.testing.assert_array_equal(
            slow, JR.FleetEngine._slow_recals(jrng, jcl, jdet))

    def test_region_fleet_matches_reference(self):
        """`regions=4` (the unique-row store and its shared map, scrubs
        per (bank, region), one launch of replay_blocks (c) an epoch):
        every field of every policy equal to the reference's (the 2.5 ns
        grid of the benches on both sides)."""
        jcfg, cfg = tiny_cfg(6, 4)
        jpop, pop = tiny_pop(6, 4)
        jprof, prof = fast_profilers()
        kw = dict(n_epochs=20, workload_rows=(0,), n_requests=256,
                  module_failures=((8, 2),), seed=0, regions=4)
        dc = dict(region_accel=3.0)
        ref = JR.run_policies(jpop, JR.FleetSpec(**kw), var_cfg=jcfg,
                              profiler=jprof, drift_cfg=JD.DriftConfig(**dc))
        got = run_policies(pop, FleetSpec(**kw), var_cfg=cfg, profiler=prof,
                           drift_cfg=DriftConfig(**dc), device="cpu",
                           traces=ref_traces(256))
        for p in ref:
            assert got[p].table.per_region and got[p].table.regions == 4
            assert_fleet_equal(ref[p], got[p], 256)
            np.testing.assert_array_equal(got[p].table.region_index,
                                          ref[p].table.region_index)
        assert_frontier_equal(JR.frontier(ref), frontier(got), 256)

    def test_faulted_fleet_matches_reference(self):
        """A `FaultSpec` axis on the serve (one launch of replay_blocks
        (e) an epoch, the reference's threefry error uniforms handed
        across): the detected / silent / watchdog counters, and every
        other field, equal to the reference's."""
        jcfg, cfg = tiny_cfg(6, 4)
        jpop, pop = tiny_pop(6, 4)
        jprof, prof = fast_profilers()
        fa = JF.FaultSpec(scenarios=(
            JF.FaultScenario(name="err", err_scale=1.0, err_free_red=0.0,
                             detect_frac=0.9, retry_ns=60.0),), seed=5)
        kw = dict(n_epochs=20, workload_rows=(0,), n_requests=256,
                  module_failures=((8, 2),), seed=0)
        ref = JR.run_policies(jpop, JR.FleetSpec(**kw, faults=fa),
                              var_cfg=jcfg, profiler=jprof)
        u = np.asarray(JF.fault_uniforms(jax.random.PRNGKey(5), 1, 256))
        got = run_policies(pop, FleetSpec(**kw, faults=convert.fault_spec(fa)),
                           var_cfg=cfg, profiler=prof, device="cpu",
                           traces=ref_traces(256), fault_uniforms=u)
        assert ref["error"].served_detected.sum() > 0
        for p in ref:
            assert_fleet_equal(ref[p], got[p], 256)
        assert_frontier_equal(JR.frontier(ref), frontier(got), 256)


class TestRegionFleet:
    def test_unique_mask_scatters_shared_rows(self):
        idx = np.array([[[0, 0], [1, 2]]], np.int32)
        fail = np.zeros((1, 2, 2), bool)
        fail[0, 0, 1] = True
        um = FleetEngine._unique_mask(fail, idx, 3)
        assert um.shape == (1, 3)
        assert um[0].tolist() == [True, False, False]
        fail[0, 1, 0] = True
        um = FleetEngine._unique_mask(fail, idx, 3)
        assert um[0].tolist() == [True, True, False]
        np.testing.assert_array_equal(
            um, JR.FleetEngine._unique_mask(fail, idx, 3))

    def test_drift_region_accel_scales_rates(self):
        from repro_torch.core.charge import row_positions
        jcfg, cfg = tiny_cfg(3, 4)
        jpop, pop = tiny_pop(3, 4)
        dm0 = DriftModel(pop, DriftConfig(), var_cfg=cfg, seed=5)
        dm1 = DriftModel(pop, DriftConfig(region_accel=2.0), var_cfg=cfg,
                         seed=5)
        pos = row_positions(4).numpy().astype(np.float64)
        np.testing.assert_allclose(
            dm1.rates, dm0.rates * (1.0 + 2.0 * pos)[:, None], rtol=1e-12)
        np.testing.assert_array_equal(
            dm1.rates, JD.DriftModel(jpop, JD.DriftConfig(region_accel=2.0),
                                     var_cfg=jcfg, seed=5).rates)

    def test_probe_region_axis_consistent_with_dense(self):
        from repro_torch.core import timing as T
        from repro_torch.core.sweep import MarginEngine
        jpop, pop = tiny_pop(3, 4)
        m, bk = pop.n_modules, pop.n_banks
        rows3 = np.broadcast_to(T.DDR3_1600.as_row(),
                                (m, bk, 6)).astype(np.float32).copy()
        mon = ErrorMonitor(engine=MarginEngine(device="cpu"))
        p3 = mon.probe(pop, rows3, 55.0)
        assert p3.fail_counts.shape == (m, bk)
        p41 = mon.probe(pop, rows3[:, :, None, :], 55.0)
        assert p41.fail_counts.shape == (m, bk, 1)
        assert np.array_equal(p41.fail_counts[..., 0], p3.fail_counts)
        assert np.array_equal(p41.worst_margin[..., 0], p3.worst_margin)
        p42 = mon.probe(pop, np.broadcast_to(
            rows3[:, :, None, :], (m, bk, 2, 6)).copy(), 55.0)
        assert p42.fail_counts.shape == (m, bk, 2)
        assert np.array_equal(p42.fail_counts.sum(axis=2), p3.fail_counts)
        assert np.array_equal(p42.worst_margin.min(axis=2), p3.worst_margin)
        want = JM.ErrorMonitor().probe(jpop, rows3, 55.0)
        np.testing.assert_array_equal(p3.fail_counts, want.fail_counts)
        np.testing.assert_allclose(p3.worst_margin, want.worst_margin,
                                   rtol=0, atol=TOL)

    @pytest.mark.slow
    def test_region_fleet_closed_loop(self):
        jcfg, cfg = tiny_cfg(4, 8)
        jpop, pop = tiny_pop(4, 8)
        kw = dict(policy="error", n_epochs=5, n_requests=96,
                  workload_rows=(0,), temp_bins=(55.0, 85.0), regions=2,
                  seed=0)
        eng = FleetEngine(pop, FleetSpec(**kw), var_cfg=cfg,
                          drift_cfg=DriftConfig(region_accel=3.0),
                          device="cpu", traces=ref_traces(96))
        res = eng.run()
        assert res.replay_dispatches == 5
        assert res.table.per_region and res.table.regions == 2
        assert res.compression_ratio.shape == (5,)
        assert ((res.compression_ratio > 0.0)
                & (res.compression_ratio <= 1.0)).all()
        s = res.summary()
        assert 0.0 < s["mean_compression_ratio"] <= 1.0
        assert s["final_compression_ratio"] == res.compression_ratio[-1]
        rows, idx = eng._rows_from_table(res.table)
        assert idx is not None and idx.shape == (4, pop.n_banks, 2)
        dense = FleetEngine._dense(rows[:, 0], idx)
        assert dense.shape == (4, pop.n_banks, 2, 6)
        jeng = JR.FleetEngine(jpop, JR.FleetSpec(**kw), var_cfg=jcfg,
                              drift_cfg=JD.DriftConfig(region_accel=3.0))
        ref = jeng.run()
        assert_fleet_equal(ref, res, 96)
        jrows, jidx = jeng._rows_from_table(ref.table)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(idx, jidx)


class TestEpochAutotune:
    def test_autotune_records_epoch_key_and_serve_consults_it(self,
                                                              tmp_path):
        from repro_torch.core.autotune import ReplayTuner, replay_unit
        from repro_torch.core.sim_engine import SimEngine
        _, cfg = tiny_cfg(4, 3)
        _, pop = tiny_pop(4, 3)
        spec = FleetSpec(n_epochs=2, workload_rows=(0,), n_requests=256,
                         seed=0)
        tuner = ReplayTuner(platform="cpu", path=str(tmp_path / "tune.json"))
        sim = SimEngine(device="cpu", backend="auto", tuner=tuner)
        eng = FleetEngine(pop, spec, var_cfg=cfg, sim=sim, device="cpu")
        unit = replay_unit(adaptive=False, banked=True, channels=False)
        b = tuner.table._bin(tuner._condition(spec.n_requests))
        assert (unit, b) not in tuner.table._table
        winner = eng.autotune_epoch(reps=1)
        assert (unit, b) in tuner.table._table
        assert winner in tuner.candidates
        assert ReplayTuner(platform="cpu",
                           path=str(tmp_path / "tune.json")).lookup(
                               unit, spec.n_requests) == winner
        seen = []
        orig = tuner.lookup

        def spy(unit_, n_):
            seen.append((unit_, n_))
            return orig(unit_, n_)

        tuner.lookup = spy
        res = eng.run()
        assert res.replay_dispatches == spec.n_epochs
        assert len(seen) >= spec.n_epochs
        assert all(k == (unit, spec.n_requests) for k in seen), seen


class TestDevices:
    def test_engine_refuses_a_sim_or_profiler_on_another_device(self):
        """No silent move across devices: a `sim` or `profiler` that
        lives elsewhere than the fleet raises, as the controller does."""
        from repro_torch.core.profiler import Profiler
        from repro_torch.core.sim_engine import SimEngine
        _, cfg = tiny_cfg()
        _, pop = tiny_pop()
        with pytest.raises(ValueError, match="sim engine runs on meta"):
            FleetEngine(pop, FleetSpec(n_epochs=1), var_cfg=cfg,
                        sim=SimEngine(device="meta"), device="cpu")
        with pytest.raises(ValueError, match="profiler runs on meta"):
            FleetEngine(pop, FleetSpec(n_epochs=1), var_cfg=cfg,
                        profiler=Profiler(device="meta"), device="cpu")

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default does not raise")
        _, pop = tiny_pop()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetEngine(pop, FleetSpec(n_epochs=1))

    def test_spec_rejects_bad_fields(self):
        with pytest.raises(ValueError):
            FleetSpec(policy="sometimes")
        with pytest.raises(ValueError):
            FleetSpec(regions=0)
        with pytest.raises(TypeError):
            FleetSpec(faults="not-a-faultspec")


class TestDrivers:
    """`port_fleet_bench --fast` and `examples/port_aldram_fleet.py
    --fast` against the reference's runs computed here (the
    reference's population and pool handed across)."""

    @pytest.mark.slow
    def test_port_fleet_bench_fast_matches_reference(self, capsys):
        from benchmarks import fleet_bench, port_fleet_bench
        ref = fleet_bench.run(fast=True)
        cfg = dataclasses.replace(J_VAR, n_modules=8, n_cells=4)
        cells = np.asarray(j_sample(jax.random.PRNGKey(7), cfg).cells)
        pool = [np.asarray(f) for f in j_trace_batch(512, 0, 8)]
        got = port_fleet_bench.run(fast=True, device="cpu", cells=cells,
                                   traces=pool)
        out = capsys.readouterr().out
        assert "port_fleet_frontier," in out and "|dispatches=90|" in out
        assert got["dispatches"] == ref["dispatches"]
        assert_frontier_equal({"policies": ref["frontier"]},
                              {"policies": got["frontier"]}, 512)
        for p, s in ref["summaries"].items():
            for k, v in s.items():
                if k in ("raw_reduction", "eff_reduction"):
                    assert abs(got["summaries"][p][k] - v) <= red_tol(
                        lat_rtol(512), v), (p, k)
                else:
                    assert got["summaries"][p][k] == v, (p, k)

    @pytest.mark.slow
    def test_port_example_fast_matches_reference(self, capsys):
        import importlib.util
        import runpy
        spec = importlib.util.spec_from_file_location(
            "port_aldram_fleet", ROOT / "examples" / "port_aldram_fleet.py")
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        jcfg, _ = tiny_cfg(6, 4)
        jpop = j_sample(jax.random.PRNGKey(7), jcfg)
        pool = [np.asarray(f) for f in j_trace_batch(512, 0, 8)]
        got = ex.main(["--fast", "--device", "cpu"],
                      cells=np.asarray(jpop.cells), traces=pool)
        out = capsys.readouterr().out
        assert "ZERO uncorrectable events" in out
        argv = sys.argv
        sys.argv = ["aldram_fleet.py", "--fast"]
        try:
            runpy.run_path(str(ROOT / "examples" / "aldram_fleet.py"),
                           run_name="__main__")
        finally:
            sys.argv = argv
        ref_out = capsys.readouterr().out
        table = [ln for ln in out.splitlines() if ln.startswith("  ")]
        ref_table = [ln for ln in ref_out.splitlines()
                     if ln.startswith("  ")]
        assert table == ref_table
        assert got["error"].replay_dispatches == 30

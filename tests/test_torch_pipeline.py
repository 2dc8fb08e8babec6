"""End-to-end parity of the port's AL-DRAM main path with the JAX
reference on the CPU: population -> profile -> timing tables -> verify
-> Fig. 4 replay, on the `small_pop` fixture (12 modules).

The port samples its own traces from `torch.Generator`s, so the Fig. 4
comparison replays the REFERENCE's `trace_batch` streams (handed across
through `repro_torch.convert`) in the port's `SimEngine`: speedups agree
within 1e-5 (the latencies are bitwise equal; only the order of the
mean's summation differs)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import perf_model as jpm
from repro.core import timing as JT
from repro.core.aldram import ALDRAMController as JController
from repro.core.profiler import Profiler as JProfiler
from repro_torch import convert
from repro_torch.core import perf_model as tpm
from repro_torch.core import timing as TT
from repro_torch.core.aldram import ALDRAMController as TController
from repro_torch.core.profiler import Profiler as TProfiler
from repro_torch.core.sim_engine import SimEngine
from _torch_parity import one_thread as _one_thread  # noqa: F401


N_REQ = 256


@pytest.fixture(scope="module")
def pipeline(small_pop):
    jc = JController(JProfiler(constants=jcal.CALIBRATED_CONSTANTS,
                               grid_step=2.5))
    jtab = jc.profile(small_pop)
    tc = TController(TProfiler(convert.charge_constants(
        dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)), grid_step=2.5,
        device="cpu"), device="cpu")
    pop = convert.population(np.array(small_pop.cells), device="cpu")
    ttab = tc.profile(pop)
    return dict(jc=jc, tc=tc, jtab=jtab, ttab=ttab, jpop=small_pop, pop=pop,
                profile_dispatches=tc.engine.dispatch_count)


def _converted(jtab):
    return convert.timing_table(
        jtab.temp_bins, np.asarray(jtab.params),
        np.asarray(jtab.safe_trefi_read), np.asarray(jtab.safe_trefi_write),
        params_module=np.asarray(jtab.params_module))


def _ref_traces(n):
    tb = jpm.trace_batch(n=n, seed=0)
    return convert.trace(*(np.asarray(f) for f in tb), device="cpu")


def test_tables_equal(pipeline):
    j, t = pipeline["jtab"], pipeline["ttab"]
    assert t.per_bank and t.params.shape == j.params.shape
    np.testing.assert_array_equal(t.params, j.params)
    np.testing.assert_array_equal(t.params_module, j.params_module)
    np.testing.assert_array_equal(t.safe_trefi_read, j.safe_trefi_read)
    np.testing.assert_array_equal(t.safe_trefi_write, j.safe_trefi_write)
    assert pipeline["profile_dispatches"] == 2


def test_verify_agrees(pipeline):
    eng = pipeline["tc"].engine
    d0 = eng.dispatch_count
    assert pipeline["tc"].verify(pipeline["pop"]) is True
    assert pipeline["jc"].verify(pipeline["jpop"]) is True
    assert eng.dispatch_count - d0 == 1


def test_verify_chunked_by_module_groups(pipeline):
    eng = pipeline["tc"].engine
    d0 = eng.dispatch_count
    assert pipeline["tc"].verify(pipeline["pop"], max_grid_elems=200_000)
    assert eng.dispatch_count - d0 > 1


@pytest.mark.parametrize("where", ["module", "bank"])
def test_verify_catches_unsafe_row(pipeline, where):
    """An unsafe row (tRCD cut to 3.75 ns) makes both packages' verify
    fail — for a bank row only through the per-bank columns."""
    jtab = pipeline["jtab"]
    jc, tc = pipeline["jc"], pipeline["tc"]
    bad_mod, bad_bank = np.array(jtab.params_module), np.array(jtab.params)
    if where == "module":
        bad_mod[3, 1, 0] = 3.75
    else:
        bad_bank[5, 2, 6, 0] = 3.75
    jc_bad = JController(jc.profiler)
    jc_bad.table = dataclasses.replace(jtab, params=bad_bank,
                                       params_module=bad_mod)
    tc_bad = TController(tc.profiler, device="cpu")
    tc_bad.table = convert.timing_table(
        jtab.temp_bins, bad_bank, jtab.safe_trefi_read,
        jtab.safe_trefi_write, params_module=bad_mod)
    assert jc_bad.verify(pipeline["jpop"]) is False
    assert tc_bad.verify(pipeline["pop"]) is False


@pytest.mark.parametrize("temp", [45.0, 55.0, 85.0, 95.0])
def test_average_reductions_equal(pipeline, temp):
    assert pipeline["tc"].average_reductions(temp) == \
        pipeline["jc"].average_reductions(temp)


def test_lookups_and_stacks_equal(pipeline):
    jtab = pipeline["jtab"]
    ttab = _converted(jtab)
    rng = np.random.default_rng(2)
    mods = rng.integers(0, 12, 40)
    banks = rng.integers(0, 8, 40)
    temps = rng.uniform(30.0, 95.0, 40)
    temps[:3] = (45.0, 85.0, 85.5)          # exact edges, above hottest
    np.testing.assert_array_equal(ttab.lookup_many(mods, temps),
                                  jtab.lookup_many(mods, temps))
    np.testing.assert_array_equal(ttab.lookup_many_banks(mods, banks, temps),
                                  jtab.lookup_many_banks(mods, banks, temps))
    for a, b in zip(ttab.safe_stack(), jtab.safe_stack()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttab.lookup(4, 60.0).as_row(),
                                  jtab.lookup(4, 60.0).as_row())
    red = ttab.reduce_banks()
    assert not red.per_bank
    np.testing.assert_array_equal(red.params, jtab.reduce_banks().params)
    np.testing.assert_array_equal(pipeline["tc"].select(4, 60.0).as_row(),
                                  pipeline["jc"].select(4, 60.0).as_row())


def test_fig4_profiled_speedups_on_reference_traces(pipeline):
    """`evaluate_system`'s replay: the all-module-safe row of every bin
    plus the DDR3 baseline over the 70-trace pool."""
    jres = pipeline["jc"].evaluate_system(pipeline["jpop"], n=N_REQ)
    eng = SimEngine(device="cpu")
    tres = pipeline["tc"].evaluate_system(pipeline["pop"], n=N_REQ,
                                          engine=eng)
    np.testing.assert_array_equal(tres["rows"], jres["rows"])
    assert eng.dispatch_count == 1
    em = tpm.evaluate_many(tres["rows"], engine=eng,
                           traces=_ref_traces(N_REQ))
    sp = tpm.cpi_speedups(em["mean_latency_ns"])
    np.testing.assert_allclose(sp, jres["speedups"], rtol=1e-5, atol=1e-5)
    for tc_ in jres["temps"]:
        for key, val in tres["per_temp"][tc_].items():
            assert np.isfinite(val) and -1.0 < val < 1.0, (tc_, key, val)


def test_fig4_aldram_55c_on_reference_traces():
    """`perf_model.evaluate`'s campaign (DDR3 vs the paper's 55C set)."""
    rows = JT.stack_timing([JT.DDR3_1600, JT.ALDRAM_55C_EVAL])
    jem = jpm.evaluate_many(rows, n=N_REQ, seed=0)
    tem = tpm.evaluate_many(rows, engine=SimEngine(device="cpu"),
                            traces=_ref_traces(N_REQ))
    np.testing.assert_allclose(tem["mean_latency_ns"],
                               jem["mean_latency_ns"], rtol=1e-5)
    jsp = jpm.cpi_speedups(jem["mean_latency_ns"])
    tsp = tpm.cpi_speedups(tem["mean_latency_ns"])
    np.testing.assert_allclose(tsp, jsp, rtol=1e-5, atol=1e-5)
    intensive = np.array([w.intensive for w in tpm.WORKLOADS])
    assert abs(tpm.gmean_speedup(tsp[1, intensive, 0, 1])
               - jpm.gmean_speedup(jsp[1, intensive, 0, 1])) < 1e-5


def test_port_evaluate_runs_on_its_own_traces():
    out = tpm.evaluate(n=128, device="cpu")
    s = out["summary"]
    assert out["dispatches"] == {"replay": 1}
    assert 0.0 < s["multi_intensive_gmean"] < 0.5
    assert s["multi_nonintensive_gmean"] < s["multi_intensive_gmean"]
    assert set(out["multi"]) == {w.name for w in tpm.WORKLOADS}
    np.testing.assert_array_equal(TT.ALDRAM_55C_EVAL.as_row(),
                                  JT.ALDRAM_55C_EVAL.as_row())


@pytest.mark.parametrize("method", ["evaluate_region_system",
                                    "region_table"])
def test_region_paths_need_a_region_profile(pipeline, method):
    """The per-bank controller (regions=1) has no region table: the
    region paths ask for a regions > 1 profile (tests/test_torch_region.py
    holds them to the reference)."""
    args = (pipeline["pop"],) if method == "evaluate_region_system" else (2,)
    with pytest.raises(RuntimeError, match="regions > 1"):
        getattr(pipeline["tc"], method)(*args)


def test_table_patch_and_controller_options(pipeline):
    t0 = pipeline["ttab"]
    t1 = t0.patch(params=t0.params)
    assert t1.version == t0.version + 1 and t1.rollback() is t0
    np.testing.assert_array_equal(t1.params, t0.params)
    with pytest.raises(ValueError, match="per-bank"):
        TController(pipeline["tc"].profiler, regions=2, per_bank=False,
                    device="cpu")
    with pytest.raises(ValueError):
        TController(pipeline["tc"].profiler, device="meta")


def test_convert_table_roundtrip(pipeline):
    t = _converted(pipeline["jtab"])
    assert t.temp_bins == pipeline["jtab"].temp_bins
    assert t.n_banks == 8 and t.module_params.shape == (12, 5, 4)
    assert isinstance(pipeline["pop"].cells, torch.Tensor)

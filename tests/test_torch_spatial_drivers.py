"""The port's spatial and replay drivers against the reference's, on the
CPU: `benchmarks/port_fig_bank.py`, `port_thermal_bench.py` and
`port_sim_bench.py` on the population and the pool of the reference
drivers' `--fast` runs (the reference's `trace_batch` streams), handed
across through `repro_torch.convert`; each reference driver runs in the
same test.  (`port_fig_region.py` is held to `fig_region --fast` in
`tests/test_torch_region.py::test_fig_region_fast_parity`.)

Tables equal up to pass/fail flips whose deciding margin lies within
2e-4 of zero (counted and printed; with flips the test records
itself as xfailed, the tables not compared); speedups and gmeans within 1e-5
relative; replay dispatch counts exact; host statistics and totals
exact; device means and p99s within ceil(log2 N) float32 half-ulps."""

import numpy as np
import pytest

from _torch_parity import (assert_device_means, assert_rel, campaign_flips,
                           equality_needs_no_flips)
from benchmarks import common as jcommon
from benchmarks import fig_bank as jbank
from benchmarks import port_fig_bank as tbank
from benchmarks import port_sim_bench as tsim
from benchmarks import port_thermal_bench as tthermal
from benchmarks import sim_bench as jsim
from benchmarks import thermal_bench as jthermal
from repro.core import perf_model as jpm
from repro_torch import convert
from _torch_parity import one_thread as _one_thread  # noqa: F401


BINS = (45.0, 55.0, 65.0, 75.0, 85.0)


@pytest.fixture(scope="module")
def pops():
    jpop = jcommon.population(True)
    pop = convert.population(np.asarray(jpop.cells), device="cpu")
    return jpop, pop, campaign_flips(jpop, pop, BINS)


def _pool(n):
    return convert.trace(*(np.asarray(f) for f in jpm.trace_batch(n=n,
                                                                  seed=0)),
                         device="cpu")


def test_port_fig_bank_equals_reference(pops, capsys):
    jpop, pop, n_flips = pops
    jres = jbank.run(fast=True)
    tres = tbank.run(True, pop=pop, traces=_pool(1024), device="cpu")
    out = capsys.readouterr().out
    print(f"fig_bank --fast: {n_flips} pass/fail flips")
    assert tres["dispatches"] == {"replay": 1, "synth": 0, "total": 1}
    assert "fig_bank_tables," in out
    equality_needs_no_flips(n_flips, "fig_bank --fast")
    np.testing.assert_array_equal(tres["rows"], np.asarray(jres["rows"]))
    assert tres["reductions"] == jres["reductions"]
    np.testing.assert_allclose(tres["speedups"], np.asarray(jres["speedups"]),
                               rtol=1e-5, atol=1e-7)
    for t, d in jres["per_temp"].items():
        for k, v in d.items():
            assert_rel(tres["per_temp"][t][k], v, (t, k))
    assert_rel(tres["mean_bank_delta"], jres["mean_bank_delta"])


@pytest.mark.parametrize("per_bank", [False, True], ids=["module", "bank"])
def test_port_thermal_bench_equals_reference(pops, per_bank, capsys):
    jpop, pop, n_flips = pops
    tres = tthermal.run(True, pop=pop, traces=_pool(1024),
                        per_bank=per_bank, device="cpu")
    assert tres["dispatches"] == {"replay": 1, "synth": 0, "total": 1}
    if per_bank:
        # the reference bench is module-level; its per-bank twin is the
        # same controller's bracket
        from repro.core.aldram import ALDRAMController as JController
        jc = JController(jcommon.profiler(True))
        jc.profile(jpop)
        jres = jc.evaluate_dynamic(jpop, n=1024, fused=True, per_bank=True)
    else:
        jres = jthermal.run(fast=True)
    out = capsys.readouterr().out
    print(f"thermal_bench --fast ({'bank' if per_bank else 'module'}): "
          f"{n_flips} pass/fail flips")
    assert "thermal_adaptive_replay," in out
    equality_needs_no_flips(n_flips, "thermal_bench --fast")
    np.testing.assert_array_equal(tres["table"], np.asarray(jres["table"]))
    np.testing.assert_array_equal(tres["worst_bin"],
                                  np.asarray(jres["worst_bin"]))
    for pj, pt in zip(jres["per_policy"], tres["per_policy"]):
        assert list(pt) == list(pj)
        for name, d in pj.items():
            e = pt[name]
            assert e["worst_bin"] == d["worst_bin"], name
            assert e["mean_bin_switches"] == d["mean_bin_switches"], name
            for k in ("adaptive_gmean", "static_worst_gmean",
                      "oracle_gmean"):
                assert_rel(e[k], d[k], (name, k))
            np.testing.assert_allclose(e["temp_peak"], d["temp_peak"],
                                       rtol=1e-5)


def test_port_sim_bench_equals_reference(capsys):
    from repro.core import dram_sim as jdram
    from repro.core.dram_sim import Policy as JPolicy
    from repro.core.dram_sim import Trace as JTrace
    from repro.core.sim_engine import SimEngine as JSimEngine
    from repro.core.sim_engine import SimSpec as JSimSpec
    from repro.core.timing import DDR3_1600, stack_timing
    jout = jsim.run(fast=True)
    tout = tsim.run(True, traces=_pool(1024), device="cpu")
    out = capsys.readouterr().out
    assert "sim_fastpath_campaign," in out and "|dispatches=1" in out
    assert tout["dispatches"] == {"replay_per_run": 1,
                                  "decl_total_per_run": 1, "decl_synth": 0}
    assert tout["grid"] == jout["grid"] and tout["n"] == jout["n"]
    assert tout["windows"] == jout["windows"]
    # the reference's host and device statistics on the same streams
    tb = jpm.trace_batch(n=1024, seed=0)
    spec = JSimSpec(traces=JTrace(*(np.asarray(f)[35:70] for f in tb)),
                    timings=stack_timing([DDR3_1600.scaled(f, f, f, f)
                                          for f in np.linspace(1.0, 0.6, 8)]),
                    policies=(JPolicy(reorder_window=16),
                              JPolicy(reorder_window=64)))
    jdram._REORDER_CACHE.clear()
    jhost = JSimEngine(stats="host", reorder="host").run(spec)
    jdev = JSimEngine().run(spec)
    res = tout["results"]
    np.testing.assert_array_equal(res["ref"].total_ns, np.asarray(
        jhost.total_ns))
    np.testing.assert_array_equal(res["fast"].total_ns, np.asarray(
        jhost.total_ns))
    np.testing.assert_array_equal(res["ref"].mean_latency_ns,
                                  np.asarray(jhost.mean_latency_ns))
    np.testing.assert_array_equal(res["ref"].p99_latency_ns,
                                  np.asarray(jhost.p99_latency_ns))
    # device statistics: the float32 reductions' last bits (the p99's
    # interpolation too)
    assert_device_means(res["fast"].mean_latency_ns, jdev.mean_latency_ns,
                        1024)
    assert_device_means(res["fast"].p99_latency_ns, jdev.p99_latency_ns,
                        1024)
    assert tout["stats_rel_err"] <= 1e-5
    assert tout["stats_rel_err_decl"] <= 1e-5


@pytest.mark.parametrize("mod", [tbank, tthermal, tsim])
def test_port_spatial_drivers_import_no_jax(mod):
    src = open(mod.__file__).read()
    assert "import jax" not in src and "from repro." not in src \
        and "from repro " not in src

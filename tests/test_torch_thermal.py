"""Parity of the port's thermal model (`core/thermal.py`, `core/power.py`)
and of the thermal closed loop end to end (`evaluate_dynamic`,
`evaluate_bank_system`) with the JAX reference, on the CPU.

The controllers profile the shared `small_pop` fixture (12 modules) in
both packages; the replays run on the reference's own `trace_batch`
streams, handed across through `repro_torch.convert`.  `worst_bin` and
`mean_bin_switches` must be equal; the gmeans agree within 1e-5
relative (the latencies agree to the last bits, the mean's summation
order differs); `ambient_at` within rtol 1e-5 / atol 1e-4 (XLA's and
PyTorch's float32 `sin` differ in the last bits)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import perf_model as jpm
from repro.core import power as JPW
from repro.core import thermal as JTH
from repro.core.aldram import ALDRAMController as JController
from repro.core.aldram import default_scenarios as j_default_scenarios
from repro.core.profiler import Profiler as JProfiler
from repro_torch import convert
from repro_torch.core import power as TPW
from repro_torch.core import thermal as TTH
from repro_torch.core.aldram import ALDRAMController as TController
from repro_torch.core.aldram import default_scenarios
from repro_torch.core.profiler import Profiler as TProfiler
from repro_torch.core.sim_engine import SimEngine
from _torch_parity import one_thread as _one_thread  # noqa: F401


N_REQ = 128

SCENARIOS = [
    ("steady", lambda m: m.steady(42.0)),
    ("diurnal", lambda m: m.diurnal(38.0, 72.0, period_ns=1.2e5)),
    ("coolfail", lambda m: m.cooling_failure(44.0, 28.0, at_ns=3.0e4)),
    ("bursty", lambda m: m.bursty(42.0, 16.0, period_ns=6.0e4, duty=0.5)),
    ("bursty_odd", lambda m: m.bursty(50.0, -7.5, period_ns=3.3e3,
                                      duty=0.3)),
    ("rate_diurnal", lambda m: m.rate_scenario("diurnal")),
]


@pytest.mark.parametrize("make", [s[1] for s in SCENARIOS],
                         ids=[s[0] for s in SCENARIOS])
def test_ambient_at_matches_reference(make):
    js, ts = make(JTH), make(TTH)
    np.testing.assert_array_equal(ts.as_row(), js.as_row())
    assert ts.name == js.name
    rng = np.random.default_rng(1)
    t = np.concatenate([[0.0, 2.0e4, 3.0e4, 6.0e4, 1.2e5],
                        np.sort(rng.uniform(0, 4.0e5, 400))]
                       ).astype(np.float32)
    ja = np.asarray(JTH.ambient_at(jnp.asarray(js.as_row()), jnp.asarray(t)))
    ta = TTH.ambient_at(torch.tensor(ts.as_row()), torch.tensor(t))
    assert ta.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-5, atol=1e-4)
    for tt in (0.0, 3.0e4, 7.7e4):
        assert TTH.ambient_at_host(ts, tt) == JTH.ambient_at_host(js, tt)


def test_ambient_at_broadcasts_over_lanes():
    rows = TTH.stack_scenarios([m(TTH) for _, m in SCENARIOS])
    t = torch.linspace(0, 2.0e5, 33)
    lanes = TTH.ambient_at(torch.tensor(rows).T, t[:, None])     # [33, C]
    for c in range(rows.shape[0]):
        assert torch.equal(lanes[:, c],
                           TTH.ambient_at(torch.tensor(rows[c]), t))


def test_config_rows_and_stacks_equal():
    for kw in ({}, {"tau_ns": 5.0e3, "c_heat": 2.0e-4, "hyst_c": 1.5}):
        np.testing.assert_array_equal(TTH.ThermalConfig(**kw).as_row(),
                                      JTH.ThermalConfig(**kw).as_row())
    js, ts = j_default_scenarios(), default_scenarios()
    np.testing.assert_array_equal(TTH.stack_scenarios(ts),
                                  JTH.stack_scenarios(js))
    np.testing.assert_array_equal(
        TTH.stack_scenarios([s.oracle() for s in ts]),
        JTH.stack_scenarios([s.oracle() for s in js]))
    assert [s.name for s in ts] == [s.name for s in js]
    spec = TTH.ThermalSpec(ts, (45.0, 55.0))
    for a, b in zip(spec.pack(), JTH.ThermalSpec(js, (45.0, 55.0)).pack()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TTH.ThermalSpec((), (45.0,))
    with pytest.raises(ValueError):
        TTH.ThermalSpec(ts, (55.0, 45.0))
    with pytest.raises(ValueError):
        TTH.rate_scenario("nope")


def test_convert_scenario_roundtrip():
    for s in j_default_scenarios():
        t = convert.scenario(s.as_row(), s.name)
        assert t == dataclasses.replace(t, name=s.name)
        np.testing.assert_array_equal(t.as_row(), s.as_row())
    with pytest.raises(ValueError):
        convert.scenario(np.zeros(8))


def test_power_model_equal():
    pw = TPW.PowerParams()
    np.testing.assert_array_equal(TPW.energy_terms(pw),
                                  JPW.energy_terms(JPW.PowerParams()))
    from repro.core import timing as JT
    from repro_torch.core import timing as TT
    for rh in (0.0, 0.55, 1.0):
        assert TPW.access_energy(TT.ALDRAM_55C_EVAL, rh, pw) == \
            JPW.access_energy(JT.ALDRAM_55C_EVAL, rh, JPW.PowerParams())
    assert TPW.power_reduction() == JPW.power_reduction()
    e = TPW.access_energy_from_terms(torch.tensor(4.0), torch.tensor(5.0),
                                     torch.tensor(0.055),
                                     torch.tensor([0.0, 1.0]),
                                     torch.tensor([35.0, 23.75]))
    assert e.tolist() == pytest.approx([4.0, 4.0 + 5.0 + 0.055 * 23.75])


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def loop(small_pop):
    jc = JController(JProfiler(constants=jcal.CALIBRATED_CONSTANTS,
                               grid_step=2.5))
    jc.profile(small_pop)
    tc = TController(TProfiler(convert.charge_constants(
        dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)), grid_step=2.5,
        device="cpu"), device="cpu")
    pop = convert.population(np.array(small_pop.cells), device="cpu")
    tc.profile(pop)
    tb = jpm.trace_batch(n=N_REQ, seed=0)
    traces = convert.trace(*(np.asarray(f) for f in tb), device="cpu")
    return dict(jc=jc, tc=tc, jpop=small_pop, pop=pop, traces=traces,
                jres={}, tres={})


def _run(loop, per_bank, fused):
    key = (per_bank, fused)
    if key not in loop["jres"]:
        loop["jres"][key] = loop["jc"].evaluate_dynamic(
            loop["jpop"], n=N_REQ, per_bank=per_bank, fused=fused)
        eng = SimEngine(device="cpu")
        loop["tres"][key] = loop["tc"].evaluate_dynamic(
            loop["pop"], n=N_REQ, per_bank=per_bank, fused=fused,
            traces=loop["traces"], engine=eng)
        loop["tres"][key]["dispatches"] = eng.dispatch_count
    return loop["jres"][key], loop["tres"][key]


def _assert_same_loop(a, b, rtol):
    np.testing.assert_array_equal(a["worst_bin"], b["worst_bin"])
    assert list(a["per_scenario"]) == list(b["per_scenario"])
    for name, d in a["per_scenario"].items():
        e = b["per_scenario"][name]
        assert e["worst_bin"] == d["worst_bin"], name
        assert e["mean_bin_switches"] == d["mean_bin_switches"], name
        for k in ("adaptive_gmean", "static_worst_gmean", "oracle_gmean"):
            np.testing.assert_allclose(e[k], d[k], rtol=rtol, err_msg=name)
        np.testing.assert_allclose(e["temp_peak"], d["temp_peak"],
                                   rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["two-launch", "fused"])
@pytest.mark.parametrize("per_bank", [False, True], ids=["module", "bank"])
def test_evaluate_dynamic_matches_reference(loop, per_bank, fused):
    jr, tr = _run(loop, per_bank, fused)
    _assert_same_loop(jr, tr, rtol=1e-5)
    np.testing.assert_array_equal(tr["table"], jr["table"])
    assert tr["bins"] == jr["bins"]
    for k in ("static_worst", "adaptive", "oracle"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, atol=1e-6)
    assert tr["dispatches"] == (1 if fused else 2)
    assert tr["source"] == "profiled-table-dynamic"
    # the acceptance bracket of benchmarks/thermal_bench.py
    for pd in tr["per_policy"]:
        for name, d in pd.items():
            assert d["adaptive_gmean"] >= d["static_worst_gmean"] - 1e-9, name


@pytest.mark.parametrize("per_bank", [False, True], ids=["module", "bank"])
def test_run_bracket_equals_two_launch_path(loop, per_bank):
    _, two = _run(loop, per_bank, False)
    _, one = _run(loop, per_bank, True)
    _assert_same_loop(two, one, rtol=1e-5)
    np.testing.assert_allclose(one["mean_latency_ns"],
                               two["mean_latency_ns"], rtol=1e-5)
    r1, r2 = one["result"], two["result"]
    for name in ("temp_max", "temp_mean", "bin_switches", "bank_heat",
                 "total_ns"):
        np.testing.assert_array_equal(getattr(r1, name), getattr(r2, name))


def test_evaluate_bank_system_matches_reference(loop):
    jr = loop["jc"].evaluate_bank_system(loop["jpop"], n=N_REQ)
    eng = SimEngine(device="cpu")
    tr = loop["tc"].evaluate_bank_system(loop["pop"], n=N_REQ,
                                         traces=loop["traces"], engine=eng)
    assert eng.dispatch_count == 1
    np.testing.assert_array_equal(tr["rows"], jr["rows"])
    np.testing.assert_allclose(tr["speedups"], jr["speedups"], rtol=1e-5,
                               atol=1e-6)
    assert tr["reductions"] == jr["reductions"]
    for t, d in jr["per_temp"].items():
        for k, v in d.items():
            np.testing.assert_allclose(tr["per_temp"][t][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{t} {k}")


def test_safe_stacks_equal(loop):
    jt, tt = loop["jc"].table, loop["tc"].table
    for a, b in zip(tt.safe_stack(), jt.safe_stack()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tt.safe_stack_banks(), jt.safe_stack_banks()):
        np.testing.assert_array_equal(a, b)
    rows, _ = tt.safe_stack_banks()
    assert rows.shape == (6, 8, 6)
    assert (np.diff(rows[:5], axis=0) >= 0).all()        # bin-monotone
    with pytest.raises(ValueError):
        tt.reduce_banks().safe_stack_banks()


def test_evaluate_bank_system_needs_bank_table(loop):
    tc = TController(loop["tc"].profiler, per_bank=False, device="cpu")
    tc.table = loop["tc"].table.reduce_banks()
    with pytest.raises(ValueError, match="per_bank"):
        tc.evaluate_bank_system(loop["pop"], n=8)

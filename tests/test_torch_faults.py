"""Parity of the port's fault axis (`repro_torch.core.faults`, the
faulted replays and the engine's fault axis) with the JAX reference, on
the CPU.

Inputs: the reference's own fixture of `tests/test_faults.py` (two
ragged traces, three static rows with JEDEC last, the ACTIVE static
grid, the THERMAL / TABS / SENS adaptive grid), open and closed page,
and the reference's threefry error uniforms handed to the port
(`SimEngine.run(fault_uniforms=)`), so both sides draw the same errors.

Tolerances: static faulted latencies, totals and counters are held
bitwise (add, max, select, one true division).  In the adaptive replay
the sensed temperature goes through `sin` and `exp`, whose float32
results differ in the last bits between XLA and PyTorch (ROADMAP queue
C), so latencies are held to rtol 1e-5 and bins and counters to
equality for every scenario without a `hash01` draw (none, stuck).
The noise and dropout draws go through `hash01`'s own `sin`, whose
argument reaches ~1e5: those draws differ by up to 2^-8 (more where the
fract wraps), so the noisy scenario is held to the exact watchdog bound
on both sides and the lanes whose outcomes differ are counted and
printed, not asserted equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_faults as RF
from repro.core import dram_sim as jdram
from repro.core import faults as JF
from repro.core import sim_engine as jsim
from repro.core import thermal as JTH
from repro_torch import convert
from repro_torch.core import dram_sim as tdram
from repro_torch.core import faults as TF
from repro_torch.core import sim_engine as tsim
from repro_torch.core import thermal as TTH
from repro_torch.kernels.replay import ops as trops
from _torch_parity import one_thread as _one_thread  # noqa: F401


POLS_J = (jdram.OPEN_FCFS, jdram.Policy(page="closed"))
POLS_T = (tdram.OPEN_FCFS, tdram.Policy(page="closed"))
N = max(len(t.arrival) for t in RF.TRACES)
BANKS = 8


def _traces():
    return tuple(convert.trace(*t, device="cpu") for t in RF.TRACES)


def _thermal():
    scns, bins, tcfg = RF.THERMAL.pack()
    c = RF.THERMAL.config
    spec = TTH.ThermalSpec(
        tuple(convert.scenario(r, x.name)
              for r, x in zip(scns, RF.THERMAL.scenarios)),
        tuple(float(b) for b in bins),
        TTH.ThermalConfig(tau_ns=c.tau_ns, c_heat=c.c_heat, hyst_c=c.hyst_c))
    np.testing.assert_array_equal(spec.config.as_row(), tcfg)
    return spec


def _uniforms(fspec):
    """The reference engine's in-launch draw at the padded [T, N]."""
    return np.asarray(JF.fault_uniforms(jax.random.PRNGKey(fspec.seed),
                                        len(RF.TRACES), N))


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


# ------------------------------------------------------------- elementwise

def _rows(m: int, seed: int = 0) -> np.ndarray:
    """[F_COLS, m] seeded fault rows: every mode on and off, no noise
    and no dropout (their draws go through hash01)."""
    r = np.random.default_rng(seed)
    fp = np.zeros((JF.F_COLS, m), np.float32)
    fp[JF.STUCK_C] = r.uniform(20, 60, m)
    fp[JF.STUCK_FROM] = np.where(r.random(m) < 0.5, -1.0,
                                 r.uniform(0, 500, m))
    fp[JF.DRIFT] = np.where(r.random(m) < 0.5, 0.0, r.uniform(-1e-3, 1e-3, m))
    fp[JF.QUANT] = r.choice([0.0, 0.25, 0.5, 1.0, 2.0], m)
    fp[JF.LAG_TAU] = r.choice([0.0, 50.0, 400.0, 3000.0], m)
    fp[JF.ERR_SCALE] = r.uniform(0, 2, m)
    fp[JF.ERR_FREE] = r.uniform(0, 0.2, m)
    fp[JF.ERR_BIN_C] = r.uniform(0, 0.1, m)
    fp[JF.DET_FRAC] = r.uniform(0, 1, m)
    fp[JF.RETRY_NS] = r.uniform(10, 80, m)
    fp[JF.WD_ERR_N] = r.integers(0, 5, m) + r.choice([0.0, 0.7], m)
    fp[JF.WD_JUMP_C] = r.choice([0.0, 4.0], m)
    fp[JF.WD_SENSE_N] = r.integers(0, 4, m)
    fp[JF.WD_PROBE] = r.integers(0, 6, m) + r.choice([0.0, 0.5], m)
    fp[JF.WD_RECOVER_N] = r.integers(0, 4, m)
    fp[JF.SEED] = r.integers(0, 20, m)
    return fp


def _both(fn_j, fn_t, *args):
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    out_t = fn_t(*(torch.tensor(np.asarray(a)) for a in args))
    return out_j, out_t


def test_pack_and_spec_equal():
    for spec in (RF.ACTIVE, RF.SENS, JF.FaultSpec.none()):
        port = convert.fault_spec(spec)
        np.testing.assert_array_equal(port.pack(), spec.pack())
        assert port.names() == spec.names() and port.seed == spec.seed
        assert port.is_none == spec.is_none and len(port) == len(spec)
    assert TF.F_COLS == JF.F_COLS and TF.N_COUNTERS == JF.N_COUNTERS
    assert TF.ERR_CAP == JF.ERR_CAP and TF.NO_READING == JF.NO_READING


def test_fault_sensor_exact():
    """Bitwise wherever the lag stage's `exp` agrees: XLA's and
    PyTorch's float32 `exp` differ in the last bit at some arguments
    (counted and printed), and a lagging lane inherits that bit — those
    lanes are held to rtol 1e-6."""
    m = 4096
    r = np.random.default_rng(1)
    fp = _rows(m)
    t = np.cumsum(r.uniform(0, 20, m)).astype(np.float32)
    dt = r.uniform(0, 30, m).astype(np.float32)
    raw = r.uniform(30, 90, m).astype(np.float32)
    lag = np.where(r.random(m) < 0.2, JF.NO_READING,
                   r.uniform(30, 90, m)).astype(np.float32)
    held = np.where(r.random(m) < 0.2, JF.NO_READING,
                    r.uniform(30, 90, m)).astype(np.float32)
    k = np.arange(m, dtype=np.int32)
    oj, ot = _both(JF.fault_sensor, TF.fault_sensor, fp, t, dt, raw, lag,
                   held, k)
    arg = -np.maximum(dt, 0.0) / np.maximum(fp[JF.LAG_TAU], np.float32(1e-9))
    exp_off = (_bits(jnp.exp(jnp.asarray(arg)))
               != _bits(torch.exp(torch.tensor(arg)).numpy()))
    exp_off &= fp[JF.LAG_TAU] > 0
    for a, b in zip(oj, ot):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(_bits(a)[~exp_off], _bits(b)[~exp_off])
        np.testing.assert_allclose(b[exp_off], a[exp_off], rtol=1e-6)
    print(f"fault_sensor: {int(exp_off.sum())} of {m} lagging readings "
          "follow an exp that differs from the reference's in the last bit")
    # every stage took effect somewhere
    reading = np.asarray(oj[0])
    assert (reading != raw).mean() > 0.5 and (reading == raw).any()


def test_error_model_exact():
    m = 4096
    r = np.random.default_rng(2)
    fp = _rows(m)
    red = r.uniform(0, 0.4, m).astype(np.float32)
    excess = np.where(r.random(m) < 0.5, 0.0,
                      r.uniform(0, 30, m)).astype(np.float32)
    u = r.random(m).astype(np.float32)
    pj, pt = _both(JF.error_prob, TF.error_prob, fp, red, excess)
    np.testing.assert_array_equal(_bits(pj), _bits(pt.numpy()))
    assert (np.asarray(pj) == JF.ERR_CAP).any()
    dj, dt_ = _both(JF.error_draw, TF.error_draw, fp, u, np.asarray(pj))
    for a, b in zip(dj, dt_):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(dj[1]).any() and np.asarray(dj[2]).any()


def test_watchdog_exact():
    m = 4096
    r = np.random.default_rng(3)
    fp = _rows(m)
    wd = tuple(r.integers(0, 6, m).astype(np.int32) for _ in range(4)) \
        + (r.integers(0, 2, m).astype(np.int32),)
    det = r.random(m) < 0.4
    implaus = r.random(m) < 0.4
    v = r.random(m) < 0.8
    cnt = tuple(r.integers(0, 50, m).astype(np.int32) for _ in range(5))
    gj = JF.wd_gate(jnp.asarray(fp), tuple(jnp.asarray(x) for x in wd))
    gt = TF.wd_gate(torch.tensor(fp), tuple(torch.tensor(x) for x in wd))
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    probe = np.asarray(gj[0])
    assert probe.any() and not probe.all()
    uj = JF.wd_update(jnp.asarray(fp), tuple(jnp.asarray(x) for x in wd),
                      jnp.asarray(det), jnp.asarray(implaus),
                      jnp.asarray(probe))
    ut = TF.wd_update(torch.tensor(fp), tuple(torch.tensor(x) for x in wd),
                      torch.tensor(det), torch.tensor(implaus),
                      torch.tensor(probe))
    for a, b in zip(uj[0] + (uj[1],), ut[0] + (ut[1],)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(uj[1]).any()
    cj = JF.counter_update(tuple(jnp.asarray(x) for x in cnt), jnp.asarray(v),
                           jnp.asarray(det), jnp.asarray(implaus),
                           np.asarray(uj[1]), jnp.asarray(wd[4] > 0),
                           jnp.asarray(probe))
    ct = TF.counter_update(tuple(torch.tensor(x) for x in cnt),
                           torch.tensor(v), torch.tensor(det),
                           torch.tensor(implaus),
                           torch.tensor(np.asarray(uj[1])),
                           torch.tensor(wd[4] > 0), torch.tensor(probe))
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_hash01_draw_by_draw():
    """The argument of `sin` agrees bit for bit; the draws agree within
    2^-7 modulo 1 (the last bit of float32 `sin` differs between XLA
    and PyTorch, and the 43758.5 scale amplifies it)."""
    k = np.arange(8192, dtype=np.int32)
    n_diff = n_wrap = 0
    for seed in (0.0, 3.0, 7.0, 8.0, 11.0, 12.0):
        for s in (seed, seed + 1.0):
            sj = jnp.float32(s)
            arg_j = jnp.asarray(k).astype(jnp.float32) * 12.9898 \
                + sj * 78.233 + 0.5
            arg_t = torch.tensor(k).to(torch.float32) * 12.9898 \
                + torch.tensor(s, dtype=torch.float32) * 78.233 + 0.5
            np.testing.assert_array_equal(_bits(arg_j), _bits(arg_t.numpy()))
            hj = np.asarray(JF.hash01(sj, jnp.asarray(k)))
            ht = TF.hash01(torch.tensor(s, dtype=torch.float32),
                           torch.tensor(k)).numpy()
            d = np.abs(hj - ht)
            circ = np.minimum(d, 1.0 - d)
            assert (circ <= 2.0 ** -7).all(), float(circ.max())
            n_diff += int((d > 0).sum())
            n_wrap += int((d > 0.5).sum())
    print(f"hash01: {n_diff} of {12 * 8192} draws differ from the "
          f"reference, {n_wrap} by a wrap of the fract")


# ------------------------------------------------------------ static grid

def _static_spec_j(fspec=None):
    return jsim.SimSpec(traces=RF.TRACES, timings=RF.ROWS, policies=POLS_J,
                        faults=fspec, collect=("latencies",))


def _static_spec_t(fspec=None, timings=RF.ROWS):
    return tsim.SimSpec(traces=_traces(), timings=timings, policies=POLS_T,
                        faults=None if fspec is None
                        else convert.fault_spec(fspec),
                        collect=("latencies",))


@pytest.fixture(scope="module")
def static_res():
    ref = jsim.SimEngine(backend="scan").run(_static_spec_j(RF.ACTIVE))
    u = _uniforms(RF.ACTIVE)
    port = {st: tsim.SimEngine(device="cpu", stats=st).run(
        _static_spec_t(RF.ACTIVE), fault_uniforms=u)
        for st in ("device", "host")}
    plain = tsim.SimEngine(device="cpu").run(_static_spec_t())
    none = tsim.SimEngine(device="cpu").run(
        _static_spec_t(JF.FaultSpec.none()))
    return ref, port, plain, none


@pytest.mark.parametrize("stats", ["device", "host"])
def test_static_faulted_bitwise(static_res, stats):
    ref, port, _, _ = static_res
    rt = port[stats]
    assert rt.latencies.shape == ref.latencies.shape == (2, 2, 3, 3, N)
    np.testing.assert_array_equal(_bits(rt.latencies), _bits(ref.latencies))
    np.testing.assert_array_equal(_bits(rt.total_ns), _bits(ref.total_ns))
    np.testing.assert_array_equal(rt.fault_counters, ref.fault_counters)
    np.testing.assert_allclose(rt.mean_latency_ns, ref.mean_latency_ns,
                               rtol=1e-6)
    # the error lane counts and prices, the watchdog lane trips
    assert rt.detected_errors[..., 1].sum() > 0
    assert rt.silent_errors[..., 1].sum() > 0
    assert rt.wd_trips[..., 2].sum() > 0
    bound = 4 * (rt.wd_trips[..., 2] + 1) + rt.wd_probes[..., 2]
    assert (rt.detected_errors[..., 2] <= bound).all()


def test_static_inert_lane_and_none(static_res):
    _, port, plain, none = static_res
    rt = port["device"]
    np.testing.assert_array_equal(_bits(rt.latencies[..., 0, :]),
                                  _bits(plain.latencies))
    np.testing.assert_array_equal(_bits(rt.mean_latency_ns[..., 0]),
                                  _bits(plain.mean_latency_ns))
    assert rt.fault_counters[..., 0, :].sum() == 0
    # FaultSpec.none(): the unfaulted launch, repeated along F = 1
    assert none.mean_latency_ns.shape == plain.mean_latency_ns.shape + (1,)
    for name in ("mean_latency_ns", "p99_latency_ns", "total_ns"):
        np.testing.assert_array_equal(getattr(none, name)[..., 0],
                                      getattr(plain, name))
    np.testing.assert_array_equal(none.latencies[..., 0, :], plain.latencies)
    assert none.fault_counters.shape == plain.total_ns.shape + (1, 5)
    assert none.fault_counters.sum() == 0


def test_none_spec_launches_no_faulted_replay(monkeypatch):
    calls = []
    orig = trops.replay_blocks

    def spy(*a, **kw):
        calls.append(kw.get("fault"))
        return orig(*a, **kw)

    monkeypatch.setattr(trops, "replay_blocks", spy)
    tsim.SimEngine(device="cpu").run(_static_spec_t(JF.FaultSpec.none()))
    assert calls == [None]


def test_single_stream_views_match_reference():
    tr = RF.TRACES[1]
    n = len(tr.arrival)
    valid = np.ones(n, bool)
    u = np.random.default_rng(5).random(n).astype(np.float32)
    rows_f = np.tile(RF.ACTIVE.pack(), (3, 1))            # [9, F_COLS]
    tim = np.repeat(RF.ROWS, 3, axis=0)
    args = tuple(np.asarray(x) for x in tr) + (valid,)
    for closed in (False, True):
        rj = jdram.replay_rows(*(jnp.asarray(a) for a in args),
                               jnp.asarray(tim), closed,
                               fault=(jnp.asarray(rows_f),
                                      jnp.asarray(RF.ROWS[-1]),
                                      jnp.asarray(u)))
        rt = tdram.replay_rows(*(torch.tensor(a) for a in args),
                               torch.tensor(tim), closed,
                               fault=(torch.tensor(rows_f),
                                      torch.tensor(RF.ROWS[-1]),
                                      torch.tensor(u)))
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        oj = jdram.replay_one(*(jnp.asarray(a) for a in args),
                              jnp.asarray(RF.ROWS[0]), closed,
                              fault=(jnp.asarray(rows_f[2]),
                                     jnp.asarray(RF.ROWS[-1]),
                                     jnp.asarray(u)))
        ot = tdram.replay_one(*(torch.tensor(a) for a in args),
                              torch.tensor(RF.ROWS[0]), closed,
                              fault=(torch.tensor(rows_f[2]),
                                     torch.tensor(RF.ROWS[-1]),
                                     torch.tensor(u)))
        for a, b in zip(oj, ot):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert int(ot[2][2]) > 0                          # trips
        scns, bins, tcfg = RF.THERMAL.pack()
        aj = jdram.replay_adaptive(*(jnp.asarray(a) for a in args),
                                   jnp.asarray(RF.TABS[0]), jnp.asarray(bins),
                                   jnp.asarray(scns[1]), jnp.asarray(tcfg),
                                   closed,
                                   fault=(jnp.asarray(RF.SENS.pack()[1]),
                                          jnp.asarray(u)))
        at = tdram.replay_adaptive(*(torch.tensor(a) for a in args),
                                   torch.tensor(RF.TABS[0]),
                                   torch.tensor(bins), torch.tensor(scns[1]),
                                   torch.tensor(tcfg), closed,
                                   fault=(torch.tensor(RF.SENS.pack()[1]),
                                          torch.tensor(u)))
        np.testing.assert_array_equal(np.asarray(aj[3]), at[3].numpy())
        np.testing.assert_array_equal(np.asarray(aj[5]), at[5].numpy())
        np.testing.assert_allclose(at[0].numpy(), np.asarray(aj[0]),
                                   rtol=1e-5)


# ---------------------------------------------------------- adaptive grid

def _bank_tabs():
    """TABS per bank, each bank its own scale (JEDEC row scaled too)."""
    sc = np.linspace(1.0, 1.1, BANKS, dtype=np.float32)
    return (RF.TABS[:, :, None, :] * sc[None, None, :, None]).astype(
        np.float32)


def _region_tabs():
    """A [1, 4, U=3, 6] unique-column stack and a [banks * 2] map."""
    sc = np.array([1.0, 0.95, 1.08], np.float32)
    tabs = (RF.TABS[:, :, None, :] * sc[None, None, :, None]).astype(
        np.float32)
    rmap = np.random.default_rng(4).integers(0, 3, BANKS * 2).astype(np.int32)
    return tabs, rmap


LAYOUTS = {"module": lambda: (RF.TABS, None), "bank": lambda: (_bank_tabs(),
                                                                None),
           "region": _region_tabs}


@pytest.fixture(scope="module")
def adaptive_res():
    out = {}
    u = _uniforms(RF.SENS)
    for name, mk in LAYOUTS.items():
        tabs, rmap = mk()
        kw = dict(traces=RF.TRACES, timings=tabs, policies=POLS_J,
                  thermal=RF.THERMAL, region_map=rmap,
                  collect=("latencies", "temps", "bins"))
        ref = jsim.SimEngine(backend="scan").run(
            jsim.SimSpec(faults=RF.SENS, **kw))
        kw_t = dict(traces=_traces(), timings=tabs, policies=POLS_T,
                    thermal=_thermal(), region_map=rmap,
                    collect=("latencies", "temps", "bins"))
        eng = tsim.SimEngine(device="cpu")
        port = eng.run(tsim.SimSpec(faults=convert.fault_spec(RF.SENS),
                                    **kw_t), fault_uniforms=u)
        plain = eng.run(tsim.SimSpec(**kw_t))
        none = eng.run(tsim.SimSpec(faults=TF.FaultSpec.none(), **kw_t))
        out[name] = (ref, port, plain, none)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adaptive_sensor_faults_match(adaptive_res, layout):
    ref, port, _, _ = adaptive_res[layout]
    assert port.latencies.shape == ref.latencies.shape == (2, 2, 1, 2, 3, N)
    assert port.fault_counters.shape == (2, 2, 1, 2, 3, 5)
    for f in (0, 1):                              # none, stuck: no hash01
        np.testing.assert_array_equal(port.bins[..., f, :],
                                      ref.bins[..., f, :])
        np.testing.assert_array_equal(port.fault_counters[..., f, :],
                                      ref.fault_counters[..., f, :])
        np.testing.assert_array_equal(port.bin_switches[..., f],
                                      ref.bin_switches[..., f])
        np.testing.assert_allclose(port.latencies[..., f, :],
                                   ref.latencies[..., f, :], rtol=1e-5)
        np.testing.assert_allclose(port.total_ns[..., f],
                                   ref.total_ns[..., f], rtol=1e-5)
        np.testing.assert_allclose(port.temps[..., f, :], ref.temps[..., f, :],
                                   rtol=1e-5, atol=1e-4)
    # the stuck-cold sensor errs; its reading is the stuck value
    assert (port.detected_errors[..., 1].sum()
            + port.silent_errors[..., 1].sum()) > 0
    # noisy_wd: the exact watchdog bound on both sides; differing
    # outcomes counted, not asserted
    for r in (ref, port):
        det = np.asarray(r.detected_errors[..., 2])
        bound = 3 * (r.wd_trips[..., 2] + 1) + r.wd_probes[..., 2]
        assert (det <= bound).all()
    assert port.wd_trips[..., 2].sum() > 0
    lanes_off = ((port.bins[..., 2, :] != ref.bins[..., 2, :]).any(-1)
                 | (port.fault_counters[..., 2, :]
                    != ref.fault_counters[..., 2, :]).any(-1))
    print(f"{layout} noisy_wd: {int(lanes_off.sum())} of {lanes_off.size} "
          "lanes differ from the reference in bins or counters")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adaptive_inert_lane_and_none(adaptive_res, layout):
    _, port, plain, none = adaptive_res[layout]
    for name in ("latencies", "temps", "bank_heat"):
        np.testing.assert_array_equal(
            _bits(np.moveaxis(getattr(port, name), 4, 0)[0]),
            _bits(getattr(plain, name)))
    np.testing.assert_array_equal(port.bins[..., 0, :], plain.bins)
    for name in ("total_ns", "temp_max", "bin_switches", "mean_latency_ns"):
        np.testing.assert_array_equal(getattr(port, name)[..., 0],
                                      getattr(plain, name))
    assert port.fault_counters[..., 0, :].sum() == 0
    for name in ("latencies", "temps", "bins", "bank_heat"):
        np.testing.assert_array_equal(
            np.moveaxis(getattr(none, name), 4, 0)[0], getattr(plain, name))
    for name in ("mean_latency_ns", "total_ns", "temp_max", "temp_mean",
                 "bin_switches"):
        np.testing.assert_array_equal(getattr(none, name)[..., 0],
                                      getattr(plain, name))
    assert none.fault_counters.shape == plain.total_ns.shape + (1, 5)
    assert none.fault_counters.sum() == 0


def test_adaptive_error_probs_diagnostic():
    """`probs=True` returns each request's error probability: in [0,
    ERR_CAP], 0 at padding, and the draws u < p are exactly the
    detected plus silent errors the counters hold."""
    from repro_torch.kernels.replay import ref as trref
    tr = _traces()
    spec = tsim.SimSpec(traces=tr, timings=RF.TABS, policies=POLS_T,
                        thermal=_thermal())
    arrival, bank, row, is_write, valid, closed = spec.pack(
        torch.device("cpu"))
    cl, arr, bk, rw, wr, val = trref.to_cells(
        arrival, bank, row, is_write, torch.as_tensor(valid),
        torch.as_tensor(closed))
    scns, bins, tcfg = spec.thermal.pack()
    nf = len(RF.SENS)
    u = trref.cell_uniforms(torch.tensor(_uniforms(RF.SENS)), 2)
    out = tdram.replay_adaptive_cells(
        arr, bk, rw, wr.bool(), val.bool(),
        trref.lane_tables(torch.tensor(RF.TABS), len(scns) * nf), bins,
        trref.lane_scenarios(torch.tensor(scns), 1, nf), tcfg, cl > 0.5,
        fault=(trref.lane_faults(torch.tensor(RF.SENS.pack()),
                                 len(scns)), u), probs=True)
    cnt, p = out[6], out[7]
    assert p.shape == arr.shape + (len(scns) * nf,)
    assert float(p.min()) >= 0.0 and float(p.max()) <= TF.ERR_CAP
    assert bool((p[~val.bool()] == 0).all())
    errs = (u[:, :, None] < p).sum(1)                     # [G, L]
    assert torch.equal(errs.to(torch.int32), cnt[0] + cnt[1])
    assert int(errs.sum()) > 0


def test_adaptive_host_stats_match_device(adaptive_res):
    _, port, _, _ = adaptive_res["module"]
    tabs, _ = LAYOUTS["module"]()
    host = tsim.SimEngine(device="cpu", stats="host").run(
        tsim.SimSpec(traces=_traces(), timings=tabs, policies=POLS_T,
                     thermal=_thermal(), faults=convert.fault_spec(RF.SENS)),
        fault_uniforms=_uniforms(RF.SENS))
    np.testing.assert_array_equal(host.fault_counters, port.fault_counters)
    np.testing.assert_array_equal(host.bin_switches, port.bin_switches)
    np.testing.assert_array_equal(host.temp_max, port.temp_max)
    np.testing.assert_allclose(host.mean_latency_ns, port.mean_latency_ns,
                               rtol=1e-5)


def test_own_uniform_draw():
    """Without `fault_uniforms` the engine draws its own: the same seed
    gives the same grid, another seed another one; a misshapen array
    is refused."""
    spec = _static_spec_t(RF.ACTIVE)
    eng = tsim.SimEngine(device="cpu")
    a, b = eng.run(spec), eng.run(spec)
    np.testing.assert_array_equal(a.fault_counters, b.fault_counters)
    other = _static_spec_t(dataclasses.replace(RF.ACTIVE, seed=4))
    assert not np.array_equal(eng.run(other).fault_counters,
                              a.fault_counters)
    u = TF.fault_uniforms(3, 2, N, device="cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == (2, N)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    with pytest.raises(ValueError, match="fault_uniforms"):
        eng.run(spec, fault_uniforms=np.zeros((2, N - 1), np.float32))


# ------------------------------------------------------------- refusals

def test_refusals():
    rows_b = np.repeat(RF.ROWS[:, None, :], BANKS, axis=1)   # [S, B, 6]
    with pytest.raises(ValueError, match="per-bank"):
        tsim.SimSpec(traces=_traces(), timings=rows_b, policies=POLS_T,
                     faults=convert.fault_spec(RF.ACTIVE))
    # an inert spec is allowed there: it runs the unfaulted launch
    tsim.SimSpec(traces=_traces(), timings=rows_b, policies=POLS_T,
                 faults=TF.FaultSpec.none())
    with pytest.raises(TypeError, match="FaultSpec"):
        tsim.SimSpec(traces=_traces(), timings=RF.ROWS,
                     faults="not-a-faultspec")
    with pytest.raises(TypeError, match="FaultSpec"):
        tsim.SimSpec(traces=_traces(), timings=RF.ROWS, faults=RF.ACTIVE)
    spec = tsim.SimSpec(traces=_traces(), timings=RF.TABS, policies=POLS_T,
                        thermal=_thermal(),
                        faults=convert.fault_spec(RF.SENS))
    with pytest.raises(ValueError, match="bracket"):
        tsim.SimEngine(device="cpu").run_bracket(spec, RF.ROWS[-1])
    with pytest.raises(ValueError, match="module rows"):
        trops.replay_grid(*(torch.zeros((1, 1, 4)) for _ in range(4)),
                          torch.ones((1, 4), dtype=torch.bool),
                          torch.tensor(rows_b), torch.tensor([False]),
                          fault=(torch.zeros((3, TF.F_COLS)),
                                 torch.tensor(RF.ROWS[-1]),
                                 torch.zeros((1, 4))))
    with pytest.raises(ValueError):
        TF.FaultSpec(scenarios=())


# ----------------------------------------------------- the fault benchmark

def test_reference_uniforms_file():
    from benchmarks import port_fault_bench as pfb
    for fast, n in ((True, 2048), (False, 4096)):
        ref = np.asarray(JF.fault_uniforms(jax.random.PRNGKey(11), 2, n))
        np.testing.assert_array_equal(pfb.reference_uniforms(fast), ref)


def test_fault_bench_fast_parity(monkeypatch):
    """`fault_bench.run(fast=True)` and the port's, on the reference's
    uniforms: the `pairs` dict (reduced from each side's own result) is
    equal and both runs reach the same verdict on the acceptance
    bracket."""
    from benchmarks import fault_bench
    from benchmarks import port_fault_bench as pfb
    captured = {}
    orig = jsim.SimEngine.run

    def spy(self, spec, *a, **kw):
        captured["res"] = orig(self, spec, *a, **kw)
        return captured["res"]

    monkeypatch.setattr(jsim.SimEngine, "run", spy)
    try:
        verdict_ref = repr(fault_bench.run(fast=True)["pairs"])
    except AssertionError as e:
        verdict_ref = f"AssertionError{e.args}"
    span = float(np.asarray(fault_bench._mk_trace(2048, 1).arrival)[-1])
    fspec, lanes = fault_bench._fault_grid(True, span)
    u = pfb.reference_uniforms(True)
    c = pfb.campaign(True, "cpu", u)
    ref = pfb.summarize(captured["res"], fspec, lanes, c["n_req"],
                        check=False)
    port = pfb.summarize(c["res"], c["fspec"], c["lanes"], c["n_req"],
                         check=False)
    assert port["pairs"] == ref["pairs"]
    assert port["bound_exact"] and ref["bound_exact"]
    np.testing.assert_array_equal(c["res"].fault_counters,
                                  captured["res"].fault_counters)
    try:
        verdict_port = repr(pfb.run(True, "cpu", u)["pairs"])
    except AssertionError as e:
        verdict_port = f"AssertionError{e.args}"
    print(f"fault_bench --fast verdict: reference {verdict_ref}; port "
          f"{verdict_port}")
    assert verdict_port == verdict_ref

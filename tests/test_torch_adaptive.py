"""Parity of the port's closed-loop (adaptive) replay and its per-bank
static replay with the JAX reference, on the CPU.

Inputs come from a numpy seed: ragged valid prefixes, K = 2 table
stacks, a steady and a diurnal scenario, tau = 5 us and c_heat = 2e-4
(the reference's own kernel-parity setting, tests/test_replay_kernel.py).
The reference runs through its lax.scan path (`impl="ref"`).

Tolerances: the sensed temperature goes through `exp` and `sin`, whose
float32 results differ in the last bits between XLA and PyTorch, so
temperatures and heat are held to rtol 1e-5 / atol 1e-4 and latencies
to rtol 1e-5; the selected bins must be equal on every request (no
reading in these inputs lies within the last bits of a bin edge).
Where both sides run the port's own code the comparison is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram_sim as jdram
from repro.core import sim_engine as jsim
from repro.core import thermal as JTH
from repro.core.timing import DDR3_1600
from repro.kernels.replay import ops as jrops
from repro.kernels.replay import ref as jrref
from repro_torch import convert
from repro_torch.core import dram_sim as tdram
from repro_torch.core import sim_engine as tsim
from repro_torch.core import thermal as TTH
from repro_torch.kernels.replay import ops as trops
from repro_torch.kernels.replay import ref as trref
from _torch_parity import one_thread as _one_thread  # noqa: F401


N = 160
BANKS = 8


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _streams(t=3, p=2, n=N, seed=0):
    """[T, P, N] streams with ragged valid prefixes (n, n/2, 37)."""
    rng = np.random.default_rng(seed)
    lens = [n, n // 2, 37][:t]
    arr = np.zeros((t, n), np.float32)
    valid = np.zeros((t, n), bool)
    for i, ln in enumerate(lens):
        arr[i, :ln] = np.cumsum(rng.exponential(60.0, ln)).astype(np.float32)
        valid[i, :ln] = True
    bank = rng.integers(0, BANKS, (t, n)).astype(np.int32)
    row = rng.integers(0, 12, (t, n)).astype(np.int32)
    wr = rng.random((t, n)) < 0.3

    def tp(x):
        return np.broadcast_to(x[:, None], (t, p, n)).copy()

    closed = np.array([(i % 2) == 1 for i in range(p)])
    return tp(arr), tp(bank), tp(row), tp(wr), valid, closed


def _tables(k=2, s=3, banked=False):
    """K stacks of S bin rows + the JEDEC row, optionally per-bank
    (each bank scaled by its own factor)."""
    stacks = []
    for j in range(k):
        rows = [DDR3_1600.scaled(f, f, f, f).as_row()
                for f in np.linspace(0.7 + 0.05 * j, 0.9, s)]
        rows.append(DDR3_1600.as_row())
        tab = np.stack(rows)
        if banked:
            tab = tab[:, None, :] * np.linspace(1.0, 1.1, BANKS)[None, :, None]
        stacks.append(tab)
    return np.stack(stacks).astype(np.float32)


def _thermal(c_heat=2.0e-4):
    scns = JTH.stack_scenarios((JTH.steady(48.0),
                                JTH.diurnal(40.0, 90.0, period_ns=2.0e4)))
    tcfg = JTH.ThermalConfig(tau_ns=5.0e3, c_heat=c_heat).as_row()
    return scns, tcfg


def _inputs(banked=False, s=3, c_heat=2.0e-4):
    a, b, r, w, v, closed = _streams()
    scns, tcfg = _thermal(c_heat)
    bins = np.linspace(55.0, 85.0, s).astype(np.float32)
    return (a, b, r, w, v, _tables(s=s, banked=banked), bins, scns, tcfg,
            closed)


def _jax(args):
    return jrops.replay_grid_adaptive(*(jnp.asarray(x) for x in args),
                                      impl="ref")


def _port(args, emit_raw=True):
    return trops.replay_grid_adaptive(*(torch.tensor(x) for x in args),
                                      emit_raw=emit_raw)


@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
def test_adaptive_grid_matches_reference(banked):
    args = _inputs(banked)
    lj, tj, tempj, binj, heatj, _ = _jax(args)
    lt, tt, tempt, bint, heatt, diag = _port(args)
    assert lt.shape == (3, 2, 2, 2, N) and heatt.shape == (3, 2, 2, 2, BANKS)
    # the wrapper's CPU path is the plain version under the same contract
    plain = trref.replay_grid_adaptive(*(torch.tensor(x) for x in args))
    for x, y in zip((lt, tt, tempt, bint, heatt) + diag,
                    plain[:5] + plain[5]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(bint.numpy(), np.asarray(binj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5)
    np.testing.assert_allclose(tempt.numpy(), np.asarray(tempj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(heatt.numpy(), np.asarray(heatj), rtol=1e-5,
                               atol=1e-4)
    # the loop switches bins and reaches the JEDEC row somewhere
    assert int(bint.max()) == 3 and int((bint[..., 1:] != bint[..., :-1])
                                        .sum()) > 0
    # diagnostics reduced in the launch vs the reference's reduction
    # over its own raw traces
    dj = jsim._device_thermal_diag(tempj, binj, jnp.asarray(args[4]))
    np.testing.assert_allclose(diag[0].numpy(), np.asarray(dj[0]), rtol=1e-5)
    np.testing.assert_allclose(diag[1].numpy(), np.asarray(dj[1]), rtol=1e-5)
    np.testing.assert_array_equal(diag[2].numpy(), np.asarray(dj[2]))


@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
def test_adaptive_grid_matches_pallas_interpret(banked):
    """The reference's own kernel body (interpret mode, on-device diag)."""
    args = _inputs(banked)
    lj, tj, tempj, binj, heatj, dj = jrops.replay_grid_adaptive(
        *(jnp.asarray(x) for x in args), impl="pallas_interpret", bs=8,
        emit_raw=True)
    lt, tt, tempt, bint, heatt, diag = _port(args)
    np.testing.assert_array_equal(bint.numpy(), np.asarray(binj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5)
    np.testing.assert_allclose(heatt.numpy(), np.asarray(heatj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(diag[0].numpy(), np.asarray(dj[0]), rtol=1e-5)
    np.testing.assert_allclose(diag[1].numpy(), np.asarray(dj[1]), rtol=1e-5)
    np.testing.assert_array_equal(diag[2].numpy(), np.asarray(dj[2]))


def test_in_loop_diag_equals_raw_reduction():
    """The running diagnostics equal the port's reduction of its own
    raw grids: max and switch counts exactly, the mean to 1e-6."""
    args = _inputs()
    _, _, temps, bins, _, diag = _port(args)
    d = tsim._device_thermal_diag(temps, bins, torch.tensor(args[4]))
    assert torch.equal(diag[0], d[0]) and torch.equal(diag[2], d[2].int())
    torch.testing.assert_close(diag[1], d[1], rtol=1e-6, atol=0)


def test_device_thermal_diag_matches_reference():
    rng = np.random.default_rng(5)
    temps = rng.uniform(30, 90, (3, 2, 2, 2, 50)).astype(np.float32)
    bins = rng.integers(0, 4, temps.shape).astype(np.int32)
    valid = np.ones((3, 50), bool)
    valid[1, 20:] = False
    valid[2, 1:] = False
    j = jsim._device_thermal_diag(jnp.asarray(temps), jnp.asarray(bins),
                                  jnp.asarray(valid))
    t = tsim._device_thermal_diag(torch.tensor(temps), torch.tensor(bins),
                                  torch.tensor(valid))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-6)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))


def test_emit_raw_off_keeps_raw_grids_out():
    args = _inputs()
    out = _port(args, emit_raw=False)
    ref = _port(args)
    assert out[2] is None and out[3] is None
    for a, b in zip(out[:2] + out[4:5] + out[5], ref[:2] + ref[4:5] + ref[5]):
        assert torch.equal(a, b)


def test_steady_no_heat_equals_static_replay():
    """Steady ambient with c_heat = 0: every request selects the same
    bin, and the latencies equal the static replay of that row bit for
    bit."""
    a, b, r, w, v, tabs, bins, scns, tcfg, closed = _inputs(c_heat=0.0)
    scns = scns[:1]                                  # steady 48 C
    lt, tt, temps, sel, heat, _ = _port((a, b, r, w, v, tabs, bins, scns,
                                         tcfg, closed))
    vv = torch.tensor(v)[:, None, None, None, :]
    assert bool((sel[vv.expand_as(sel)] == 0).all())   # 48 C <= 55 C edge
    assert bool((heat == 0).all())
    ls, ts = trops.replay_grid(*(torch.tensor(x) for x in (a, b, r, w, v)),
                               torch.tensor(tabs[:, 0]), torch.tensor(closed))
    assert torch.equal(lt[:, :, :, 0], ls) and torch.equal(tt[:, :, :, 0], ts)


def test_constant_bank_stack_bit_identical_adaptive():
    """A per-bank stack constant across banks replays exactly like the
    module stack: latencies, totals, temperatures, bins and heat."""
    args = _inputs()
    tabs = args[5]
    tabs_b = np.broadcast_to(tabs[:, :, None, :],
                             tabs.shape[:2] + (BANKS, 6)).copy()
    m = _port(args)
    bk = _port(args[:5] + (tabs_b,) + args[6:])
    for x, y in zip(m[:5] + m[5], bk[:5] + bk[5]):
        assert torch.equal(x, y)


def test_constant_bank_rows_bit_identical_static():
    a, b, r, w, v, closed = _streams()
    rows = _tables(k=1, s=3)[0]
    rows_b = np.broadcast_to(rows[:, None, :], (4, BANKS, 6)).copy()
    ins = [torch.tensor(x) for x in (a, b, r, w, v)]
    lm, tm = trops.replay_grid(*ins, torch.tensor(rows), torch.tensor(closed))
    lb, tb = trops.replay_grid(*ins, torch.tensor(rows_b),
                               torch.tensor(closed))
    assert torch.equal(lm, lb) and torch.equal(tm, tb)


def test_banked_static_replay_bitwise_vs_reference():
    a, b, r, w, v, closed = _streams()
    rows_b = _tables(k=1, s=3, banked=True)[0]          # [4, B, 6]
    lj, tj = jrref.replay_grid(*(jnp.asarray(x) for x in (a, b, r, w, v)),
                               jnp.asarray(rows_b), jnp.asarray(closed))
    lt, tt = trops.replay_grid(*(torch.tensor(x) for x in
                                 (a, b, r, w, v, rows_b, closed)))
    np.testing.assert_array_equal(_bits(lt.numpy()), _bits(lj))
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(tj))
    lr, tr = trref.replay_grid(*(torch.tensor(x) for x in
                                 (a, b, r, w, v, rows_b, closed)))
    assert torch.equal(lr, lt) and torch.equal(tr, tt)


@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
def test_single_stream_replay_adaptive(banked):
    a, b, r, w, v, tabs, bins, scns, tcfg, closed = _inputs(banked)
    one = [x[1, 0] for x in (a, b, r, w)] + [v[1]]
    jo = jdram.replay_adaptive(*(jnp.asarray(x) for x in one),
                               jnp.asarray(tabs[1]), jnp.asarray(bins),
                               jnp.asarray(scns[1]), jnp.asarray(tcfg), True)
    to = tdram.replay_adaptive(*(torch.tensor(x) for x in one),
                               torch.tensor(tabs[1]), torch.tensor(bins),
                               torch.tensor(scns[1]), torch.tensor(tcfg),
                               True)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), rtol=1e-5)
    np.testing.assert_allclose(float(to[1]), float(jo[1]), rtol=1e-5)
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(to[4].numpy(), np.asarray(jo[4]), rtol=1e-5,
                               atol=1e-4)
    assert int((to[3] == -1).sum()) == N - N // 2      # padding suffix


def test_hot_reading_selects_jedec_and_empty_bins():
    """Above the hottest edge the JEDEC row (last) serves; with no edges
    at all the one-row stack is the JEDEC row."""
    a, b, r, w, v, closed = _streams(t=1, p=1)
    scns = TTH.stack_scenarios((TTH.steady(95.0),))
    tcfg = TTH.ThermalConfig(c_heat=0.0).as_row()
    ins = [torch.tensor(x) for x in (a, b, r, w, v)]
    tabs = torch.tensor(_tables(k=1, s=2))
    _, _, _, sel, _, _ = trops.replay_grid_adaptive(
        *ins, tabs, torch.tensor([55.0, 85.0]), torch.tensor(scns),
        torch.tensor(tcfg), torch.tensor(closed), emit_raw=True)
    assert bool((sel[0, 0, 0, 0] == 2).all())
    jed = tabs[:, -1:]
    l1, t1, _, sel1, _, _ = trops.replay_grid_adaptive(
        *ins, jed, torch.zeros(0), torch.tensor(scns), torch.tensor(tcfg),
        torch.tensor(closed), emit_raw=True)
    assert bool((sel1 == 0).all())
    ls, ts = trops.replay_grid(*ins, jed[:, 0], torch.tensor(closed))
    assert torch.equal(l1[:, :, :, 0], ls) and torch.equal(t1[:, :, :, 0], ts)


@pytest.mark.parametrize("stats", ["device", "host"])
@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
def test_sim_engine_adaptive_matches_reference(stats, banked):
    a, b, r, w, v, tabs, bins, scns, tcfg, closed = _inputs(banked)
    lens = v.sum(1)
    cfg = JTH.ThermalConfig(tau_ns=5.0e3, c_heat=2.0e-4)
    jscn = (JTH.steady(48.0), JTH.diurnal(40.0, 90.0, period_ns=2.0e4))
    jt = tuple(jdram.Trace(*(jnp.asarray(f[i, 0, :lens[i]])
                             for f in (a, b, r, w))) for i in range(3))
    ref = jsim.SimEngine(stats="host", reorder="host").run(jsim.SimSpec(
        traces=jt, timings=tabs, n_banks=BANKS,
        policies=(jdram.OPEN_FCFS, jdram.Policy(page="closed")),
        thermal=JTH.ThermalSpec(jscn, tuple(bins.tolist()), cfg),
        collect=("latencies", "temps", "bins")))
    tt = tuple(convert.trace(*(f[i, 0, :lens[i]] for f in (a, b, r, w)),
                             device="cpu") for i in range(3))
    tspec = TTH.ThermalSpec(
        tuple(convert.scenario(x, s.name) for x, s in zip(scns, jscn)),
        tuple(bins.tolist()), TTH.ThermalConfig(tau_ns=5.0e3, c_heat=2.0e-4))
    eng = tsim.SimEngine(device="cpu", stats=stats)
    res = eng.run(tsim.SimSpec(
        traces=tt, timings=tabs, thermal=tspec,
        policies=(tdram.OPEN_FCFS, tdram.Policy(page="closed")),
        collect=("latencies", "temps", "bins")))
    assert eng.dispatch_count == 1
    assert res.mean_latency_ns.shape == (3, 2, 2, 2)
    np.testing.assert_array_equal(res.bins, ref.bins)
    for name in ("latencies", "total_ns", "mean_latency_ns",
                 "p99_latency_ns", "temp_max", "temp_mean"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name),
                                   rtol=1e-5, err_msg=name)
    for name in ("temps", "bank_heat"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(res.bin_switches, ref.bin_switches)


def test_sim_spec_thermal_validation():
    tr = tdram.Trace(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.bool))
    tspec = TTH.ThermalSpec((TTH.steady(50.0),), (45.0, 55.0))
    with pytest.raises(ValueError, match="JEDEC"):
        tsim.SimSpec(traces=(tr,), timings=_tables(k=1, s=3), thermal=tspec)
    with pytest.raises(TypeError):
        tsim.SimSpec(traces=(tr,), timings=_tables(k=1, s=2),
                     thermal=object())
    with pytest.raises(ValueError, match="adaptive"):
        tsim.SimSpec(traces=(tr,), timings=_tables(k=1, s=2)[0],
                     collect=("temps",))
    with pytest.raises(ValueError, match="banks"):
        tsim.SimSpec(traces=(tr,), timings=_tables(k=1, s=2, banked=True),
                     thermal=tspec, n_banks=4)
    spec = tsim.SimSpec(traces=(tr,), timings=_tables(k=2, s=2),
                        thermal=tspec)
    assert spec.shape == (1, 1, 2, 1)


@pytest.mark.parametrize("kw,item", [({"n_channels": 2}, "10"),
                                     ({"n_ranks": 2}, "10")])
def test_unported_adaptive_axes_raise(kw, item):
    """The multi-channel closed loop is ported (its parity is in
    tests/test_torch_traffic.py): it runs on C*R*8 bank slots.  Sharded
    campaigns are ported too (tests/test_torch_engine.py): a mesh is
    accepted, and a mesh with host reordering raises."""
    z = torch.zeros(4)
    zi = torch.zeros(4, dtype=torch.int32)
    out = tdram.replay_adaptive(z, zi, zi, z.bool(), z.bool(),
                                torch.tensor(_tables(k=1, s=2)[0]),
                                torch.tensor([45.0, 55.0]),
                                torch.tensor(TTH.steady(50.0).as_row()),
                                torch.tensor(TTH.ThermalConfig().as_row()),
                                False, **kw)
    assert out[4].shape == (16,)
    from repro_torch.launch.mesh import make_campaign_mesh
    mesh = make_campaign_mesh(devices=["cpu"] * 2)
    assert tsim.SimEngine(device="cpu", mesh=mesh).mesh.shape == \
        {"campaign": 2}
    with pytest.raises(ValueError, match="reorder"):
        tsim.SimEngine(device="cpu", mesh=mesh, reorder="host")

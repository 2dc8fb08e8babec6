"""Parity of the port's FR-FCFS reordering and multi-channel, multi-tenant
campaigns (`repro_torch.core.dram_sim`, `sim_engine`, `perf_model` and
`benchmarks/port_traffic_bench.py`) with the JAX reference, on the CPU.

Inputs are made with numpy from a seed (request streams over 8 banks
and 600 rows, rows repeated so that FR-FCFS finds hits) or by the
reference itself (`perf_model.tenant_spec(...).materialize()`), handed
to the port with `convert.trace`.

Tolerances: the channel map, the issue orders and the tenant mixes are
integers or exact draws, held equal.  The static replay is float32 add,
max and select only, so latencies, totals and counters are held
bitwise, and the engine's host statistics (the same numpy reduction on
equal grids) too.  The closed loop senses its temperature through `sin`
and `exp`, whose float32 results differ in the last bits between XLA and
PyTorch (ROADMAP queue C): its bins, switches, latencies and totals are
held equal, temperatures and heat to rtol 1e-5, atol 1e-4.  The
traffic bench's grid means are held to 1e-6 relative: both sides
average equal statistics in float32, the port after a float64 device
mean (`sim_engine._device_stats`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram_sim as jdram
from repro.core import faults as JF
from repro.core import perf_model as jpm
from repro.core import sim_engine as jsim
from repro.core import thermal as JTH
from repro.core import timing as JT
from repro_torch import convert
from repro_torch.core import dram_sim as tdram
from repro_torch.core import perf_model as tpm
from repro_torch.core import sim_engine as tsim
from repro_torch.core import thermal as TTH
from repro_torch.kernels.replay import ops as trops
from repro_torch.kernels.replay import ref as trref
from _torch_parity import one_thread as _one_thread  # noqa: F401


N = 160
ROWS = JT.stack_timing([JT.DDR3_1600.scaled(0.8, 0.7, 0.6, 0.9),
                        JT.ALDRAM_55C_EVAL, JT.DDR3_1600])   # JEDEC last
CHANS = [(2, 1), (2, 2), (4, 1), (4, 2)]
LAYOUTS = ["module", "bank", "region", "faulted"]
REGIONS = 4
ERR = JF.FaultScenario(name="err", err_scale=0.8, err_free_red=0.0,
                       detect_frac=0.9, retry_ns=60.0)
WD = JF.FaultScenario(name="wd", err_scale=0.8, err_free_red=0.0,
                      detect_frac=1.0, wd_err_n=4, wd_probe=16,
                      wd_recover_n=2)


def _stream(n: int = N, seed: int = 0, gap: float = 8.0):
    """arrival, bank, row, is_write as numpy, every third row repeated
    so FR-FCFS finds hits."""
    r = np.random.default_rng(seed)
    row = r.integers(0, 600, n).astype(np.int32)
    row[::3] = row[0]
    return (np.cumsum(r.exponential(gap, n)).astype(np.float32),
            r.integers(0, 8, n).astype(np.int32), row, r.random(n) < 0.3)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return np.array_equal(_bits(a), _bits(b))
    return np.array_equal(a, b)


def _layout(kind: str):
    """(timings, region map, fault rows) of one layout: module rows
    [3, 6], per-bank rows [3, 8, 6], a [3, 6, 6] unique-row store with a
    [8 * REGIONS] map, or module rows under the two margin-error rows
    and an inert one (lanes l = s*F + f, JEDEC row last)."""
    if kind == "bank":
        return (ROWS[:, None, :] * np.linspace(1.0, 1.2, 8)[None, :, None]
                ).astype(np.float32), None, None
    if kind == "region":
        r = np.random.default_rng(4)
        store = (ROWS[:, None, :] * r.uniform(0.9, 1.1, (1, 6, 1))
                 ).astype(np.float32)
        rmap = r.integers(0, 6, 8 * REGIONS).astype(np.int32)
        rmap[:6] = np.arange(6)
        return store, rmap, None
    if kind == "faulted":
        f = np.stack([JF.FaultScenario().as_row(), ERR.as_row(),
                      WD.as_row()])
        return (np.repeat(ROWS, 3, 0),
                None, np.tile(f, (3, 1)).astype(np.float32))
    return ROWS, None, None


# ------------------------------------------------------------ address map

@pytest.mark.parametrize("il", [0, 1, 2])
@pytest.mark.parametrize("c,r", [(2, 1), (4, 2), (3, 2)])
def test_chan_rank_equals_reference(il, c, r):
    """The (channel, rank) of every request, negative rows included
    (int32 floored modulo and division)."""
    _, bank, row, _ = _stream(300, seed=il)
    row = row - 300
    a = jdram.chan_rank(jnp.asarray(bank), jnp.asarray(row), jnp.int32(il),
                        c, r)
    b = tdram.chan_rank(torch.tensor(bank), torch.tensor(row), il, c, r)
    for x, y in zip(a, b):
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_ileave_codes_equal_on_every_pack():
    assert tdram.ILEAVE_CODES == jdram.ILEAVE_CODES
    for name in tdram.ILEAVE_CODES:
        assert tdram.Policy(interleave=name).ileave_code == \
            jdram.Policy(interleave=name).ileave_code
    tr = tuple(convert.trace(*_stream(40, s), device="cpu")
               for s in range(2))
    pols = tuple(tdram.Policy(reorder_window=w, interleave=il)
                 for w, il in ((0, "bank_xor"), (8, "row"),
                               (4, "cacheline")))
    spec = tsim.SimSpec(traces=tr, timings=ROWS, policies=pols,
                        n_channels=2)
    jspec = jsim.SimSpec(traces=tuple(jdram.Trace(*_stream(40, s))
                                      for s in range(2)),
                         timings=ROWS, policies=tuple(
                             jdram.Policy(reorder_window=p.reorder_window,
                                          interleave=p.interleave)
                             for p in pols), n_channels=2)
    codes = [spec.ileave_codes for _ in range(3)]
    assert all(np.array_equal(c, jspec.ileave_codes) for c in codes)
    assert codes[0].dtype == np.int32
    assert spec.chan == jspec.chan == (2, 1, 5.0)
    for x, y in zip(spec.policy_knobs(), jspec.policy_knobs()):
        np.testing.assert_array_equal(x, y)
    # the host pack and the device pack carry the same codes and shapes
    a = spec.pack(torch.device("cpu"))
    b = spec.pack_device(torch.device("cpu"))
    assert a[0].shape == (2, 3, 40) and b[0].shape == (2, 40)
    np.testing.assert_array_equal(a[4], b[4])


# ------------------------------------------------------------------ FR-FCFS

def _perms(tr, window, slack, cap, w, valid=None):
    n = tr[0].shape[0]
    valid = np.ones(n, bool) if valid is None else valid
    pj = np.asarray(jdram.frfcfs_perm(
        *(jnp.asarray(x) for x in tr[:3]), jnp.asarray(valid),
        jnp.asarray(window, jnp.int32), jnp.asarray(slack, jnp.float32),
        jnp.asarray(cap, jnp.int32), max_window=w))
    pt = tdram.frfcfs_perm(*(torch.tensor(x) for x in tr[:3]),
                           torch.tensor(valid), window, slack, cap, w)
    return pj, pt.numpy()


@pytest.mark.parametrize("window,slack", [(2, 30.0), (4, 30.0), (8, 15.0),
                                          (16, 60.0)])
def test_frfcfs_order_and_perm_equal_reference(window, slack):
    tr = _stream(384, seed=window, gap=6.0)
    ref = jdram.frfcfs_order(jdram.Trace(*tr), window, slack)
    port = tdram.frfcfs_order(tdram.Trace(*(torch.tensor(x) for x in tr)),
                              window, slack)
    pj, pt = _perms(tr, window, slack, 4 * window, window)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(pj, ref)
    np.testing.assert_array_equal(pt, ref)
    assert not np.array_equal(ref, np.arange(384))    # it does reorder


def test_frfcfs_perm_padded_stream():
    """A padded stream reorders its valid prefix like the unpadded
    oracle, and the padding drains in order."""
    tr = _stream(300, seed=7, gap=6.0)
    ref = jdram.frfcfs_order(jdram.Trace(*tr), 8, 30.0)
    pad = [np.zeros(512, x.dtype) for x in tr]
    for p, x in zip(pad, tr):
        p[:300] = x
    valid = np.arange(512) < 300
    pj, pt = _perms(pad, 8, 30.0, 32, 8, valid)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(pt[:300], ref)
    np.testing.assert_array_equal(pt[300:], np.arange(300, 512))


def test_frfcfs_perm_starvation_cap():
    """An all-hit stream runs into the starvation cap."""
    n = 128
    tr = (np.zeros(n, np.float32), np.zeros(n, np.int32),
          np.where(np.arange(n) % 3, 7, 1).astype(np.int32),
          np.zeros(n, bool))
    ref = jdram.frfcfs_order(jdram.Trace(*tr), 4, 1e9, max_defer=3)
    pj, pt = _perms(tr, 4, 1e9, 3, 4)
    np.testing.assert_array_equal(pj, ref)
    np.testing.assert_array_equal(pt, ref)


def test_frfcfs_perm_batched_cells():
    """One scheduler run over cells with their own window, slack and cap
    equals each cell's run alone; window <= 1 is the identity."""
    trs = [_stream(200, seed=s, gap=5.0) for s in range(3)]
    knobs = [(8, 30.0, 32), (0, 30.0, 4), (4, 60.0, 2)]
    batch = tdram.frfcfs_perm(
        *(torch.tensor(np.stack([t[i] for t in trs])) for i in range(3)),
        torch.ones((3, 200), dtype=torch.bool),
        torch.tensor([k[0] for k in knobs]), torch.tensor([k[1] for k in
                                                           knobs]),
        torch.tensor([k[2] for k in knobs]), 8)
    for t, (w, s, c), got in zip(trs, knobs, batch):
        np.testing.assert_array_equal(
            got.numpy(), jdram.frfcfs_order(jdram.Trace(*t), max(w, 1), s,
                                            max_defer=c))
    np.testing.assert_array_equal(batch[1].numpy(), np.arange(200))


def test_frfcfs_reorder_caches_by_content():
    tr = tdram.Trace(*(torch.tensor(x) for x in _stream(120, seed=2)))
    a = tdram.frfcfs_reorder(tr, 8)
    assert tdram.frfcfs_reorder(tr, 8) is a               # a cache hit
    assert tdram.frfcfs_reorder(tr, 1) is tr              # FCFS: untouched
    with pytest.raises(ValueError):
        a.arrival[0] = 0.0                                # read-only
    np.testing.assert_array_equal(
        a.row, tr.row.numpy()[tdram.frfcfs_order(tr, 8)])
    tr.row[5] += 1                                        # in place
    b = tdram.frfcfs_reorder(tr, 8)
    assert b is not a
    np.testing.assert_array_equal(
        b.row, tr.row.numpy()[tdram.frfcfs_order(tr, 8)])


def test_eff_window_keeps_the_permutation():
    tr = _stream(200, seed=11, gap=4.0)
    valid = np.ones(200, bool)
    eff = tsim._eff_window(tr[0][None], valid[None], 32, 30.0)
    assert eff == jsim._eff_window(tr[0][None], valid[None], 32, 30.0)
    assert 1 <= eff < 32
    args = [torch.tensor(x) for x in tr[:3]] + [torch.tensor(valid)]
    np.testing.assert_array_equal(tdram.frfcfs_perm(*args, 32, 30.0, 16,
                                                    eff),
                                  tdram.frfcfs_perm(*args, 32, 30.0, 16,
                                                    32))
    dec = np.array([[5.0, 3.0, 8.0]], np.float32)
    assert tsim._eff_window(dec, np.ones((1, 3), bool), 16, 30.0) == 16


# --------------------------------------------------- multi-channel replays

def _replay_args(layout: str, n: int = N, seed: int = 1):
    tr = _stream(n, seed)
    valid = np.ones(n, bool)
    valid[n - 23:] = False
    tim, rmap, frows = _layout(layout)
    u = np.random.default_rng(seed).random(n).astype(np.float32)
    fault = None if frows is None else (frows, ROWS[-1], u)
    return tr + (valid,), tim, rmap, fault


def _jfault(fault):
    return None if fault is None else tuple(jnp.asarray(x) for x in fault)


def _tfault(fault):
    return None if fault is None else tuple(torch.tensor(x) for x in fault)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c,r", CHANS)
def test_replay_rows_multi_channel_bitwise(layout, c, r):
    """replay_rows and replay_one at C x R channels, every interleave,
    open and closed page: bitwise the reference's scan."""
    args, tim, rmap, fault = _replay_args(layout, seed=c * 10 + r)
    jr = None if rmap is None else jnp.asarray(rmap)
    tr_ = None if rmap is None else torch.tensor(rmap)
    for il in (0, 1, 2):
        closed = il == 1
        oj = jdram.replay_rows(*(jnp.asarray(x) for x in args),
                               jnp.asarray(tim), closed, n_channels=c,
                               n_ranks=r, ileave=il, t_burst=5.0,
                               fault=_jfault(fault), region_map=jr)
        ot = tdram.replay_rows(*(torch.tensor(x) for x in args),
                               torch.tensor(tim), closed, n_channels=c,
                               n_ranks=r, ileave=il, t_burst=5.0,
                               fault=_tfault(fault), region_map=tr_)
        assert len(oj) == len(ot)
        assert all(_equal(a, b.numpy()) for a, b in zip(oj, ot)), il
    if layout == "module":
        oj = jdram.replay_one(*(jnp.asarray(x) for x in args),
                              jnp.asarray(tim[1]), False, n_channels=c,
                              n_ranks=r, ileave=2, t_burst=7.5)
        ot = tdram.replay_one(*(torch.tensor(x) for x in args),
                              torch.tensor(tim[1]), False, n_channels=c,
                              n_ranks=r, ileave=2, t_burst=7.5)
        assert all(_equal(a, b.numpy()) for a, b in zip(oj, ot))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_replay_cells_per_cell_interleave(layout):
    """replay_cells over cells with their own interleave code (the
    kernel's [G] code column) equals replay_rows per cell."""
    tr = [_stream(N, seed=s) for s in range(3)]
    tim, rmap, frows = _layout(layout)
    u = np.random.default_rng(3).random((3, N)).astype(np.float32)
    stack = [torch.tensor(np.stack([t[i] for t in tr])) for i in range(4)]
    valid = torch.ones((3, N), dtype=torch.bool)
    valid[2, 100:] = False
    closed = torch.tensor([False, True, False])
    codes = torch.tensor([2, 0, 1], dtype=torch.int32)
    rm = None if rmap is None else torch.tensor(rmap)
    fault = (None if frows is None else
             (torch.tensor(frows), torch.tensor(ROWS[-1]), torch.tensor(u)))
    out = tdram.replay_cells(*stack, valid, torch.tensor(tim), closed,
                             region_map=rm, fault=fault, n_channels=4,
                             n_ranks=2, ileave=codes, t_burst=5.0)
    for g in range(3):
        f1 = None if fault is None else (fault[0], fault[1], fault[2][g])
        one = tdram.replay_rows(*(x[g] for x in stack), valid[g],
                                torch.tensor(tim), bool(closed[g]),
                                region_map=rm, fault=f1, n_channels=4,
                                n_ranks=2, ileave=int(codes[g]))
        assert torch.equal(out[0][g].T, one[0])
        assert torch.equal(out[1][g], one[1])
        if fault is not None:
            assert torch.equal(out[2][:, g], one[2])


@pytest.mark.parametrize("layout", ["module", "region", "faulted"])
@pytest.mark.parametrize("c,r,all_valid", [(1, 1, False), (2, 2, False),
                                           (4, 1, True)])
def test_replay_rows_frfcfs_bitwise(layout, c, r, all_valid):
    """The merged scheduler + replay equals the reference's and the
    port's replay_rows on the frfcfs_perm-permuted stream (the uniforms
    stay in issue position)."""
    args, tim, rmap, fault = _replay_args(layout, n=140, seed=5)
    if all_valid:
        args = args[:4] + (np.ones(140, bool),)
    w, slack, cap, buf = 8, 30.0, 32, 8
    jr = None if rmap is None else jnp.asarray(rmap)
    tr_ = None if rmap is None else torch.tensor(rmap)
    oj = jdram.replay_rows_frfcfs(
        *(jnp.asarray(x) for x in args), jnp.asarray(tim), False, w, slack,
        cap, buf, all_valid=all_valid, n_channels=c, n_ranks=r, ileave=1,
        fault=_jfault(fault), region_map=jr)
    targs = [torch.tensor(x) for x in args]
    ot = tdram.replay_rows_frfcfs(
        *targs, torch.tensor(tim), False, w, slack, cap, buf,
        all_valid=all_valid, n_channels=c, n_ranks=r, ileave=1,
        fault=_tfault(fault), region_map=tr_)
    assert all(_equal(a, b.numpy()) for a, b in zip(oj, ot))
    perm = tdram.frfcfs_perm(*targs[:3], targs[4], w, slack, cap, buf)
    assert not torch.equal(perm, torch.arange(140))
    op = tdram.replay_rows(*(x[perm] for x in targs[:4]), targs[4],
                           torch.tensor(tim), False, region_map=tr_,
                           fault=_tfault(fault), n_channels=c, n_ranks=r,
                           ileave=1)
    assert all(torch.equal(a, b) for a, b in zip(ot, op))


def test_single_channel_is_todays_arithmetic():
    """C = R = 1 with any interleave code and burst replays bitwise like
    the replay without a channel geometry, directly and through the
    engine (static, host and device reorder)."""
    args, tim, _, _ = _replay_args("module")
    t = [torch.tensor(x) for x in args]
    base = tdram.replay_one(*t, torch.tensor(ROWS[0]), False)
    for code in tdram.ILEAVE_CODES.values():
        got = tdram.replay_one(*t, torch.tensor(ROWS[0]), False,
                               n_channels=1, n_ranks=1, ileave=code,
                               t_burst=99.0)
        assert all(torch.equal(a, b) for a, b in zip(base, got))
    tr = tuple(convert.trace(*_stream(96, s), device="cpu")
               for s in range(3))
    for reorder in ("host", "device"):
        eng = tsim.SimEngine(device="cpu", stats="host", reorder=reorder)

        def run(il, **kw):
            return eng.run(tsim.SimSpec(
                traces=tr, timings=ROWS, collect=("latencies",),
                policies=(tdram.OPEN_FCFS,
                          tdram.Policy(reorder_window=8, interleave=il)),
                **kw))

        a = run("row")
        for il in ("cacheline", "bank_xor"):
            b = run(il, n_channels=1, n_ranks=1, t_burst_ns=99.0)
            assert all(_equal(getattr(a, f), getattr(b, f)) for f in
                       ("latencies", "mean_latency_ns", "p99_latency_ns",
                        "total_ns"))


def _thermal():
    spec = JTH.ThermalSpec(
        scenarios=(JTH.steady(48.0), JTH.diurnal(40.0, 90.0,
                                                 period_ns=2.0e4)),
        temp_bins=(55.0,), config=JTH.ThermalConfig(tau_ns=5.0e3,
                                                    c_heat=2.0e-4))
    scns, bins, tcfg = spec.pack()
    port = TTH.ThermalSpec(tuple(convert.scenario(r) for r in scns),
                           (55.0,), TTH.ThermalConfig(tau_ns=5.0e3,
                                                      c_heat=2.0e-4))
    return spec, port


@pytest.mark.parametrize("layout", ["module", "bank", "region", "faulted"])
@pytest.mark.parametrize("c,r", [(2, 1), (4, 2)])
def test_replay_adaptive_multi_channel(layout, c, r):
    """The closed loop at C x R channels: bins and latencies (and, with
    faults, counters) equal, temperatures and heat within tolerance."""
    args, _, rmap, _ = _replay_args("module", n=200, seed=c + r)
    tab = np.stack([JT.ALDRAM_55C_EVAL.as_row(), JT.DDR3_1600.as_row()])
    if layout in ("bank", "region"):
        k = 8 if layout == "bank" else 6
        tab = (tab[:, None, :] * np.linspace(1.0, 1.1, k)[None, :, None])
        if layout == "region":
            rmap = np.random.default_rng(2).integers(0, 6, 8 * REGIONS) \
                .astype(np.int32)
    tab = tab.astype(np.float32)
    fault = None
    if layout == "faulted":
        f = dataclasses.replace(WD, err_bin_c=0.05, stuck_c=30.0,
                                stuck_from_ns=200.0).as_row()
        fault = (f, np.random.default_rng(9).random(200).astype(np.float32))
    spec, _ = _thermal()
    _, bins, tcfg = spec.pack()
    # a fast swing across the 55 C edge within the trace
    scn = np.asarray(JTH.diurnal(38.0, 72.0, period_ns=1.0e3).as_row())
    scns = (None, scn)
    oj = jdram.replay_adaptive(
        *(jnp.asarray(x) for x in args), jnp.asarray(tab),
        jnp.asarray(bins), jnp.asarray(scns[1]), jnp.asarray(tcfg), False,
        n_channels=c, n_ranks=r, ileave=2, t_burst=5.0,
        fault=_jfault(fault),
        region_map=None if rmap is None else jnp.asarray(rmap))
    ot = tdram.replay_adaptive(
        *(torch.tensor(x) for x in args), torch.tensor(tab),
        torch.tensor(bins), torch.tensor(scns[1]), torch.tensor(tcfg),
        False, n_channels=c, n_ranks=r, ileave=2, t_burst=5.0,
        fault=_tfault(fault),
        region_map=None if rmap is None else torch.tensor(rmap))
    lat, total, temps, sel, heat = (x.numpy() for x in ot[:5])
    assert heat.shape == (c * r * 8,)
    assert _equal(oj[0], lat) and _equal(oj[1], total)
    np.testing.assert_array_equal(np.asarray(oj[3]), sel)
    assert len(set(sel[sel >= 0].tolist())) == 2       # it switches bins
    np.testing.assert_allclose(np.asarray(oj[2]), temps, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(oj[4]), heat, rtol=1e-5,
                               atol=1e-4)
    if fault is not None:
        np.testing.assert_array_equal(np.asarray(oj[5]), ot[5].numpy())
        assert int(ot[5].sum()) > 0


# ---------------------------------------------------------------- engine

def _campaign(n_traces: int = 3):
    jtr = tuple(jdram.Trace(*_stream(N - 30 * (s % 2), s))
                for s in range(n_traces))
    pols = (dict(), dict(reorder_window=8, interleave="cacheline"),
            dict(page="closed", interleave="bank_xor"),
            dict(reorder_window=4, reorder_slack_ns=60.0,
                 interleave="bank_xor"))
    return (jtr, tuple(convert.trace(*t, device="cpu") for t in jtr),
            tuple(jdram.Policy(**p) for p in pols),
            tuple(tdram.Policy(**p) for p in pols))


STAT = ("latencies", "mean_latency_ns", "p99_latency_ns", "total_ns")


@pytest.mark.parametrize("kind", ["module", "bank", "faulted"])
@pytest.mark.parametrize("c,r", [(1, 1), (2, 1), (4, 2)])
def test_engine_static_equals_reference(kind, c, r):
    """Static campaigns with device and host reordering: the latency
    grid, statistics, totals and counters equal the reference's
    SimEngine(stats="host", reorder="host")."""
    jtr, ttr, jpol, tpol = _campaign()
    tim = ROWS if kind != "bank" else _layout("bank")[0]
    kw = dict(timings=tim, n_channels=c, n_ranks=r, collect=("latencies",))
    jkw, tkw, u = dict(kw), dict(kw), None
    if kind == "faulted":
        fs = JF.FaultSpec(scenarios=(JF.FaultScenario(), ERR, WD), seed=3)
        jkw["faults"], tkw["faults"] = fs, convert.fault_spec(fs)
        u = np.asarray(JF.fault_uniforms(jax.random.PRNGKey(3), 3, N))
    ref = jsim.SimEngine(stats="host", reorder="host").run(
        jsim.SimSpec(traces=jtr, policies=jpol, **jkw))
    fields = STAT + (("fault_counters",) if u is not None else ())
    for reorder in ("device", "host"):
        port = tsim.SimEngine(device="cpu", stats="host",
                              reorder=reorder).run(
            tsim.SimSpec(traces=ttr, policies=tpol, **tkw),
            fault_uniforms=u)
        for f in fields:
            assert _equal(getattr(ref, f), getattr(port, f)), (reorder, f)
    if u is not None:
        assert port.detected_errors.sum() > 0


@pytest.mark.parametrize("c,r", [(1, 1), (2, 2)])
def test_engine_adaptive_equals_reference(c, r):
    """Adaptive campaigns with device and host reordering: latencies,
    bins, statistics and switches equal; temperatures and the [.., C*R*
    banks] heat within tolerance."""
    jtr, ttr, jpol, tpol = _campaign(2)
    jspec, tspec = _thermal()
    tab = np.stack([JT.ALDRAM_55C_EVAL.as_row(), JT.DDR3_1600.as_row()])[
        None]
    kw = dict(timings=tab, n_channels=c, n_ranks=r,
              collect=("latencies", "bins"))
    ref = jsim.SimEngine(stats="host", reorder="host").run(
        jsim.SimSpec(traces=jtr, policies=jpol, thermal=jspec, **kw))
    for reorder in ("device", "host"):
        port = tsim.SimEngine(device="cpu", stats="host",
                              reorder=reorder).run(
            tsim.SimSpec(traces=ttr, policies=tpol, thermal=tspec, **kw))
        for f in STAT + ("bins", "bin_switches"):
            assert _equal(getattr(ref, f), getattr(port, f)), (reorder, f)
        assert port.bank_heat.shape == ref.bank_heat.shape \
            == (2, 4, 1, 2, c * r * 8)
        for f in ("temp_max", "temp_mean", "bank_heat"):
            np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                       rtol=1e-5, atol=1e-4)


def test_engine_refusals_name_their_items():
    _, ttr, _, tpol = _campaign(1)
    spec = tsim.SimSpec(traces=ttr, timings=ROWS, policies=tpol,
                        n_channels=2, n_ranks=2)        # no longer raises
    assert spec.multi and spec.chan == (2, 2, 5.0)
    from repro_torch.core import faults as TF_
    from repro_torch.launch.mesh import make_campaign_mesh
    mesh = make_campaign_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="stats"):
        tsim.SimEngine(device="cpu", mesh=mesh, stats="host")
    faulted = tsim.SimSpec(traces=ttr, timings=ROWS, n_channels=2,
                           faults=TF_.FaultSpec(scenarios=(
                               TF_.FaultScenario(name="err", err_scale=0.8,
                                                 err_free_red=0.0),)))
    with pytest.raises(ValueError, match="single-device"):
        tsim.SimEngine(device="cpu", mesh=mesh).run(faulted)
    declared = tsim.SimSpec(traces=tpm.tenant_spec(n=16, n_streams=2),
                            timings=ROWS)      # a declarative axis
    assert declared.synth is not None and declared.shape == (2, 1, 3)
    with pytest.raises(TypeError, match="traces"):
        tsim.SimSpec(traces=object(), timings=ROWS)
    with pytest.raises(ValueError, match="reorder"):
        tsim.SimEngine(device="cpu", reorder="both")
    with pytest.raises(ValueError, match="interleave"):
        tdram.Policy(interleave="page")
    with pytest.raises(ValueError, match="n_channels"):
        tsim.SimSpec(traces=ttr, timings=ROWS, n_channels=0)


# ------------------------------------------------------- tenants and bench

def test_tenant_spec_mixes_bitwise_and_draws_deterministic():
    ref = jpm.tenant_spec(n=64, n_streams=5, seed=3)
    port = tpm.tenant_spec(n=64, n_streams=5, seed=3)
    np.testing.assert_array_equal(np.array(port.mixes), np.array(ref.mixes))
    np.testing.assert_array_equal(np.array(port.arrivals, np.float32),
                                  np.array(ref.arrivals, np.float32))
    assert (port.row_hits, port.write_fracs, port.inter_arrivals,
            port.offsets) == (ref.row_hits, ref.write_fracs,
                              ref.inter_arrivals, ref.offsets)
    a = port.materialize("cpu")
    b = tpm.tenant_spec(n=64, n_streams=5, seed=3).materialize("cpu")
    c = tpm.tenant_spec(n=64, n_streams=5, seed=4).materialize("cpu")
    assert len(a) == 5 and a[0].arrival.shape == (64,)
    for x, y in zip(a, b):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert not torch.equal(a[0].row, c[0].row)
    assert len({tuple(t.row.tolist()) for t in a}) == 5    # distinct
    for t in a:
        assert bool((t.arrival[1:] >= t.arrival[:-1]).all())
        assert t.bank.dtype == torch.int32 and 0 <= int(t.bank.min()) \
            and int(t.bank.max()) < 8
    assert port.materialize("cpu") is a                   # cached


def test_port_traffic_bench_matches_reference():
    """`port_traffic_bench.run(fast=True)` on the reference's
    materialized tenant traces: per channel count the grid mean, p99 and
    gap of the reference's unsharded engine on the same traces, within
    1e-6 relative; one replay per run; contention lowers the p99."""
    from benchmarks import port_traffic_bench as B
    n, n_streams, n_rows = B.grid(True)
    traces = jpm.tenant_spec(n=n, n_streams=n_streams, seed=0).materialize()
    rows = JT.stack_timing([JT.DDR3_1600.scaled(f, f, f, f)
                            for f in np.linspace(1.0, 0.68, n_rows)])
    np.testing.assert_array_equal(B.timing_rows(n_rows), rows)
    pols = tuple(jdram.Policy(reorder_window=16, interleave=il)
                 for il in B.INTERLEAVES)
    eng = jsim.SimEngine()
    out = B.run(fast=True, device="cpu", traces=tuple(
        convert.trace(*t, device="cpu") for t in traces))
    assert out["requests"] == n * n_streams * 3 * n_rows
    for c in B.CHANNEL_SWEEP:
        res = eng.run(jsim.SimSpec(traces=traces, timings=rows,
                                   policies=pols, n_channels=c))
        m = res.mean_latency_ns
        want = (float(m.mean()), float(res.p99_latency_ns.mean()),
                float(m[..., 0].mean() / m[..., -1].mean()))
        d = out["per_channel"][str(c)]
        got = (d["mean_ns"], d["p99_ns"], d["static_vs_adaptive_gap"])
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert d["replays"] == 2 and d["prepass_s"] > 0
    p99 = [out["per_channel"][str(c)]["p99_ns"] for c in B.CHANNEL_SWEEP]
    assert p99[0] > p99[1] >= p99[2]
    assert out["sharded_rel"] == 0.0


def test_replay_blocks_cpu_multi_runs_plain_version():
    """On CPU tensors the wrapper's multi-channel path is replay_cells
    (no launch counted), and the grid wrapper tiles the [P] codes per
    cell."""
    tr = [_stream(90, seed=s) for s in range(2)]
    a, b, rw, w = (np.stack([t[i] for t in tr])[:, None].repeat(3, 1)
                   for i in range(4))
    valid = np.ones((2, 90), bool)
    closed = np.array([False, True, False])
    codes = np.array([1, 0, 2], np.int32)
    before = (trops.replay_blocks.launches, trops.replay_blocks.launches_multi)
    lat, total = trops.replay_grid(
        *(torch.tensor(x) for x in (a, b, rw, w, valid)), torch.tensor(ROWS),
        torch.tensor(closed), chan=(2, 2, 5.0), ileave=torch.tensor(codes))
    assert (trops.replay_blocks.launches,
            trops.replay_blocks.launches_multi) == before
    lp, tp = trref.replay_grid(
        *(torch.tensor(x) for x in (a, b, rw, w, valid)), torch.tensor(ROWS),
        torch.tensor(closed), chan=(2, 2, 5.0), ileave=codes)
    assert torch.equal(lat, lp) and torch.equal(total, tp)
    for t in range(2):
        for p in range(3):
            one = tdram.replay_rows(
                *(torch.tensor(x[t, p]) for x in (a, b, rw, w)),
                torch.tensor(valid[t]), torch.tensor(ROWS), closed[p],
                n_channels=2, n_ranks=2, ileave=int(codes[p]))
            assert torch.equal(lat[t, p], one[0])

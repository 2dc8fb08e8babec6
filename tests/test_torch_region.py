"""Parity of the port's subarray-region path with the JAX reference, on
the CPU: the lossless row compressor, the row-position gradient, the
region views of the fused sweep, the mask-compressed `TimingTable` and
its lineage (`patch` / `rollback`), `verify` with region columns,
`region_reductions`, `safe_stack_regions`, `evaluate_region_system`,
and the regioned static and adaptive replays.

Fixture: the reference's own region configuration (6 modules, 8 tail
cells, 2.5 ns grid, bins 55/70/85 C, 4 regions per bank), profiled on
both sides from the reference's cells.  Margins agree within 2e-4, so a
pass/fail boolean may flip only where the reference's deciding margin
(the minimum over the region's chips and cells) lies within 2e-4 of 0;
flips are counted and must be explained that way.  The static replay is
held bitwise (the gather is a selection); the adaptive replay to equal
bins on every request, latencies within rtol 1e-5 and temperatures /
heat within rtol 1e-5, atol 1e-4 (XLA's and PyTorch's float32 `sin` and
`exp` differ in the last bits).  Speedups are compared within 1e-5 on
the reference's traces."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import charge as jcharge
from repro.core import dram_sim as jdram
from repro.core import perf_model as jpm
from repro.core import sim_engine as jsim
from repro.core import thermal as JTH
from repro.core import variation as jvar
from repro.core.aldram import ALDRAMController as JController
from repro.core.aldram import TimingTable as JTable
from repro.core.profiler import Profiler as JProfiler
from repro.core.timing import DDR3_1600
from repro.kernels.replay import ref as jrref
from repro.runtime import compression as jcomp
from repro_torch import convert
from repro_torch.core import calibration as tcal
from repro_torch.core import charge as tcharge
from repro_torch.core import dram_sim as tdram
from repro_torch.core import perf_model as tpm
from repro_torch.core import sim_engine as tsim
from repro_torch.core import thermal as TTH
from repro_torch.core import variation as tvar
from repro_torch.core.aldram import ALDRAMController as TController
from repro_torch.core.aldram import TimingTable
from repro_torch.core.profiler import Profiler as TProfiler
from repro_torch.kernels.replay import ops as trops
from repro_torch.runtime import compression as tcomp
from _torch_parity import one_thread as _one_thread  # noqa: F401


TOL = 2e-4
BINS = (55.0, 70.0, 85.0)
REGIONS = 4
BANKS = 8
N_REQ = 128


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def region_pop():
    cfg = dataclasses.replace(jcal.CALIBRATED_VARIATION, n_modules=6,
                              n_cells=8)
    return jvar.sample_population(jax.random.PRNGKey(7), cfg)


def _port_profiler():
    return TProfiler(convert.charge_constants(
        dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)), grid_step=2.5,
        device="cpu")


@pytest.fixture(scope="module")
def ctrls(region_pop):
    jc = JController(JProfiler(constants=jcal.CALIBRATED_CONSTANTS,
                               grid_step=2.5, impl="ref"),
                     temp_bins=BINS, regions=REGIONS)
    jc.profile(region_pop)
    tc = TController(_port_profiler(), temp_bins=BINS, regions=REGIONS,
                     device="cpu")
    pop = convert.population(np.asarray(region_pop.cells), device="cpu")
    tc.profile(pop)
    return dict(jc=jc, tc=tc, jpop=region_pop, pop=pop,
                profile_dispatches=tc.engine.dispatch_count)


@pytest.fixture(scope="module")
def sweeps(ctrls):
    """The region campaign's raw sweep on both sides (margins kept)."""
    jc, tc = ctrls["jc"], ctrls["tc"]
    jres = jc.engine.sweep(ctrls["jpop"], jc.sweep_result.spec,
                           regions=REGIONS)
    tres = tc.engine.sweep(ctrls["pop"], tc.sweep_result.spec,
                           regions=REGIONS)
    return jres, tres


def _ref_traces(n):
    tb = jpm.trace_batch(n=n, seed=0)
    return convert.trace(*(np.asarray(f) for f in tb), device="cpu")


# ----------------------------------------------------------- compressor

def _rows_case(case):
    rng = np.random.default_rng(3)
    if case == "mixed":
        base = rng.uniform(5, 30, (3, 4)).astype(np.float32)
        return base[rng.integers(0, 3, (2, 5, 16))]
    if case == "all_equal":
        return np.broadcast_to(np.float32([12.5, 35.0, 15.0, 13.75]),
                               (3, 16, 4)).copy()
    if case == "all_unique":
        return rng.uniform(5, 30, (2, 16, 4)).astype(np.float32)
    if case == "ragged_u":
        rows = np.empty((2, 8, 4), np.float32)
        rows[0] = 7.0                                 # U = 1 ...
        rows[1] = rng.uniform(5, 30, (8, 4))          # ... next to U = 8
        return rows
    raise KeyError(case)


@pytest.mark.parametrize("case", ["mixed", "all_equal", "all_unique",
                                  "ragged_u"])
def test_compress_rows_matches_reference(case):
    rows = _rows_case(case)
    st, it = tcomp.compress_rows(rows)
    sj, ij = jcomp.compress_rows(rows)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(it, ij)
    assert it.dtype == np.int32
    np.testing.assert_array_equal(tcomp.decompress_rows(st, it), rows)
    assert tcomp.rows_compression_ratio(st, it) == \
        jcomp.rows_compression_ratio(sj, ij)


def test_compress_rows_min_u_pads_with_last_row():
    rows = _rows_case("all_equal")
    st, it = tcomp.compress_rows(rows, min_u=5)
    sj, ij = jcomp.compress_rows(rows, min_u=5)
    assert st.shape == (3, 5, 4)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(it, ij)
    assert (st == st[:, :1]).all()


def test_compress_stack_matches_reference():
    rng = np.random.default_rng(4)
    cols = rng.uniform(5, 30, (5, 3, 6)).astype(np.float32)
    rows = cols[rng.integers(0, 5, 32)].transpose(1, 0, 2).copy()
    ut, it = tcomp.compress_stack(rows)         # [3, U, 6], [32]
    uj, ij = jcomp.compress_stack(rows)
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(ut[:, it], rows)
    with pytest.raises(ValueError):
        tcomp.compress_stack(rows[0])


# ----------------------------------------------------- charge, variation

def test_row_positions_and_region_gradient():
    np.testing.assert_allclose(tcharge.row_positions(24).numpy(),
                               np.asarray(jcharge.row_positions(24)),
                               rtol=0, atol=1e-6)
    for k in (0.0, 0.3, -0.7):
        gt = tcharge.region_gradient(tcharge.row_positions(8), k,
                                     tvar.FIELD_WEAK_SIGNS)
        gj = jcharge.region_gradient(jcharge.row_positions(8), k,
                                     jvar.FIELD_WEAK_SIGNS)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(np.asarray(tvar.FIELD_WEAK_SIGNS,
                                             np.float32),
                                  jvar.FIELD_WEAK_SIGNS)


def test_k_region_applies_the_row_position_gradient():
    """The port's sampler applies the gradient to the same draw: the
    k_region population is the k_region = 0 one times the gradient."""
    cfg = dataclasses.replace(tcal.CALIBRATED_VARIATION, n_modules=2,
                              n_cells=8)
    flat = tvar.sample_population(torch.Generator().manual_seed(3), cfg,
                                  device="cpu")
    grad = tvar.sample_population(
        torch.Generator().manual_seed(3),
        dataclasses.replace(cfg, k_region=0.4), device="cpu")
    g = tcharge.region_gradient(tcharge.row_positions(8), 0.4,
                                tvar.FIELD_WEAK_SIGNS)
    torch.testing.assert_close(grad.cells, flat.cells * g, rtol=0, atol=0)
    # far cells are weaker: slower tau_r, shorter retention
    assert bool((grad.cells[..., -1, 0] > flat.cells[..., -1, 0]).all())
    assert bool((grad.cells[..., -1, 2] < flat.cells[..., -1, 2]).all())


# ------------------------------------------------------------ region_of

def test_region_of_matches_reference():
    rows = np.array([0, 1, 127, 128, 255, 511, 512, 700, 1023, 4095,
                     65535, -1, -300, -513], np.int32)
    for r in (1, 2, 4, 8):
        got = tdram.region_of(torch.tensor(rows), r)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jdram.region_of(jnp.asarray(rows), r)))
    # float32 rows (the packed-stream form) and exact nesting
    f = tdram.region_of(torch.tensor(rows[:11], dtype=torch.float32), 8)
    np.testing.assert_array_equal(f.numpy(),
                                  tdram.region_of(torch.tensor(rows[:11]),
                                                  8).numpy())
    fine = tdram.region_of(torch.tensor(rows), 8)
    for lv in (1, 2, 4):
        assert torch.equal(tdram.region_of(torch.tensor(rows), lv),
                           fine // (8 // lv))
    assert tdram.SUBARRAY_ROWS == jdram.SUBARRAY_ROWS


# ------------------------------------------------------ regioned replay

def _streams(t=3, p=2, n=200, seed=0):
    """[T, P, N] streams with ragged valid prefixes; rows span several
    subarrays so every region and the `row mod 512` fold are hit."""
    rng = np.random.default_rng(seed)
    lens = [n, n // 2, 37][:t]
    arr = np.zeros((t, n), np.float32)
    valid = np.zeros((t, n), bool)
    for i, ln in enumerate(lens):
        arr[i, :ln] = np.cumsum(rng.exponential(30.0, ln)).astype(np.float32)
        valid[i, :ln] = True
    bank = rng.integers(0, BANKS, (t, n)).astype(np.int32)
    row = rng.integers(0, 4 * tdram.SUBARRAY_ROWS, (t, n)).astype(np.int32)
    row[:, 1::7] = row[:, :-1:7]                  # some row hits
    wr = rng.random((t, n)) < 0.3

    def tp(x):
        return np.broadcast_to(x[:, None], (t, p, n)).copy()

    return tp(arr), tp(bank), tp(row), tp(wr), valid, np.array([False, True])


def _store(s, u, seed=1):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.55, 1.0, (s, u))
    base = DDR3_1600.as_row()
    rows = np.broadcast_to(base, (s, u, 6)).copy()
    rows[..., :4] *= f[..., None]
    return rows.astype(np.float32)


def _map(rng, shape, u):
    return rng.integers(0, u, shape).astype(np.int32)


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lane"])
@pytest.mark.parametrize("regions", [2, 8])
def test_regioned_static_replay_bitwise_equals_reference(per_lane, regions):
    a, b, r, w, v, closed = _streams()
    s, u = 5, 7
    tim = _store(s, u)
    rng = np.random.default_rng(regions)
    rmap = _map(rng, ((s,) if per_lane else ()) + (BANKS * regions,), u)
    lj, tj = jrref.replay_grid(*(jnp.asarray(x) for x in
                                 (a, b, r, w, v, tim, closed)),
                               region_map=jnp.asarray(rmap))
    lt, tt = trops.replay_grid(*(torch.tensor(x) for x in
                                 (a, b, r, w, v, tim, closed)),
                               region_map=torch.tensor(rmap))
    assert lt.shape == (3, 2, s, 200)
    np.testing.assert_array_equal(lt.numpy().view(np.int32),
                                  np.asarray(lj).view(np.int32))
    np.testing.assert_array_equal(tt.numpy().view(np.int32),
                                  np.asarray(tj).view(np.int32))
    assert bool((lt[1, :, :, 100:] == 0).all())       # padding suffix


def test_constant_region_map_equals_per_bank_replay():
    """A map that sends every region of bank b to column b replays the
    per-bank [S, banks, 6] stack bit for bit (and so does R = 1 with the
    identity map)."""
    a, b, r, w, v, closed = _streams(seed=5)
    tim = _store(4, BANKS, seed=6)
    ins = [torch.tensor(x) for x in (a, b, r, w, v, tim, closed)]
    lb, tb = trops.replay_grid(*ins)
    for rmap in (np.repeat(np.arange(BANKS), 4), np.arange(BANKS)):
        lr, tr = trops.replay_grid(*ins, region_map=torch.tensor(
            rmap.astype(np.int32)))
        assert torch.equal(lr, lb) and torch.equal(tr, tb)


def _thermal_args(per_stack, seed=2, regions=4):
    a, b, r, w, v, closed = _streams(n=160, seed=seed)
    k, s, u = 2, 3, 6
    rng = np.random.default_rng(seed)
    tabs = np.stack([np.concatenate([_store(s, u, seed=seed + j),
                                     np.broadcast_to(DDR3_1600.as_row(),
                                                     (1, u, 6))])
                     for j in range(k)]).astype(np.float32)
    tabs[:, :s] = np.sort(tabs[:, :s], axis=1)       # bin-monotone
    scns = JTH.stack_scenarios((JTH.steady(48.0),
                                JTH.diurnal(40.0, 90.0, period_ns=2.0e3)))
    tcfg = JTH.ThermalConfig(tau_ns=5.0e3, c_heat=2.0e-4).as_row()
    bins = np.linspace(55.0, 85.0, s).astype(np.float32)
    rmap = _map(rng, ((k,) if per_stack else ()) + (BANKS * regions,), u)
    return (a, b, r, w, v, tabs, bins, scns, tcfg, closed), rmap


@pytest.mark.parametrize("per_stack", [False, True], ids=["shared", "stack"])
def test_regioned_adaptive_replay_matches_reference(per_stack):
    args, rmap = _thermal_args(per_stack)
    lj, tj, tempj, binj, heatj = jrref.replay_grid_adaptive(
        *(jnp.asarray(x) for x in args), region_map=jnp.asarray(rmap))
    lt, tt, tempt, bint, heatt, diag = trops.replay_grid_adaptive(
        *(torch.tensor(x) for x in args), emit_raw=True,
        region_map=torch.tensor(rmap))
    assert lt.shape == (3, 2, 2, 2, 160) and heatt.shape[-1] == BANKS
    np.testing.assert_array_equal(bint.numpy(), np.asarray(binj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5)
    np.testing.assert_allclose(tempt.numpy(), np.asarray(tempj), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(heatt.numpy(), np.asarray(heatj), rtol=1e-5,
                               atol=1e-4)
    sel = bint.numpy()
    assert (sel == 3).any() and len(np.unique(sel[sel >= 0])) > 2
    assert (sel[1, :, :, :, 80:] == -1).all()         # padding suffix


def test_replay_adaptive_single_stream_region_map():
    """`dram_sim.replay_adaptive` takes the [banks, R] map of
    `safe_stack_regions` as well as the flat one."""
    args, rmap = _thermal_args(False, seed=4)
    a, b, r, w, v, tabs, bins, scns, tcfg, closed = args
    one = [torch.tensor(x[0, 0]) for x in (a, b, r, w)]
    ref = jdram.replay_adaptive(*(jnp.asarray(x[0, 0]) for x in (a, b, r, w)),
                                jnp.asarray(v[0]), jnp.asarray(tabs[0]),
                                jnp.asarray(bins), jnp.asarray(scns[1]),
                                jnp.asarray(tcfg), False,
                                region_map=jnp.asarray(rmap))
    for m in (rmap, rmap.reshape(BANKS, -1)):
        got = tdram.replay_adaptive(*one, torch.tensor(v[0]),
                                    torch.tensor(tabs[0]), torch.tensor(bins),
                                    torch.tensor(scns[1]), torch.tensor(tcfg),
                                    False, region_map=torch.tensor(m))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5)


def test_simspec_region_map_contract():
    a, b, r, w, v, _ = _streams(t=1, p=1, n=16)
    tr = tdram.Trace(torch.tensor(a[0, 0]), torch.tensor(b[0, 0]),
                     torch.tensor(r[0, 0]), torch.tensor(w[0, 0]))
    tim = _store(2, 3)
    ok = tsim.SimSpec(traces=(tr,), timings=tim,
                      region_map=np.zeros(16, np.int64))
    assert ok.region_map.dtype == np.int32 and ok.region_map.shape == (16,)
    for bad in (np.full(16, 3), np.full(16, -1), np.zeros(12),
                np.zeros((3, 16)), np.zeros(16, np.float32)):
        with pytest.raises(ValueError):
            tsim.SimSpec(traces=(tr,), timings=tim, region_map=bad)
    with pytest.raises(ValueError, match="unique-row"):
        tsim.SimSpec(traces=(tr,), timings=tim[:, 0],
                     region_map=np.zeros(8, np.int32))
    # the regioned campaign equals the reference engine's
    res = tsim.SimEngine(device="cpu").run(tsim.SimSpec(
        traces=(tr,), timings=tim, region_map=np.arange(16) % 3,
        collect=("latencies",)))
    jres = jsim.SimEngine().run(jsim.SimSpec(
        traces=(jdram.Trace(*(jnp.asarray(x[0, 0]) for x in (a, b, r, w))),),
        timings=tim, region_map=np.arange(16) % 3, collect=("latencies",)))
    np.testing.assert_array_equal(res.latencies, np.asarray(jres.latencies))


# ------------------------------------------------------------ the sweep

@pytest.mark.parametrize("op", ["read", "write"])
def test_region_envelopes_agree_up_to_explained_flips(ctrls, sweeps, op):
    jres, tres = sweeps
    k = jres.index(op)
    okj, okt = np.asarray(jres.ok_region[k]), tres.ok_region[k]
    assert okt.shape == okj.shape == (6, BANKS, REGIONS, 3,
                                      okj.shape[-1])
    m, ch, bk, kc = ctrls["jpop"].cells.shape[:4]
    m3 = np.asarray(jres.margins[k])
    deciding = m3.reshape(m, ch, bk, REGIONS, kc // REGIONS,
                          *m3.shape[1:]).min(axis=(1, 4))
    flip = okj != okt
    print(f"{op}: {int(flip.sum())} pass/fail flips of {flip.size} region "
          "envelopes")
    assert (np.abs(deciding[flip]) <= TOL).all(), deciding[flip]
    # the spatial hierarchy is exact
    np.testing.assert_array_equal(tres.ok_bank[k], okt.all(2))
    np.testing.assert_array_equal(tres.ok[k], tres.ok_bank[k].all(1))
    clean = ~flip.reshape(m, -1).any(1)
    for name in ("chosen_region", "latency_sum_region"):
        np.testing.assert_array_equal(getattr(tres, name)[k][clean],
                                      np.asarray(getattr(jres, name)[k])[clean])


def test_region_sweep_is_one_launch_and_checks_regions(ctrls):
    assert ctrls["profile_dispatches"] == 2          # refresh + timing
    tc = ctrls["tc"]
    with pytest.raises(ValueError, match="divide"):
        tc.engine.sweep(ctrls["pop"], tc.sweep_result.spec, regions=3)
    assert tc.sweep_result.regions == REGIONS


# ------------------------------------------------------- region table

def test_region_table_equals_reference(ctrls):
    j, t = ctrls["jc"].table, ctrls["tc"].table
    assert t.per_region and t.per_bank and t.regions == REGIONS
    assert t.n_banks == BANKS and t.n_unique == j.n_unique
    for name in ("params", "region_index", "params_bank", "params_module",
                 "safe_trefi_read", "safe_trefi_write"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    assert t.region_index.dtype == np.int32
    assert t.compression_ratio() == j.compression_ratio() < 1.0
    np.testing.assert_array_equal(t.expand_regions(), j.expand_regions())
    np.testing.assert_array_equal(t.bank_params, np.asarray(j.bank_params))


@pytest.mark.parametrize("level", [1, 2, 4])
def test_region_table_levels_equal_reference(ctrls, level):
    t = ctrls["tc"].region_table(level)
    j = ctrls["jc"].region_table(level)
    assert t.per_region == j.per_region
    np.testing.assert_array_equal(t.params, np.asarray(j.params))
    if level > 1:
        np.testing.assert_array_equal(t.region_index, j.region_index)
        assert t.compression_ratio() == j.compression_ratio()
    else:
        np.testing.assert_array_equal(t.params,
                                      ctrls["tc"].table.params_bank)
    assert ctrls["tc"].region_table(REGIONS) is ctrls["tc"].table
    with pytest.raises(ValueError):
        ctrls["tc"].region_table(3)                  # must divide R


def test_lookups_and_safe_stack_regions_equal_reference(ctrls):
    t, j = ctrls["tc"].table, ctrls["jc"].table
    rng = np.random.default_rng(1)
    q = (rng.integers(0, 6, 40), rng.integers(0, BANKS, 40),
         rng.integers(0, REGIONS, 40), rng.uniform(40.0, 95.0, 40))
    np.testing.assert_array_equal(t.lookup_many_regions(*q),
                                  j.lookup_many_regions(*q))
    np.testing.assert_array_equal(t.lookup_many_banks(*q[:2], q[3]),
                                  j.lookup_many_banks(*q[:2], q[3]))
    for a, b in zip(t.safe_stack_regions(), j.safe_stack_regions()):
        np.testing.assert_array_equal(a, b)
    rows_u, _, idx = t.safe_stack_regions()
    assert idx.shape == (BANKS, REGIONS)
    np.testing.assert_array_equal(rows_u[-1][idx.reshape(-1)],
                                  np.broadcast_to(DDR3_1600.as_row(),
                                                  (BANKS * REGIONS, 6)))
    red = t.reduce_regions()
    assert not red.per_region and red.per_bank
    np.testing.assert_array_equal(red.params, np.asarray(j.params_bank))


def test_convert_region_table_roundtrip(ctrls):
    j = ctrls["jc"].table
    t = convert.timing_table(j.temp_bins, np.asarray(j.params),
                             np.asarray(j.safe_trefi_read),
                             np.asarray(j.safe_trefi_write),
                             params_module=np.asarray(j.params_module),
                             region_index=np.asarray(j.region_index),
                             params_bank=np.asarray(j.params_bank))
    assert t.per_region and t.regions == REGIONS
    for a, b in zip(t.safe_stack_regions(), j.safe_stack_regions()):
        np.testing.assert_array_equal(a, b)


def test_verify_region_invariant(ctrls):
    jc, tc = ctrls["jc"], ctrls["tc"]
    d0 = tc.engine.dispatch_count
    assert tc.verify(ctrls["pop"]) is True and jc.verify(ctrls["jpop"])
    assert tc.engine.dispatch_count - d0 == 1        # 6 modules: one group


def test_verify_catches_bad_unique_row(ctrls):
    """Corrupting one unique row (absurd tRCD) flips verify: the region
    diagonal reads through the index map.  A module-group split must
    not hide it."""
    tc = ctrls["tc"]
    tbl = tc.table
    params = tbl.params.copy()
    params[0, 0, 0, 0] = 1.0
    tc.table = dataclasses.replace(tbl, params=params)
    try:
        assert tc.verify(ctrls["pop"]) is False
        assert tc.verify(ctrls["pop"], max_grid_elems=200_000) is False
    finally:
        tc.table = tbl
    assert tc.verify(ctrls["pop"], max_grid_elems=200_000) is True


def test_region_reductions_equal_reference(ctrls):
    rt = ctrls["tc"].region_reductions((1, 2, 4))
    rj = ctrls["jc"].region_reductions((1, 2, 4))
    assert rt.keys() == rj.keys()
    for op in rt:
        assert rt[op].keys() == rj[op].keys()
        for key, val in rt[op].items():
            assert abs(val - rj[op][key]) <= 1e-6, (op, key)
        seq = [rt[op][x] for x in ("module", "bank", "region2", "region4")]
        assert all(b >= a - 1e-9 for a, b in zip(seq, seq[1:])), seq


def test_evaluate_region_system_on_reference_traces(ctrls):
    jres = ctrls["jc"].evaluate_region_system(ctrls["jpop"], n=N_REQ,
                                              levels=(2, 4))
    eng = tsim.SimEngine(device="cpu")
    tres = ctrls["tc"].evaluate_region_system(
        ctrls["pop"], n=N_REQ, levels=(2, 4), engine=eng,
        traces=_ref_traces(N_REQ))
    assert eng.dispatch_count == 1                   # one replay launch
    np.testing.assert_array_equal(tres["rows"], jres["rows"])
    np.testing.assert_array_equal(tres["region_map"], jres["region_map"])
    assert tres["rows"].shape == (1 + 4 * 3, tres["rows"].shape[1], 6)
    assert tres["region_map"].shape == (BANKS * REGIONS,)
    np.testing.assert_allclose(tres["speedups"], jres["speedups"],
                               rtol=1e-5, atol=1e-5)
    for tc_, d in jres["per_temp"].items():
        for key, val in d.items():
            assert abs(tres["per_temp"][tc_][key] - val) <= 1e-5 * abs(val) \
                + 1e-9, (tc_, key)
    assert tres["compression_ratio"] == jres["compression_ratio"]
    assert tres["reductions"] == ctrls["tc"].region_reductions((2, 4))


def test_regioned_stack_closed_loop_matches_reference(ctrls):
    """The deployed regioned stack (`safe_stack_regions`) in closed
    loop through both engines, on the reference's traces: bins equal,
    means within 1e-5."""
    rows_u, edges, idx = ctrls["tc"].table.safe_stack_regions()
    scns = (JTH.steady(42.0), JTH.diurnal(38.0, 72.0, period_ns=1.2e4),
            JTH.cooling_failure(44.0, 28.0, at_ns=3.0e3))
    cfg = JTH.ThermalConfig(tau_ns=5.0e3, c_heat=2.0e-4)
    tb = jpm.trace_batch(n=96, seed=0)
    jspec = jsim.SimSpec(traces=tb, timings=rows_u[None],
                         region_map=idx.reshape(-1),
                         thermal=JTH.ThermalSpec(scns, tuple(edges.tolist()),
                                                 cfg),
                         collect=("bins",))
    jres = jsim.SimEngine().run(jspec)
    tscns = tuple(convert.scenario(x.as_row(), x.name) for x in scns)
    tspec = tsim.SimSpec(
        traces=convert.trace(*(np.asarray(f) for f in tb), device="cpu"),
        timings=rows_u[None], region_map=idx.reshape(-1),
        thermal=TTH.ThermalSpec(tscns, tuple(edges.tolist()),
                                TTH.ThermalConfig(tau_ns=5.0e3,
                                                  c_heat=2.0e-4)),
        collect=("bins",))
    eng = tsim.SimEngine(device="cpu")
    tres = eng.run(tspec)
    assert eng.dispatch_count == 1 and tres.bins.shape[:4] == (70, 1, 1, 3)
    np.testing.assert_array_equal(tres.bins, np.asarray(jres.bins))
    np.testing.assert_allclose(tres.mean_latency_ns,
                               np.asarray(jres.mean_latency_ns), rtol=1e-5)
    with pytest.raises(ValueError, match="region"):
        eng.run_bracket(tspec, DDR3_1600.as_row())


# -------------------------------------------------------------- lineage

def tiny_region_table(m=2, nb=2, banks=3, rg=2, u=4, seed=0):
    rng = np.random.default_rng(seed)
    params = rng.uniform(10.0, 30.0, (m, nb, u, 4)).astype(np.float32)
    idx = rng.integers(0, u, (m, nb, banks, rg)).astype(np.int32)
    idx[0, 0, 0, 0] = u - 1                  # the full range is used
    dense = tcomp.decompress_rows(params, idx.reshape(m, nb, banks * rg)
                                  ).reshape(m, nb, banks, rg, 4)
    pb = dense.max(axis=3)
    kw = dict(params_module=pb.max(axis=2), region_index=idx,
              params_bank=pb)
    return (TimingTable((55.0, 85.0), params, np.full(m, 64.0),
                        np.full(m, 64.0), **kw),
            JTable((55.0, 85.0), params, np.full(m, 64.0),
                   np.full(m, 64.0), **kw))


class TestPatchLineage:
    """`patch` / `rollback` hold the reference's lineage contract
    (tests/test_region_table.py::TestPatchValidation), case by case:
    the port raises `ValueError` exactly where the reference does."""

    def test_u_resize_is_the_legal_patch(self):
        t0, j0 = tiny_region_table()
        grown = np.concatenate([t0.params, t0.params[:, :, -1:]], axis=2)
        t1, j1 = t0.patch(params=grown), j0.patch(params=grown)
        assert t1.version == j1.version == 1 and t1.parent is t0
        assert t1.n_unique == j1.n_unique == t0.n_unique + 1
        idx = np.clip(t0.region_index, 0, 0)
        t2 = t0.patch(params=t0.params[:, :, :1], region_index=idx)
        assert t2.n_unique == 1
        np.testing.assert_array_equal(t2.expand_regions(), j0.patch(
            params=t0.params[:, :, :1], region_index=idx).expand_regions())

    def test_rank_change_rejected(self):
        t0, _ = tiny_region_table()
        with pytest.raises(ValueError, match="rank"):
            t0.patch(params=t0.params[:, :, 0])

    def test_spatial_shape_change_rejected(self):
        t0, _ = tiny_region_table()
        with pytest.raises(ValueError, match="shape"):
            t0.patch(params_bank=t0.params_bank[:, :, :2])
        with pytest.raises(ValueError, match="shape"):
            t0.patch(region_index=t0.region_index[:, :, :, :1])
        with pytest.raises(ValueError, match="shape"):
            t0.patch(params=t0.params[:1])

    def test_cannot_introduce_uncarried_field(self):
        t0, _ = tiny_region_table()
        bank_only = t0.reduce_regions()
        with pytest.raises(ValueError, match="introduce"):
            bank_only.patch(region_index=t0.region_index)

    def test_index_past_store_rejected(self):
        t0, _ = tiny_region_table()
        bad = t0.region_index.copy()
        bad[0, 0, 0, 0] = t0.n_unique
        with pytest.raises(ValueError, match="unique-row"):
            t0.patch(region_index=bad)
        with pytest.raises(ValueError, match="unique-row"):
            t0.patch(params=t0.params[:, :, :1])

    def test_rollback_across_violation(self):
        t0, _ = tiny_region_table()
        t1 = t0.patch(params=t0.params * np.float32(1.01))
        with pytest.raises(ValueError):
            t1.patch(params=t1.params[:, :, 0])
        assert t1.version == 1 and t1.parent is t0
        assert t1.rollback() is t0
        assert t0.rollback() is t0

    def test_patch_of_a_per_bank_table(self, ctrls):
        """The lineage is not region-only: a per-bank table patches its
        rows and keeps its shape."""
        t0 = ctrls["tc"].table.reduce_regions()
        t1 = t0.patch(params=t0.params * np.float32(1.1))
        assert t1.version == 1 and t1.rollback() is t0
        with pytest.raises(ValueError, match="unknown"):
            t0.patch(temp_bins=(1.0,))


def test_controller_region_options_validated(ctrls):
    prof = ctrls["tc"].profiler
    with pytest.raises(ValueError, match="per-bank"):
        TController(prof, regions=2, per_bank=False, device="cpu")
    with pytest.raises(ValueError):
        TController(prof, regions=0, device="cpu")
    bank_only = TController(prof, device="cpu")
    with pytest.raises(RuntimeError, match="profile"):
        bank_only.region_table(1)


# ------------------------------------------------- fig_region --fast parity

@pytest.mark.slow
def test_fig_region_fast_parity(capsys):
    """`benchmarks/fig_region.py --fast` against the port's driver
    `benchmarks/port_fig_region.py --fast` on the reference's fast
    population (24 modules, 8 cells) profiled at 8 regions, with the
    reference's traces: the rows, map, reductions and compression ratios
    equal, and the per-temperature gmeans within 1e-5 relative; both
    drivers' CSV lines carry the same reductions.  The campaign's
    pass/fail flips (each within 2e-4 of zero) are counted and printed;
    the comparisons are made whatever their count."""
    from _torch_parity import campaign_flips
    from benchmarks import common
    from benchmarks import fig_region as jfr
    from benchmarks import port_fig_region as tfr
    jpop = common.population(fast=True)
    pop = convert.population(np.asarray(jpop.cells), device="cpu")
    jres = jfr.run(fast=True)
    tres = tfr.run(True, pop=pop, traces=_ref_traces(1024), device="cpu")
    out = capsys.readouterr().out
    n_flips = campaign_flips(jpop, pop, (45.0, 55.0, 65.0, 75.0, 85.0))
    assert tres["dispatches"] == {"replay": 1, "synth": 0, "total": 1}
    assert tres["compression_ratio"]["8"] < 0.5
    lines = [ln.split(",", 2)[2] for ln in out.splitlines()
             if ln.startswith("fig_region_hierarchy,")]
    assert len(lines) == 2
    for op in ("read", "write"):
        seq = [tres["reductions"][op][x]
               for x in ("module", "bank", "region2", "region4", "region8")]
        assert all(b >= a - 1e-9 for a, b in zip(seq, seq[1:])), seq
    print(f"fig_region --fast parity: {n_flips} pass/fail flips")
    np.testing.assert_array_equal(tres["rows"], jres["rows"])
    np.testing.assert_array_equal(tres["region_map"], jres["region_map"])
    assert tres["compression_ratio"] == jres["compression_ratio"]
    assert lines[0].split("|")[:5] == lines[1].split("|")[:5]
    worst = 0.0
    for op, d in jres["reductions"].items():
        for key, val in d.items():
            assert abs(tres["reductions"][op][key] - val) <= 1e-6, (op, key)
    for tc_, d in jres["per_temp"].items():
        for key, val in d.items():
            rel = abs(tres["per_temp"][tc_][key] - val) / abs(val)
            worst = max(worst, rel)
            assert rel <= 1e-5, (tc_, key, rel)
    print(f"fig_region --fast parity: ratios {tres['compression_ratio']}, "
          f"read {tres['reductions']['read']}, max rel gmean diff {worst:.3e}")

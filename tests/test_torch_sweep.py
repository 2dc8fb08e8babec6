"""Parity of the port's profiling front end (MarginEngine sweeps and the
Profiler) with the JAX reference, on the CPU, on the same population.

Margins agree within 2e-4, so a pass/fail boolean may flip only where
the deciding (bank-minimum) margin lies within 2e-4 of zero.  Every
flip is counted and must be explained that way; outside the modules
that contain one, the chosen combos must be identical."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import sweep as jsweep
from repro.core import timing as JT
from repro.core.profiler import Profiler as JProfiler
from repro_torch import convert
from repro_torch.core import sweep as tsweep
from repro_torch.core import timing as TT
from repro_torch.core.profiler import Profiler as TProfiler
from _torch_parity import one_thread as _one_thread  # noqa: F401


TOL = 2e-4
TEMPS = (55.0, 85.0)
OPS = ["read", "write"]


@pytest.fixture(scope="module")
def campaign(small_pop):
    jp = JProfiler(constants=jcal.CALIBRATED_CONSTANTS, grid_step=2.5)
    jr = jp.refresh_campaign(small_pop, 85.0)
    jres = jp.engine.sweep(small_pop, jp.campaign_spec(TEMPS, *jr))

    tp = TProfiler(convert.charge_constants(
        dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)), grid_step=2.5,
        device="cpu")
    pop = convert.population(np.array(small_pop.cells), device="cpu")
    tr = tp.refresh_campaign(pop, 85.0)
    d0 = tp.engine.dispatch_count
    tres = tp.engine.sweep(pop, tp.campaign_spec(TEMPS, *tr))
    return dict(jp=jp, tp=tp, pop=pop, jr=jr, tr=tr, jres=jres, tres=tres,
                sweep_dispatches=tp.engine.dispatch_count - d0,
                cells=small_pop.cells.shape)


def _bank_min_margin(jres, k, shape):
    m, ch, bk, kc = shape[:4]
    m3 = np.asarray(jres.margins[k])
    return m3.reshape(m, ch, bk, kc, *m3.shape[1:]).min(axis=(1, 3))


def _flips(c, op):
    k = c["jres"].index(op)
    okj, okt = c["jres"].ok_bank[k], c["tres"].ok_bank[k]
    flip = okj != okt
    mmin = _bank_min_margin(c["jres"], k, c["cells"])
    return flip, mmin


@pytest.mark.parametrize("op", OPS)
def test_refresh_envelopes_equal(campaign, op):
    i = OPS.index(op)
    single = campaign["tp"].refresh_profile(campaign["pop"], 85.0, op)
    for field in ("per_module", "per_chip", "per_bank", "safe"):
        np.testing.assert_array_equal(getattr(campaign["tr"][i], field),
                                      getattr(campaign["jr"][i], field))
        np.testing.assert_array_equal(getattr(single, field),
                                      getattr(campaign["jr"][i], field))


@pytest.mark.parametrize("op", OPS)
def test_pass_envelopes_agree_up_to_explained_flips(campaign, op):
    flip, mmin = _flips(campaign, op)
    n = int(flip.sum())
    print(f"{op}: {n} pass/fail flips of {flip.size} bank envelopes")
    assert (np.abs(mmin[flip]) <= TOL).all(), mmin[flip]
    k = campaign["tres"].index(op)
    np.testing.assert_array_equal(campaign["tres"].ok[k],
                                  campaign["tres"].ok_bank[k].all(1))


@pytest.mark.parametrize("op", OPS)
def test_chosen_combos_equal_outside_flips(campaign, op):
    flip, _ = _flips(campaign, op)
    clean = ~flip.reshape(flip.shape[0], -1).any(1)       # per module
    k = campaign["jres"].index(op)
    j, t = campaign["jres"], campaign["tres"]
    for name in ("chosen", "latency_sum", "chosen_bank",
                 "latency_sum_bank"):
        np.testing.assert_array_equal(getattr(t, name)[k][clean],
                                      getattr(j, name)[k][clean])


@pytest.mark.parametrize("op", OPS)
def test_margins_within_tolerance(campaign, op):
    k = campaign["jres"].index(op)
    got = campaign["tres"].margins[k]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(
        campaign["jres"].margins[k]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op", OPS)
def test_reductions_equal(campaign, op):
    # this population has no flips (see the flip test), so every
    # module's choice and hence every statistic is identical
    assert campaign["tres"].reductions(op) == campaign["jres"].reductions(op)


def test_campaign_is_one_dispatch(campaign):
    assert campaign["sweep_dispatches"] == 1
    tp, pop = campaign["tp"], campaign["pop"]
    d0 = tp.engine.dispatch_count
    tp.refresh_campaign(pop, 85.0)
    assert tp.engine.dispatch_count - d0 == 1


def test_campaign_columns_layout(campaign):
    tp, pop = campaign["tp"], campaign["pop"]
    spec = tp.campaign_spec(TEMPS, *campaign["tr"])
    combos, temps, trefi_mod, trefi_cells = tp.engine.campaign_columns(
        pop, spec)
    nr, nw = (tp.combo_grid(op).shape[0] for op in OPS)
    assert combos.shape == (2 * (nr + nw), 5)
    np.testing.assert_array_equal(temps[:nr], np.full(nr, 55.0, np.float32))
    np.testing.assert_array_equal(combos[:nr], tp.combo_grid("read"))
    cpm = int(np.prod(pop.cells.shape[1:4]))
    assert trefi_cells[tsweep.Op.READ].shape == (pop.n_modules * cpm,)
    np.testing.assert_array_equal(trefi_mod[tsweep.Op.WRITE],
                                  campaign["tr"][1].safe)


@pytest.mark.parametrize("op", OPS)
def test_timing_profile_shim(campaign, op):
    tp, pop = campaign["tp"], campaign["pop"]
    i = OPS.index(op)
    prof = tp.timing_profile(pop, 55.0, op, campaign["tr"][i].safe)
    jprof = campaign["jp"].timing_profile(
        # the reference's own shim on the same cells
        _jax_pop(pop), 55.0, op, campaign["jr"][i].safe)
    np.testing.assert_array_equal(prof.combos, jprof.combos)
    np.testing.assert_array_equal(prof.pass_per_module,
                                  jprof.pass_per_module)
    assert tp.reductions(prof, op) == campaign["jp"].reductions(jprof, op)


def _jax_pop(pop):
    import jax.numpy as jnp
    from repro.core.variation import Population
    return Population(cells=jnp.asarray(pop.cells.numpy()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_combos_matches_reference(seed):
    rng = np.random.default_rng(seed)
    combos = JT.read_combo_grid(step=2.5)
    ok = rng.uniform(size=(4, 3, combos.shape[0])) < 0.3
    ok[0, 0] = False                      # nothing passes: slowest combo
    trefi = rng.uniform(60, 300, 4).astype(np.float32)
    for op in OPS:
        cj, sj = jsweep.select_combos(combos, ok, op, trefi)
        ct, st = tsweep.select_combos(combos, ok, op, trefi)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(st, sj)
    p = combos[:7, :4]
    assert tsweep.param_reductions(p, TT.DDR3_1600, allsafe=True) == \
        jsweep.param_reductions(p, JT.DDR3_1600, allsafe=True)


def test_spec_validation(campaign):
    tp = campaign["tp"]
    g = tp.combo_grid("read")
    spec = tsweep.SweepSpec(tests=(tsweep.OpSweep("read", g, 100.0),
                                   tsweep.OpSweep("read", g, 120.0)),
                            temps=(55.0,))
    with pytest.raises(ValueError, match="share trefi_ms"):
        spec.op_trefi(tsweep.Op.READ, 3)
    with pytest.raises(ValueError, match="empty"):
        tsweep.SweepSpec(tests=(), temps=(55.0,))
    # regions must split the tail cells into equal contiguous groups
    with pytest.raises(ValueError, match="divide"):
        tp.engine.sweep(campaign["pop"], tsweep.SweepSpec.single(
            "read", g, 55.0), regions=4)

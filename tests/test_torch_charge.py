"""Parity of the port's timing grids, charge physics, margin grid and
population sampler with the JAX reference, on the CPU.

Margins are compared at rtol = atol = 2e-4, the bound the reference
holds its own Pallas kernel to against its oracle: the two frameworks'
float32 `exp`/`log` differ in the last bits, and the 8-step fixed point
carries that through."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import charge as jcharge
from repro.core import timing as JT
from repro.core import variation as jvar
from repro.kernels.charge_sim import ops as jops
from repro_torch import convert
from repro_torch.core import calibration as tcal
from repro_torch.core import charge as tcharge
from repro_torch.core import timing as TT
from repro_torch.core import variation as tvar
from repro_torch.kernels.charge_sim import ops as tops
from _torch_parity import one_thread as _one_thread  # noqa: F401


TOL = dict(rtol=2e-4, atol=2e-4)
C_J = jcal.CALIBRATED_CONSTANTS
C_T = convert.charge_constants(dataclasses.asdict(C_J))


@pytest.fixture(scope="module")
def grid_inputs(small_pop):
    """300 cells (ragged against the kernel's 8-row tiles) x 70 combos
    from both tests' grids, per-combo temperatures and per-cell read /
    write tREFI overrides, all drawn from one seed."""
    rng = np.random.default_rng(11)
    cells = np.asarray(small_pop.flat_cells())[:300]
    combos = np.concatenate([JT.read_combo_grid(step=2.5),
                             JT.write_combo_grid(step=2.5)])
    combos = combos[rng.choice(combos.shape[0], 70, replace=False)]
    temps = rng.choice([45.0, 55.0, 65.0, 75.0, 85.0],
                       size=70).astype(np.float32)
    tr = rng.uniform(40.0, 320.0, 300).astype(np.float32)
    tw = rng.uniform(40.0, 320.0, 300).astype(np.float32)
    return cells, combos, temps, tr, tw


def _jax_margins(impl, cells, combos, temps, tr, tw):
    r, w = jops.margin_sweep(
        jnp.asarray(cells), jnp.asarray(combos), jnp.asarray(temps), C_J,
        impl=impl,
        trefi_read_cells=None if tr is None else jnp.asarray(tr),
        trefi_write_cells=None if tw is None else jnp.asarray(tw))
    return np.asarray(r), np.asarray(w)


def _port_margins(path, cells, combos, temps, tr, tw):
    args = [torch.tensor(x) if x is not None else None
            for x in (cells, combos, temps, tr, tw)]
    fn = tops.margin_sweep if path == "ops" else tcharge.margin_sweep
    r, w = fn(args[0], args[1], args[2], C_T, args[3], args[4])
    return r.numpy(), w.numpy()


class TestTiming:
    @pytest.mark.parametrize("step", [1.25, 2.5])
    def test_combo_grids_equal(self, step):
        np.testing.assert_array_equal(TT.read_combo_grid(step=step),
                                      JT.read_combo_grid(step=step))
        np.testing.assert_array_equal(TT.write_combo_grid(step=step),
                                      JT.write_combo_grid(step=step))

    def test_full_campaign_width(self):
        # 810 read + 891 write combos at the 1.25 ns grid; x 5 bins
        n = (TT.read_combo_grid().shape[0], TT.write_combo_grid().shape[0])
        assert n == (810, 891) and 5 * sum(n) == 8505

    def test_rows_and_refresh_grid_equal(self):
        np.testing.assert_array_equal(TT.refresh_grid(), JT.refresh_grid())
        for p in ("DDR3_1600", "ALDRAM_55C_EVAL"):
            np.testing.assert_array_equal(getattr(TT, p).as_row(),
                                          getattr(JT, p).as_row())
        rows = TT.stack_timing([TT.DDR3_1600, TT.ALDRAM_55C_EVAL])
        np.testing.assert_array_equal(
            TT.TimingParams.from_row(rows[1]).as_row(), rows[1])
        np.testing.assert_array_equal(TT.DDR3_1600.as_array().numpy(),
                                      np.asarray(JT.DDR3_1600.as_array()))


class TestMargins:
    @pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
    @pytest.mark.parametrize("path", ["core", "ops"])
    def test_margin_sweep_matches_reference(self, grid_inputs, impl, path):
        rj, wj = _jax_margins(impl, *grid_inputs)
        rt, wt = _port_margins(path, *grid_inputs)
        np.testing.assert_allclose(rt, rj, **TOL)
        np.testing.assert_allclose(wt, wj, **TOL)

    def test_without_overrides(self, grid_inputs):
        cells, combos, temps, _, _ = grid_inputs
        rj, wj = _jax_margins("ref", cells, combos, temps, None, None)
        rt, wt = _port_margins("ops", cells, combos, temps, None, None)
        np.testing.assert_allclose(rt, rj, **TOL)
        np.testing.assert_allclose(wt, wj, **TOL)

    @pytest.mark.parametrize("temp", [55.0, 85.0])
    def test_combo_margins_single_temperature(self, grid_inputs, temp):
        cells, combos, _, tr, _ = grid_inputs
        rj, wj = jops.combo_margins(jnp.asarray(cells), jnp.asarray(combos),
                                    temp, C_J, impl="ref",
                                    trefi_cells=jnp.asarray(tr))
        rt, wt = tops.combo_margins(torch.tensor(cells),
                                    torch.tensor(combos), temp, C_T,
                                    torch.tensor(tr))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)

    @pytest.mark.parametrize("op", ["read", "write"])
    def test_refresh_margin(self, grid_inputs, op):
        cells = grid_inputs[0][:64]
        grid = JT.refresh_grid()
        mj = jcharge.refresh_margin(jnp.asarray(cells), jnp.asarray(grid),
                                    JT.DDR3_1600.as_array(), 85.0, op, C_J)
        mt = tcharge.refresh_margin(torch.tensor(cells),
                                    torch.tensor(grid),
                                    TT.DDR3_1600.as_array(), 85.0, op, C_T)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **TOL)

    def test_kernel_layout_plain_equals_sweep(self, grid_inputs):
        """The [7, n] / [6, m] kernel contract (with its -1 override
        sentinel) computes the same grid as the cell-major sweep."""
        cells, combos, temps, tr, tw = (torch.tensor(x)
                                        for x in grid_inputs)
        ct, mt = tops.pack_inputs(cells, combos, temps, tr, None)
        assert ct.shape == (7, 300) and mt.shape == (6, 70)
        assert bool((ct[6] == -1.0).all())
        r1, w1 = tops.margin_grid(ct, mt, C_T)
        r2, w2 = tcharge.margin_sweep(cells, combos, temps, C_T, tr, None)
        torch.testing.assert_close(r1, r2, rtol=0, atol=0)
        torch.testing.assert_close(w1, w2, rtol=0, atol=0)

    def test_flops_helper_matches_reference(self):
        assert tops.margin_grid_flops(176_640, 8_505) == \
            jops.margin_grid_flops(176_640, 8_505)


class TestPopulation:
    def test_calibrated_constants_equal(self):
        assert dataclasses.asdict(tcal.CALIBRATED_CONSTANTS) == \
            dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)
        assert dataclasses.asdict(tcal.CALIBRATED_VARIATION) == \
            dataclasses.asdict(jcal.CALIBRATED_VARIATION)
        assert C_T == tcal.CALIBRATED_CONSTANTS

    def test_sampler_matches_reference_distribution(self):
        """Same hierarchical lognormal as the reference, not the same
        bits: per field, the log-medians agree within 0.2 and the
        log-sigmas within 10% of the reference's log-sigma, over 32,768
        cells (128 modules carry the module-level spread)."""
        cfg_j = dataclasses.replace(jcal.CALIBRATED_VARIATION,
                                    n_modules=128, n_cells=4)
        cfg_t = dataclasses.replace(tcal.CALIBRATED_VARIATION,
                                    n_modules=128, n_cells=4)
        a = np.log(np.asarray(jvar.sample_population(
            jax.random.PRNGKey(3), cfg_j).cells)).reshape(-1, 5)
        pop = tvar.sample_population(torch.Generator().manual_seed(3),
                                     cfg_t, device="cpu")
        assert pop.cells.shape == (128, 8, 8, 4, 5)
        assert pop.cells.dtype == torch.float32
        b = np.log(pop.cells.numpy()).reshape(-1, 5)
        sd = a.std(0)
        assert (np.abs(np.median(a, 0) - np.median(b, 0)) <= 0.2 * sd).all()
        assert (np.abs(b.std(0) / sd - 1.0) <= 0.1).all()

    def test_sampler_is_seeded_and_device_independent(self):
        cfg = dataclasses.replace(tcal.CALIBRATED_VARIATION, n_modules=3,
                                  n_cells=2)
        p1 = tvar.sample_population(torch.Generator().manual_seed(5), cfg,
                                    device="cpu")
        p2 = tvar.sample_population(torch.Generator().manual_seed(5), cfg,
                                    device="cpu")
        assert torch.equal(p1.cells, p2.cells)
        assert p1.flat_cells().shape == (3 * 8 * 8 * 2, 5)

    def test_k_region_population_matches_reference_gradient(self):
        """k_region != 0 multiplies the draw by the reference's
        row-position gradient (`charge.region_gradient`)."""
        cfg = dataclasses.replace(tcal.CALIBRATED_VARIATION, n_modules=2,
                                  n_cells=6, k_region=0.25)
        pg = tvar.sample_population(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        p0 = tvar.sample_population(torch.Generator().manual_seed(0),
                                    dataclasses.replace(cfg, k_region=0.0),
                                    device="cpu")
        grad = np.asarray(jcharge.region_gradient(
            jcharge.row_positions(6), 0.25, jvar.FIELD_WEAK_SIGNS))
        np.testing.assert_allclose(pg.cells.numpy(), p0.cells.numpy() * grad,
                                   rtol=1e-6)

    def test_convert_population_roundtrip(self, small_pop):
        pop = convert.population(np.asarray(small_pop.cells), device="cpu")
        np.testing.assert_array_equal(pop.cells.numpy(),
                                      np.asarray(small_pop.cells))
        assert (pop.n_modules, pop.n_banks, pop.n_cells) == \
            (small_pop.n_modules, small_pop.n_banks, small_pop.n_cells)
        with pytest.raises(ValueError):
            convert.population(np.zeros((2, 3, 5)), device="cpu")

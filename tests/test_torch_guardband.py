"""Parity of the port's guardband layer (`repro_torch.core.guardband`)
and the variation tail it stands on (`variation.compound_quantile`,
`weakness_score`, `worst_case_reference`, `Population.with_cells`,
`timing.combos_with_trefi`) with the JAX reference, on the CPU: the
tests of tests/test_guardband.py, each also held to the reference on
the same inputs.

Tolerances: `reference_margin` is the margin grid at one cell and one
combo, held to the grid's 2e-4 (the reference's bound for its own
kernel); `design_quantile` bisects it 24 times from [0, 8], held to one
bisection step (8 / 2**24) of the reference's.  The guardband moves are
float32 adds, mins and maxes, held bitwise; the z-scores are float64
numpy on equal cells, held to 1e-12 relative."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import guardband as JG
from repro.core import timing as JT
from repro.core import variation as JV
from repro.core.calibration import CALIBRATED_CONSTANTS as J_CONST
from repro.core.calibration import CALIBRATED_VARIATION as J_VAR
from repro_torch import convert
from repro_torch.core import guardband as TG
from repro_torch.core import timing as TT
from repro_torch.core import variation as TV
from repro_torch.core.calibration import CALIBRATED_CONSTANTS as T_CONST
from repro_torch.core.calibration import CALIBRATED_VARIATION as T_VAR
from _torch_parity import one_thread as _one_thread  # noqa: F401


STEP = 8.0 / 2 ** 24


def _port_constants(**kw):
    return convert.charge_constants(
        dataclasses.asdict(dataclasses.replace(J_CONST, **kw)))


def _population(n_modules=8, n_cells=8):
    cfg = dataclasses.replace(J_VAR, n_modules=n_modules, n_cells=n_cells)
    pop = JV.sample_population(jax.random.PRNGKey(0), cfg)
    return pop, cfg, convert.population(np.asarray(pop.cells), device="cpu")


def test_calibrated_constants_are_the_references():
    assert dataclasses.asdict(T_CONST) == pytest.approx(
        dataclasses.asdict(J_CONST))
    assert dataclasses.asdict(T_VAR) == pytest.approx(
        dataclasses.asdict(J_VAR))


class TestSafeRefresh:
    def test_one_step_guardband(self):
        mp = np.array([208.0, 160.0, 64.0])
        np.testing.assert_array_equal(TG.safe_refresh(mp),
                                      JG.safe_refresh(mp))
        np.testing.assert_allclose(TG.safe_refresh(mp),
                                   mp - TT.REFRESH_STEP_MS)

    def test_floor_at_one_step(self):
        mp = np.array([TT.REFRESH_STEP_MS, TT.REFRESH_STEP_MS / 2, 0.0])
        out = TG.safe_refresh(mp)
        assert (out >= TT.REFRESH_STEP_MS).all()
        np.testing.assert_array_equal(out, JG.safe_refresh(mp))


class TestDesignPoint:
    @pytest.mark.parametrize("q", [0.0, 2.5, 4.0, 8.0])
    def test_reference_margin_matches(self, q):
        """One margin-grid evaluation (1 cell x 1 combo): within 2e-4 of
        the reference's, and the worst-case cell equal to 1e-6."""
        np.testing.assert_allclose(
            TV.worst_case_reference(quantile=q).numpy(),
            np.asarray(JV.worst_case_reference(quantile=q)), rtol=1e-6)
        got = TG.reference_margin(T_CONST, quantile=q, device="cpu")
        want = JG.reference_margin(J_CONST, quantile=q)
        assert abs(got - want) <= 2e-4, (got, want)

    def test_reference_margin_sign_at_design_point(self):
        q = TG.design_quantile(T_CONST, device="cpu")
        assert abs(q - JG.design_quantile(J_CONST)) <= STEP
        assert TG.reference_margin(T_CONST, quantile=q - 1e-3,
                                   device="cpu") >= 0.0
        assert TG.reference_margin(T_CONST, quantile=q + 1e-3,
                                   device="cpu") < 0.0
        assert TG.reference_margin(T_CONST, quantile=0.0, device="cpu") > 0

    def test_design_quantile_makes_26_launches_of_one_cell(self, monkeypatch):
        """Two bracket ends and 24 bisection steps, each one
        `MarginEngine.margins` call of 1 cell x 1 combo."""
        from repro_torch.kernels.charge_sim import ops
        shapes = []
        orig = ops.margin_sweep

        def spy(cells, combos, *a, **kw):
            shapes.append((tuple(cells.shape), tuple(combos.shape)))
            return orig(cells, combos, *a, **kw)

        monkeypatch.setattr(ops, "margin_sweep", spy)
        TG.design_quantile(T_CONST, device="cpu")
        assert shapes == [((1, 5), (1, 5))] * 26

    def test_design_quantile_exceeds_realised_population(self):
        """The design point exceeds the sampled population's realised
        compound quantile, and the realised quantile is the
        reference's on the same cells."""
        pop, cfg, tpop = _population()
        q = TG.design_quantile(T_CONST, device="cpu")
        realised = TV.compound_quantile(
            tpop.cells, convert_variation(cfg)).max()
        want = np.asarray(JV.compound_quantile(pop.cells, cfg)).max()
        assert realised == pytest.approx(want, rel=1e-12)
        assert q > realised, (q, realised)

    def test_bracket_assertion_lo(self):
        bad = _port_constants(dv_min=10.0)
        with pytest.raises(ValueError, match="bracket broken"):
            TG.design_quantile(bad, device="cpu")
        with pytest.raises(ValueError, match="bracket broken"):
            JG.design_quantile(dataclasses.replace(J_CONST, dv_min=10.0))

    def test_bracket_assertion_hi(self):
        with pytest.raises(ValueError, match="raise `hi`"):
            TG.design_quantile(T_CONST, hi=1e-6, device="cpu")

    def test_default_device_is_cuda(self):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                TG.reference_margin(T_CONST)


def convert_variation(cfg):
    return TV.VariationConfig(**dataclasses.asdict(cfg))


class TestOnlineMoves:
    def rows(self):
        r = JT.DDR3_1600.as_row()[None, None, :].repeat(2, 0).repeat(3, 1)
        r = r.copy()
        r[..., :4] -= 4 * JT.TIMING_STEP_NS
        r[..., 4] += 4 * JT.REFRESH_STEP_MS
        return r.astype(np.float32)

    def _both(self, fn, *args, **kw):
        got = getattr(TG, fn)(*args, **kw)
        want = getattr(JG, fn)(*args, **kw)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b)
        return got

    def test_tighten_moves_toward_jedec_both_knobs(self):
        rows = self.rows()
        out, at_jedec = self._both("tighten_rows", rows)
        np.testing.assert_allclose(out[..., :4],
                                   rows[..., :4] + TT.TIMING_STEP_NS)
        np.testing.assert_allclose(out[..., 4],
                                   rows[..., 4] - TT.REFRESH_STEP_MS)
        assert not at_jedec.any()

    def test_tighten_respects_mask(self):
        rows = self.rows()
        mask = np.zeros(rows.shape[:-1], bool)
        mask[0, 1] = True
        out, _ = self._both("tighten_rows", rows, mask=mask)
        np.testing.assert_array_equal(out[~mask], rows[~mask])
        assert (out[0, 1, :4] > rows[0, 1, :4]).all()

    def test_tighten_clamps_and_flags_at_jedec(self):
        std = np.broadcast_to(TT.DDR3_1600.as_row(),
                              (2, 6)).astype(np.float32)
        out, at_jedec = self._both("tighten_rows", std)
        np.testing.assert_array_equal(out, std)
        assert at_jedec.all()

    def test_relax_steps_back_and_clamps_at_floor(self):
        floor = self.rows()
        tight, _ = TG.tighten_rows(floor)
        relaxed = self._both("relax_rows", tight, floor)
        np.testing.assert_array_equal(relaxed, floor)
        again = self._both("relax_rows", relaxed, floor)
        np.testing.assert_array_equal(again, floor)

    def test_tighten_then_relax_roundtrip_is_identity(self):
        floor = self.rows()
        rows = floor
        for _ in range(3):
            rows, _ = TG.tighten_rows(rows)
        for _ in range(5):          # extra relax steps clamp at the floor
            rows = TG.relax_rows(rows, floor)
        np.testing.assert_array_equal(rows, floor)


class TestVariationTail:
    def test_field_stats_and_scores_match_the_reference(self):
        pop, cfg, tpop = _population(n_modules=4, n_cells=6)
        tcfg = convert_variation(cfg)
        np.testing.assert_array_equal(TV.field_medians(tcfg),
                                      JV.field_medians(cfg))
        np.testing.assert_array_equal(TV.field_sigmas(tcfg),
                                      JV.field_sigmas(cfg))
        np.testing.assert_allclose(
            TV.compound_quantile(tpop.cells, tcfg),
            np.asarray(JV.compound_quantile(pop.cells, cfg)), rtol=1e-12)
        w = TV.weakness_score(tpop.cells, tcfg)
        assert w.dtype == np.float32 and (w >= 0).all()
        np.testing.assert_array_equal(
            w, np.asarray(JV.weakness_score(pop.cells, cfg)))

    def test_population_with_cells_module_and_params(self):
        pop, _, tpop = _population(n_modules=3, n_cells=4)
        aged = tpop.cells * 1.01
        new = tpop.with_cells(aged.double())
        assert new.cells.dtype == torch.float32 and torch.equal(new.cells,
                                                                aged)
        with pytest.raises(ValueError, match="shape"):
            tpop.with_cells(tpop.cells[:1])
        np.testing.assert_array_equal(tpop.module(1).numpy(),
                                      np.asarray(pop.module(1)))
        p = tpop.params()
        np.testing.assert_array_equal(p.xfer.numpy(),
                                      np.asarray(pop.params().xfer))

    def test_combos_with_trefi(self):
        combos = TT.read_combo_grid()[:7]
        trefi = np.array([64.0, 128.0, 200.0], np.float32)
        got = TT.combos_with_trefi(combos, trefi)
        assert got.shape == (3, 7, 5)
        np.testing.assert_array_equal(got, JT.combos_with_trefi(combos,
                                                                trefi))
        assert (got[1, :, 4] == 128.0).all()
        np.testing.assert_array_equal(got[..., :4],
                                      np.broadcast_to(combos[:, :4],
                                                      (3, 7, 4)))

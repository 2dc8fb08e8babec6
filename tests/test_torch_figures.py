"""The port's figure drivers against the reference's, on the CPU:
`benchmarks/port_fig2_refresh.py`, `port_fig2_timing.py`,
`port_multi_timing.py`, `port_repeatability.py` and `port_power_bench.py`
on the population (and trace) of the reference drivers' `--fast` runs,
handed across through `repro_torch.convert`; each reference driver runs
in the same test.

Chosen combos, safe refresh intervals and frontier points are equal: a
pass/fail flip is allowed only where the deciding margin lies within
2e-4 of zero, and each is counted and printed (`-s`); without flips the
result dicts and CSV lines are equal, and with flips the test records
itself as xfailed (equality not compared).  Device means within ceil(log2 N)
float32 half-ulps; power exactly."""

import jax
import numpy as np
import pytest

from _torch_parity import (assert_device_means, campaign_flips,
                           equality_needs_no_flips, flips,
                           profilers)
from benchmarks import common as jcommon
from benchmarks import fig2_refresh as jfig2r
from benchmarks import fig2_timing as jfig2t
from benchmarks import multi_timing as jmulti
from benchmarks import port_fig2_refresh as tfig2r
from benchmarks import port_fig2_timing as tfig2t
from benchmarks import port_multi_timing as tmulti
from benchmarks import port_power_bench as tpower
from benchmarks import port_repeatability as trep
from benchmarks import power_bench as jpower
from benchmarks import repeatability as jrep
from repro_torch import convert
from _torch_parity import one_thread as _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def pops():
    jpop = jcommon.population(True)
    return jpop, convert.population(np.asarray(jpop.cells), device="cpu")


def _csv(out: str, name: str) -> list[str]:
    """The derived column of every `name,us,derived` line."""
    return [ln.split(",", 2)[2] for ln in out.splitlines()
            if ln.startswith(name + ",")]


def test_port_fig2_refresh_equals_reference(pops, capsys):
    jpop, pop = pops
    jout = jfig2r.run(fast=True)
    tout = tfig2r.run(True, pop=pop, device="cpu")
    n_flips = campaign_flips(jpop, pop)
    out = capsys.readouterr().out
    print(f"fig2_refresh --fast: {n_flips} pass/fail flips")
    lines = _csv(out, "fig2a_refresh_envelope")
    assert len(lines) == 2
    equality_needs_no_flips(n_flips, "fig2_refresh --fast")
    assert tout == jout
    assert lines[0] == lines[1]


def test_port_fig2_timing_equals_reference(pops, capsys):
    jpop, pop = pops
    jout = jfig2t.run(fast=True)
    tout = tfig2t.run(True, pop=pop, device="cpu")
    n_flips = campaign_flips(jpop, pop, jfig2t.TEMPS)
    out = capsys.readouterr().out
    print(f"fig2_timing --fast: {n_flips} pass/fail flips")
    lines = _csv(out, "fig2bc_timing_combos")
    assert len(lines) == 2
    equality_needs_no_flips(n_flips, "fig2_timing --fast")
    assert tout == jout
    assert lines[0] == lines[1]


def test_port_multi_timing_equals_reference(pops, capsys):
    from repro.core import dram_sim as jdram
    jpop, pop = pops
    jout = jmulti.run(fast=True)
    jtrace = jdram.synth_trace(jax.random.PRNGKey(0), 2048, row_hit=0.5)
    trace = convert.trace(*(np.asarray(f) for f in jtrace), device="cpu")
    tout = tmulti.run(True, pop=pop, trace=trace, device="cpu")

    def read55(prof, p, rr, rw, sw):
        return prof.engine.sweep(p, sw.SweepSpec.single(
            sw.Op.READ, prof.combo_grid(sw.Op.READ), (55.0,), rr.safe))

    n_flips = campaign_flips(jpop, pop, sweep=read55)
    out = capsys.readouterr().out
    print(f"multi_timing --fast: {n_flips} pass/fail flips")
    assert tout["dispatches"] == {"replay": 1}
    assert tout["monotone"] == jout["monotone"]
    lines = _csv(out, "sec72_multi_timing_interaction")
    assert len(lines) == 2 and all("|replay_dispatches=1" in ln
                                   for ln in lines)
    equality_needs_no_flips(n_flips, "multi_timing --fast")
    assert tout["frontier"] == jout["frontier"]
    assert list(tout["system_latency_ns"]) == list(
        jout["system_latency_ns"])
    assert_device_means(list(tout["system_latency_ns"].values()),
                        list(jout["system_latency_ns"].values()), 2048)


def test_port_repeatability_equals_reference(pops, capsys):
    from repro.core.calibration import CALIBRATED_CONSTANTS
    from repro.core.sweep import MarginEngine as JMarginEngine
    jpop, pop = pops
    jout = jrep.run(fast=True)
    tout = trep.run(True, pop=pop, device="cpu")
    # the reference's noisy margins, drawn as its driver draws them
    r, w = JMarginEngine(constants=CALIBRATED_CONSTANTS, impl="ref").margins(
        jpop.flat_cells(), trep.stress_combo(), temp_c=55.0)
    margin = np.minimum(r, w)[:, 0]
    rng = np.random.default_rng(0)
    noisy = np.stack([margin + rng.normal(0, trep.MARGIN_NOISE,
                                          margin.shape) for _ in range(10)])
    n_flips = flips(noisy, tout["noisy"])
    # the margins themselves: within the margin kernel's tolerance
    # against its plain version (rtol = atol = 2e-4)
    np.testing.assert_allclose(tout["margin"], margin, rtol=2e-4, atol=2e-4)
    capsys.readouterr()
    print(f"repeatability --fast: {n_flips} noisy pass/fail flips "
          f"(failing {tout['failing_cells']} vs {jout['failing_cells']})")
    assert tout["dispatches"] == {"margin": 1}
    equality_needs_no_flips(n_flips, "repeatability --fast")
    assert tout["failing_cells"] == jout["failing_cells"]
    assert tout["repeatable_fraction"] == jout["repeatable_fraction"]


def test_port_power_bench_equals_reference(capsys):
    jout = jpower.run(fast=True)
    tout = tpower.run(True, device="cpu")
    assert tout == jout
    lines = _csv(capsys.readouterr().out, "sec7_power")
    assert len(lines) == 2 and lines[0] == lines[1]


def test_profilers_share_the_grid():
    jprof, tprof = profilers(2.5)
    from repro.core.sweep import Op as JOp
    from repro_torch.core.sweep import Op
    for jop, op in ((JOp.READ, Op.READ), (JOp.WRITE, Op.WRITE)):
        np.testing.assert_array_equal(tprof.combo_grid(op),
                                      np.asarray(jprof.combo_grid(jop)))


@pytest.mark.parametrize("mod", [tfig2r, tfig2t, tmulti, trep, tpower])
def test_port_figure_drivers_import_no_jax(mod):
    src = open(mod.__file__).read()
    assert "import jax" not in src and "from repro." not in src \
        and "from repro " not in src

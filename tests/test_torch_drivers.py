"""The port's main-path drivers against the reference's, on the CPU:
`benchmarks/port_fig3_population.py` and `port_fig4_system.py` (`run`,
`run_profiled`) on the population and traces of the reference drivers'
`--fast` runs, handed across through `repro_torch.convert`.

fig3: the chosen combos are equal in every module without a pass/fail
flip; a flip is allowed only where the deciding (bank-minimum) margin
lies within 2e-4 of zero (the margin kernel's tolerance), each is
counted, and without flips the headline numbers are equal.  fig4: the
speedups agree within 1e-5 (the latencies are bitwise equal; only the
order of the mean's summation differs)."""

import numpy as np
import pytest

from benchmarks import common as jcommon
from benchmarks import fig3_population as jfig3
from benchmarks import fig4_system as jfig4
from benchmarks import port_fig3_population as tfig3
from benchmarks import port_fig4_system as tfig4
from repro.core import perf_model as jpm
from repro.core.sweep import Op as JOp
from repro_torch import convert
from _torch_parity import one_thread as _one_thread  # noqa: F401


TOL = 2e-4


def _pop():
    return convert.population(np.array(jcommon.population(True).cells),
                              device="cpu")


def _traces(n):
    tb = jpm.trace_batch(n=n, seed=0)
    return convert.trace(*(np.asarray(f) for f in tb), device="cpu")


def test_port_fig3_population_equals_reference_up_to_flips(capsys):
    jout = jfig3.run(fast=True)
    jpop, jprof = jcommon.population(True), jcommon.profiler(True)
    jres = jprof.engine.sweep(jpop, jprof.campaign_spec(
        jfig3.TEMPS, *jprof.refresh_campaign(jpop, 85.0)))
    tout = tfig3.run(fast=True, pop=_pop(), device="cpu")
    head = capsys.readouterr().out.splitlines()
    tres = tout.pop("result")
    m, ch, bk, kc = np.array(jpop.cells).shape[:4]
    n_flips = 0
    for op in (JOp.READ, JOp.WRITE):
        k = jres.index(op)
        flip = np.asarray(jres.ok_bank[k]) != np.asarray(tres.ok_bank[k])
        mm = np.asarray(jres.margins[k])
        mmin = mm.reshape(m, ch, bk, kc, *mm.shape[1:]).min(axis=(1, 3))
        assert (np.abs(mmin[flip]) <= TOL).all(), mmin[flip]
        n_flips += int(flip.sum())
        clean = ~flip.reshape(flip.shape[0], -1).any(1)
        np.testing.assert_array_equal(np.asarray(tres.chosen[k])[clean],
                                      np.asarray(jres.chosen[k])[clean])
    print(f"fig3 --fast: {n_flips} pass/fail flips")
    if n_flips == 0:
        assert tout == jout
    # the same two headline lines, timing column aside
    lines = [ln for ln in head if ln.startswith(("fig3_population,",
                                                 "sec52_param"))]
    assert len(lines) == 4
    for a, b in zip(lines[:2], lines[2:]):
        assert a.split(",")[0] == b.split(",")[0]
        if n_flips == 0:
            assert a.split(",", 2)[2] == b.split(",", 2)[2]


def test_port_fig4_system_speedups_equal_reference():
    jres = jfig4.run(fast=True)
    tres = tfig4.run(fast=True, traces=_traces(2048), device="cpu")
    assert tres["dispatches"] == {"replay": 1}
    js, ts = jres["summary"], tres["summary"]
    for k in ("multi_intensive_gmean", "multi_nonintensive_gmean",
              "multi_all_gmean", "single_intensive_gmean"):
        assert abs(ts[k] - js[k]) <= 1e-5, (k, ts[k], js[k])
    assert ts["best_multi"][0] == js["best_multi"][0]
    for tag in ("single", "multi"):
        for name, v in jres[tag].items():
            assert abs(tres[tag][name] - v) <= 1e-5, (tag, name)


def test_port_fig4_profiled_speedups_equal_reference():
    jres = jfig4.run_profiled(fast=True)
    tres = tfig4.run_profiled(fast=True, pop=_pop(), traces=_traces(1024),
                              device="cpu")
    np.testing.assert_array_equal(tres["rows"], np.asarray(jres["rows"]))
    np.testing.assert_allclose(tres["speedups"], np.asarray(jres["speedups"]),
                               rtol=1e-5, atol=1e-5)
    assert tres["temps"] == tuple(jres["temps"])
    for tc in jres["temps"]:
        for key, val in jres["per_temp"][tc].items():
            assert abs(tres["per_temp"][tc][key] - val) <= 1e-5, (tc, key)


@pytest.mark.parametrize("mod", [tfig3, tfig4])
def test_port_drivers_import_no_jax(mod):
    src = open(mod.__file__).read()
    assert "import jax" not in src and "from repro." not in src \
        and "from repro " not in src

"""Shared tolerances of the port's driver parity tests
(`tests/test_torch_figures.py`, `test_torch_spatial_drivers.py`,
`test_torch_calibration.py`): the margin kernel's near-zero flip rule,
device means within ceil(log2 N) float32 half-ulps, and the pass/fail
flips of a whole profiling campaign (refresh sweep plus fused timing
sweep) counted on both sides.  Also the one-thread fixture that every
CPU port test file takes by import."""

import dataclasses
import math

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a test module.  On some CPU hosts a
    multi-threaded `torch.exp` returned values off in the fourth
    significant digit in some processes, never with one thread (ROADMAP
    queue C); and the suite runs in several worker processes at once
    (`pytest -n`), where torch's default of a thread per core in each
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-4              # the margin kernel's tolerance against its plain
                        # version: a pass/fail flip is allowed only here


def flips(ref, port) -> int:
    """Cells whose pass/fail (margin >= 0) differs between the
    reference's margins and the port's; each must lie within TOL of
    zero on the reference's side."""
    ref = np.asarray(ref)
    port = np.asarray(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    d = (ref >= 0) != (port >= 0)
    assert (np.abs(ref[d]) <= TOL).all(), ref[d]
    return int(d.sum())


def equality_needs_no_flips(n_flips: int, what: str) -> None:
    """The comparisons after this call hold tables that a pass/fail flip
    moves.  Flips within TOL of zero are allowed (`flips` asserts it),
    but then the tables are not compared, and the run records the test
    as xfailed, not passed."""
    if n_flips:
        pytest.xfail(f"{what}: {n_flips} near-zero pass/fail flips, "
                     "equality not compared")


def mean_rtol(n: int) -> float:
    """ceil(log2 N) float32 half-ulps, relative: the float32 reduction's
    bound on a device mean over N requests."""
    return math.ceil(math.log2(n)) * 2.0 ** -24


def assert_device_means(port, ref, n: int):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    rel = np.abs(port - ref) / np.abs(ref)
    assert rel.max() <= mean_rtol(n), float(rel.max())


def assert_rel(got, want, what=""):
    """Speedups and gmeans: within 1e-5 relative (atol 1e-7 for values
    near zero, such as a difference of two gmeans)."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                               err_msg=str(what))


def profilers(grid_step: float):
    from repro.core import calibration as jcal
    from repro.core.profiler import Profiler as JProfiler
    from repro_torch import convert
    from repro_torch.core.profiler import Profiler as TProfiler
    return (JProfiler(constants=jcal.CALIBRATED_CONSTANTS,
                      grid_step=grid_step),
            TProfiler(convert.charge_constants(
                dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)),
                grid_step=grid_step, device="cpu"))


def campaign_flips(jpop, pop, temps=(), grid_step: float = 2.5,
                   sweep=None) -> int:
    """Pass/fail flips of a profiling campaign on the reference's
    population `jpop` and the port's copy `pop`: the 85C refresh sweep
    (both tests), then the fused read+write sweep over `temps` at each
    test's safe refresh interval, or the campaign `sweep(profiler,
    pop, rp_read, rp_write, sweep_module)` runs (`sweep_module`: the
    side's `core.sweep`, for its `Op` and `SweepSpec`)."""
    from repro.core import sweep as jsweep
    from repro_torch.core import sweep as tsweep
    jprof, tprof = profilers(grid_step)
    from repro.core import timing as JT
    grid = JT.refresh_grid()
    combos = np.repeat(np.asarray(JT.DDR3_1600.as_array())[None], len(grid),
                       axis=0)
    combos[:, 4] = grid
    jr, jw = jprof.engine.margins(jpop.flat_cells(), combos, temp_c=85.0)
    tr, tw = tprof.engine.margins(pop.flat_cells(), combos, temp_c=85.0)
    n = flips(jr, tr.numpy()) + flips(jw, tw.numpy())
    if not temps and sweep is None:
        return n
    if sweep is None:
        def sweep(prof, p, rr, rw, _):
            return prof.engine.sweep(p, prof.campaign_spec(temps, rr, rw))
    js = sweep(jprof, jpop, *jprof.refresh_campaign(jpop, 85.0), jsweep)
    ts = sweep(tprof, pop, *tprof.refresh_campaign(pop, 85.0), tsweep)
    for k in range(len(js.margins)):
        n += flips(np.asarray(js.margins[k]), ts.margins[k].numpy())
    return n

"""The port's calibration search, its last core shims, its examples and
its benchmark harness against the reference, on the CPU:

* `repro_torch.core.calibration.evaluate` on the reference's population
  of 8 modules x 8 cells at the full 1.25 ns grid: the statistics equal
  up to pass/fail flips whose deciding margin lies within 2e-4 of zero
  (counted and printed), and with none the loss and residuals equal
  (with flips the test records itself as xfailed);
  `run_search` proposes the reference's candidates from
  `np.random.default_rng(seed)` in its order (both evaluations replaced
  by one deterministic stand-in), skips only an `OutOfRangeCandidate`;
* `core.charge.combo_margins` within 2e-4 of the reference's, through
  the margin-grid wrapper; `core.perf_model.workload_speedup` equal to
  the batched `evaluate` on a host-statistics engine (exactly) and
  within 1e-5 relative of the reference's;
* `examples/port_quickstart.py`, `port_aldram_profile.py` and
  `port_aldram_dynamic.py --fast` on the reference examples' inputs
  against the reference examples run here;
* `benchmarks/port_run.py --fast --only power` writes its summary under
  the given `--out-dir`."""

import dataclasses
import importlib.util
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (assert_rel, campaign_flips,
                           equality_needs_no_flips, flips)
from repro.core import calibration as jcal
from repro.core import perf_model as jpm
from repro.core.variation import sample_population as j_sample
from repro_torch import convert
from repro_torch.core import calibration as tcal
from _torch_parity import one_thread as _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
BINS = (45.0, 55.0, 65.0, 75.0, 85.0)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{Path(name).stem}", ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference_example(name, argv):
    old = sys.argv
    sys.argv = [name] + argv
    try:
        runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
    finally:
        sys.argv = old


def _sections(out: str) -> dict:
    """`== title ==` sections of an example's output, CSV lines
    (`name,us,derived`) dropped, each parsed as JSON."""
    secs, cur = {}, None
    for ln in out.splitlines():
        if ln.startswith("== "):
            cur = ln
            secs[cur] = []
        elif cur is not None and not (ln[:1].isalpha() and "," in ln):
            secs[cur].append(ln)
    return {k: json.loads("\n".join(v)) for k, v in secs.items()}


# ------------------------------------------------------------ calibration

@pytest.fixture(scope="module")
def calib_pop():
    cfg = dataclasses.replace(jcal.CALIBRATED_VARIATION, n_modules=8,
                              n_cells=8)
    jpop = j_sample(jax.random.PRNGKey(0), cfg)
    return cfg, jpop, convert.population(np.asarray(jpop.cells),
                                         device="cpu")


def test_calibration_constants_equal_reference():
    assert tcal.TARGETS == jcal.TARGETS and tcal.WEIGHTS == jcal.WEIGHTS
    assert tcal._SEARCH_FIELDS == jcal._SEARCH_FIELDS
    assert dataclasses.asdict(tcal.CALIBRATED_CONSTANTS) == \
        dataclasses.asdict(jcal.CALIBRATED_CONSTANTS)
    assert convert.variation_config(dataclasses.asdict(
        jcal.CALIBRATED_VARIATION)) == tcal.CALIBRATED_VARIATION


def test_evaluate_equals_reference(calib_pop, capsys):
    cfg, jpop, pop = calib_pop
    jstats = jcal.evaluate(jcal.CALIBRATED_CONSTANTS, cfg, seed=0,
                           fast=False)
    tstats = tcal.evaluate(tcal.CALIBRATED_CONSTANTS,
                           convert.variation_config(dataclasses.asdict(cfg)),
                           fast=False, pop=pop, device="cpu")
    n_flips = campaign_flips(jpop, pop, (55.0, 85.0), grid_step=1.25)
    capsys.readouterr()
    print(f"calibration.evaluate 8 x 8: {n_flips} pass/fail flips, loss "
          f"{tcal.loss(tstats):.6f} vs {jcal.loss(jstats):.6f}")
    assert list(tstats) == list(jstats)
    equality_needs_no_flips(n_flips, "calibration.evaluate 8 x 8")
    assert tstats == jstats
    assert tcal.loss(tstats) == jcal.loss(jstats)
    assert tcal.residuals(tstats) == jcal.residuals(jstats)


def test_evaluate_samples_its_own_population():
    cfg = dataclasses.replace(tcal.CALIBRATED_VARIATION, n_modules=2,
                              n_cells=2)
    a = tcal.evaluate(tcal.CALIBRATED_CONSTANTS, cfg, fast=False,
                      device="cpu")
    b = tcal.evaluate(tcal.CALIBRATED_CONSTANTS, cfg, fast=False,
                      device="cpu")
    assert a == b and set(tcal.TARGETS) <= set(a)
    assert np.isfinite(tcal.loss(a))


def _stand_in(log):
    """A deterministic evaluation of a candidate: the statistics are
    smooth functions of its fields, so both searches see one landscape."""
    def evaluate(c, v, seed=0, fast=True, **kw):
        log.append((dataclasses.asdict(c), {k: val for k, val in
                                            dataclasses.asdict(v).items()}))
        x = c.t_wl + c.alpha_share + v.mu_tau_r + v.s_cell + c.dv_min * 10
        return {k: t * (1.0 + 0.1 * np.sin(x + i))
                for i, (k, t) in enumerate(jcal.TARGETS.items())}
    return evaluate


def test_run_search_draws_as_the_reference(monkeypatch):
    jlog, tlog = [], []
    monkeypatch.setattr(jcal, "evaluate", _stand_in(jlog))
    monkeypatch.setattr(tcal, "evaluate", _stand_in(tlog))
    jc, jv, jstats, jbest = jcal.run_search(iters=12, seed=3, verbose=False)
    tc, tv, tstats, tbest = tcal.run_search(iters=12, seed=3, verbose=False,
                                            device="cpu")
    assert len(tlog) == len(jlog) == 13
    assert tlog == jlog
    assert tbest == jbest and tstats == jstats
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)


def test_run_search_skips_only_out_of_range_candidates(monkeypatch):
    calls = []

    def evaluate(c, v, seed=0, fast=True, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise tcal.OutOfRangeCandidate("not finite")
        return dict(jcal.TARGETS)

    monkeypatch.setattr(tcal, "evaluate", evaluate)
    tcal.run_search(iters=2, seed=0, verbose=False, device="cpu")
    assert len(calls) == 3

    def broken(c, v, seed=0, fast=True, **kw):
        calls.append(1)
        if len(calls) > 4:
            raise RuntimeError("CUDA error: an illegal memory access")
        return dict(jcal.TARGETS)

    monkeypatch.setattr(tcal, "evaluate", broken)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcal.run_search(iters=2, seed=0, verbose=False, device="cpu")


def test_run_search_on_the_cpu(monkeypatch):
    """Two real iterations, each candidate's population cut to 2 modules
    x 2 cells (the mechanics: draws, evaluations, the returned best)."""
    real = tcal.evaluate
    n = []

    def small(c, v, seed=0, fast=True, **kw):
        n.append(1)
        return real(c, dataclasses.replace(v, n_modules=2, n_cells=2), seed,
                    fast=False, device="cpu")

    monkeypatch.setattr(tcal, "evaluate", small)
    c, v, stats, best = tcal.run_search(iters=2, seed=0, verbose=False,
                                        device="cpu")
    assert len(n) == 3 and np.isfinite(best) and best == tcal.loss(stats)


def test_evaluate_raises_out_of_range():
    cfg = dataclasses.replace(tcal.CALIBRATED_VARIATION, n_modules=1,
                              n_cells=1)
    cells = torch.full((1, 8, 8, 1, 5), float("inf"))
    from repro_torch.core.variation import Population
    with pytest.raises(tcal.OutOfRangeCandidate):
        tcal.evaluate(tcal.CALIBRATED_CONSTANTS, cfg, pop=Population(cells),
                      device="cpu")


def test_calibration_main_full_eval_json(monkeypatch, capsys):
    monkeypatch.setattr(tcal, "CALIBRATED_VARIATION", dataclasses.replace(
        tcal.CALIBRATED_VARIATION, n_modules=2, n_cells=2))
    assert tcal.main(["--full-eval", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"stats", "residuals", "loss"}
    assert out["loss"] == tcal.loss(out["stats"])


# ------------------------------------------------------------ core shims

@pytest.mark.parametrize("trefi", [False, True], ids=["combo", "per-cell"])
def test_combo_margins_matches_reference(calib_pop, trefi, monkeypatch):
    from repro.core import charge as jcharge
    from repro.core import timing as JT
    from repro_torch.core import charge as tcharge
    from repro_torch.kernels.charge_sim import ops
    _, jpop, pop = calib_pop
    cells = np.asarray(jpop.flat_cells())[:512]
    combos = np.asarray(JT.read_combo_grid(JT.DDR3_1600, 2.5))
    tr = (np.linspace(32.0, 256.0, cells.shape[0]).astype(np.float32)
          if trefi else None)
    jr, jw = jcharge.combo_margins(
        jax.numpy.asarray(cells), jax.numpy.asarray(combos), 60.0,
        jcal.CALIBRATED_CONSTANTS,
        None if tr is None else jax.numpy.asarray(tr))
    calls = []
    real = ops.margin_grid
    monkeypatch.setattr(ops, "margin_grid",
                        lambda *a: calls.append(1) or real(*a))
    r, w = tcharge.combo_margins(
        torch.tensor(cells), torch.tensor(combos), 60.0,
        tcal.CALIBRATED_CONSTANTS, None if tr is None else torch.tensor(tr))
    assert calls == [1]
    assert r.shape == w.shape == (512, combos.shape[0])
    for a, b in ((r, jr), (w, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-4)
        flips(np.asarray(b), a.numpy())


def test_workload_speedup_equals_batched_evaluate():
    from repro.core.sim_engine import SimEngine as JSimEngine
    from repro.core.timing import ALDRAM_55C_EVAL as JFAST
    from repro.core.timing import DDR3_1600 as JSTD
    from repro_torch.core import perf_model as tpm
    from repro_torch.core.dram_sim import Trace
    from repro_torch.core.sim_engine import SimEngine
    from repro_torch.core.timing import ALDRAM_55C_EVAL, DDR3_1600
    n = 256
    pool = convert.trace(*(np.asarray(f) for f in jpm.trace_batch(n=n,
                                                                  seed=0)),
                         device="cpu")
    res = tpm.evaluate(n=n, traces=pool, engine=SimEngine(
        device="cpu", stats="host", reorder="host"))
    jres = jpm.evaluate(n=n, engine=JSimEngine(stats="host", reorder="host"))
    key = jax.random.PRNGKey(0)
    nw = len(tpm.WORKLOADS)
    for mi, multi in enumerate((False, True)):
        tag = "multi" if multi else "single"
        for i in (0, 7, 19, 34):
            w = tpm.WORKLOADS[i]
            row = Trace(*(f[mi * nw + i] for f in pool))
            got = tpm.workload_speedup(w, DDR3_1600, ALDRAM_55C_EVAL, row,
                                       n, multi, device="cpu")
            assert res[tag][w.name] == got, (tag, w.name)
            k = jax.random.fold_in(key, i + (1000 if multi else 0))
            want = jpm.workload_speedup(jpm.WORKLOADS[i], JSTD, JFAST, k, n,
                                        multi)
            assert want == jres[tag][w.name]
            assert_rel(got, want, (tag, w.name))
    # its own draw: a generator gives the trace synth_trace draws from it
    from repro_torch.core import dram_sim
    w = tpm.WORKLOADS[3]
    got = tpm.workload_speedup(w, DDR3_1600, ALDRAM_55C_EVAL,
                               torch.Generator().manual_seed(5), n, True,
                               device="cpu")
    rh, wf, ia = tpm._knobs(w, True)
    tr = dram_sim.synth_trace(torch.Generator().manual_seed(5), n,
                              row_hit=rh, write_frac=wf, inter_arrival_ns=ia,
                              device="cpu")
    assert got == tpm.workload_speedup(w, DDR3_1600, ALDRAM_55C_EVAL, tr, n,
                                       True, device="cpu")


# --------------------------------------------------------------- examples

def test_port_quickstart_equals_reference(capsys):
    from repro.core import dram_sim as jdram
    jcfg = dataclasses.replace(jcal.CALIBRATED_VARIATION, n_modules=12,
                               n_cells=8)
    jpop = j_sample(jax.random.PRNGKey(0), jcfg)
    jtrace = jdram.synth_trace(jax.random.PRNGKey(1), 4096)
    _run_reference_example("quickstart.py", [])
    ref_out = capsys.readouterr().out
    ex = _load_example("port_quickstart.py")
    pop = convert.population(np.asarray(jpop.cells), device="cpu")
    got = ex.main(["--device", "cpu"], cells=np.asarray(jpop.cells),
                  traces=[np.asarray(f) for f in jtrace])
    out = capsys.readouterr().out
    n_flips = campaign_flips(jpop, pop, BINS)
    print(f"quickstart: {n_flips} pass/fail flips")
    assert got["verify"] is True and got["dispatches"] == 3
    equality_needs_no_flips(n_flips, "quickstart")
    assert out.splitlines() == ref_out.splitlines()


def test_port_aldram_profile_equals_reference(capsys):
    from benchmarks import common as jcommon
    jpop = jcommon.population(True)
    pools = {n: [np.asarray(f) for f in jpm.trace_batch(n=n, seed=0)]
             for n in (1024, 2048)}
    _run_reference_example("aldram_profile.py", ["--fast"])
    ref = _sections(capsys.readouterr().out)
    ex = _load_example("port_aldram_profile.py")
    got = ex.main(["--fast", "--device", "cpu"],
                  cells=np.asarray(jpop.cells), traces=pools)
    port = _sections(capsys.readouterr().out)
    pop = convert.population(np.asarray(jpop.cells), device="cpu")
    n_flips = (campaign_flips(jpop, pop, (85.0, 55.0))
               + campaign_flips(jpop, pop, BINS))
    print(f"aldram_profile --fast: {n_flips} pass/fail flips")
    assert list(port) == list(ref)
    t2a, t3, t4, t4p = list(port.values())
    r2a, r3, r4, r4p = list(ref.values())
    assert got["fig4"]["dispatches"] == {"replay": 1}
    for k, v in r4.items():
        if k == "best_multi":
            assert t4[k][0] == v[0]
            assert_rel(t4[k][1], v[1], k)
        else:
            assert_rel(t4[k], v, k)
    equality_needs_no_flips(n_flips, "aldram_profile --fast")
    assert t2a == r2a and t3 == r3
    assert list(t4p) == list(r4p)
    for tc, d in r4p.items():
        for k, v in d.items():
            assert_rel(t4p[tc][k], v, (tc, k))


def test_port_aldram_dynamic_equals_reference(capsys):
    from benchmarks import common as jcommon
    jpop = jcommon.population(True)
    pool = [np.asarray(f) for f in jpm.trace_batch(n=1024, seed=0)]
    _run_reference_example("aldram_dynamic.py", ["--fast"])
    ref_out = capsys.readouterr().out
    ex = _load_example("port_aldram_dynamic.py")
    got = ex.main(["--fast", "--device", "cpu"],
                  cells=np.asarray(jpop.cells), traces=pool)
    out = capsys.readouterr().out
    pop = convert.population(np.asarray(jpop.cells), device="cpu")
    n_flips = campaign_flips(jpop, pop, BINS)
    print(f"aldram_dynamic --fast: {n_flips} pass/fail flips")
    assert got["dispatches"] == 2
    head, ref_head = (o.split("== adaptive")[0] for o in (out, ref_out))
    equality_needs_no_flips(n_flips, "aldram_dynamic --fast")
    assert head == ref_head                       # bin edges, table stack
    ref_per = json.loads(ref_out.split("static bracket)")[0].split(
        "scenarios ==\n")[1].rsplit("\nreplay dispatches", 1)[0])
    per = got["result"]["per_scenario"]
    assert list(per) == list(ref_per)
    for name, d in ref_per.items():
        for k, v in d.items():
            if k in ("worst_bin", "mean_bin_switches"):
                assert per[name][k] == v, (name, k)
            elif k == "temp_peak":
                np.testing.assert_allclose(per[name][k], v, rtol=1e-5)
            else:
                assert_rel(per[name][k], v, (name, k))


# ---------------------------------------------------------------- harness

def test_port_run_writes_under_out_dir(tmp_path, capsys):
    from benchmarks import port_run
    assert port_run.main(["--fast", "--only", "power", "--device", "cpu",
                          "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "sec7_power," in out
    summary = json.loads((tmp_path / "BENCH_power.json").read_text())
    assert summary["name"] == "power" and summary["fast"] is True
    assert summary["error"] is None
    assert summary["headline"]["power_reduction"] > 0
    assert [p.name for p in tmp_path.iterdir()] == ["BENCH_power.json"]
    # against that summary as its baseline, a factor of 0 must gate
    assert port_run.main(["--fast", "--only", "power", "--device", "cpu",
                          "--out-dir", str(tmp_path / "b"),
                          "--baseline", str(tmp_path),
                          "--baseline-factor", "0"]) == 1


def test_port_run_covers_every_port_driver():
    from benchmarks import port_run
    names = set(port_run.benches())
    assert names == {"fig2_refresh", "fig2_timing", "fig3_population",
                     "fig4_system", "fig4_profiled", "fig_bank", "fig_region",
                     "sim_bench", "thermal_bench", "power", "repeatability",
                     "multi_timing", "fleet_bench", "fault_bench",
                     "traffic_bench", "framework", "roofline"}
    assert port_run.DEFAULT_OUT.endswith(str(Path("chiprun_out") / "bench"))


@pytest.mark.parametrize("path", [
    "src/repro_torch/core/calibration.py", "benchmarks/port_run.py",
    "benchmarks/port_common.py", "examples/port_quickstart.py",
    "examples/port_aldram_profile.py", "examples/port_aldram_dynamic.py"])
def test_new_port_modules_import_no_jax(path):
    src = (ROOT / path).read_text()
    assert "import jax" not in src and "from repro." not in src \
        and "from repro " not in src and "import repro." not in src

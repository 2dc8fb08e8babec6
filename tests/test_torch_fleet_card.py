"""The port's fleet recalibration service on the card against the same
runs on the CPU (`repro_torch.fleet`, `benchmarks.port_fleet_bench`).
This file imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src:. python -m pytest -q --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_fleet_card.py

Every test needs an NVIDIA card and skips without one (decided inside
the `cuda` fixture, never at import).  Card and CPU must give equal
telemetry, or diverge only where a scrub or profile counted a cell whose
margin lies within 2e-4 of zero on one device and not on the other
(`port_fleet_bench.compare`; the margin kernel differs from its plain
version in the last bits); worst margins within 2e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.fleet.drift import DriftModel
from repro_torch.fleet.monitor import ErrorMonitor
from repro_torch.fleet.recal import FleetEngine, FleetSpec

TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _card_cases(fast_pop, var_cfg, spec):
    """The fleets `port_fleet_bench.cross_device` runs on the card and on
    the CPU: the bench's --fast fleet-month (10 epochs here), a
    regions=4 fleet and a faulted fleet."""
    from benchmarks.port_common import profiler
    from repro_torch.core import faults as TF
    fa = TF.FaultSpec(scenarios=(TF.FaultScenario(
        name="err", err_scale=1.0, err_free_red=0.0, detect_frac=0.9,
        retry_ns=60.0),), seed=5)
    short = dataclasses.replace(spec, n_epochs=10)
    u = TF.fault_uniforms(5, len(spec.workload_rows), spec.n_requests,
                          device="cpu")
    base = dict(pop=fast_pop, var_cfg=var_cfg, profiler=profiler(True, "cpu"))
    return {"plain": dict(base, spec=short),
            "regions=4": dict(base, spec=dataclasses.replace(short,
                                                             regions=4)),
            "faulted": dict(base, fault_uniforms=u,
                            spec=dataclasses.replace(short, faults=fa))}


@pytest.mark.gpu
def test_fleet_month_card_matches_cpu(cuda):
    """The bench's --fast fleets on the card against the CPU: equal
    telemetry, or a divergence that only cells within 2e-4 of zero
    explain (printed with both margins)."""
    from benchmarks import port_fleet_bench as PFB
    var_cfg, spec = PFB.config(True)
    pop = PFB.population(var_cfg, device="cpu")
    out = PFB.cross_device(_card_cases(pop, var_cfg, spec))
    for name, o in out.items():
        for p, rep in o["reports"].items():
            print(name, p, rep)
            assert rep["ok"], (name, p, rep)
        for r in o["card"].values():
            assert r.replay_dispatches == r.spec.n_epochs


@pytest.mark.gpu
def test_probe_card_matches_cpu(cuda):
    """One scrub of a drifted population on the card and on the CPU:
    fail counts equal (a difference only at cells within 2e-4 of zero),
    worst margins within 2e-4."""
    from benchmarks import port_fleet_bench as PFB
    from benchmarks.port_common import profiler
    from repro_torch.core import timing as T
    var_cfg, _ = PFB.config(True)
    pop = PFB.population(var_cfg, device="cpu")
    dm = DriftModel(pop, var_cfg=var_cfg)
    st = dm.init_state()
    for _ in range(25):
        st = dm.advance(st, temp_c=57.0)
    dpop = dm.population(st)
    row = T.DDR3_1600.as_row().copy()
    row[:4] *= 0.75
    rows = np.broadcast_to(row, (pop.n_modules, pop.n_banks, 6)).copy()
    res = {d: ErrorMonitor(engine=profiler(True, d).engine).probe(
        dpop.to(d), rows, 57.0) for d in ("cuda", "cpu")}
    assert res["cpu"].fail_counts.sum() > 0
    np.testing.assert_allclose(res["cuda"].worst_margin,
                               res["cpu"].worst_margin, rtol=0, atol=TOL)
    if not np.array_equal(res["cuda"].fail_counts, res["cpu"].fail_counts):
        call = {"kind": "probe", "cells": dpop.cells.numpy(), "rows": rows,
                "temp_c": 57.0, "spec": FleetSpec(),
                "profiler": profiler(True, "cpu")}
        rep = PFB.explain(call)
        print(rep)
        assert rep["explained"], rep


@pytest.mark.gpu
def test_autotune_epoch_records_the_cuda_key(cuda, tmp_path):
    """On the card `autotune_epoch` profiles the CUDA candidates (the
    kernel at its default block and at 32 lanes) and records the epoch's
    (unit, size bin); an `auto` fleet consults it on every serve."""
    from benchmarks import port_fleet_bench as PFB
    from repro_torch.core.autotune import ReplayTuner, replay_unit
    from repro_torch.core.sim_engine import SimEngine
    var_cfg, spec = PFB.config(True)
    spec = dataclasses.replace(spec, n_epochs=3)
    pop = PFB.population(var_cfg, device="cuda")
    tuner = ReplayTuner(platform="cuda", path=str(tmp_path / "tune.json"))
    sim = SimEngine(device="cuda", backend="auto", tuner=tuner)
    eng = FleetEngine(pop, spec, var_cfg=var_cfg, sim=sim, device="cuda")
    unit = replay_unit(adaptive=False, banked=True, channels=False)
    winner = eng.autotune_epoch(reps=2)
    b = tuner.table._bin(tuner._condition(spec.n_requests))
    assert (unit, b) in tuner.table._table and winner in tuner.candidates
    seen = []
    orig = tuner.lookup
    tuner.lookup = lambda u_, n_: seen.append((u_, n_)) or orig(u_, n_)
    res = eng.run()
    assert res.replay_dispatches == spec.n_epochs
    assert seen and all(k == (unit, spec.n_requests) for k in seen)

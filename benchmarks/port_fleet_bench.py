"""Fleet recalibration benchmark of the PyTorch/CUDA port: the
errors-avoided vs latency-given-back frontier of
`benchmarks/fleet_bench.py` (the JAX package's), on `repro_torch.fleet`.

    PYTHONPATH=src python -m benchmarks.port_fleet_bench [--full] [--cpu]

Runs the SAME drifting fleet-month (identical population, drift seed,
epoch temperatures, and a mid-month module failure) under the three
serving policies (static-forever, periodic re-profile, error-driven)
and asserts the reference's acceptance bracket:

  * serving is exactly ONE replay dispatch per epoch, every policy;
  * the error-driven policy serves ZERO uncorrectable events (exactly
    0.0), while static-forever accumulates them;
  * error-driven beats static-forever on EFFECTIVE latency reduction.

The population and the [70, N] trace pool are the port's own draws
unless given as arrays (`cells`, `traces`), e.g. the reference's.

`cross_device` runs fleet-months on the card and on the CPU from the
same arrays and compares them.  The margin kernel differs from its
plain version in the last bits, so a scrub can count a cell whose
margin lies that close to zero on one device and not on the other;
from that epoch on the trajectories diverge.  The comparison finds the
first profile or scrub whose result differs, re-runs it on both
devices, and names the cells whose margin sign differs with both
margins: a divergence that only such cells within `TOL` of zero
explain is the known departure, any other is a failure.  This module
imports neither JAX nor the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TOL = 2e-4          # the margin grid's bound against its reference
INT_FIELDS = ("corr_events", "unc_events", "scrub_corr", "served_detected",
              "served_silent", "served_wd_trips", "compression_ratio",
              "temp_c", "tighten_steps", "version", "dead_modules",
              "straggler_fallbacks", "jedec_fallbacks")
LAT_FIELDS = ("lat_jedec_ns", "lat_fleet_ns", "eff_lat_ns")
EPOCH_SETS = ("recal_epochs", "relax_epochs", "relax_rejected")


def config(fast: bool):
    """(variation config, `FleetSpec`) of `fleet_bench.run(fast)`."""
    from repro_torch.core.calibration import CALIBRATED_VARIATION
    from repro_torch.fleet.recal import FleetSpec
    var_cfg = dataclasses.replace(CALIBRATED_VARIATION,
                                  n_modules=8 if fast else 16,
                                  n_cells=4 if fast else 6)
    spec = FleetSpec(n_epochs=30,
                     workload_rows=(0, 19) if fast else (0, 17, 19),
                     n_requests=512 if fast else 1024,
                     module_failures=((10, 3),), seed=0)
    return var_cfg, spec


def population(var_cfg, cells=None, device="cuda"):
    """The port's draw (seed 7) of `var_cfg`, or the given cells."""
    from repro_torch import convert
    from repro_torch.core.variation import sample_population
    if cells is None:
        return sample_population(torch.Generator().manual_seed(7), var_cfg,
                                 device=device)
    return convert.population(np.asarray(cells), device=device)


def run(fast: bool = False, device: str | torch.device = "cuda",
        cells=None, traces=None) -> dict:
    """The benchmark: the bracket asserted, the same dict as
    `fleet_bench.run`.  `cells` ([modules, chips, banks, K, 5]) and
    `traces` (the (arrival, bank, row, is_write) arrays of a [70, 512 or
    1024] pool) replace the port's own draws."""
    from benchmarks.port_common import emit, timed
    from benchmarks.port_common import profiler
    from repro_torch import convert
    from repro_torch.fleet.recal import frontier, run_policies
    var_cfg, spec = config(fast)
    pop = population(var_cfg, cells, device)
    if traces is not None:
        traces = convert.trace(*traces, device=device)
    with timed(device) as t:
        results = run_policies(pop, spec, var_cfg=var_cfg,
                               profiler=profiler(fast, device),
                               device=device, traces=traces)
        fr = frontier(results)

    replay = {p: r.summary()["replay_per_epoch"]
              for p, r in results.items()}
    for p, rpe in replay.items():
        assert rpe == 1.0, (p, rpe)
    err = fr["policies"]["error"]
    sta = fr["policies"]["static"]
    assert err["total_unc"] == 0.0, err        # exactly zero, no tolerance
    assert sta["total_unc"] > 0.0, sta
    assert err["eff_reduction"] > sta["eff_reduction"], (err, sta)

    total_replay = sum(r.replay_dispatches for r in results.values())
    parts = ["{}:eff={:.1%}/unc={:.0f}".format(
        p, fr["policies"][p]["eff_reduction"],
        fr["policies"][p]["total_unc"]) for p in results]
    emit("port_fleet_frontier", t.us,
         "|".join(parts) + "|replay_per_epoch=1"
         + f"|dispatches={total_replay}|device={torch.device(device)}")

    return {
        "frontier": fr["policies"],
        "summaries": fr["summaries"],
        "dispatches": {
            "replay_total": total_replay,
            "replay_per_epoch": 1.0,
            "margin": sum(r.margin_dispatches for r in results.values()),
        },
    }


# ------------------------------------------------------------ card vs CPU

def on_device(prof, device):
    """`prof`, a `Profiler`, with its margin engine on `device`."""
    return dataclasses.replace(prof, device=device, engine=None)


def record(eng) -> list:
    """Record, in call order, every profile and scrub of a `FleetEngine`
    with its epoch, inputs and result (on the host), and the engine's
    spec and profiler, which `explain` re-runs it with."""
    calls, epoch = [], [-1]
    setup = {"spec": eng.spec, "profiler": eng.controller.profiler}
    advance = eng.drift.advance
    profile = eng.controller.profile
    probe = eng.monitor.probe

    def advance_(*a, **kw):
        epoch[0] += 1
        return advance(*a, **kw)

    def profile_(pop):
        t = profile(pop)
        calls.append({**setup, "epoch": epoch[0], "kind": "profile",
                      "cells": pop.cells.cpu().numpy(),
                      "out": [np.asarray(x) for x in (
                          t.params, t.params_module, t.safe_trefi_read,
                          t.safe_trefi_write, t.region_index)
                          if x is not None]})
        return t

    def probe_(pop, rows, temp_c):
        r = probe(pop, rows, temp_c)
        calls.append({**setup, "epoch": epoch[0], "kind": "probe",
                      "cells": pop.cells.cpu().numpy(),
                      "rows": np.array(rows), "temp_c": float(temp_c),
                      "out": [r.fail_counts.copy()]})
        return r

    eng.drift.advance = advance_
    eng.controller.profile = profile_
    eng.monitor.probe = probe_
    return calls


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def _launches(call, device) -> list:
    """Re-run one recorded call on `device` and return each margin
    launch it made: its inputs and its (read, write) grids, on the
    host."""
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.variation import Population
    from repro_torch.fleet.monitor import ErrorMonitor

    spec = call["spec"]
    ctrl = ALDRAMController(on_device(call["profiler"], device),
                            temp_bins=spec.temp_bins, per_bank=True,
                            regions=spec.regions, device=device)
    eng, log = ctrl.engine, []
    margins = eng.margins

    def host(x):
        return None if x is None else torch.as_tensor(x).cpu().numpy()

    def margins_(cells, combos, temps_combo=None, temp_c=None,
                 trefi_read=None, trefi_write=None):
        r, w = margins(cells, combos, temps_combo, temp_c, trefi_read,
                       trefi_write)
        log.append({"in": [host(x) for x in (cells, combos, temps_combo,
                                             trefi_read, trefi_write)]
                    + [np.asarray(-1.0 if temp_c is None else float(temp_c))],
                    "read": host(r), "write": host(w)})
        return r, w

    eng.margins = margins_
    pop = Population(torch.tensor(call["cells"], device=device))
    if call["kind"] == "profile":
        ctrl.profile(pop)
    else:
        ErrorMonitor(engine=eng).probe(pop, call["rows"], call["temp_c"])
    return log


def explain(call, max_cells: int = 12) -> dict:
    """Re-run a call whose result differs on the card and the CPU, on
    both, and walk its margin launches in order: the first launch whose
    grids' signs differ must have had equal inputs on both devices and
    every cell of it whose sign differs must lie within `TOL` of zero
    (the CPU's margin and the card's).  Returns the launch, the cells
    (cell, column, test, card margin, CPU margin) and the verdict."""
    runs = {d: _launches(call, d) for d in ("cuda", "cpu")}
    g, c = runs["cuda"], runs["cpu"]
    for i, (lg, lc) in enumerate(zip(g, c)):
        if not _same([x for x in lg["in"] if x is not None],
                     [x for x in lc["in"] if x is not None]):
            return {"launch": i, "explained": False, "cells": [],
                    "why": "the launch's inputs differ on the two devices"}
        cells = []
        for test in ("read", "write"):
            mg, mc = lg[test], lc[test]
            for j, k in zip(*np.nonzero((mg < 0.0) != (mc < 0.0))):
                cells.append({"cell": int(j), "column": int(k),
                              "test": test, "card": float(mg[j, k]),
                              "cpu": float(mc[j, k])})
        if cells:
            ok = all(abs(x["card"]) <= TOL and abs(x["cpu"]) <= TOL
                     for x in cells)
            return {"launch": i, "explained": ok, "n_cells": len(cells),
                    "cells": cells[:max_cells],
                    "why": "margin signs differ near zero" if ok else
                    "a margin sign differs beyond the tolerance"}
    return {"launch": None, "explained": False, "cells": [],
            "why": "the results differ but no margin sign does"}


def compare(card, cpu, calls_card, calls_cpu) -> dict:
    """Card against CPU for one policy's fleet-month.  Without a
    differing profile or scrub, every field must be equal: integer and
    event telemetry, latencies (both devices sum the device means
    exactly in float64), epoch lists, dispatch counts.  Otherwise the
    epochs before the first differing call must be, and that call must
    be explained by `explain`."""
    first = next((i for i, (a, b) in enumerate(zip(calls_card, calls_cpu))
                  if a["kind"] != b["kind"] or not _same(a["out"], b["out"])),
                 None)
    if first is None and len(calls_card) != len(calls_cpu):
        first = min(len(calls_card), len(calls_cpu))
    e_stop = cpu.spec.n_epochs
    report = {"divergence": None}
    if first is not None:
        call = (calls_cpu + [None])[first] or calls_card[first]
        e_stop = call["epoch"]
        report["divergence"] = {"call": first, "kind": call["kind"],
                                "epoch": e_stop,
                                **explain(call)}
    bad = [f for f in INT_FIELDS + LAT_FIELDS
           if not np.array_equal(getattr(card, f)[:max(e_stop, 0)],
                                 getattr(cpu, f)[:max(e_stop, 0)])]
    bad += [f for f in EPOCH_SETS
            if [e for e in getattr(card, f) if e < e_stop]
            != [e for e in getattr(cpu, f) if e < e_stop]]
    if first is None:
        bad += [f for f in ("replay_dispatches", "margin_dispatches")
                if getattr(card, f) != getattr(cpu, f)]
    report["differing_fields"] = bad
    report["compared_epochs"] = max(e_stop, 0)
    report["ok"] = not bad and (first is None
                                or report["divergence"]["explained"])
    return report


def fleet_runs(cases: dict, device) -> dict:
    """Each case's recorded fleet-months on `device`.  `cases`: {name:
    dict(pop=, spec=, var_cfg=, profiler= (on any device), and
    optionally traces=, fault_uniforms=, policies=)}; returns {name:
    ({policy: (FleetResult, calls)}, seconds)}."""
    import time
    from repro_torch.fleet.recal import POLICIES, FleetEngine
    out = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        kw = dict(case)
        pop, spec = kw.pop("pop").to(device), kw.pop("spec")
        policies = kw.pop("policies", POLICIES)
        kw["profiler"] = on_device(kw["profiler"], device)
        runs = {}
        for p in policies:
            eng = FleetEngine(pop, dataclasses.replace(spec, policy=p),
                              device=device, **kw)
            calls = record(eng)
            runs[p] = (eng.run(), calls)
        out[name] = (runs, time.perf_counter() - t0)
    return out


def cross_device(cases: dict, card=None) -> dict:
    """`cases` (as `fleet_runs`) on the card — or `card`, the card's
    `fleet_runs` already made — and on the CPU from the same arrays,
    compared policy by policy: {name: {"card": results, "cpu": results,
    "reports": {policy: compare(...)}, "seconds": {device: s}}}."""
    card = card or fleet_runs(cases, "cuda")
    cpu = fleet_runs(cases, "cpu")
    out = {}
    for name in cases:
        (g, s_g), (c, s_c) = card[name], cpu[name]
        out[name] = {
            "card": {p: r for p, (r, _) in g.items()},
            "cpu": {p: r for p, (r, _) in c.items()},
            "reports": {p: compare(g[p][0], c[p][0], g[p][1], c[p][1])
                        for p in c},
            "seconds": {"cuda": s_g, "cpu": s_c}}
    return out


if __name__ == "__main__":
    import json
    import sys
    r = run("--full" not in sys.argv,
            device="cpu" if "--cpu" in sys.argv else "cuda")
    print(json.dumps(r["frontier"], indent=1))

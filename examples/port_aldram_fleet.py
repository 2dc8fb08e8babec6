"""Fleet recalibration demo on the PyTorch/CUDA port (`repro_torch.fleet`):
a compressed fleet-month with a mid-run cooling failure layered on
FLY-DRAM-style drift, the port's counterpart of `examples/aldram_fleet.py`.

Samples a fleet of modules, profiles them once, then serves thirty
daily epochs while the cell population ages (tail cells fastest) and,
halfway through the month, a machine-room chiller dies and the ambient
jumps, which both shifts the serving temperature bin AND thermally
accelerates the aging itself.  The same drifting fleet is served under
all three policies:

  static-forever  : the paper's one-shot deployment,
  periodic        : full re-profile every week,
  error-driven    : scrub-then-react guardband tightening with
                    probe-confirmed relaxation.

Each epoch is ONE replay launch; every scrub and re-profile launches the
margin kernel.  The demo prints the per-epoch telemetry of the
error-driven loop and the errors-avoided vs latency-given-back frontier
across policies.

    PYTHONPATH=src python examples/port_aldram_fleet.py [--fast] \
        [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, cells=None, traces=None):
    """Run the demo; `cells` and `traces` (the arrays of a [70, N] pool)
    replace the port's own population and trace draws.  Returns the
    per-policy `FleetResult`s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmarks.port_common import profiler
    from repro_torch import convert
    from repro_torch.core.calibration import CALIBRATED_VARIATION
    from repro_torch.core.thermal import cooling_failure
    from repro_torch.fleet.recal import FleetSpec, frontier, run_policies

    var_cfg = dataclasses.replace(CALIBRATED_VARIATION,
                                  n_modules=6 if args.fast else 12,
                                  n_cells=4 if args.fast else 6)
    if cells is None:
        import torch
        from repro_torch.core.variation import sample_population
        pop = sample_population(torch.Generator().manual_seed(7), var_cfg,
                                device=args.device)
    else:
        pop = convert.population(cells, device=args.device)
    if traces is not None:
        traces = convert.trace(*traces, device=args.device)

    # the chiller dies mid-month: the scenario clock advances
    # ambient_step_ns per epoch, so at_ns = 15 epochs in
    step_ns = 1.0e4
    scn = cooling_failure(base_c=48.0, jump_c=9.0, at_ns=15 * step_ns)
    spec = FleetSpec(n_epochs=30,
                     ambient=scn, ambient_step_ns=step_ns,
                     workload_rows=(0, 19),
                     n_requests=512 if args.fast else 1024,
                     module_failures=((10, 3),),
                     seed=0)

    print(f"== fleet: {var_cfg.n_modules} modules, scenario {scn.name} "
          f"(chiller dies at epoch 15), module 3 dies at epoch 10 ==")
    results = run_policies(pop, spec, var_cfg=var_cfg,
                           profiler=profiler(args.fast, args.device),
                           device=args.device, traces=traces)

    err = results["error"]
    print("\n== error-driven loop, per epoch ==")
    print("  ep  temp_c  red%   scrub  tighten  ver  note")
    for e in range(spec.n_epochs):
        red = 1.0 - err.lat_fleet_ns[e] / err.lat_jedec_ns[e]
        notes = []
        if e in err.recal_epochs:
            notes.append("RECAL")
        if e in err.relax_epochs:
            notes.append("relax")
        if e in err.relax_rejected:
            notes.append("relax-rejected")
        if err.jedec_fallbacks[e]:
            notes.append(f"jedec-fb x{int(err.jedec_fallbacks[e])}")
        if err.straggler_fallbacks[e]:
            notes.append(f"straggler x{int(err.straggler_fallbacks[e])}")
        if e and err.dead_modules[e] > err.dead_modules[e - 1]:
            notes.append("module DEAD")
        print(f"  {e:2d}  {err.temp_c[e]:5.1f}  {red:5.1%}  "
              f"{int(err.scrub_corr[e]):5d}  {int(err.tighten_steps[e]):5d}"
              f"  {int(err.version[e]):4d}  {' '.join(notes)}")

    print("\n== errors-avoided vs latency-given-back frontier ==")
    fr = frontier(results)
    print(f"  {'policy':>10}  {'raw':>7}  {'effective':>9}  "
          f"{'unc events':>10}  {'given back':>10}")
    for p, d in fr["policies"].items():
        print(f"  {p:>10}  {d['raw_reduction']:6.1%}  "
              f"{d['eff_reduction']:8.1%}  {d['total_unc']:10.0f}  "
              f"{d['latency_given_back']:9.2%}")

    replay = {p: r.summary()["replay_per_epoch"]
              for p, r in results.items()}
    assert all(v == 1.0 for v in replay.values()), replay
    assert fr["policies"]["error"]["total_unc"] == 0.0
    print("\nevery policy served one replay launch per epoch; the "
          "error-driven loop finished the month with ZERO uncorrectable "
          "events.")
    return results


if __name__ == "__main__":
    main()

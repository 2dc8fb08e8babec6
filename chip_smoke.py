#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's AL-DRAM main, thermal and subarray-region
paths on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result line):

  1. build every CUDA kernel from the sources in this checkout (nvcc,
     one process per source, in parallel) and print the compiler's
     register / spill report;
  2. the main path at full width, kernel launch counts reset just
     before and read just after: sample the calibrated 115-module
     population (176,640 cells); profile it (one refresh launch, one
     176,640 x 8,505 margin-grid launch); report the Sec. 5.2 / Fig. 3
     reductions at 55C and 85C; verify the zero-error invariant (12
     launches); replay the 70-trace pool under the profiled rows
     (`evaluate_system`, n = 4096) and under the paper's 55C set
     (`perf_model.evaluate`, n = 8192);
     then the same path once more under `torch.profiler` for the
     device busy share and device time by kernel;
  3. margin_grid against its plain PyTorch version on the card, on the
     first 8 modules' 12,288 cells x all 8,505 campaign combos (rtol =
     atol = 2e-4); its device time (mean of 5 launches after a warm-up,
     from torch.profiler's kernel records) and its wrapper call's time
     (median of 5, CUDA events) beside its bound and the plain
     version's time (the same for every kernel below);
  4. the thermal path at full width on the table the main path
     profiled, launch counts reset just before and read just after:
     `evaluate_dynamic(n=4096)` with the default scenarios (70 traces,
     4 scenarios + 4 oracles, 5 bins + JEDEC) per-module and per-bank,
     each through the two-launch path and `fused=True` (`run_bracket`),
     which must agree (worst_bin equal, gmeans within 1e-5 relative);
     adaptive >= static_worst - 1e-9 for every scenario and policy; then
     `evaluate_bank_system(n=4096)`; then the same path under
     `torch.profiler` for the device busy share;
  5. the subarray-region path at full width on the same population,
     launch counts reset just before and read just after: a regions=8
     controller profiles it (one refresh launch, one margin-grid launch)
     and verifies it (must be True; 39 launches); `region_reductions((2,
     4, 8))` must be monotone module <= bank <= r2 <= r4 <= r8, the
     8-region store under 0.5 of dense; `evaluate_region_system(n=4096)`
     replays 70 traces x 26 rows (JEDEC, 5 module, 5 bank, 3 x 5 region
     rows) over <= 64 unique columns in ONE launch of replay_blocks (c);
     the deployed `safe_stack_regions()` (5 bins + JEDEC, a [64] map)
     runs in closed loop through `SimEngine` under the default 4 + 4
     scenarios in ONE launch of adaptive_blocks (c), and its gmean must
     be >= that of the static replay of each scenario's worst bin; then
     the same path under `torch.profiler` for the device busy share;
  6. replay_blocks (a) at both Fig. 4 shapes (bitwise), replay_blocks
     (b) and adaptive_blocks (module and per-bank tables, raw temps and
     bins emitted) against their plain versions on the card at the
     thermal path's full shapes (bins
     identical on every request, latencies within rtol 1e-5,
     temperatures / heat / diagnostics within rtol 1e-5, atol 1e-4;
     the per-bank replay bitwise), replay_blocks (c) at
     `evaluate_region_system`'s shape (bitwise on every lane; a
     bank-constant map and R = 1 with the identity map bitwise equal to
     variant (b)) and adaptive_blocks (c) at the regioned closed loop's
     shape (bins identical on every request, raw temps and bins
     emitted), with their times;
  7. the main path at --fast scale (24 modules, 8 cells, 2.5 ns grid) on
     the card and on the CPU: chosen combos must agree (a flip only
     where the CPU's deciding margin is within 2e-4 of 0) and the
     Fig. 4 gmeans within 1e-5 relative; then `evaluate_dynamic(n=1024)`
     on both: worst_bin equal, gmeans within 1e-4 relative, and a
     selected bin may differ only where the CPU's sensed temperature
     lies within 1e-3 C of a switching threshold (an edge, or an edge
     minus the hysteresis) or where the lane's previous request already
     differed (the hysteresis carries the earlier choice); then the region
     path at --fast scale (regions=8) on both: chosen region rows equal
     up to flips whose deciding margin lies within 2e-4 of 0,
     `region_reductions` and compression ratios equal, and the
     `evaluate_region_system(n=1024)` gmeans within 1e-5 relative.

The last lines are the card (`nvidia-smi` name and power limit), one
JSON object of per-kernel numbers, and the result object.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 2e-4
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores (both at the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
REPLAY_OPS_PER_STEP = 25     # service_math: adds, maxes, compares, selects
# thermal step on top of service_math: decay and sum of 8 bank heats,
# ambient (sin, fmod, compares), 2 x 5 bin compares, energy and deposit
ADAPTIVE_OPS_PER_STEP = 75
HYST_EDGE_TOL = 1e-3         # C: a bin may flip only this close to a threshold


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device time of `fn` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_ms(fn, kernel: str, reps: int = 5) -> float:
    """Mean device time in ms of one launch of the CUDA kernel whose
    name contains `kernel`, over `reps` calls of `fn` after a warm-up
    (torch.profiler's CUPTI kernel records).  Unlike `cuda_ms` it leaves
    out what the wrapper does around the launch, such as input checks
    that wait for the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key
            and e.self_device_time_total > 0]
    check(len(hits) == 1 and hits[0].count == reps,
          f"profiler saw {[(e.key, e.count) for e in hits]} for {kernel}")
    return hits[0].self_device_time_total / reps / 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.charge_sim import ops as charge_ops
    from repro_torch.kernels.replay import ops as replay_ops
    charge_ops.margin_grid.launches = 0
    for fn in (replay_ops.replay_blocks, replay_ops.adaptive_blocks):
        fn.launches = 0
        fn.launches_banked = 0
        fn.launches_regioned = 0


def read_counts() -> dict:
    """Launches per kernel variant since `reset_counts`."""
    from repro_torch.kernels.charge_sim import ops as charge_ops
    from repro_torch.kernels.replay import ops as replay_ops
    out = {"margin_grid": charge_ops.margin_grid.launches}
    for name, fn in (("replay_blocks", replay_ops.replay_blocks),
                     ("adaptive_blocks", replay_ops.adaptive_blocks)):
        out[f"{name} (a)"] = (fn.launches - fn.launches_banked
                              - fn.launches_regioned)
        out[f"{name} (b)"] = fn.launches_banked
        out[f"{name} (c)"] = fn.launches_regioned
    return out


def wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phases

def main_path(env) -> dict:
    """Phase 2: the full-width main path through the kernels."""
    import torch
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population

    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    pop, t_pop = wall(lambda: sample_population(
        torch.Generator().manual_seed(SEED), CALIBRATED_VARIATION,
        device="cuda"))
    ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=1.25),
                            device="cuda")
    table, t_prof = wall(lambda: ctrl.profile(pop))
    red = {t: ctrl.average_reductions(t) for t in (55.0, 85.0)}
    res = ctrl.sweep_result
    fig3 = {}
    for t in (55.0, 85.0):
        ti = res.temps.index(t)
        r, w = res.reductions(Op.READ)[ti], res.reductions(Op.WRITE)[ti]
        fig3[t] = {"read_sum": r["latency_sum"], "write_sum": w["latency_sum"],
                   "trcd": r["trcd"], "tras": r["tras"], "twr": w["twr"],
                   "trp": r["trp"]}
    d_prof = ctrl.engine.dispatch_count
    ok, t_ver = wall(lambda: ctrl.verify(pop))
    d_ver = ctrl.engine.dispatch_count - d_prof
    eng_sys, eng_ev = SimEngine(device="cuda"), SimEngine(device="cuda")
    sys_res, t_sys = wall(lambda: ctrl.evaluate_system(pop, n=4096,
                                                       engine=eng_sys))
    ev, t_ev = wall(lambda: perf_model.evaluate(n=8192, engine=eng_ev))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"population: {tuple(pop.cells.shape)} = "
          f"{pop.flat_cells().shape[0]} cells ({t_pop:.3f} s)")
    print(f"profile: table {table.params.shape}, {d_prof} launches "
          f"({t_prof:.3f} s); verify: {ok}, {d_ver} launches ({t_ver:.3f} s)")
    for t in (55.0, 85.0):
        f = fig3[t]
        print(f"fig3 @{t:.0f}C: read_sum {f['read_sum']:.2%} write_sum "
              f"{f['write_sum']:.2%} | tRCD {f['trcd']:.2%} tRAS "
              f"{f['tras']:.2%} tWR {f['twr']:.2%} tRP {f['trp']:.2%}")
        print(f"average_reductions({t:.0f}): " + " ".join(
            f"{k} {v:.2%}" for k, v in red[t].items()))
    for t, d in sys_res["per_temp"].items():
        print(f"evaluate_system @{t:.0f}C: " + " ".join(
            f"{k} {v:.2%}" for k, v in d.items()))
    s = ev["summary"]
    print(f"evaluate (55C set): multi intensive {s['multi_intensive_gmean']:.2%}"
          f" non-intensive {s['multi_nonintensive_gmean']:.2%} all "
          f"{s['multi_all_gmean']:.2%} best {s['best_multi'][0]} "
          f"{s['best_multi'][1]:.2%}")
    print(f"dispatches: profile+verify {ctrl.engine.dispatch_count}, "
          f"evaluate_system {eng_sys.dispatch_count}, evaluate "
          f"{eng_ev.dispatch_count}")
    print(f"phase seconds: profile {t_prof:.3f} verify {t_ver:.3f} "
          f"evaluate_system {t_sys:.3f} evaluate {t_ev:.3f}; peak device "
          f"memory {peak_gb:.2f} GB")
    print("kernels: " + json.dumps(launches))

    check(ok is True, "verify() found a negative margin")
    check(all(launches[k] > 0 for k in ("margin_grid", "replay_blocks (a)")),
          f"a kernel of the main path never launched: {launches}")
    check(table.params.shape == (115, 5, 8, 4), str(table.params.shape))
    check(d_prof == 2 and d_ver == 12, f"launches {d_prof}+{d_ver}")
    for t in (55.0, 85.0):
        check(all(0.0 < v < 1.0 for v in fig3[t].values()), str(fig3[t]))
    check(fig3[55.0]["read_sum"] > fig3[85.0]["read_sum"],
          "55C must allow deeper cuts than 85C")
    vals = [v for d in sys_res["per_temp"].values() for v in d.values()]
    vals += [s["multi_intensive_gmean"], s["multi_nonintensive_gmean"],
             s["multi_all_gmean"]]
    check(all(-1.0 < v < 1.0 for v in vals), f"speedups {vals}")
    check(s["multi_intensive_gmean"] > s["multi_nonintensive_gmean"] > 0,
          "intensive workloads must gain more than non-intensive ones")
    env.update(pop=pop, ctrl=ctrl, sys_res=sys_res, launches=launches,
               launches_main=launches)
    return env


def busy_share(label: str, fn) -> None:
    """Run `fn` once under `torch.profiler`: wall time, device busy and
    idle share, device time by name.  A measurement only: if the
    profiler records no device time it reports "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if dev_us <= 0:
        print(f"{label}: device busy share not measured (the profiler "
              "recorded no device time)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{label} under torch.profiler: {t:.3f} s wall, device busy "
          f"{dev_us / 1e6:.3f} s = {dev_us / 1e6 / t:.1%} (idle "
          f"{1 - dev_us / 1e6 / t:.1%})")
    for e in top:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")


def time_breakdown(env) -> None:
    """Phase 2b: the main path once more under `torch.profiler`."""
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController

    pop = env["pop"]
    ctrl = ALDRAMController(env["ctrl"].profiler, device="cuda")
    busy_share("main path", lambda: (
        ctrl.profile(pop), ctrl.verify(pop),
        ctrl.evaluate_system(pop, n=4096),
        perf_model.evaluate(n=8192, device="cuda")))


def path_launches(env, kernel: str) -> dict:
    """A kernel variant's launches: the total over the paths driven,
    and per path."""
    by_path = {path: env[f"launches_{path}"][kernel]
               for path in ("main", "thermal", "region")
               if f"launches_{path}" in env}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def kernel_margin_grid(env) -> dict:
    """Phase 3: margin_grid vs its plain version, and its times."""
    import torch
    from repro_torch.core.calibration import CALIBRATED_CONSTANTS as C
    from repro_torch.core.sweep import Op
    from repro_torch.kernels.charge_sim import ops, ref

    pop, ctrl = env["pop"], env["ctrl"]
    combos, temps, _, tc = ctrl.engine.campaign_columns(
        pop, ctrl.sweep_result.spec)
    dev = torch.device("cuda")
    cells_t, combos_t = ops.pack_inputs(
        pop.flat_cells(), torch.tensor(combos, device=dev),
        torch.tensor(temps, device=dev), torch.tensor(tc[Op.READ], device=dev),
        torch.tensor(tc[Op.WRITE], device=dev))
    n, m = cells_t.shape[1], combos_t.shape[1]
    n_slice = 8 * 8 * 8 * 24
    sl = cells_t[:, :n_slice].contiguous()
    err_abs = err_rel = 0.0
    viol = nonbit = 0
    for k_out, p_out in zip(ops.margin_grid(sl, combos_t, C),
                            ref.margin_grid(sl, combos_t, C)):
        d = (k_out - p_out).abs()
        err_abs = max(err_abs, d.max().item())
        err_rel = max(err_rel, (d / p_out.abs().clamp(min=1e-30)).max().item())
        viol += int((d > TOL + TOL * p_out.abs()).sum())
        nonbit += int((k_out.view(torch.int32)
                       != p_out.view(torch.int32)).sum())
    print(f"margin_grid vs plain on {n_slice} x {m} (x2 outputs): max abs "
          f"{err_abs:.3e}, max rel {err_rel:.3e}, {viol} elements beyond "
          f"rtol=atol={TOL:g}, {nonbit} not bitwise equal")
    check(viol == 0, f"margin_grid disagrees with its plain version at "
                     f"{viol} elements")

    call = cuda_ms(lambda: ops.margin_grid(cells_t, combos_t, C))
    ms = kernel_ms(lambda: ops.margin_grid(cells_t, combos_t, C),
                   "margin_grid_kernel")
    plain = cuda_ms(lambda: ref.margin_grid(cells_t, combos_t, C), reps=2)
    n_bytes = 4 * (7 * n + 6 * m) + 2 * 4 * n * m
    b_ms, b_by = bound_ms(n_bytes, ops.margin_grid_flops(n, m))
    print(f"margin_grid at {n} x {m}: kernel {ms:.3f} ms (wrapper call "
          f"{call:.3f} ms), plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}: {n_bytes / 1e9:.2f} GB, "
          f"{ops.margin_grid_flops(n, m):.3e} flop, "
          f"{ops.TRANSCENDENTALS_PER_ELEM * n * m:.3e} expf/logf)")
    return {"name": "margin_grid", "route": "cuda",
            "source": "src/repro_torch/kernels/charge_sim/margin_grid.cu",
            "replaces": "src/repro/kernels/charge_sim/charge_sim.py:119",
            **path_launches(env, "margin_grid"),
            "max_abs_err": err_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def kernel_replay(env) -> dict:
    """Phase 5a: replay_blocks (a) vs its plain version at both Fig. 4
    shapes, and its times."""
    import torch
    from repro_torch.core import dram_sim, perf_model
    from repro_torch.core import timing as T
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    shapes = (("evaluate", 8192, T.stack_timing([T.DDR3_1600,
                                                 T.ALDRAM_55C_EVAL])),
              ("evaluate_system", 4096, env["sys_res"]["rows"]))
    entry = None
    for name, n, rows in shapes:
        tb = perf_model.trace_batch(n, SEED, device=dev)
        g = tb.arrival.shape[0]
        cells = ref.to_cells(*(f[:, None] for f in tb),
                             torch.ones((g, n), dtype=torch.bool, device=dev),
                             torch.tensor([False], device=dev))
        tim = torch.tensor(rows, device=dev)
        tim_t = tim.T.contiguous()
        s = tim.shape[0]
        lat, total = ops.replay_blocks(*cells, tim_t)
        closed, arr, bank, row, wr, valid = cells
        plain_fn = lambda: dram_sim.replay_cells(   # noqa: E731
            arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5)
        (lat2, total2), _ = wall(plain_fn)
        lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
                 | (total.view(torch.int32) != total2.view(torch.int32)))
        n_bad = int(lanes.sum())
        err = max((lat - lat2).abs().max().item(),
                  (total - total2).abs().max().item())
        call = cuda_ms(lambda: ops.replay_blocks(*cells, tim_t))
        ms = kernel_ms(lambda: ops.replay_blocks(*cells, tim_t),
                       "replay_kernel")
        plain = cuda_ms(plain_fn, reps=1, warmup=0)
        n_bytes = g * n * 5 * 4 + g * n * s * 4 + g * s * 4 + 6 * s * 4 + g * 4
        b_ms, b_by = bound_ms(n_bytes, REPLAY_OPS_PER_STEP * g * n * s)
        print(f"replay_blocks ({name}) G={g} N={n} S={s}: {n_bad} of "
              f"{g * s} lanes not bitwise equal to plain (max abs "
              f"{err:.3e}); kernel {ms:.3f} ms (wrapper call {call:.3f} ms "
              f"with its host-side input checks), plain {plain:.3f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
              f"path {n} dependent requests")
        check(n_bad == 0, f"replay_blocks: {n_bad} lanes differ ({name})")
        if entry is None:
            entry = {"name": "replay_blocks", "variant": "a",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/replay/replay.cu",
                     "replaces": "src/repro/kernels/replay/replay.py:640",
                     **path_launches(env, "replay_blocks (a)"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return entry


def thermal_path(env) -> None:
    """Phase 4: the thermal closed loop at full width on the table the
    main path profiled, kernel launch counts reset just before and read
    just after."""
    import numpy as np
    from repro_torch.core.sim_engine import SimEngine

    pop, ctrl = env["pop"], env["ctrl"]
    runs, secs, calls = {}, {}, {}
    reset_counts()
    for per_bank in (False, True):
        for fused in (False, True):
            eng = SimEngine(device="cuda")
            key = (per_bank, fused)
            runs[key], secs[key] = wall(lambda: ctrl.evaluate_dynamic(
                pop, n=4096, per_bank=per_bank, fused=fused, engine=eng))
            calls[key] = eng.dispatch_count
    bank, t_bank = wall(lambda: ctrl.evaluate_bank_system(pop, n=4096))
    launches = read_counts()

    for key, res in runs.items():
        tag = (("per-bank" if key[0] else "per-module") + " "
               + ("fused" if key[1] else "two-launch"))
        print(f"evaluate_dynamic {tag}: {secs[key]:.3f} s, {calls[key]} "
              f"engine calls, worst_bin {res['worst_bin'].tolist()}")
        for name, d in res["per_scenario"].items():
            print(f"  {name}: adaptive {d['adaptive_gmean']:.4%} "
                  f"static_worst {d['static_worst_gmean']:.4%} oracle "
                  f"{d['oracle_gmean']:.4%} temp_peak {d['temp_peak']:.3f} "
                  f"worst_bin {d['worst_bin']} mean_bin_switches "
                  f"{d['mean_bin_switches']:.3f}")
    for t, d in bank["per_temp"].items():
        print(f"evaluate_bank_system @{t:.0f}C: " + " ".join(
            f"{k} {v:.3%}" for k, v in d.items()))
    print("evaluate_bank_system reductions: " + json.dumps(
        bank["reductions"]))
    print("thermal path seconds: " + " ".join(
        f"dynamic[{'bank' if k[0] else 'module'},"
        f"{'fused' if k[1] else 'two'}] {v:.3f}" for k, v in secs.items())
        + f" bank_system {t_bank:.3f}")
    print("thermal path kernels: " + json.dumps(launches))

    for per_bank in (False, True):
        a, b = runs[(per_bank, False)], runs[(per_bank, True)]
        check(np.array_equal(a["worst_bin"], b["worst_bin"]),
              f"worst_bin two-launch {a['worst_bin']} vs fused "
              f"{b['worst_bin']}")
        for name, d in a["per_scenario"].items():
            for k in ("adaptive_gmean", "static_worst_gmean",
                      "oracle_gmean"):
                x, y = d[k], b["per_scenario"][name][k]
                check(abs(x - y) <= 1e-5 * max(abs(x), abs(y)),
                      f"{name} {k}: two-launch {x} vs fused {y}")
    for key, res in runs.items():
        check(calls[key] == (1 if key[1] else 2), f"engine calls {calls}")
        check(res["adaptive"].shape == (2, 35, 1, 4),
              str(res["adaptive"].shape))
        for pd in res["per_policy"]:
            for name, d in pd.items():
                check(all(np.isfinite(v) for v in d.values()
                          if isinstance(v, float)), f"{name}: {d}")
                check(d["adaptive_gmean"] >= d["static_worst_gmean"] - 1e-9,
                      f"adaptive < static_worst for {name}: {d}")
    check(all(np.isfinite(v) and -1.0 < v < 1.0
              for d in bank["per_temp"].values() for v in d.values()),
          str(bank["per_temp"]))
    check(all(launches[k] > 0 for k in ("replay_blocks (a)",
                                        "replay_blocks (b)",
                                        "adaptive_blocks (a)",
                                        "adaptive_blocks (b)")),
          f"a kernel of the thermal path never launched: {launches}")
    env.update(launches_thermal=launches, bank_res=bank)


def thermal_breakdown(env) -> None:
    """Phase 4b: the thermal path once more under `torch.profiler`."""
    pop, ctrl = env["pop"], env["ctrl"]
    busy_share("thermal path", lambda: (
        [ctrl.evaluate_dynamic(pop, n=4096, per_bank=pb, fused=f)
         for pb in (False, True) for f in (False, True)],
        ctrl.evaluate_bank_system(pop, n=4096)))


def _campaign_cells(n: int):
    """The 70-trace pool at length n as kernel cells (open page)."""
    import torch
    from repro_torch.core import perf_model
    from repro_torch.kernels.replay import ref

    dev = torch.device("cuda")
    tb = perf_model.trace_batch(n, SEED, device=dev)
    g = tb.arrival.shape[0]
    return ref.to_cells(*(f[:, None] for f in tb),
                        torch.ones((g, n), dtype=torch.bool, device=dev),
                        torch.tensor([False], device=dev))


def kernel_adaptive(env) -> list:
    """Phase 5c: adaptive_blocks (module and per-bank tables) against
    its plain version at the thermal path's full shape (70 cells x 4096
    requests x 8 lanes, raw temps and bins emitted), and its times."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    scn_t = torch.tensor(TH.stack_scenarios(scns).T.copy(), device=dev)
    tcfg = torch.tensor(TH.ThermalConfig().as_row(), device=dev)
    table = env["ctrl"].table
    entries = []
    for variant, (rows, edges) in (("a", table.safe_stack()),
                                   ("b", table.safe_stack_banks())):
        tile = ref.table_tile(ref.lane_tables(
            torch.tensor(rows, device=dev)[None], len(scns)))
        bins = torch.tensor(edges, device=dev)
        lanes = tile.shape[-1]
        out = ops.adaptive_blocks(*cells, tile, scn_t, bins, tcfg,
                                  emit_raw=True)
        plain, plain_s = wall(lambda: dram_sim.replay_adaptive_cells(
            arr, bank, row, wr.bool(), valid.bool(), ref.lane_stacks(tile),
            bins, scn_t.T, tcfg, closed > 0.5))
        lat, total, tmax, tmean, sw, heat, temps, sel = out
        plat, ptot, ptemps, psel, pheat, (ptmax, ptmean, psw) = plain
        pairs = ((lat, plat), (total, ptot), (temps, ptemps), (heat, pheat),
                 (tmax, ptmax), (tmean, ptmean))
        err = max((a - b).abs().max().item() for a, b in pairs)
        same_bins = bool(torch.equal(sel, psel) and torch.equal(sw, psw))

        def lane_bits(a, b):
            d = a.view(torch.int32) != b.view(torch.int32)
            return d.reshape(g, -1, lanes).any(1)

        lanes_off = lane_bits(lat, plat) | lane_bits(temps, ptemps) \
            | lane_bits(heat, pheat) | lane_bits(total, ptot) \
            | lane_bits(tmean, ptmean) | (sel != psel).any(1)
        n_off = int(lanes_off.sum())
        close = all(torch.allclose(a, b, rtol=1e-5, atol=0)
                    for a, b in pairs[:2]) and all(
            torch.allclose(a, b, rtol=1e-5, atol=1e-4) for a, b in pairs[2:])
        call = cuda_ms(lambda: ops.adaptive_blocks(*cells, tile, scn_t, bins,
                                                   tcfg))
        ms = kernel_ms(lambda: ops.adaptive_blocks(*cells, tile, scn_t, bins,
                                                   tcfg), "adaptive_kernel")
        n_bytes = (g * n * 5 * 4 + g * n * lanes * 4 + g * 4
                   + tile.numel() * 4 + scn_t.numel() * 4 + bins.numel() * 4
                   + 24 + g * lanes * 4 * 4 + heat.numel() * 4)
        b_ms, b_by = bound_ms(n_bytes, (REPLAY_OPS_PER_STEP
                                        + ADAPTIVE_OPS_PER_STEP) * g * n * lanes)
        print(f"adaptive_blocks ({variant}, {'per-bank' if variant == 'b' else 'module'} "
              f"tables) G={g} N={n} L={lanes}: bins identical {same_bins}, "
              f"{int(sw.sum())} switches, {n_off} of {g * lanes} lanes not "
              f"bitwise equal to plain (max abs {err:.3e}); kernel {ms:.3f} ms "
              f"(wrapper call {call:.3f} ms), plain {plain_s * 1e3:.1f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
              f"path {n} dependent requests")
        check(same_bins, f"adaptive_blocks ({variant}): bins differ")
        check(close, f"adaptive_blocks ({variant}): outputs beyond tolerance "
                     f"(max abs {err:.3e})")
        entries.append({
            "name": "adaptive_blocks", "variant": variant, "route": "cuda",
            "source": "src/repro_torch/kernels/replay/adaptive.cu",
            "replaces": "src/repro/kernels/replay/replay.py:522",
            **path_launches(env, f"adaptive_blocks ({variant})"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return entries


def kernel_replay_banked(env) -> dict:
    """Phase 5b: replay_blocks (b), the per-bank tile, against its plain
    version at `evaluate_bank_system`'s shape, and its times."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    tim = torch.tensor(env["bank_res"]["rows"], device=arr.device)
    tile = ref.timing_tile(tim)
    s, banks = tim.shape[0], tim.shape[1]
    lat, total = ops.replay_blocks(*cells, tile)
    (lat2, total2), plain_s = wall(lambda: dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5))
    lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
             | (total.view(torch.int32) != total2.view(torch.int32)))
    n_bad = int(lanes.sum())
    err = max((lat - lat2).abs().max().item(),
              (total - total2).abs().max().item())
    call = cuda_ms(lambda: ops.replay_blocks(*cells, tile))
    ms = kernel_ms(lambda: ops.replay_blocks(*cells, tile), "replay_kernel")
    n_bytes = (g * n * 5 * 4 + g * n * s * 4 + g * s * 4 + banks * 6 * s * 4
               + g * 4)
    b_ms, b_by = bound_ms(n_bytes, REPLAY_OPS_PER_STEP * g * n * s)
    print(f"replay_blocks (b, per-bank tile) G={g} N={n} S={s} banks={banks}: "
          f"{n_bad} of {g * s} lanes not bitwise equal to plain (max abs "
          f"{err:.3e}); kernel {ms:.3f} ms (wrapper call {call:.3f} ms), "
          f"plain {plain_s * 1e3:.1f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{n_bytes / 1e6:.2f} MB)")
    check(n_bad == 0, f"replay_blocks (b): {n_bad} lanes differ")
    return {"name": "replay_blocks", "variant": "b", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/replay.cu",
            "replaces": "src/repro/kernels/replay/replay.py:640",
            **path_launches(env, "replay_blocks (b)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def cross_device() -> dict:
    """Phase 6a: the --fast-scale main path on the card vs on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population

    cfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=24, n_cells=8)
    pop_cpu = sample_population(torch.Generator().manual_seed(SEED), cfg,
                                device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        pop = pop_cpu.to(dev)
        ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=2.5,
                                         device=dev), device=dev)
        t0 = time.perf_counter()
        tbl = ctrl.profile(pop)
        ok = ctrl.verify(pop)
        sys_res = ctrl.evaluate_system(pop, n=1024)
        ev = perf_model.evaluate(n=2048, device=dev)
        out[dev] = dict(ctrl=ctrl, tbl=tbl, ok=ok, sys=sys_res, ev=ev,
                        pop=pop, s=time.perf_counter() - t0)
    g, c = out["cuda"], out["cpu"]
    check(g["ok"] and c["ok"], "verify failed at --fast scale")
    diff_rows = int((g["tbl"].params != c["tbl"].params).any(-1).sum()
                    + (g["tbl"].params_module
                       != c["tbl"].params_module).any(-1).sum())
    flips = unexplained = 0
    if diff_rows:
        # a differing choice must come from a pass/fail flip whose
        # deciding (bank-minimum) margin lies within TOL of zero
        spec = c["ctrl"].sweep_result.spec
        rg = g["ctrl"].engine.sweep(g["pop"], spec)
        rc = c["ctrl"].engine.sweep(c["pop"], spec)
        m, ch, bk, kc = c["pop"].cells.shape[:4]
        for op in Op:
            k = rc.index(op)
            flip = rg.ok_bank[k] != rc.ok_bank[k]
            mm = rc.margins[k].reshape(m, ch, bk, kc, *rc.margins[k].shape[1:])
            mmin = mm.amin(dim=(1, 3)).numpy()
            flips += int(flip.sum())
            unexplained += int((np.abs(mmin[flip]) > TOL).sum())
    rel = []
    for tc_, d in g["sys"]["per_temp"].items():
        same = np.array_equal(g["sys"]["rows"][1 + list(
            g["sys"]["temps"]).index(tc_)], c["sys"]["rows"][1 + list(
                c["sys"]["temps"]).index(tc_)])
        if same:
            rel += [abs(v / c["sys"]["per_temp"][tc_][k] - 1)
                    for k, v in d.items()]
    for k in ("multi_intensive_gmean", "multi_nonintensive_gmean",
              "multi_all_gmean", "single_intensive_gmean"):
        rel.append(abs(g["ev"]["summary"][k] / c["ev"]["summary"][k] - 1))
    max_rel = max(rel)
    print(f"cross-device --fast (24 modules, 8 cells, 2.5 ns grid): "
          f"{diff_rows} differing chosen rows, {flips} pass/fail flips "
          f"({unexplained} unexplained), max rel gmean diff {max_rel:.3e}; "
          f"card {g['s']:.2f} s, CPU {c['s']:.2f} s")
    check(unexplained == 0, "card and CPU choices differ beyond 2e-4")
    check(max_rel <= 1e-5, f"card vs CPU gmeans differ by {max_rel:.3e}")
    return out


def cross_device_thermal(out) -> None:
    """Phase 6b: `evaluate_dynamic` at --fast scale (n = 1024) on the
    card and on the CPU, both on the CPU controller's table, and the
    selected bin of every request of the same campaign on both."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.sim_engine import SimEngine, SimSpec

    table = out["cpu"]["tbl"]
    out["cuda"]["ctrl"].table = table
    dyn, secs = {}, {}
    for dev in ("cuda", "cpu"):
        o = out[dev]
        t0 = time.perf_counter()
        dyn[dev] = {pb: o["ctrl"].evaluate_dynamic(o["pop"], n=1024,
                                                    per_bank=pb)
                    for pb in (False, True)}
        secs[dev] = time.perf_counter() - t0
    rel = 0.0
    for pb in (False, True):
        g, c = dyn["cuda"][pb], dyn["cpu"][pb]
        check(np.array_equal(g["worst_bin"], c["worst_bin"]),
              f"worst_bin card {g['worst_bin']} vs CPU {c['worst_bin']}")
        for name, d in c["per_scenario"].items():
            for k in ("adaptive_gmean", "static_worst_gmean",
                      "oracle_gmean"):
                x, y = g["per_scenario"][name][k], d[k]
                rel = max(rel, abs(x - y) / max(abs(y), 1e-12))

    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    cfg = TH.ThermalConfig()
    hyst = cfg.hyst_c * TH.stack_scenarios(scns)[:, 8]          # [C]
    diff = near = carried = total = 0
    max_dt = 0.0
    for rows, edges in (table.safe_stack(), table.safe_stack_banks()):
        spec_kw = dict(timings=rows[None], collect=("temps", "bins"),
                       thermal=TH.ThermalSpec(scns, tuple(edges.tolist()),
                                              cfg))
        res = {dev: SimEngine(device=dev).run(SimSpec(
            traces=perf_model.trace_batch(1024, SEED, device=dev),
            **spec_kw)) for dev in ("cuda", "cpu")}
        bg, bc = res["cuda"].bins, res["cpu"].bins          # [T, 1, 1, C, N]
        temp = res["cpu"].temps
        max_dt = max(max_dt, float(np.abs(res["cuda"].temps - temp).max()))
        d = bg != bc
        thr = np.concatenate([np.broadcast_to(edges, hyst.shape + edges.shape),
                              edges[None, :] - hyst[:, None]], axis=1)
        dist = np.abs(temp[..., None] - thr[None, None, None, :, None, :])
        is_near = (dist <= HYST_EDGE_TOL).any(-1)
        prev = np.zeros_like(d)
        prev[..., 1:] = d[..., :-1]
        diff += int(d.sum())
        near += int((d & is_near).sum())
        carried += int((d & ~is_near & prev).sum())
        total += d.size
    unexplained = diff - near - carried
    print(f"cross-device evaluate_dynamic --fast (n=1024, module + per-bank): "
          f"worst_bin equal, max rel gmean diff {rel:.3e}; {diff} of {total} "
          f"selected bins differ ({near} within {HYST_EDGE_TOL:g} C of a "
          f"threshold, {carried} carried by hysteresis from a differing "
          f"previous request, {unexplained} unexplained); max sensed-temp "
          f"diff {max_dt:.3e} C; card {secs['cuda']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s")
    check(rel <= 1e-4, f"card vs CPU dynamic gmeans differ by {rel:.3e}")
    check(unexplained == 0, f"{unexplained} bins differ away from a "
                            "switching threshold")

REGIONS = 8
LEVELS = (2, 4, 8)


def _region_bracket(eng, rows_u, edges, idx, traces):
    """The deployed region stack in closed loop (ONE adaptive launch)
    and the static replay of each real scenario's worst bin (ONE static
    launch, JEDEC baseline first), both through `SimEngine`, priced as
    multi-core CPI gmeans per scenario the way
    `perf_model.evaluate_adaptive` prices the module stack."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core import timing as T
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.sim_engine import SimSpec

    scns = default_scenarios()
    nc = len(scns)
    cfg = TH.ThermalConfig()
    rmap = idx.reshape(-1)
    spec = SimSpec(traces=traces, timings=rows_u[None], region_map=rmap,
                   thermal=TH.ThermalSpec(scns + tuple(x.oracle()
                                                       for x in scns),
                                          tuple(edges.tolist()), cfg))
    res_a, t_a = wall(lambda: eng.run(spec))
    peak = res_a.temp_max[:, :, 0, :nc].max(axis=(0, 1))
    worst = np.searchsorted(edges, peak + np.float32(cfg.hyst_c),
                            side="left")
    base = np.broadcast_to(T.DDR3_1600.as_row(), rows_u.shape[1:])
    rows = np.concatenate([base[None], rows_u[worst]], axis=0)
    res_s, t_s = wall(lambda: eng.run(SimSpec(traces=traces, timings=rows,
                                              region_map=rmap)))
    lat = np.concatenate([res_s.mean_latency_ns,
                          res_a.mean_latency_ns[:, :, 0, :]], axis=-1)
    sp = perf_model.cpi_speedups(lat.reshape((2, -1) + lat.shape[1:]))
    out = {}
    for ci, x in enumerate(scns):
        out[x.name] = {
            "adaptive": perf_model.gmean_speedup(sp[1, :, 0, 1 + nc + ci]),
            "static_worst": perf_model.gmean_speedup(sp[1, :, 0, 1 + ci]),
            "oracle": perf_model.gmean_speedup(sp[1, :, 0, 1 + 2 * nc + ci]),
            "worst_bin": int(worst[ci]), "temp_peak": float(peak[ci]),
            "switches": float(res_a.bin_switches[:, 0, 0, ci].mean())}
    return out, t_a + t_s


def region_path(env) -> None:
    """Phase 5: the subarray-region path at full width on the main
    path's population, kernel launch counts reset just before and read
    just after."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import CALIBRATED_CONSTANTS
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine

    pop = env["pop"]
    reset_counts()
    ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=1.25),
                            regions=REGIONS, device="cuda")
    table, t_prof = wall(lambda: ctrl.profile(pop))
    d_prof = ctrl.engine.dispatch_count
    ok, t_ver = wall(lambda: ctrl.verify(pop))
    d_ver = ctrl.engine.dispatch_count - d_prof
    red, t_red = wall(lambda: ctrl.region_reductions(LEVELS))
    ratios = {lv: ctrl.region_table(lv).compression_ratio() for lv in LEVELS}
    eng_sys = SimEngine(device="cuda")
    sys_res, t_sys = wall(lambda: ctrl.evaluate_region_system(
        pop, n=4096, levels=LEVELS, engine=eng_sys))
    before = read_counts()
    (rows_u, edges, idx), t_stack = wall(table.safe_stack_regions)
    eng_dyn = SimEngine(device="cuda")
    traces = perf_model.trace_batch(4096, SEED, device="cuda")
    dyn, t_dyn = _region_bracket(eng_dyn, rows_u, edges, idx, traces)
    launches = read_counts()
    ad_launch = (launches["adaptive_blocks (c)"]
                 - before["adaptive_blocks (c)"])

    print(f"region profile: store {table.params.shape} (U = "
          f"{table.n_unique}), map {table.region_index.shape}, {d_prof} "
          f"launches ({t_prof:.3f} s); verify: {ok}, {d_ver} launches "
          f"({t_ver:.3f} s)")
    for op, d in red.items():
        print(f"region_reductions {op}: " + " ".join(
            f"{k} {v:.2%}" for k, v in d.items()))
    print("compression ratios: " + " ".join(
        f"r{lv} {v:.4f}" for lv, v in ratios.items())
        + f" (region_reductions {t_red:.3f} s)")
    print(f"evaluate_region_system: rows {sys_res['rows'].shape}, map "
          f"{sys_res['region_map'].shape}, {eng_sys.dispatch_count} engine "
          f"call ({t_sys:.3f} s)")
    for t, d in sys_res["per_temp"].items():
        print(f"  @{t:.0f}C: " + " ".join(f"{k} {v:.3%}"
                                          for k, v in d.items()))
    print(f"safe_stack_regions: rows {rows_u.shape}, map {idx.shape} "
          f"({t_stack:.3f} s); closed loop + static worst bins: "
          f"{eng_dyn.dispatch_count} engine calls ({t_dyn:.3f} s)")
    for name, d in dyn.items():
        print(f"  {name}: adaptive {d['adaptive']:.4%} static_worst "
              f"{d['static_worst']:.4%} oracle {d['oracle']:.4%} temp_peak "
              f"{d['temp_peak']:.3f} worst_bin {d['worst_bin']} "
              f"mean_bin_switches {d['switches']:.3f}")
    print("region path kernels: " + json.dumps(launches))

    check(ok is True, "verify() found a negative margin in the region table")
    check(d_prof == 2 and d_ver == 39, f"launches {d_prof}+{d_ver}")
    check(table.params.shape[:2] == (115, 5)
          and table.region_index.shape == (115, 5, 8, REGIONS),
          str(table.region_index.shape))
    for op, d in red.items():
        seq = [d["module"], d["bank"]] + [d[f"region{lv}"] for lv in LEVELS]
        check(all(b >= a - 1e-9 for a, b in zip(seq, seq[1:])),
              f"{op} reductions not monotone: {seq}")
    check(ratios[REGIONS] < 0.5, f"8-region store ratio {ratios}")
    check(eng_sys.dispatch_count == 1
          and sys_res["rows"].shape[0] == 26
          and sys_res["rows"].shape[1] <= 64
          and sys_res["region_map"].shape == (64,),
          f"evaluate_region_system {sys_res['rows'].shape}")
    check(all(np.isfinite(v) and -1.0 < v < 1.0
              for d in sys_res["per_temp"].values() for v in d.values()),
          str(sys_res["per_temp"]))
    check(before["replay_blocks (c)"] == 1,
          f"evaluate_region_system replay launches {before}")
    check(eng_dyn.dispatch_count == 2 and ad_launch == 1
          and idx.shape == (8, REGIONS) and rows_u.shape[0] == 6,
          f"closed loop launches {ad_launch}, stack {rows_u.shape}")
    for name, d in dyn.items():
        check(d["adaptive"] >= d["static_worst"] - 1e-9,
              f"adaptive < static_worst for {name}: {d}")
    check(all(launches[k] > 0 for k in ("margin_grid", "replay_blocks (c)",
                                        "adaptive_blocks (c)")),
          f"a kernel of the region path never launched: {launches}")
    env.update(launches_region=launches, region_ctrl=ctrl,
               region_sys=sys_res, region_stack=(rows_u, edges, idx))


def region_breakdown(env) -> None:
    """Phase 5b: the region path once more under `torch.profiler`."""
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.sim_engine import SimEngine

    pop, old = env["pop"], env["region_ctrl"]
    ctrl = ALDRAMController(old.profiler, regions=REGIONS, device="cuda")

    def run():
        ctrl.profile(pop)
        ctrl.verify(pop)
        ctrl.evaluate_region_system(pop, n=4096, levels=LEVELS)
        _region_bracket(SimEngine(device="cuda"),
                        *ctrl.table.safe_stack_regions(),
                        perf_model.trace_batch(4096, SEED, device="cuda"))

    busy_share("region path", run)


def kernel_replay_regioned(env) -> dict:
    """Phase 6d: replay_blocks (c), the region store gathered through the
    index map, against its plain version at `evaluate_region_system`'s
    shape, variant (b) reproduced by bank-constant maps, and its times."""
    import numpy as np
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    dev = arr.device
    g = arr.shape[0]
    tim = torch.tensor(env["region_sys"]["rows"], device=dev)  # [S, U, 6]
    rmap = torch.tensor(env["region_sys"]["region_map"], device=dev)
    tile = ref.timing_tile(tim)
    s, u = tim.shape[0], tim.shape[1]
    lat, total = ops.replay_blocks(*cells, tile, region_map=rmap)
    (lat2, total2), plain_s = wall(lambda: dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5,
        region_map=rmap))
    lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
             | (total.view(torch.int32) != total2.view(torch.int32)))
    n_bad = int(lanes.sum())
    err = max((lat - lat2).abs().max().item(),
              (total - total2).abs().max().item())
    # variant (b) is (c) with the bank as the column: a bank-constant
    # map over 8 regions, and R = 1 with the identity map
    bank_rows = torch.tensor(env["bank_res"]["rows"], device=dev)
    btile = ref.timing_tile(bank_rows)
    lb = ops.replay_blocks(*cells, btile)
    same_b = []
    for bmap in (np.repeat(np.arange(8), REGIONS), np.arange(8)):
        lc = ops.replay_blocks(*cells, btile, region_map=torch.tensor(
            bmap, dtype=torch.int32, device=dev))
        same_b.append(all(torch.equal(x.view(torch.int32),
                                      y.view(torch.int32))
                          for x, y in zip(lb, lc)))
    call = cuda_ms(lambda: ops.replay_blocks(*cells, tile, region_map=rmap))
    ms = kernel_ms(lambda: ops.replay_blocks(*cells, tile, region_map=rmap),
                   "replay_kernel")
    n_bytes = (g * n * 5 * 4 + g * n * s * 4 + g * s * 4 + u * 6 * s * 4
               + rmap.numel() * 4 + g * 4)
    b_ms, b_by = bound_ms(n_bytes, REPLAY_OPS_PER_STEP * g * n * s)
    print(f"replay_blocks (c, region store) G={g} N={n} S={s} U={u} "
          f"map={tuple(rmap.shape)}: {n_bad} of {g * s} lanes not bitwise "
          f"equal to plain (max abs {err:.3e}); bank-constant map and "
          f"identity map equal to variant (b): {same_b}; kernel {ms:.3f} ms "
          f"(wrapper call {call:.3f} ms), plain {plain_s * 1e3:.1f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
          f"path {n} dependent requests")
    check(n_bad == 0, f"replay_blocks (c): {n_bad} lanes differ")
    check(all(same_b), "replay_blocks (c) with a bank map differs from (b)")
    return {"name": "replay_blocks", "variant": "c", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/replay.cu",
            "replaces": "src/repro/kernels/replay/replay.py:640",
            **path_launches(env, "replay_blocks (c)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def kernel_adaptive_regioned(env) -> dict:
    """Phase 6e: adaptive_blocks (c), the deployed region stack gathered
    through its [64] map, against its plain version at the regioned
    closed loop's full shape (raw temps and bins emitted), and its
    times."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    scn_t = torch.tensor(TH.stack_scenarios(scns).T.copy(), device=dev)
    tcfg = torch.tensor(TH.ThermalConfig().as_row(), device=dev)
    rows_u, edges, idx = env["region_stack"]
    tile = ref.table_tile(ref.lane_tables(
        torch.tensor(rows_u, device=dev)[None], len(scns)))  # [U, S+1, 6, L]
    rmap = torch.tensor(idx.reshape(-1), device=dev)
    bins = torch.tensor(edges, device=dev)
    lanes = tile.shape[-1]
    out = ops.adaptive_blocks(*cells, tile, scn_t, bins, tcfg, emit_raw=True,
                              region_map=rmap)
    plain, plain_s = wall(lambda: dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), ref.lane_stacks(tile),
        bins, scn_t.T, tcfg, closed > 0.5, region_map=rmap))
    lat, total, tmax, tmean, sw, heat, temps, sel = out
    plat, ptot, ptemps, psel, pheat, (ptmax, ptmean, psw) = plain
    pairs = ((lat, plat), (total, ptot), (temps, ptemps), (heat, pheat),
             (tmax, ptmax), (tmean, ptmean))
    err = max((a - b).abs().max().item() for a, b in pairs)
    same_bins = bool(torch.equal(sel, psel) and torch.equal(sw, psw))

    def lane_bits(a, b):
        d = a.view(torch.int32) != b.view(torch.int32)
        return d.reshape(g, -1, lanes).any(1)

    n_off = int((lane_bits(lat, plat) | lane_bits(temps, ptemps)
                 | lane_bits(heat, pheat) | lane_bits(total, ptot)
                 | (sel != psel).any(1)).sum())
    close = all(torch.allclose(a, b, rtol=1e-5, atol=0)
                for a, b in pairs[:2]) and all(
        torch.allclose(a, b, rtol=1e-5, atol=1e-4) for a, b in pairs[2:])
    fn = lambda: ops.adaptive_blocks(*cells, tile, scn_t, bins, tcfg,  # noqa: E731
                                     region_map=rmap)
    call = cuda_ms(fn)
    ms = kernel_ms(fn, "adaptive_kernel")
    n_bytes = (g * n * 5 * 4 + g * n * lanes * 4 + g * 4 + tile.numel() * 4
               + rmap.numel() * 4 + scn_t.numel() * 4 + bins.numel() * 4
               + 24 + g * lanes * 4 * 4 + heat.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, (REPLAY_OPS_PER_STEP
                                    + ADAPTIVE_OPS_PER_STEP) * g * n * lanes)
    print(f"adaptive_blocks (c, region tables) G={g} N={n} L={lanes} "
          f"U={tile.shape[0]}: bins identical {same_bins}, {int(sw.sum())} "
          f"switches, {n_off} of {g * lanes} lanes not bitwise equal to plain "
          f"(max abs {err:.3e}); kernel {ms:.3f} ms (wrapper call {call:.3f} "
          f"ms), plain {plain_s * 1e3:.1f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{n_bytes / 1e6:.2f} MB); critical path {n} dependent requests")
    check(same_bins, "adaptive_blocks (c): bins differ")
    check(close, f"adaptive_blocks (c): outputs beyond tolerance (max abs "
                 f"{err:.3e})")
    return {"name": "adaptive_blocks", "variant": "c", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/adaptive.cu",
            "replaces": "src/repro/kernels/replay/replay.py:522",
            **path_launches(env, "adaptive_blocks (c)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def cross_device_region() -> None:
    """Phase 7c: the region path at --fast scale (24 modules, 8 cells,
    2.5 ns grid, regions=8) on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population

    cfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=24, n_cells=8)
    pop_cpu = sample_population(torch.Generator().manual_seed(SEED), cfg,
                                device="cpu")
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        pop = pop_cpu.to(dev)
        ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=2.5,
                                         device=dev), regions=REGIONS,
                                device=dev)
        t0 = time.perf_counter()
        ctrl.profile(pop)
        red = ctrl.region_reductions(LEVELS)
        ratios = {lv: ctrl.region_table(lv).compression_ratio()
                  for lv in LEVELS}
        out[dev] = dict(ctrl=ctrl, pop=pop, red=red, ratios=ratios,
                        dense=ctrl.table.expand_regions())
        secs[dev] = time.perf_counter() - t0
    g, c = out["cuda"], out["cpu"]
    diff = int((g["dense"] != c["dense"]).any(-1).sum())
    flips = unexplained = 0
    if diff:
        spec = c["ctrl"].sweep_result.spec
        rg = g["ctrl"].engine.sweep(g["pop"], spec, regions=REGIONS)
        rc = c["ctrl"].engine.sweep(c["pop"], spec, regions=REGIONS)
        m, ch, bk, kc = c["pop"].cells.shape[:4]
        for op in Op:
            k = rc.index(op)
            flip = rg.ok_region[k] != rc.ok_region[k]
            mm = rc.margins[k].reshape(m, ch, bk, REGIONS, kc // REGIONS,
                                       *rc.margins[k].shape[1:])
            mmin = mm.amin(dim=(1, 4)).numpy()
            flips += int(flip.sum())
            unexplained += int((np.abs(mmin[flip]) > TOL).sum())
    # the system-side comparison replays the CPU controller's tables on
    # both devices
    g["ctrl"].table = c["ctrl"].table
    g["ctrl"].sweep_result = c["ctrl"].sweep_result
    sys_res = {}
    for dev in ("cuda", "cpu"):
        o = out[dev]
        t0 = time.perf_counter()
        sys_res[dev] = o["ctrl"].evaluate_region_system(o["pop"], n=1024,
                                                        levels=LEVELS)
        secs[dev] += time.perf_counter() - t0
    rel = 0.0
    for tc_, d in sys_res["cpu"]["per_temp"].items():
        for k, v in d.items():
            rel = max(rel, abs(sys_res["cuda"]["per_temp"][tc_][k] / v - 1))
    same_red = g["red"] == c["red"] and g["ratios"] == c["ratios"]
    print(f"cross-device region --fast (24 modules, 8 cells, 2.5 ns grid, "
          f"regions={REGIONS}): {diff} differing dense region rows, {flips} "
          f"pass/fail flips ({unexplained} unexplained); region_reductions "
          f"and ratios equal: {same_red} (ratios {c['ratios']}); "
          f"evaluate_region_system(n=1024) max rel gmean diff {rel:.3e}; "
          f"card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s")
    check(unexplained == 0, "card and CPU region choices differ beyond 2e-4")
    check(diff > 0 or same_red, "region reductions or ratios differ with "
                                "equal tables")
    check(rel <= 1e-5, f"card vs CPU region gmeans differ by {rel:.3e}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    try:
        card = card_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
              f"{torch.cuda.get_device_name(0)} ({card})")
        t0 = time.perf_counter()
        build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        for name in build.SOURCES:
            for line in build.log_path(name).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        env = main_path({})
        time_breakdown(env)
        k1 = kernel_margin_grid(env)
        thermal_path(env)
        thermal_breakdown(env)
        region_path(env)
        region_breakdown(env)
        k1.update(path_launches(env, "margin_grid"))
        k2 = kernel_replay(env)
        k3 = kernel_replay_banked(env)
        k4 = kernel_adaptive(env)
        k5 = kernel_replay_regioned(env)
        k6 = kernel_adaptive_regioned(env)
        del env
        torch.cuda.empty_cache()
        cross_device_thermal(cross_device())
        cross_device_region()
    except Exception:                       # report and fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [k1, k2, k3, *k4, k5, k6]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The redesigned kernels against the versions they replace, on one
NVIDIA card, and the selective scan's launch plans side by side.

    git archive <parent> src/repro_torch/kernels | tar -x -C .archive/parent
    python3 -m benchmarks.port_kernel_redesign --parent .archive/parent
    python3 -m benchmarks.port_kernel_redesign --plans

`--parent DIR` builds those of DIR's `replay/replay.cu`,
`replay/adaptive.cu`, `mamba_scan/mamba_scan.cu` and `rwkv6/wkv_bwd.cu`
whose source or headers (`*.cuh` beside it) differ from this
checkout's, with the same `nvcc` flags, calls both builds on the same
inputs through their C interfaces, and counts the output elements that
differ bit for bit.
DIR is the parent's kernels, or a variant of this checkout's (a build
whose scan takes a launch plan gets this checkout's plan; a replay
build whose C interface takes the tile's column count gets it, an
older one the per-bank flag), for an A/B of two designs in one run:

- replay_blocks at `chip_smoke.py`'s shapes: (a) module rows at both
  Fig. 4 shapes (70 cells x 8192 requests x the DDR3 and AL-DRAM 55C
  rows; x 4096 x the profiled table's 6 rows), (b) the per-bank tile
  of `evaluate_bank_system` (11 rows), (c) the region store and map of
  `evaluate_region_system` (26 rows, 8 regions), (d) the traffic shape
  (48 FR-FCFS-ordered cells x 8192 requests x 8 rows) on 2 and 4
  channels and faulted (24 lanes, 4 channels), (e) the static fault
  campaign (140 cells x 4096 x 66 lanes); lat, total and counters;
- adaptive_blocks at `chip_smoke.py`'s shapes: (a) module and (b)
  per-bank stacks of the profiled table at 70 cells x 4096 requests x 8
  lanes, (c) the regions=8 table's deployed stack, (d) each of the three
  under the `fault_bench` grid (72 lanes), raw temperatures and bins
  emitted;
- mamba_scan at every `chip_smoke.SCAN_SHAPES` entry: the final state
  (bitwise) and y (max abs; its sum order changed);
- wkv_bwd at every `chip_smoke.WKV_BWD_SHAPES` entry: each gradient's
  max abs against the plain version for both builds (a variant may sum
  in another order);

with each kernel's time, the two builds in turns (old, new, new, old):
the replay kernels and wkv_bwd by CUDA events around the C launch alone
(median of 5), mamba_scan by torch.profiler's device time (mean of 10
launches).

`--clocks` samples the SM clock and power while each kernel runs back
to back.  `--plans` times (device time) the selective scan under every team,
block and tile the kernel takes at the prefill and decode shapes of ds =
16 and ds = 8, the measurement `ops.SCAN_PLANS` rests on.  Results go to stdout and, with
`--out FILE`, to FILE as JSON.  Imports neither JAX nor the
reference package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def _events_ms(fn, reps: int = 5) -> float:
    import torch
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


def _device_ms(fn, kernel: str, reps: int = 10) -> float:
    """Mean device time of the CUDA kernel named `kernel` over `reps`
    calls of `fn`, from torch.profiler's kernel records (the call's host
    work left out: it is most of a decode step's wrapper time)."""
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
    total = sum(e.self_device_time_total for e in hits)
    count = sum(e.count for e in hits)
    return total / max(count, 1) / 1e3


PARENT_SOURCES = {"replay_blocks": "replay/replay.cu",
                  "adaptive_blocks": "replay/adaptive.cu",
                  "mamba_scan": "mamba_scan/mamba_scan.cu",
                  "wkv_bwd": "rwkv6/wkv_bwd.cu"}


def _source_bytes(root: Path, src: str) -> list:
    """A kernel source and the headers beside it, as bytes."""
    path = root / src
    return [path.read_bytes()] + [h.read_bytes() for h in
                                  sorted(path.parent.glob("*.cuh"))]


def _build_parent(parent: Path) -> dict:
    """Compile, with this checkout's flags, the parent's kernel sources
    that differ from this checkout's (with their headers)."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    root = parent / "src" / "repro_torch" / "kernels"
    here = ROOT / "src" / "repro_torch" / "kernels"
    for name, src in PARENT_SOURCES.items():
        if _source_bytes(root, src) == _source_bytes(here, src):
            print(f"{name}: the parent's source is this checkout's; not "
                  "compared")
            continue
        so = out_dir / f"{name}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                               str(so), str(root / src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {root / src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        libs[name] = ctypes.CDLL(str(so))
    if "replay_blocks" in libs:
        # since the lanes-per-block cap, both C interfaces end in an int
        # max_lanes before the stream
        lanes = "int max_lanes" in (root / "replay" / "replay.cu").read_text()
        libs["replay_blocks"].replay_launch.argtypes = \
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 \
            + [ctypes.c_float] + [ctypes.c_int] * lanes + [ctypes.c_void_p]
        libs["replay_blocks"].replay_launch.restype = ctypes.c_int
        # the C interface's 21st argument: the tile's column count, or
        # (the first kernel) a per-bank flag
        libs["replay_takes_cols"] = "int n_cols" in (
            root / "replay" / "replay.cu").read_text()
    if "adaptive_blocks" in libs:
        lanes = "int max_lanes" in (root / "replay" /
                                    "adaptive.cu").read_text()
        libs["adaptive_blocks"].adaptive_launch.argtypes = \
            [ctypes.c_void_p] * 22 + [ctypes.c_int] * (11 + lanes) \
            + [ctypes.c_void_p]
        libs["adaptive_blocks"].adaptive_launch.restype = ctypes.c_int
    if "mamba_scan" in libs:
        # the first kernel's C interface has no launch plan; a build
        # that takes one (int team, channels, steps) gets this checkout's
        src = (root / "mamba_scan" / "mamba_scan.cu").read_text()
        libs["scan_takes_plan"] = "int team" in src
        libs["mamba_scan"].mamba_scan_launch.argtypes = \
            [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * (7 if libs["scan_takes_plan"] else 4) \
            + [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
        libs["mamba_scan"].mamba_scan_launch.restype = ctypes.c_int
    if "wkv_bwd" in libs:
        libs["wkv_bwd"].wkv_bwd_launch.argtypes = [ctypes.c_void_p] * 18 \
            + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 15 \
            + [ctypes.c_void_p]
        libs["wkv_bwd"].wkv_bwd_launch.restype = ctypes.c_int
    return libs


# -------------------------------------------------------------- replay

def _replay_cases():
    """(label, inputs) at chip_smoke.py's replay shapes, on freshly
    profiled tables of the calibrated population: cells (closed,
    arrival, bank, row, is_write, valid), the kernel-layout timing tile,
    the region map, the fault tuple (tile, JEDEC column, uniforms), the
    channel geometry and the interleave codes."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from benchmarks import port_traffic_bench as B
    from repro_torch.core import faults, perf_model
    from repro_torch.core import timing as T
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.core.variation import sample_population
    from repro_torch.kernels.replay import ref

    dev = torch.device("cuda")
    pop = sample_population(torch.Generator().manual_seed(SEED),
                            CALIBRATED_VARIATION, device="cuda")
    ctrl = {r: ALDRAMController(Profiler(CALIBRATED_CONSTANTS,
                                         grid_step=1.25), regions=r,
                                device="cuda") for r in (1, cs.REGIONS)}
    for c in ctrl.values():
        c.profile(pop)
    sys_rows = ctrl[1].evaluate_system(pop, n=4096)["rows"]
    bank_rows = ctrl[1].evaluate_bank_system(pop, n=4096)["rows"]
    reg = ctrl[cs.REGIONS].evaluate_region_system(pop, n=4096,
                                                  levels=cs.LEVELS)
    none = dict(rmap=None, fault=None, chan=(1, 1, 5.0), codes=None)
    cases = []
    for label, n, rows in (
            ("(a) evaluate", 8192, T.stack_timing([T.DDR3_1600,
                                                   T.ALDRAM_55C_EVAL])),
            ("(a) evaluate_system", 4096, sys_rows)):
        cases.append((label, dict(cells=cs._campaign_cells(n),
                                  tile=torch.tensor(rows, device=dev)
                                  .T.contiguous(), **none)))
    cells = cs._campaign_cells(4096)
    cases.append(("(b) per-bank tile", dict(
        cells=cells, tile=ref.timing_tile(torch.tensor(bank_rows,
                                                       device=dev)),
        **none)))
    cases.append(("(c) region store", dict(
        cells=cells, tile=ref.timing_tile(torch.tensor(reg["rows"],
                                                       device=dev)),
        **(none | {"rmap": torch.tensor(reg["region_map"], device=dev)}))))

    # (d): chip_smoke.kernel_replay_multi's inputs
    n, _, n_rows = B.grid(False)
    rows = torch.tensor(B.timing_rows(n_rows), device=dev)
    traces = perf_model.tenant_spec(n=n, n_streams=16,
                                    seed=0).materialize("cuda")
    spec = SimSpec(traces=traces, timings=B.timing_rows(n_rows),
                   policies=B.policies(), n_channels=4)
    arrival, bank, row, is_write, valid, closed = SimEngine(
        device="cuda").reorder_streams(spec)
    t, p, _ = arrival.shape
    mcells = ref.to_cells(arrival, bank, row, is_write,
                          torch.tensor(valid, device=dev),
                          torch.tensor(closed, device=dev))
    codes = ref.cell_codes(torch.tensor(spec.ileave_codes, device=dev), t,
                           p, "cuda")
    fspec = faults.FaultSpec(scenarios=(
        faults.FaultScenario(),
        faults.FaultScenario(name="err", err_scale=0.8, err_free_red=0.0,
                             detect_frac=0.9, retry_ns=60.0),
        faults.FaultScenario(name="wd", err_scale=0.8, err_free_red=0.0,
                             detect_frac=1.0, wd_err_n=4, wd_probe=16,
                             wd_recover_n=2)), seed=SEED)
    for c in (2, 4):
        cases.append((f"(d) C={c}", dict(
            cells=mcells, tile=ref.timing_tile(rows),
            **(none | {"chan": (c, 1, 5.0), "codes": codes}))))
    cases.append(("(d) C=4 faulted", dict(
        cells=mcells,
        tile=ref.timing_tile(rows.repeat_interleave(len(fspec), dim=0)),
        rmap=None, fault=(
            ref.fault_tile(torch.tensor(fspec.pack(), device=dev)
                           .repeat(n_rows, 1)),
            rows[0].contiguous(),
            ref.cell_uniforms(cs._fault_uniforms(t, n), p)),
        chan=(4, 1, 5.0), codes=codes)))

    # (e): chip_smoke.kernel_replay_faulted's inputs
    env = {"sys_res": {"rows": sys_rows}, "ctrl": ctrl[1],
           "region_stack": ctrl[cs.REGIONS].table.safe_stack_regions()}
    kw = cs._fault_campaigns(env)["static"]
    tb, fs = kw["traces"], kw["faults"]
    t, n = tb.arrival.shape
    ecells = ref.to_cells(*(f[:, None].expand(t, 2, n) for f in tb),
                          torch.ones((t, n), dtype=torch.bool, device=dev),
                          torch.tensor([False, True], device=dev))
    erows = torch.tensor(np.asarray(kw["timings"]), device=dev)
    cases.append(("(e) faulted module rows", dict(
        cells=ecells,
        tile=ref.timing_tile(erows.repeat_interleave(len(fs), dim=0)),
        rmap=None, fault=(
            ref.fault_tile(torch.tensor(fs.pack(), device=dev)
                           .repeat(erows.shape[0], 1)),
            erows[-1].contiguous(),
            ref.cell_uniforms(cs._fault_uniforms(t, n), 2)),
        chan=(1, 1, 5.0), codes=None)))
    return cases


def _replay_outputs(c: dict):
    import torch
    from repro_torch.core import faults
    g, n = c["cells"][1].shape
    s = c["tile"].shape[-1]
    return {"lat": torch.empty((g, n, s), device="cuda"),
            "total": torch.empty((g, s), device="cuda"),
            "counters": (torch.zeros((faults.N_COUNTERS, g, s),
                                     dtype=torch.int32, device="cuda")
                         if c["fault"] is not None else None)}


def _default_lanes(fn, n_before: int) -> tuple:
    """The lanes-per-block argument (0: the kernel's default) where the
    C interface takes one: it has more than its `n_before` arguments."""
    return (0,) if len(fn.argtypes) > n_before else ()


def _replay_call(lib, takes_cols: bool, c: dict, out: dict):
    """One launch of `lib.replay_launch` on case `c` into `out`; the
    21st argument is the tile's column count (`takes_cols`) or the
    per-bank flag of the first interface."""
    import torch
    closed, arr, bank, row, wr, valid = c["cells"]
    g, n = arr.shape
    tile, rmap, fault = c["tile"], c["rmap"], c["fault"]
    n_ch, n_rk, t_burst = c["chan"]
    banked = tile.dim() == 3
    cols = (tile.shape[0] if takes_cols else 1) if banked else 0
    p = [x.data_ptr() for x in (closed, arr, bank, row, wr, valid, tile)]
    rc = lib.replay_launch(
        *p, None if rmap is None else rmap.data_ptr(),
        *((fault[0].data_ptr(), fault[1].data_ptr(), fault[2].data_ptr())
          if fault else (None,) * 3),
        None if c["codes"] is None else c["codes"].data_ptr(),
        out["lat"].data_ptr(), out["total"].data_ptr(),
        None if out["counters"] is None else out["counters"].data_ptr(),
        g, n, tile.shape[-1], 8, 8, cols,
        0 if rmap is None else rmap.numel() // 8, 0, n_ch, n_rk, t_burst,
        *_default_lanes(lib.replay_launch, 27),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"replay_launch: cudaError {rc}")


def compare_replay(old_lib, old_takes_cols: bool) -> list:
    from repro_torch.kernels.replay import ops
    new_lib = ops._replay_lib()
    rows = []
    for label, c in _replay_cases():
        new, old = _replay_outputs(c), _replay_outputs(c)
        _replay_call(new_lib, True, c, new)
        _replay_call(old_lib, old_takes_cols, c, old)
        diff = {k: _n_differing(new[k], old[k]) for k in new
                if new[k] is not None}
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            lib, out, cols = ((old_lib, old, old_takes_cols) if who == "old"
                              else (new_lib, new, True))
            t[who].append(_events_ms(
                lambda: _replay_call(lib, cols, c, out)))
        g, n = c["cells"][1].shape
        row = {"case": label, "G": g, "N": n, "S": c["tile"].shape[-1],
               "elements": {k: new[k].numel() for k in diff},
               "differing": diff, "old_ms": t["old"], "new_ms": t["new"]}
        print(f"replay_blocks {label} G={g} N={n} S={row['S']}: "
              f"{sum(diff.values())} of {sum(row['elements'].values())} "
              f"output elements differ from the previous kernel "
              f"({json.dumps(diff)}); previous {t['old'][0]:.3f} / "
              f"{t['old'][1]:.3f} ms, new {t['new'][0]:.3f} / "
              f"{t['new'][1]:.3f} ms")
        rows.append(row)
    return rows


# ------------------------------------------------------------ adaptive

def _adaptive_cases():
    """(label, ops.adaptive_blocks arguments) at chip_smoke.py's shapes,
    on a freshly profiled table of the calibrated population."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from benchmarks import port_fault_bench
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import ALDRAMController, default_scenarios
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.variation import sample_population
    from repro_torch.kernels.replay import ref

    dev = torch.device("cuda")
    pop = sample_population(torch.Generator().manual_seed(SEED),
                            CALIBRATED_VARIATION, device="cuda")
    tables = {}
    for regions in (1, cs.REGIONS):
        ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS,
                                         grid_step=1.25),
                                regions=regions, device="cuda")
        tables[regions] = ctrl.profile(pop)
    n = 4096
    cells = cs._campaign_cells(n)
    g = cells[1].shape[0]
    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    scn_t = torch.tensor(TH.stack_scenarios(scns).T.copy(), device=dev)
    tcfg = torch.tensor(TH.ThermalConfig().as_row(), device=dev)
    rows_u, edges_u, idx = tables[cs.REGIONS].safe_stack_regions()
    stacks = {"module": tables[1].safe_stack() + (None,),
              "bank": tables[1].safe_stack_banks() + (None,),
              "region": (rows_u, edges_u, idx.reshape(-1))}
    cases = []
    for (name, (rows, edges, rmap)), var in zip(stacks.items(), "abc"):
        tile = ref.table_tile(ref.lane_tables(
            torch.tensor(rows, device=dev)[None], len(scns)))
        cases.append((f"({var}) {name}", dict(
            cells=cells, tile=tile, scn_t=scn_t,
            bins=torch.tensor(edges, device=dev), tcfg=tcfg,
            rmap=None if rmap is None else torch.tensor(rmap, device=dev),
            fault=None)))
    traces = perf_model.trace_batch(n, SEED, device="cuda")
    fspec, _ = port_fault_bench._fault_grid(False,
                                            float(traces.arrival[0, -1]))
    nf = len(fspec)
    u = cs._fault_uniforms(g, n)
    ftile = ref.fault_tile(ref.lane_faults(
        torch.tensor(fspec.pack(), device=dev), len(scns)))
    for name, (rows, edges, rmap) in stacks.items():
        tile = ref.table_tile(ref.lane_tables(
            torch.tensor(np.asarray(rows), device=dev)[None],
            len(scns) * nf))
        cases.append((f"(d) {name}", dict(
            cells=cells, tile=tile,
            scn_t=ref.lane_scenarios(torch.tensor(
                TH.stack_scenarios(scns), device=dev), 1,
                nf).T.contiguous(),
            bins=torch.tensor(edges, device=dev), tcfg=tcfg,
            rmap=None if rmap is None else torch.tensor(rmap, device=dev),
            fault=(ftile, u))))
    return cases


def _adaptive_outputs(c: dict):
    import torch
    from repro_torch.core import faults
    g, n = c["cells"][1].shape
    lanes = c["tile"].shape[-1]
    nb = 8
    f32 = dict(dtype=torch.float32, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    return {"lat": torch.empty((g, n, lanes), **f32),
            "total": torch.empty((g, lanes), **f32),
            "temp_max": torch.empty((g, lanes), **f32),
            "temp_mean": torch.empty((g, lanes), **f32),
            "switches": torch.empty((g, lanes), **i32),
            "heat": torch.empty((g, nb, lanes), **f32),
            "temps": torch.empty((g, n, lanes), **f32),
            "bins": torch.empty((g, n, lanes), **i32),
            "counters": (torch.empty((faults.N_COUNTERS, g, lanes), **i32)
                         if c["fault"] is not None else None)}


def _adaptive_call(lib, c: dict, out: dict):
    """One launch of `lib.adaptive_launch` (the interface both builds
    share) on case `c` into `out`."""
    import torch
    closed, arr, bank, row, wr, valid = c["cells"]
    g, n = arr.shape
    tile, rmap, fault = c["tile"], c["rmap"], c["fault"]
    lanes = tile.shape[-1]
    banked = tile.dim() == 4
    s = c["bins"].shape[0]
    p = [x.data_ptr() for x in (closed, arr, bank, row, wr, valid, tile)]
    rc = lib.adaptive_launch(
        *p, None if rmap is None else rmap.data_ptr(), c["scn_t"].data_ptr(),
        c["bins"].data_ptr(), c["tcfg"].data_ptr(),
        *((fault[0].data_ptr(), fault[1].data_ptr()) if fault
          else (None, None)),
        *(None if v is None else v.data_ptr() for v in out.values()),
        g, n, lanes, s, s + 1, 8, 8, int(banked),
        0 if rmap is None else rmap.numel() // 8, 0, 1,
        *_default_lanes(lib.adaptive_launch, 34),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adaptive_launch: cudaError {rc}")


def compare_adaptive(old_lib) -> list:
    from repro_torch.kernels.replay import ops
    new_lib = ops._adaptive_lib()
    rows = []
    for label, c in _adaptive_cases():
        new, old = _adaptive_outputs(c), _adaptive_outputs(c)
        _adaptive_call(new_lib, c, new)
        _adaptive_call(old_lib, c, old)
        diff = {k: _n_differing(new[k], old[k]) for k in new
                if new[k] is not None}
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            lib, out = (old_lib, old) if who == "old" else (new_lib, new)
            t[who].append(_events_ms(lambda: _adaptive_call(lib, c, out)))
        row = {"case": label, "shape": list(c["tile"].shape),
               "elements": {k: new[k].numel() for k in diff},
               "differing": diff, "old_ms": t["old"], "new_ms": t["new"]}
        print(f"adaptive_blocks {label} G={c['cells'][1].shape[0]} "
              f"N={c['cells'][1].shape[1]} L={c['tile'].shape[-1]}: "
              f"{sum(diff.values())} of {sum(row['elements'].values())} "
              f"output elements differ from the previous kernel "
              f"({json.dumps(diff)}); previous {t['old'][0]:.3f} / "
              f"{t['old'][1]:.3f} ms, new {t['new'][0]:.3f} / "
              f"{t['new'][1]:.3f} ms")
        rows.append(row)
    return rows


def _n_differing(a, b) -> int:
    """Elements of a and b that differ bit for bit."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


# --------------------------------------------------------------- mamba

def _scan_inputs(shape, seed):
    """chip_smoke.py's phase-16 inputs."""
    import torch
    b, t, di, ds, with_state = shape
    g = torch.Generator("cuda").manual_seed(seed)

    def n(*shp):
        return torch.randn(shp, generator=g, device="cuda")
    return (0.5 * n(b, t, di), torch.nn.functional.softplus(n(b, t, di) - 1.0),
            0.5 * n(b, t, ds), 0.5 * n(b, t, ds), -torch.exp(0.3 * n(di, ds)),
            0.5 * n(b, di, ds) if with_state else None)


def _old_scan(lib, takes_plan, x, dt, bm, cm, a, h0):
    import torch
    from repro_torch.kernels.mamba_scan import ops
    b, t, di = x.shape
    ds = bm.shape[-1]
    y = torch.empty((b, t, di), device="cuda")
    h = torch.empty((b, di, ds), device="cuda")
    strides = [s for z in (x, dt, bm, cm, y) for s in z.stride()[:2]]
    plan = ops.scan_plan(t, ds)
    rc = lib.mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        a.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), b, t, di, ds,
        *((plan.team, plan.channels, plan.steps) if takes_plan else ()),
        *strides, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_launch: cudaError {rc}")
    return y, h


def compare_mamba(old_lib, takes_plan: bool) -> list:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.mamba_scan import ops
    rows = []
    for i, (label, shape) in enumerate(cs.SCAN_SHAPES.items()):
        ins = _scan_inputs(shape, SEED + i)
        y1, h1 = ops.mamba_scan(*ins[:5], h0=ins[5])
        y0, h0 = _old_scan(old_lib, takes_plan, *ins)
        n_h = _n_differing(h1, h0)
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = ((lambda: _old_scan(old_lib, takes_plan, *ins))
                  if who == "old"
                  else (lambda: ops.mamba_scan(*ins[:5], h0=ins[5])))
            t[who].append(_device_ms(fn, "mamba_scan_kernel"))
        row = {"shape": label, "dims": list(shape[:4]),
               "state_elements": h1.numel(), "state_differing": n_h,
               "y_max_abs": float((y1 - y0).abs().max()),
               "plan": ops.scan_plan(shape[1], shape[3]).__dict__,
               "old_ms": t["old"], "new_ms": t["new"]}
        print(f"mamba_scan {label} {shape[:4]}: {n_h} of {h1.numel()} "
              f"final-state elements differ from the previous kernel, y "
              f"max abs {row['y_max_abs']:.3e}; previous {t['old'][0]:.4f}"
              f" / {t['old'][1]:.4f} ms, new {t['new'][0]:.4f} / "
              f"{t['new'][1]:.4f} ms (plan {row['plan']})")
        rows.append(row)
        del ins, y1, h1, y0, h0
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------- wkv_bwd

def _wkv_bwd_inputs(shape, seed):
    """chip_smoke.py's phase-18 inputs and the forward kernel's chunk
    states and final state."""
    import torch
    from repro_torch.kernels.rwkv6 import ops
    b, t, h, d, with_state = shape
    g = torch.Generator("cuda").manual_seed(seed)

    def n(*shp):
        return torch.randn(shp, generator=g, device="cuda")
    r, k, v = (0.5 * n(b, t, h, d) for _ in range(3))
    w = -torch.exp(n(b, t, h, d) - 2.0)
    ins = (r, k, v, w, 0.3 * n(h, d),
           0.5 * n(b, h, d, d) if with_state else None, n(b, t, h, d),
           n(b, h, d, d) if with_state else None)
    _, s_out, chunks = ops._forward(*ins[:6])
    return ins, chunks, s_out


def _wkv_bwd_call(lib, ins, chunks, s_out):
    """One call of a backward build through its C interface: (dr, dk,
    dv, dw_log, du, the initial state's gradient or None)."""
    import torch
    r, k, v, w, u, s0, d_o, d_s = ins
    b, t, h, d = r.shape
    nc = chunks.shape[0]

    def empty(*shape):
        return torch.empty(shape, device="cuda")
    outs = [empty(b, t, h, d) for _ in range(4)] + [empty(h, d)]
    ds = empty(b, h, d, d) if s0 is not None else None
    strides = [x for z in (r, k, v, w, d_o) for x in z.stride()[:3]]
    ptr = (lambda x: None if x is None else x.data_ptr())
    scratch = [empty(nc, b, h, d), empty(nc, b, h, d, d), empty(nc, b, h, d)]
    args = [ptr(x) for x in (r, k, v, w, d_o, u, chunks,
                             s_out if d_s is not None else None, d_s,
                             *outs[:4])]
    args += [scratch[0].data_ptr(), outs[4].data_ptr(), ptr(ds),
             scratch[1].data_ptr(), scratch[2].data_ptr()]
    rc = lib.wkv_bwd_launch(*args, b, t, h, d, *strides,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv_bwd_launch: cudaError {rc}")
    return (*outs, ds)


def compare_wkv_bwd(old_lib) -> list:
    """Both builds against the plain version (`ref.wkv_backward`) and
    each other at every `chip_smoke.WKV_BWD_SHAPES` shape, and both
    timed in turns (CUDA events around the C launch, median of 5); at
    the first shape each build's device time by CUDA kernel
    (torch.profiler, mean of 10 calls)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.rwkv6 import ops, ref
    rows = []
    names = ("r", "k", "v", "w_log", "u", "state")
    for i, (label, shape) in enumerate(cs.WKV_BWD_SHAPES.items()):
        ins, chunks, s_out = _wkv_bwd_inputs(shape, cs.SEED + 40 + i)
        new = ops.wkv_backward(*ins[:5], chunks, ins[6], ins[7],
                               need_state=ins[5] is not None, s_out=s_out)
        old = _wkv_bwd_call(old_lib, ins, chunks, s_out)
        want = ref.wkv_backward(*ins[:5], ins[6], state=ins[5],
                                d_state=ins[7])

        def err(a, b):
            return {f"d{nm}": float((x - y).abs().max())
                    for nm, x, y in zip(names, a, b) if y is not None}
        t = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = ((lambda: _wkv_bwd_call(old_lib, ins, chunks, s_out))
                  if who == "old" else (lambda: ops.wkv_backward(
                      *ins[:5], chunks, ins[6], ins[7],
                      need_state=ins[5] is not None, s_out=s_out)))
            t[who].append(_events_ms(fn))
        row = {"shape": label, "dims": list(shape[:4]),
               "new_vs_plain": err(new, want), "old_vs_plain": err(old, want),
               "new_vs_old": err(new, old), "old_ms": t["old"],
               "new_ms": t["new"]}
        if i == 0:                     # device time by CUDA kernel
            row["new_pass_ms"] = {p: _device_ms(lambda: ops.wkv_backward(
                *ins[:5], chunks, ins[6], ins[7], s_out=s_out), p)
                for p in cs.WKV_BWD_PASSES}
            row["old_pass_ms"] = {p: _device_ms(lambda: _wkv_bwd_call(
                old_lib, ins, chunks, s_out), p) for p in cs.WKV_BWD_PASSES}
            print(f"  device ms by CUDA kernel: new "
                  f"{json.dumps(row['new_pass_ms'])}, previous "
                  f"{json.dumps(row['old_pass_ms'])}")
        print(f"wkv_bwd {label} {shape[:4]}: max abs against the plain "
              f"version new {json.dumps(row['new_vs_plain'])}, previous "
              f"{json.dumps(row['old_vs_plain'])}; previous "
              f"{t['old'][0]:.4f} / {t['old'][1]:.4f} ms, new "
              f"{t['new'][0]:.4f} / {t['new'][1]:.4f} ms")
        rows.append(row)
        del ins, chunks, s_out, new, old, want
        torch.cuda.empty_cache()
    return rows


def sweep_plans() -> list:
    """Every team x block x tile at the prefill and decode shapes."""
    import torch
    from repro_torch.kernels.mamba_scan import ops
    shapes = {"prefill ds16": (1, 4096, 16384, 16, False),
              "decode ds16": (2, 1, 16384, 16, True),
              "prefill ds8": (2, 1300, 1000, 8, False),
              "decode ds8": (2, 1, 1000, 8, True)}
    rows = []
    for label, shape in shapes.items():
        ins = _scan_inputs(shape, SEED)
        ds, t = shape[3], shape[1]
        y_ref, h_ref = ops.mamba_scan(*ins[:5], h0=ins[5])
        for team in ops.TEAMS[ds]:
            for threads in (64, 128, 256, 512):
                for steps in ((1,) if t == 1 else (16, 32, 64, 128)):
                    plan = ops.ScanPlan(team, threads // team, steps)
                    try:
                        ops.check_plan(plan, ds)
                    except ValueError:
                        continue
                    fn = (lambda: ops.mamba_scan(*ins[:5], h0=ins[5],
                                                 plan=plan))
                    y, h = fn()
                    same = bool(torch.equal(h.view(torch.int32),
                                            h_ref.view(torch.int32)))
                    ms = _device_ms(fn, "mamba_scan_kernel")
                    rows.append({"shape": label, "team": team,
                                 "channels": plan.channels, "steps": steps,
                                 "ms": ms, "state_bitwise": same})
                    print(f"plan {label} P={team} channels={plan.channels} "
                          f"steps={steps}: {ms:.4f} ms (state bitwise "
                          f"{same})")
        best = min((r for r in rows if r["shape"] == label),
                   key=lambda r: r["ms"])
        print(f"plan {label}: fastest {json.dumps(best)}; planned "
              f"{ops.scan_plan(t, ds)}")
    return rows


def sample_clocks(seconds: float = 3.0) -> list:
    """The SM clock and power while each redesigned kernel runs back to
    back for `seconds` at its chip_smoke shape (nvidia-smi every 100 ms):
    whether the 1,980 MHz the chain bounds assume holds under load."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.replay import ops as rops
    cases = {"mamba_scan prefill": _scan_inputs(
        cs.SCAN_SHAPES["jamba 4096"], SEED)}
    adaptive = dict(_adaptive_cases())
    rows = []
    for label in ("mamba_scan prefill", "(a) module", "(d) module"):
        if label in cases:
            ins = cases[label]
            fn = (lambda: ops.mamba_scan(*ins[:5], h0=ins[5]))
        else:
            c = adaptive[label]
            out = _adaptive_outputs(c)
            fn = (lambda: _adaptive_call(rops._adaptive_lib(), c, out))
        fn()
        torch.cuda.synchronize()
        smi = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        t0 = __import__("time").perf_counter()
        while __import__("time").perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        smi.terminate()
        text, _ = smi.communicate()
        pts = [tuple(float(v) for v in ln.split(",")) for ln in
               text.strip().splitlines() if ln.count(",") == 1]
        mhz = sorted(p[0] for p in pts)
        row = {"kernel": label, "samples": len(pts),
               "sm_mhz_median": statistics.median(mhz) if mhz else None,
               "sm_mhz_min": mhz[0] if mhz else None,
               "power_w_max": max(p[1] for p in pts) if pts else None}
        print(f"clocks under {label}: {json.dumps(row)}")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="checkout whose kernels to compare with")
    ap.add_argument("--plans", action="store_true",
                    help="time every selective-scan launch plan")
    ap.add_argument("--clocks", action="store_true",
                    help="sample the SM clock while the kernels run")
    ap.add_argument("--out", type=Path,
                    help="write the results as JSON to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_redesign: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    res = {"card": card}
    if args.parent is not None:
        libs = _build_parent(args.parent.resolve())
        if "replay_blocks" in libs:
            res["replay"] = compare_replay(libs["replay_blocks"],
                                           libs["replay_takes_cols"])
        if "adaptive_blocks" in libs:
            res["adaptive"] = compare_adaptive(libs["adaptive_blocks"])
        if "mamba_scan" in libs:
            res["mamba"] = compare_mamba(libs["mamba_scan"],
                                         libs["scan_takes_plan"])
        if "wkv_bwd" in libs:
            res["wkv_bwd"] = compare_wkv_bwd(libs["wkv_bwd"])
    if args.plans:
        res["plans"] = sweep_plans()
    if args.clocks:
        res["clocks"] = sample_clocks()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

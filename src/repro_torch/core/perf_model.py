"""Real-system evaluation model (paper Sec. 6, Fig. 4), port of the
static part of `repro.core.perf_model`.

35 workloads (SPEC-like, STREAM, GUPS-like), each characterised by
(MPKI, row-buffer hit rate, write fraction, memory-level parallelism).
A miss-overlap CPU model converts the replayed average DRAM latency
into CPI:

    CPI = CPI_exe + (MPKI/1000) * lat_mem * (1 - overlap)

Single-core runs replay each workload's trace alone; multi-core runs
model four instances sharing the channel (less row locality, four times
the arrival pressure).  AL-DRAM's speedup comes ONLY from swapping the
timing rows.  `evaluate_many` replays the whole 70-trace pool under any
number of timing rows in ONE `SimEngine` launch; the traces are drawn on
the host from `torch.Generator`s (one per trace, seeded from `seed` and
the trace's pool offset) and moved to the engine's device.  `synth_spec`
is the same pool as a declarative trace axis, which the engine replays
through its cached materialization (`synth_dispatch_count` counts each
batch drawn: one per `trace_batch`, one per first `materialize`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core import dram_sim
from repro_torch.core import thermal as TH
from repro_torch.core import timing as T
from repro_torch.core.sim_engine import SimEngine, SimResult, SimSpec
from repro_torch.core.timing import ALDRAM_55C_EVAL, DDR3_1600, TimingParams


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    mpki: float
    row_hit: float
    write_frac: float
    overlap: float = 0.50       # memory-level parallelism factor
    cpi_exe: float = 0.7
    intensive: bool = True


# The paper's pool: SPEC CPU2006 + STREAM variants + GUPS (35 workloads).
WORKLOADS: list[Workload] = [
    # memory-intensive (MPKI >= 10 per the paper's classification)
    Workload("mcf", 67.7, 0.45, 0.25),
    Workload("lbm", 31.9, 0.70, 0.40),
    Workload("milc", 25.8, 0.55, 0.25),
    Workload("libquantum", 25.4, 0.90, 0.15),
    Workload("soplex", 26.8, 0.55, 0.25),
    Workload("gems", 24.9, 0.50, 0.30),
    Workload("omnetpp", 21.6, 0.40, 0.30),
    Workload("leslie3d", 20.9, 0.65, 0.30),
    Workload("bwaves", 18.7, 0.70, 0.25),
    Workload("sphinx3", 17.1, 0.60, 0.20),
    Workload("zeusmp", 4.9, 0.60, 0.30),
    Workload("cactusADM", 5.3, 0.55, 0.35),
    Workload("xalancbmk", 23.9, 0.45, 0.25),
    Workload("astar", 10.2, 0.45, 0.30),
    Workload("wrf", 8.1, 0.65, 0.30),
    # STREAM kernels (very memory-bandwidth-intensive)
    Workload("s.copy", 52.0, 0.88, 0.50, overlap=0.45),
    Workload("s.scale", 51.0, 0.88, 0.50, overlap=0.45),
    Workload("s.add", 55.0, 0.90, 0.34, overlap=0.45),
    Workload("s.triad", 56.0, 0.90, 0.34, overlap=0.45),
    # GUPS-like random access
    Workload("gups", 48.0, 0.10, 0.50, overlap=0.50),
    # non-intensive
    Workload("perlbench", 2.0, 0.60, 0.25, intensive=False),
    Workload("bzip2", 3.6, 0.55, 0.30, intensive=False),
    Workload("gcc", 4.2, 0.55, 0.30, intensive=False),
    Workload("gobmk", 1.5, 0.50, 0.25, intensive=False),
    Workload("hmmer", 2.2, 0.75, 0.20, intensive=False),
    Workload("sjeng", 1.2, 0.45, 0.25, intensive=False),
    Workload("h264ref", 2.8, 0.70, 0.20, intensive=False),
    Workload("tonto", 1.3, 0.65, 0.25, intensive=False),
    Workload("namd", 1.0, 0.70, 0.20, intensive=False),
    Workload("dealII", 3.2, 0.65, 0.25, intensive=False),
    Workload("povray", 0.7, 0.60, 0.20, intensive=False),
    Workload("calculix", 2.6, 0.70, 0.25, intensive=False),
    Workload("gromacs", 1.8, 0.65, 0.25, intensive=False),
    Workload("sixtrack", 1.1, 0.70, 0.20, intensive=False),
    Workload("gamess", 0.8, 0.65, 0.20, intensive=False),
]

MODES = (False, True)           # single-core, multi-core


def _knobs(w: Workload, multi_core: bool) -> tuple[float, float, float]:
    """(row_hit, write_frac, inter_arrival_ns) of one workload trace.
    Multi-core: 4 instances share the channel — locality drops and
    arrival pressure quadruples."""
    row_hit = w.row_hit * (0.55 if multi_core else 1.0)
    inter = max(4.0, 400.0 / w.mpki) / (4.0 if multi_core else 1.0)
    return row_hit, w.write_frac, inter


def _pool_knobs():
    """(offsets, row_hits, write_fracs, inter_arrivals) of the full
    70-trace pool — single-core block then multi-core block, each in
    WORKLOADS order."""
    offs, rhs, wfs, ias = [], [], [], []
    for multi in MODES:
        for i, w in enumerate(WORKLOADS):
            rh, wf, ia = _knobs(w, multi)
            offs.append(i + (1000 if multi else 0))
            rhs.append(rh)
            wfs.append(wf)
            ias.append(ia)
    return offs, rhs, wfs, ias


def _synth_batch(n: int, seed: int, n_banks: int,
                 device: str | torch.device) -> dram_sim.Trace:
    """The whole 70-trace pool as one [70, n] batch on `device`: the
    rows of `synth_spec`, each drawn on the host from its own generator
    (seeded from `seed` and the trace's pool offset)."""
    return synth_spec(n, seed, n_banks).synth(device)


# counts synthesis launches the way SimEngine.dispatch_count counts
# replay launches: `trace_batch` and every first `materialize` of a
# declarative trace axis add one
synth_dispatch_count = 0


class _SynthScope:
    """Handle yielded by `synth_dispatch_scope`: `.count` is the number
    of synthesis launches since the scope opened (frozen at exit)."""

    def __init__(self, start: int):
        self._start = start
        self._end: int | None = None

    @property
    def count(self) -> int:
        cur = synth_dispatch_count if self._end is None else self._end
        return cur - self._start


@contextlib.contextmanager
def synth_dispatch_scope(reset: bool = False):
    """Scoped synthesis-launch accounting over the module-global
    `synth_dispatch_count`: yields a handle whose `.count` is the
    launches inside the scope; `reset=True` restores the global to its
    entry value on exit."""
    global synth_dispatch_count
    start = synth_dispatch_count
    scope = _SynthScope(start)
    try:
        yield scope
    finally:
        scope._end = synth_dispatch_count
        if reset:
            synth_dispatch_count = start


def trace_batch(n: int = 8192, seed: int = 0, n_banks: int = 8,
                device: str | torch.device = "cuda") -> dram_sim.Trace:
    """All 35 workloads x (single, multi) as one batched `Trace` with a
    [70, n] leading axis on `device` — rows ordered single-block then
    multi-block, each in WORKLOADS order.  One synthesis launch."""
    global synth_dispatch_count
    synth_dispatch_count += 1
    return _synth_batch(n, seed, n_banks, device)


def synth_spec(n: int = 8192, seed: int = 0,
               n_banks: int = 8) -> dram_sim.SynthSpec:
    """The declarative `trace_batch`: the same 70-trace pool as a
    `dram_sim.SynthSpec` (same knobs, same generator offsets, so the
    streams are bit for bit `trace_batch`'s).  Handed to a `SimSpec` as
    the trace axis, it is drawn once, on first use, and its cached
    materialization replayed by every later run."""
    offs, rhs, wfs, ias = _pool_knobs()
    return dram_sim.SynthSpec(n=n, offsets=tuple(offs), row_hits=tuple(rhs),
                              write_fracs=tuple(wfs),
                              inter_arrivals=tuple(ias), seed=seed,
                              n_banks=n_banks)


def tenant_spec(n: int = 8192, n_streams: int = 8, seed: int = 0,
                n_banks: int = 8,
                kinds=("poisson", "bursty", "diurnal")
                ) -> dram_sim.TenantSpec:
    """Multi-tenant traffic over the same workload pool: the 70 pool
    entries become tenants with the knobs of `_pool_knobs` and an
    arrival-rate process cycled from `kinds` (`thermal.rate_scenario`);
    every stream is a Dirichlet tenant mix (alpha 0.15: a few dominant
    tenants, the rest background) drawn from `np.random.default_rng(
    seed)` exactly as the reference draws it, so the mixes are bitwise
    the reference's (the streams `TenantSpec.materialize` draws are the
    port's own)."""
    offs, rhs, wfs, ias = _pool_knobs()
    k = len(rhs)
    r = np.random.default_rng(seed)
    mixes = r.dirichlet(np.full(k, 0.15), size=n_streams)
    return dram_sim.TenantSpec(
        n=n, mixes=tuple(tuple(m) for m in mixes),
        row_hits=tuple(rhs), write_fracs=tuple(wfs),
        inter_arrivals=tuple(ias),
        arrivals=tuple(kinds[i % len(kinds)] for i in range(k)),
        seed=seed, n_banks=n_banks)


def evaluate_many(timings, n: int = 8192, seed: int = 0,
                  engine: SimEngine | None = None,
                  policies: tuple[dram_sim.Policy, ...] = (dram_sim.OPEN_FCFS,),
                  n_banks: int = 8, traces: dram_sim.Trace | None = None,
                  device: str | torch.device = "cuda",
                  region_map=None) -> dict:
    """Replay the workload pool under [S, 6] stacked timing rows (and
    policies) in ONE replay launch on the engine's device (a new
    `SimEngine(device=device)` when none is given).  `timings` may also
    be a per-bank [S, banks, 6] stack or, with `region_map` (the
    `SimSpec.region_map` contract), the [S, U, 6] unique-row store.
    `traces` replaces the synthesized pool with a given [70, N] batch.

    Returns mean latencies as [modes(2), workloads(35), P, S] plus the
    raw `SimResult` (trace axis = mode-major flattening)."""
    engine = engine or SimEngine(device=device)
    if traces is None:
        traces = trace_batch(n, seed, n_banks, device=engine.device)
    res = engine.run(SimSpec(traces=traces, timings=timings,
                             policies=policies, n_banks=n_banks,
                             region_map=region_map))
    nw = len(WORKLOADS)
    grid = res.mean_latency_ns.reshape((len(MODES), nw)
                                       + res.mean_latency_ns.shape[1:])
    return {"result": res, "mean_latency_ns": grid,
            "workloads": [w.name for w in WORKLOADS]}


def evaluate_adaptive(table, bins, scenarios, config=None, n: int = 4096,
                      seed: int = 0, engine: SimEngine | None = None,
                      policies: tuple[dram_sim.Policy, ...] =
                      (dram_sim.OPEN_FCFS,), n_banks: int = 8,
                      fused: bool = False,
                      traces: dram_sim.Trace | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """Closed-loop Fig. 4: replay the workload pool with in-replay
    temperature-bin selection under every thermal scenario, and price
    it against the two bracketing deployments:

      * static-worst-case — ONE register set provisioned for the
        scenario's peak sensed temperature plus the hysteresis margin
        (what a non-adaptive AL-DRAM deployment must ship),
      * oracle — the zero-hysteresis adaptive controller (the upper
        bound; the gap to it is the cost of thrash protection).

    `table`: [bins+1, 6] stacked rows, JEDEC fallback LAST
    (`aldram.TimingTable.safe_stack`), or the per-bank stack
    [bins+1, banks, 6] (`safe_stack_banks`: the selection then gathers
    row (bin, request's bank)); `bins`: ascending bin edges;
    `scenarios`: `thermal.ThermalScenario`s; `config`:
    `thermal.ThermalConfig`.  `traces` replaces the synthesized pool
    with a given [70, N] batch.

    Two replay launches on the engine's device whatever the number of
    scenarios and policies: the adaptive one (scenarios and their
    oracle variants share the lane axis) and the static one (the JEDEC
    baseline and every scenario's worst-case row share the timing
    axis).  The two-launch path rounds the peaks up on the host between
    them; `fused=True` runs `SimEngine.run_bracket`, which rounds them
    up on the device with no host round trip — the same evaluation to
    device-stats tolerance in one replay dispatch, against two unfused;
    either draws the pool once.
    Speedups are CPI-model speedups vs the JEDEC baseline, shaped
    [modes, workloads, P, C]."""
    engine = engine or SimEngine(device=device)
    config = config or TH.ThermalConfig()
    scenarios = tuple(scenarios)
    table = np.asarray(table, np.float32)
    if table.ndim not in (2, 3):
        raise ValueError("evaluate_adaptive takes ONE table stack ([S+1, "
                         f"6] or per-bank [S+1, banks, 6]), got "
                         f"{table.shape}")
    bins = tuple(float(b) for b in bins)
    nc = len(scenarios)
    if traces is None:
        traces = trace_batch(n, seed, n_banks, device=engine.device)
    tspec = TH.ThermalSpec(
        scenarios=scenarios + tuple(s.oracle() for s in scenarios),
        temp_bins=bins, config=config)
    spec = SimSpec(traces=traces, timings=table[None], policies=policies,
                   thermal=tspec, n_banks=n_banks)
    # The static-worst-case row is provisioned for the peak measured on
    # the ADAPTIVE trajectory, which understates a static deployment's
    # own self-heating, so the hysteresis margin is added before
    # rounding up: worst_bin then lies above every bin the adaptive
    # replay selected and adaptive >= static-worst holds structurally.
    if fused:
        br = engine.run_bracket(spec, base_row=DDR3_1600.as_row(),
                                n_real=nc)
        a = br["adaptive"]
        res_a = SimResult(spec=spec, mean_latency_ns=a["mean"],
                          p99_latency_ns=a["p99"], total_ns=a["total"],
                          valid=br["valid"], temp_max=a["temp_max"],
                          temp_mean=a["temp_mean"],
                          bin_switches=a["bin_switches"],
                          bank_heat=a["bank_heat"])
        peak, worst_bin = br["temp_peak"], br["worst_bin"]
        lat_s = br["static"]["mean"]                 # [T, P, 1+C]
    else:
        res_a = engine.run(spec)
        peak = res_a.temp_max[:, :, 0, :nc].max(axis=(0, 1))    # [C]
        worst_bin = np.searchsorted(np.asarray(bins),
                                    peak + np.float32(config.hyst_c),
                                    side="left")
        base = np.broadcast_to(DDR3_1600.as_row(), table.shape[1:])
        rows = np.concatenate([base[None], table[worst_bin]], axis=0)
        res_s = engine.run(SimSpec(traces=traces, timings=rows,
                                   policies=policies, n_banks=n_banks))
        lat_s = res_s.mean_latency_ns                # [T, P, 1+C]
    lat_a = res_a.mean_latency_ns[:, :, 0, :]        # [T, P, 2C]

    # one CPI pass: [base | static-worst | adaptive | oracle] columns
    lat = np.concatenate([lat_s, lat_a], axis=-1)
    nw = len(WORKLOADS)
    grid = lat.reshape((len(MODES), nw) + lat.shape[1:])
    sp = cpi_speedups(grid)                          # [2, W, P, 1+3C]
    out = {
        "scenarios": [s.name for s in scenarios],
        "bins": bins, "table": table, "worst_bin": worst_bin,
        "temp_peak": peak,
        "static_worst": sp[..., 1:1 + nc],
        "adaptive": sp[..., 1 + nc:1 + 2 * nc],
        "oracle": sp[..., 1 + 2 * nc:],
        "mean_latency_ns": grid, "result": res_a,
        "workloads": [w.name for w in WORKLOADS],
    }
    # multi-core gmean summaries for every policy; `per_scenario` is
    # the first policy's view
    switches = res_a.bin_switches[:, :, 0, :nc]
    per_policy = []
    for pi in range(len(policies)):
        per = {}
        for ci, s in enumerate(scenarios):
            per[s.name] = {
                "adaptive_gmean":
                    gmean_speedup(out["adaptive"][1, :, pi, ci]),
                "static_worst_gmean":
                    gmean_speedup(out["static_worst"][1, :, pi, ci]),
                "oracle_gmean":
                    gmean_speedup(out["oracle"][1, :, pi, ci]),
                "worst_bin": (float(bins[worst_bin[ci]])
                              if worst_bin[ci] < len(bins) else None),
                "temp_peak": float(peak[ci]),
                "mean_bin_switches": float(switches[:, pi, ci].mean()),
            }
        per_policy.append(per)
    out["per_scenario"] = per_policy[0]
    out["per_policy"] = per_policy
    return out


def cpi_speedups(mean_lat_ns: np.ndarray) -> np.ndarray:
    """CPI speedup of every timing row vs row 0 (the standard-timing
    baseline): [modes, workloads, P, S] latencies -> same-shape
    speedups (column 0 is identically 0)."""
    mpki = np.array([w.mpki for w in WORKLOADS])[None, :, None, None]
    ov = np.array([w.overlap for w in WORKLOADS])[None, :, None, None]
    ce = np.array([w.cpi_exe for w in WORKLOADS])[None, :, None, None]
    cpi = ce + mpki / 1000.0 * mean_lat_ns.astype(np.float64) * (1 - ov)
    return cpi[..., :1] / cpi - 1.0


def gmean_speedup(vals) -> float:
    return float(np.exp(np.mean(np.log1p(list(vals)))) - 1.0)


def evaluate(std: TimingParams = DDR3_1600,
             fast: TimingParams = ALDRAM_55C_EVAL,
             n: int = 8192, seed: int = 0,
             engine: SimEngine | None = None,
             device: str | torch.device = "cuda",
             traces: dram_sim.Trace | None = None) -> dict:
    """Fig. 4's aggregate numbers — all 35 workloads, both core modes
    and both timing sets in ONE replay launch.  `traces` replaces the
    synthesized pool with a given [70, N] batch."""
    engine = engine or SimEngine(device=device)
    d0 = engine.dispatch_count
    em = evaluate_many(T.stack_timing([std, fast]), n=n, seed=seed,
                       engine=engine, traces=traces)
    sp = cpi_speedups(em["mean_latency_ns"])         # [2, 35, 1, 2]
    out: dict = {"single": {}, "multi": {}}
    for mi, multi in enumerate(MODES):
        tag = "multi" if multi else "single"
        for i, w in enumerate(WORKLOADS):
            out[tag][w.name] = float(sp[mi, i, 0, 1])

    mi_ = [out["multi"][w.name] for w in WORKLOADS if w.intensive]
    mn = [out["multi"][w.name] for w in WORKLOADS if not w.intensive]
    out["summary"] = {
        "multi_intensive_gmean": gmean_speedup(mi_),
        "multi_nonintensive_gmean": gmean_speedup(mn),
        "multi_all_gmean": gmean_speedup(mi_ + mn),
        "single_intensive_gmean": gmean_speedup(
            [out["single"][w.name] for w in WORKLOADS if w.intensive]),
        "best_multi": max(out["multi"].items(), key=lambda kv: kv[1]),
    }
    out["dispatches"] = {"replay": engine.dispatch_count - d0}
    return out

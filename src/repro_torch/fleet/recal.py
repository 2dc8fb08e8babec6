"""The fleet recalibration service: drift-aware closed-loop serving
(port of `repro.fleet.recal`).

AL-DRAM as the paper evaluates it is one-shot: profile a module,
deploy its table, trust the 33-day stress test.  FLY-DRAM-style drift
(`repro_torch.fleet.drift`) breaks that trust — the tail cells that set the
guardband are exactly the ones that move — so a deployed fleet must
close the loop.  `FleetEngine` simulates that loop over a fleet-month,
one serving EPOCH at a time:

  1. drift advances at the epoch's ambient temperature
     (`thermal.ambient_at_host` over a `ThermalScenario`),
  2. heartbeat fault injection (`runtime.fault.HeartbeatMonitor`):
     failed modules stop beating, get declared dead, and drop out of
     serving and recalibration,
  3. the deployed per-(module, rank-bank) rows for the epoch's
     temperature bin are scrubbed against the DRIFTED population
     (`monitor.ErrorMonitor.probe`),
  4. the policy reacts:
       static   — never (deploy-and-forget: the paper's one-shot flow),
       periodic — a full `ALDRAMController.profile` of the drifted
                  population every `recal_period` epochs; modules whose
                  sampled recalibration time trips the
                  `runtime.straggler.StragglerDetector` fall back to
                  JEDEC rows until their install lands,
       error    — error-driven: `guardband.tighten_rows` on the
                  implicated rows, re-probing after EVERY step until
                  the zero-error invariant is restored (escalating to a
                  full re-profile, then to JEDEC fallback, if
                  tightening runs out of authority), and
                  `guardband.relax_rows` back toward the profiled floor
                  after a clean streak — deployed only if a fresh probe
                  confirms the relaxed rows are still error-free.
     Every deployment goes through `TimingTable.patch`, so the served
     table carries its full version lineage,
  5. the epoch's traffic is served: ONE `SimEngine` replay dispatch of
     the workload traces against [JEDEC + one per-module row-set]
     (the per-bank [1 + modules, banks, 6] timing axis), and the ECC
     event expectation (`monitor.ecc_events`) is charged against the
     rows that actually served.

With a `FleetSpec.faults` axis (`repro_torch.core.faults.FaultSpec`) the
serve dispatch itself carries in-scan fault injection: each module's
traffic replays under its envelope row with margin-conditioned
transient read errors — detected errors re-issue at the JEDEC row and
their retry price lands DIRECTLY in the served latency — and the
per-module detected-error counters become live telemetry that feeds
the error-driven policy exactly like scrub failures (a module whose
served traffic detected errors last epoch is implicated for
tightening this epoch, and any in-scan detection resets the
relaxation clean streak).  Undetected errors accumulate in the
`served_silent` counter — the corruption the closed loop exists to
bound.

The headline artifact is the errors-avoided vs latency-given-back
frontier across the three policies (`frontier`, plotted by
`benchmarks.fleet_bench`): static-forever keeps all of the profiled
latency but accumulates uncorrectable events; error-driven gives back
exactly the guardband steps drift demanded, serves ZERO uncorrectable
events (scrub-then-react runs before traffic, and `ecc_events` gates
uncorrectable probability to exact zero below two failing cells), and
dominates on EFFECTIVE latency once events are priced.

Dispatch accounting: serving is exactly ONE replay dispatch per epoch
(`SimEngine.dispatch_count`, pinned by `benchmarks.port_fleet_bench`);
probes and re-profiles ride the `MarginEngine` and are reported
separately.

On the port, `FleetEngine` runs on one `device` (default "cuda"): its
controller (every profile and scrub is a launch of the margin kernel)
and its `SimEngine` (every serve is a launch of the replay kernel: the
per-bank tile, the region store and map with `regions` > 1, the faulted
module rows with a fault axis).  The tables, the drift and the policy
logic are host numpy, as in the reference, and draw from the
reference's numpy Generators in the same order, so a fleet-month given
the reference's population, traces and error uniforms follows the
reference's trajectory.  `traces` (the [70, N] `trace_batch` pool) and
`fault_uniforms` ([T, N] error uniforms of the serve campaign) replace
the port's own draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import faults as fault_mod
from repro_torch.core import guardband
from repro_torch.core import timing as T
from repro_torch.core.aldram import (DEFAULT_TEMP_BINS, ALDRAMController,
                                     TimingTable)
from repro_torch.core.dram_sim import Trace
from repro_torch.core.perf_model import trace_batch
from repro_torch.core.profiler import Profiler
from repro_torch.core.sim_engine import SimEngine, SimSpec
from repro_torch.core.thermal import ThermalScenario, ambient_at_host
from repro_torch.core.variation import Population, VariationConfig
from repro_torch.device import resolve_device
from repro_torch.fleet.drift import DriftConfig, DriftModel
from repro_torch.fleet.monitor import (ECCConfig, ErrorMonitor, ecc_events,
                                       event_penalty_ns)
from repro_torch.runtime.compression import (compress_stack,
                                             decompress_rows)
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.runtime.straggler import ClusterModel, StragglerDetector

POLICIES = ("static", "periodic", "error")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """One fleet-month simulation campaign."""

    policy: str = "error"                    # static | periodic | error
    n_epochs: int = 30                       # serving epochs (days)
    days_per_epoch: float = 1.0
    temp_bins: tuple[float, ...] = DEFAULT_TEMP_BINS
    # subarray-region resolution of the deployed table (1 = per-bank).
    # regions > 1 deploys the mask-compressed
    # [U, 6] unique-row store + [banks * regions] index map per
    # module: scrubs probe per (bank, region), tighten/relax/patch
    # operate on UNIQUE rows (one tighten heals every region sharing
    # that row), and serving gathers through per-module index maps in
    # the same single replay dispatch.
    regions: int = 1
    # epoch ambient trajectory; None = constant `base_temp_c`.  The
    # scenario clock advances `ambient_step_ns` per epoch, so trace-
    # timescale scenarios (e.g. thermal.cooling_failure) compress onto
    # the fleet-month axis.
    ambient: ThermalScenario | None = None
    ambient_step_ns: float = 1.0e4
    base_temp_c: float = 48.0
    # serving traffic: rows of `perf_model.trace_batch` replayed each
    # epoch (one synthesis dispatch for the whole month)
    workload_rows: tuple[int, ...] = (0, 17, 19)
    n_requests: int = 1024
    seed: int = 0
    # policy knobs
    recal_period: int = 7                    # periodic: epochs per recal
    relax_after: int = 4                     # error: clean epochs before relax
    max_tighten_steps: int = 4               # error: steps before escalation
    # fault injection
    module_failures: tuple[tuple[int, int], ...] = ()   # (epoch, module)
    heartbeat_budget: float = 2.5            # missed beats before dead
    # in-scan fault axis on the SERVE dispatch (sensor faults are
    # adaptive-only; here the transient-error/watchdog columns apply):
    # detected-error telemetry feeds the error policy next epoch
    faults: "fault_mod.FaultSpec | None" = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.regions < 1:
            raise ValueError(f"regions must be >= 1, got {self.regions}")
        if self.faults is not None and not isinstance(
                self.faults, fault_mod.FaultSpec):
            raise TypeError(f"faults must be a FaultSpec, got "
                            f"{type(self.faults).__name__}")

    @property
    def fault_on(self) -> bool:
        return self.faults is not None and not self.faults.is_none


@dataclasses.dataclass
class FleetResult:
    """Per-epoch telemetry of one policy's fleet-month (arrays [E])."""

    spec: FleetSpec
    temp_c: np.ndarray
    lat_jedec_ns: np.ndarray       # served mean latency, JEDEC baseline
    lat_fleet_ns: np.ndarray       # served mean latency, deployed rows
    eff_lat_ns: np.ndarray         # + ECC event penalties per access
    corr_events: np.ndarray        # served correctable events
    unc_events: np.ndarray         # served uncorrectable events
    scrub_corr: np.ndarray         # scrub-detected (and corrected) cells
    served_detected: np.ndarray    # in-scan detected (retried) errors
    served_silent: np.ndarray      # in-scan SILENT corruptions
    served_wd_trips: np.ndarray    # in-scan watchdog trips
    compression_ratio: np.ndarray  # served distinct rows / dense slots
    tighten_steps: np.ndarray
    version: np.ndarray            # deployed TimingTable.version
    dead_modules: np.ndarray       # detected-dead count
    straggler_fallbacks: np.ndarray
    jedec_fallbacks: np.ndarray
    recal_epochs: tuple[int, ...]
    relax_epochs: tuple[int, ...]
    relax_rejected: tuple[int, ...]
    replay_dispatches: int
    margin_dispatches: int
    table: TimingTable

    def summary(self) -> dict:
        lj, lf, le = self.lat_jedec_ns, self.lat_fleet_ns, self.eff_lat_ns
        total_events = float(self.corr_events.sum() + self.unc_events.sum()
                             + self.scrub_corr.sum())
        return {
            "policy": self.spec.policy,
            "epochs": int(self.spec.n_epochs),
            "raw_reduction": float((1.0 - lf / lj).mean()),
            "eff_reduction": float((1.0 - le / lj).mean()),
            "total_corr": float(self.corr_events.sum()),
            "total_unc": float(self.unc_events.sum()),
            "total_scrub_corr": float(self.scrub_corr.sum()),
            "total_served_detected": float(self.served_detected.sum()),
            "total_served_silent": float(self.served_silent.sum()),
            "total_served_wd_trips": float(self.served_wd_trips.sum()),
            "mean_compression_ratio": float(self.compression_ratio.mean()),
            "final_compression_ratio": float(self.compression_ratio[-1]),
            "total_events": total_events,
            "final_version": int(self.version[-1]),
            "n_recals": len(self.recal_epochs),
            "n_relaxes": len(self.relax_epochs),
            "n_relax_rejected": len(self.relax_rejected),
            "max_tighten_steps": int(self.tighten_steps.max(initial=0)),
            "dead_modules": int(self.dead_modules[-1]),
            "straggler_fallbacks": int(self.straggler_fallbacks.sum()),
            "jedec_fallbacks": int(self.jedec_fallbacks.sum()),
            "replay_dispatches": self.replay_dispatches,
            "replay_per_epoch": self.replay_dispatches / self.spec.n_epochs,
            "margin_dispatches": self.margin_dispatches,
        }


class FleetEngine:
    """Closed-loop recalibration service over one simulated fleet.

    Construct one engine per (population, spec) and call `run()` once;
    policies are compared by running one engine per policy with the
    SAME seed — the drift trajectory is a function of (population,
    drift config, seed, epoch temperatures) only, so every policy
    faces the identical aging fleet.

    `device` (default "cuda"; raises without a card) holds the
    population and runs the controller, the monitor and the default
    `SimEngine`; a `profiler` or `sim` on another device raises.
    `traces` (a [70, N] `Trace` pool, `perf_model.trace_batch`'s layout)
    and `fault_uniforms` ([T, N] error uniforms of the serve campaign)
    replace the port's own draws.
    """

    def __init__(self, pop: Population, spec: FleetSpec = FleetSpec(),
                 drift_cfg: DriftConfig = DriftConfig(),
                 ecc: ECCConfig = ECCConfig(),
                 var_cfg: VariationConfig = VariationConfig(),
                 profiler: Profiler | None = None,
                 sim: SimEngine | None = None,
                 device: str | torch.device = "cuda",
                 traces: Trace | None = None,
                 fault_uniforms=None):
        self.device = resolve_device(device)
        if sim is not None and torch.device(sim.device) != self.device:
            raise ValueError(f"sim engine runs on {sim.device}, fleet on "
                             f"{self.device}")
        self.pop = pop.to(self.device)
        self.spec = spec
        self.ecc = ecc
        self.controller = ALDRAMController(profiler,
                                           temp_bins=spec.temp_bins,
                                           per_bank=True,
                                           regions=spec.regions,
                                           device=self.device)
        self.monitor = ErrorMonitor(engine=self.controller.engine)
        self.sim = sim or SimEngine(device=self.device)
        self.drift = DriftModel(self.pop, drift_cfg, var_cfg,
                                seed=spec.seed)
        self.traces = traces
        self.fault_uniforms = fault_uniforms
        self._jrow = T.DDR3_1600.as_row()

    def _workload_traces(self) -> tuple[Trace, ...]:
        """The spec's workload rows of the [70, N] pool (`traces`, else
        one `trace_batch` synthesis for the whole month), on the
        fleet's device."""
        spec = self.spec
        tb = (trace_batch(spec.n_requests, spec.seed, self.pop.n_banks,
                          device=self.device)
              if self.traces is None else self.traces)
        fields = [torch.as_tensor(f, device=self.device) for f in tb]
        return tuple(Trace(*(f[i] for f in fields))
                     for i in spec.workload_rows)

    # ------------------------------------------------------------ deploy
    def _rows_from_table(self, tbl: TimingTable
                         ) -> tuple[np.ndarray, np.ndarray | None]:
        """Deployed row state from a profiled table: ([modules, bins,
        banks, 6] dense rows, None) for a per-bank table, or the
        mask-compressed ([modules, bins, U, 6] unique-row store,
        [modules, banks, regions] int32 index map) for a region table.

        The refresh column carries min(read, write) safe tREFI — one
        deployed register per module, and the shorter interval only
        adds margin over the per-op profile — and the stack is forced
        bin-monotone (the `safe_stack` convention: moving rows toward
        JEDEC/standard only adds margin).

        A region table stores PER-BIN index maps; the deployed state
        re-compresses per module with ONE map shared across bins
        (`compression.compress_stack`, the same deployment form
        `safe_stack_regions` uses) so bin-monotone enforcement and
        cross-bin tighten propagation act directly on unique rows."""
        m, nb = tbl.params.shape[:2]
        banks = tbl.n_banks
        trefi = np.minimum(tbl.safe_trefi_read,
                           tbl.safe_trefi_write).astype(np.float32)
        if not tbl.per_region:
            rows = np.empty((m, nb, banks, 6), np.float32)
            rows[..., :4] = tbl.params.astype(np.float32)
            rows[..., 4] = trefi[:, None, None]
            rows[..., 5] = T.DDR3_1600.tcl
            return self._monotone(rows), None
        rg = tbl.regions
        g_ = banks * rg
        dense = np.empty((m, nb, g_, 6), np.float32)
        dense[..., :4] = tbl.expand_regions().reshape(m, nb, g_, 4)
        dense[..., 4] = trefi[:, None, None]
        dense[..., 5] = T.DDR3_1600.tcl
        stores, idxs = [], []
        for i in range(m):
            u_rows, idx = compress_stack(dense[i])
            stores.append(u_rows)
            idxs.append(idx)
        u_max = max(s.shape[1] for s in stores)
        rows = np.empty((m, nb, u_max, 6), np.float32)
        for i, s in enumerate(stores):
            rows[i, :, :s.shape[1]] = s
            rows[i, :, s.shape[1]:] = s[:, -1:]   # pad: repeat last row
        idx_map = np.stack(idxs).reshape(m, banks, rg).astype(np.int32)
        return self._monotone(rows), idx_map

    @staticmethod
    def _dense(rows_u: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """Gather a [modules, U, 6] unique-row epoch state through the
        [modules, banks, regions] index map to the dense [modules,
        banks, regions, 6] view (probe layout)."""
        m, banks, rg = idx.shape
        return decompress_rows(rows_u, idx.reshape(m, -1)
                               ).reshape(m, banks, rg, 6)

    @staticmethod
    def _unique_mask(fail: np.ndarray, idx: np.ndarray,
                     n_unique: int) -> np.ndarray:
        """Scatter a dense [modules, banks, regions] fail mask through
        the index map to the [modules, U] unique-row mask the guardband
        moves operate on — a failing (bank, region) implicates its
        unique row, and tightening that row heals EVERY region sharing
        it."""
        m = idx.shape[0]
        um = np.zeros((m, n_unique), bool)
        np.logical_or.at(um, (np.arange(m)[:, None],
                              idx.reshape(m, -1)), fail.reshape(m, -1))
        return um

    @staticmethod
    def _monotone(rows: np.ndarray) -> np.ndarray:
        """Bin-monotone in place: a hotter bin never carries a smaller
        timing parameter (or a longer refresh interval) than a cooler
        one — tightening a bin therefore propagates to every hotter
        bin, never silently relaxes one."""
        rows[..., :4] = np.maximum.accumulate(rows[..., :4], axis=1)
        rows[..., 4] = np.minimum.accumulate(rows[..., 4], axis=1)
        return rows

    # ----------------------------------------------------- autotuning
    def autotune_epoch(self, reps: int = 3):
        """Profile the replay configuration on an EPOCH-SHAPED
        campaign — the exact [1 + modules, banks, 6] per-bank timing
        stack and workload set every serve step replays — and record
        the winner in the sim engine's tuner table under the
        per-bank-static campaign kind and the epoch's request-count
        size bin.  A `SimEngine(backend="auto", tuner=...)` fleet then
        serves every epoch with the profiled config (the serve-time
        `SimSpec` resolves to the same tuner key).  Dispatch
        accounting stays honest — profiling runs count — so call this
        before `run()`, never inside a measured section.  Returns the
        winning `ReplayConfig`."""
        banks = self.pop.n_banks
        traces = self._workload_traces()
        timings = np.broadcast_to(
            self._jrow, (1 + self.pop.n_modules, banks, 6)
        ).astype(np.float32)
        return self.sim.autotune(
            SimSpec(traces=traces, timings=timings, n_banks=banks),
            reps=reps)

    def _install(self, table: TimingTable, rows_bins: np.ndarray,
                 idx: np.ndarray | None = None) -> TimingTable:
        """Deploy `rows_bins` as a new table VERSION via
        `TimingTable.patch`.  The module-envelope view is updated
        conservatively (elementwise max over the bank rows — always
        >= every bank row, though not necessarily a profiled grid
        point), and the scalar per-module safe-tREFI fields track the
        shortest deployed interval.  For a region fleet `rows_bins` is
        the unique-row store and `idx` its shared index map: the patch
        installs the store as `params` (the unique axis may resize —
        the one resize `TimingTable._check_patch` allows), broadcasts
        the shared map into the per-bin `region_index`, and rebuilds
        the carried bank/module envelope views from the dense
        gather."""
        if idx is None:
            trefi_min = rows_bins[..., 4].min(axis=(1, 2))
            return table.patch(
                params=rows_bins[..., :4].copy(),
                params_module=rows_bins[..., :4].max(axis=2),
                safe_trefi_read=np.minimum(table.safe_trefi_read,
                                           trefi_min).astype(np.float32),
                safe_trefi_write=np.minimum(table.safe_trefi_write,
                                            trefi_min).astype(np.float32))
        m, nb = rows_bins.shape[:2]
        banks, rg = idx.shape[1:]
        dense = decompress_rows(
            rows_bins,
            np.broadcast_to(idx.reshape(m, 1, -1), (m, nb, banks * rg))
        ).reshape(m, nb, banks, rg, 6)
        params_bank = dense[..., :4].max(axis=3)
        trefi_min = rows_bins[..., 4].min(axis=(1, 2))
        return table.patch(
            params=rows_bins[..., :4].copy(),
            region_index=np.broadcast_to(
                idx.reshape(m, 1, banks, rg), (m, nb, banks, rg)
            ).astype(np.int32).copy(),
            params_bank=params_bank,
            params_module=params_bank.max(axis=2),
            safe_trefi_read=np.minimum(table.safe_trefi_read,
                                       trefi_min).astype(np.float32),
            safe_trefi_write=np.minimum(table.safe_trefi_write,
                                        trefi_min).astype(np.float32))

    def _full_recal(self, table: TimingTable, dpop: Population
                    ) -> tuple[TimingTable, np.ndarray, np.ndarray,
                               np.ndarray | None]:
        """Re-profile the DRIFTED population end to end (one refresh
        campaign + one fused timing campaign) and deploy it as a new
        version.  Returns (table, rows_bins, floor_bins, idx) — the
        fresh profile is also the new relaxation floor (and, for a
        region fleet, the new shared index map: drift may have made
        regions diverge, so the unique-row axis legitimately
        resizes)."""
        fresh = self.controller.profile(dpop)
        rows_bins, idx = self._rows_from_table(fresh)
        updates = dict(params=fresh.params,
                       params_module=fresh.params_module,
                       safe_trefi_read=fresh.safe_trefi_read,
                       safe_trefi_write=fresh.safe_trefi_write)
        if fresh.per_region:
            updates["region_index"] = fresh.region_index
            updates["params_bank"] = fresh.params_bank
        table = table.patch(**updates)
        return table, rows_bins, rows_bins.copy(), idx

    # ---------------------------------------------------------- stragglers
    @staticmethod
    def _straggler_detector(rng: np.random.Generator, cluster: ClusterModel,
                            warmup: int = 64) -> StragglerDetector:
        lat, load, truth = cluster.sample(rng, warmup)
        det = StragglerDetector(cluster.n_nodes,
                                static_timeout_ms=float(
                                    lat[~truth].max() * 1.2))
        for t in range(warmup):
            for m in range(cluster.n_nodes):
                if not truth[t, m]:
                    det.observe(m, load[t, m], lat[t, m])
        det.fit()
        return det

    @staticmethod
    def _slow_recals(rng: np.random.Generator, cluster: ClusterModel,
                     det: StragglerDetector) -> np.ndarray:
        """[modules] bool: sampled recalibration times that trip the
        adaptive straggler threshold — those modules' installs miss
        the epoch and they serve JEDEC rows until the next one."""
        lat, load, _ = cluster.sample(rng, 1)
        return np.array([det.is_straggler(m, load[0, m], lat[0, m])
                         for m in range(cluster.n_nodes)])

    # --------------------------------------------------------------- run
    def run(self) -> FleetResult:
        spec = self.spec
        bins = np.asarray(spec.temp_bins, np.float64)
        nb = len(spec.temp_bins)
        m = self.pop.n_modules
        banks = self.pop.n_banks

        rg = spec.regions
        table = self.controller.profile(self.pop)
        rows_bins, idx = self._rows_from_table(table)
        floor_bins = rows_bins.copy()
        state = self.drift.init_state()

        def probe_rows(dpop_, rows, temp_):
            """Scrub the epoch's deployed rows: a region fleet probes
            the DENSE gather of its unique store (per (bank, region)
            granularity); `idx` rebinds across recals."""
            return self.monitor.probe(
                dpop_, rows if idx is None else self._dense(rows, idx),
                temp_)

        hb = HeartbeatMonitor(m, interval_ms=100.0,
                              static_miss_budget=spec.heartbeat_budget)
        failures: dict[int, list[int]] = {}
        for ep, mod in spec.module_failures:
            failures.setdefault(int(ep), []).append(int(mod))
        failed = np.zeros(m, bool)

        rng = np.random.default_rng(spec.seed + 101)
        cluster = ClusterModel(n_nodes=m)
        det = self._straggler_detector(rng, cluster)

        # one synthesis dispatch serves the whole fleet-month
        traces = self._workload_traces()

        e_ = spec.n_epochs
        rec = {k: np.zeros(e_) for k in
               ("temp_c", "lat_jedec_ns", "lat_fleet_ns", "eff_lat_ns",
                "corr_events", "unc_events", "scrub_corr",
                "served_detected", "served_silent", "served_wd_trips",
                "compression_ratio")}
        rec_i = {k: np.zeros(e_, np.int64) for k in
                 ("tighten_steps", "version", "dead_modules",
                  "straggler_fallbacks", "jedec_fallbacks")}
        recal_epochs: list[int] = []
        relax_epochs: list[int] = []
        relax_rejected: list[int] = []
        clean_streak = 0
        f_on = spec.fault_on
        # per-module detected-error counts from LAST epoch's serve —
        # the in-scan telemetry the error policy consumes this epoch
        det_prev = np.zeros(m, np.int64)
        d0 = self.sim.dispatch_count
        m0 = self.monitor.engine.dispatch_count

        for e in range(e_):
            temp = (spec.base_temp_c if spec.ambient is None else
                    ambient_at_host(spec.ambient, e * spec.ambient_step_ns))
            state = self.drift.advance(state, spec.days_per_epoch,
                                       temp_c=temp)
            dpop = self.drift.population(state)

            # -------- heartbeats: failed modules stop beating and are
            # declared dead once the adaptive miss budget trips
            now = e * hb.interval_ms
            for mod in failures.get(e, []):
                failed[mod] = True
            for mod in range(m):
                if not failed[mod]:
                    hb.beat(mod, now)
            dead = np.array([hb.dead(mod, now) for mod in range(m)])
            alive = ~dead
            # alive broadcast to the probe's spatial axes (bank[, region])
            av = alive[:, None] if rg == 1 else alive[:, None, None]

            # -------- deployed rows for this epoch's temperature bin
            bi = int(np.searchsorted(bins, temp, side="left"))
            over = bi >= nb
            rows_e = (np.broadcast_to(
                self._jrow, (m,) + rows_bins.shape[2:]).copy()
                if over else rows_bins[:, bi].copy())
            probe = probe_rows(dpop, rows_e, temp)
            observed = probe            # pre-reaction scrub observation
            tighten = 0
            straggler_fb = 0
            jedec_fb = 0

            # -------- policy reaction (before traffic is served)
            if (spec.policy == "periodic" and e > 0
                    and e % spec.recal_period == 0):
                table, rows_bins, floor_bins, idx = self._full_recal(
                    table, dpop)
                recal_epochs.append(e)
                slow = self._slow_recals(rng, cluster, det) & alive
                rows_e = (rows_bins[:, bi].copy() if not over
                          else np.broadcast_to(
                              self._jrow,
                              (m,) + rows_bins.shape[2:]).copy())
                if slow.any():
                    rows_e[slow] = self._jrow
                    straggler_fb = int(slow.sum())
                probe = probe_rows(dpop, rows_e, temp)
            elif spec.policy == "error" and not over:
                fail = probe.fail_mask() & av
                if f_on and (det_prev > 0).any():
                    # in-scan telemetry: modules whose SERVED traffic
                    # detected errors last epoch are implicated for
                    # (at least) one tighten step — subsequent loop
                    # iterations re-check with fresh scrub evidence
                    dv = ((det_prev > 0)[:, None] if rg == 1
                          else (det_prev > 0)[:, None, None])
                    fail = fail | (dv & av)
                if fail.any():
                    clean_streak = 0
                    while fail.any() and tighten < spec.max_tighten_steps:
                        # region fleet: the dense fail mask scatters to
                        # UNIQUE rows — one tighten heals every region
                        # sharing the implicated row
                        tmask = (fail if idx is None else
                                 self._unique_mask(fail, idx,
                                                   rows_bins.shape[2]))
                        new_rows, _ = guardband.tighten_rows(
                            rows_bins[:, bi], mask=tmask)
                        rows_bins[:, bi] = new_rows
                        self._monotone(rows_bins)
                        tighten += 1
                        rows_e = rows_bins[:, bi].copy()
                        probe = probe_rows(dpop, rows_e, temp)
                        fail = probe.fail_mask() & av
                    if fail.any():
                        # tightening ran out of authority: escalate to
                        # a full re-profile of the drifted population
                        table, rows_bins, floor_bins, idx = \
                            self._full_recal(table, dpop)
                        recal_epochs.append(e)
                        slow = self._slow_recals(rng, cluster, det) & alive
                        rows_e = rows_bins[:, bi].copy()
                        if slow.any():
                            rows_e[slow] = self._jrow
                            straggler_fb = int(slow.sum())
                        probe = probe_rows(dpop, rows_e, temp)
                        fail = probe.fail_mask() & av
                        if fail.any():
                            # beyond even a fresh profile: the module
                            # retires to JEDEC rows for this epoch
                            bad = fail.reshape(m, -1).any(axis=1)
                            rows_e[bad] = self._jrow
                            jedec_fb = int(bad.sum())
                            probe = probe_rows(dpop, rows_e, temp)
                    else:
                        table = self._install(table, rows_bins, idx)
                else:
                    clean_streak += 1
                    at_floor = bool(
                        (rows_bins[:, bi] == floor_bins[:, bi]).all())
                    if clean_streak >= spec.relax_after and not at_floor:
                        cand = guardband.relax_rows(rows_bins[:, bi],
                                                    floor_bins[:, bi])
                        p2 = probe_rows(dpop, cand, temp)
                        clean_streak = 0
                        if p2.clean:
                            # probe-confirmed: deploy the relaxed rows
                            rows_bins[:, bi] = cand
                            rows_e = cand.copy()
                            probe = p2
                            table = self._install(table, rows_bins, idx)
                            relax_epochs.append(e)
                        else:
                            # drift already consumed the reclaimed
                            # margin — the relaxation never deploys
                            relax_rejected.append(e)

            # -------- serve: ONE replay dispatch (JEDEC + per-module
            # rows share the timing axis).  With a fault axis the
            # per-module rows collapse to their conservative bank
            # ENVELOPE (the static faulted replay prices retries
            # against one [6] JEDEC row, which rides LAST per the
            # engine convention) and the counters come back per lane.
            if f_on:
                timings = np.empty((m + 1, 6), np.float32)
                # envelope over the rows that actually serve: the
                # DENSE gather for a region fleet (pad rows in the
                # unique store are stale copies, never served)
                dr = (rows_e if idx is None
                      else self._dense(rows_e, idx).reshape(m, -1, 6))
                env = dr.max(axis=1)
                env[:, 4] = dr[:, :, 4].min(axis=1)
                timings[:m] = env
                timings[m] = self._jrow          # JEDEC fallback LAST
                res = self.sim.run(SimSpec(traces=traces,
                                           timings=timings,
                                           n_banks=banks,
                                           faults=spec.faults),
                                   fault_uniforms=self.fault_uniforms)
                lat = res.mean_latency_ns        # [T, 1, m + 1, F]
                lat_j = float(lat[:, 0, m].mean())
                lat_f = float(lat[:, 0, :m][:, alive].mean())
                det_m = np.asarray(
                    res.detected_errors)[:, 0, :m].sum(axis=(0, 2))
                sil_m = np.asarray(
                    res.silent_errors)[:, 0, :m].sum(axis=(0, 2))
                trp_m = np.asarray(
                    res.wd_trips)[:, 0, :m].sum(axis=(0, 2))
                det_prev = np.where(alive, det_m, 0).astype(np.int64)
                rec["served_detected"][e] = float(det_m[alive].sum())
                rec["served_silent"][e] = float(sil_m[alive].sum())
                rec["served_wd_trips"][e] = float(trp_m[alive].sum())
            else:
                timings = np.empty((1 + m,) + rows_e.shape[1:],
                                   np.float32)
                timings[0] = self._jrow
                timings[1:] = rows_e
                spec_kw = {}
                if idx is not None:
                    # the unique stores ride the timing axis with one
                    # index map per lane (JEDEC lane: constant rows,
                    # map 0) — still ONE replay dispatch
                    rmaps = np.empty((1 + m, banks * rg), np.int32)
                    rmaps[0] = 0
                    rmaps[1:] = idx.reshape(m, -1)
                    spec_kw["region_map"] = rmaps
                res = self.sim.run(SimSpec(traces=traces,
                                           timings=timings,
                                           n_banks=banks, **spec_kw))
                lat = res.mean_latency_ns        # [T, 1, 1 + m]
                lat_j = float(lat[:, 0, 0].mean())
                lat_f = float(lat[:, 0, 1:][:, alive].mean())

            # -------- ECC events of the served traffic, charged
            # against the rows that actually served
            # a (module, bank)'s accesses split evenly across its
            # regions, so a region fleet prices collisions against the
            # failing cells of the REGION an access actually lands in
            acc = self.ecc.accesses_per_epoch / rg
            f_served = np.where(av, probe.fail_counts, 0)
            corr, unc = ecc_events(f_served, self.ecc, accesses=acc)
            pen = event_penalty_ns(corr, unc, self.ecc, accesses=acc)
            # scrub detections are themselves corrected correctable
            # events — only the error-driven policy actually scrubs
            # (for the others the probe is simulation observability)
            scrub = (float((observed.fail_counts * av).sum())
                     if spec.policy == "error" else 0.0)

            # -------- compression telemetry: distinct served rows /
            # dense (bank x region) slots, mean over modules — the
            # deployability curve as drift makes regions diverge
            if idx is not None:
                d_ = self._dense(rows_e, idx).reshape(m, banks * rg, 6)
                rec["compression_ratio"][e] = float(np.mean(
                    [np.unique(d_[i], axis=0).shape[0]
                     for i in range(m)])) / (banks * rg)
            else:
                rec["compression_ratio"][e] = float(np.mean(
                    [np.unique(rows_e[i], axis=0).shape[0]
                     for i in range(m)])) / banks

            rec["temp_c"][e] = temp
            rec["lat_jedec_ns"][e] = lat_j
            rec["lat_fleet_ns"][e] = lat_f
            rec["eff_lat_ns"][e] = lat_f + float(pen[alive].mean())
            rec["corr_events"][e] = float(corr[alive].sum())
            rec["unc_events"][e] = float(unc[alive].sum())
            rec["scrub_corr"][e] = scrub
            rec_i["tighten_steps"][e] = tighten
            rec_i["version"][e] = table.version
            rec_i["dead_modules"][e] = int(dead.sum())
            rec_i["straggler_fallbacks"][e] = straggler_fb
            rec_i["jedec_fallbacks"][e] = jedec_fb

        return FleetResult(
            spec=spec, **rec, **rec_i,
            recal_epochs=tuple(recal_epochs),
            relax_epochs=tuple(relax_epochs),
            relax_rejected=tuple(relax_rejected),
            replay_dispatches=self.sim.dispatch_count - d0,
            margin_dispatches=self.monitor.engine.dispatch_count - m0,
            table=table)


def run_policies(pop: Population, spec: FleetSpec = FleetSpec(),
                 policies: tuple[str, ...] = POLICIES,
                 **engine_kw) -> dict[str, FleetResult]:
    """One fleet-month per policy, identical drift trajectories (same
    population, same seed, same epoch temperatures)."""
    return {p: FleetEngine(pop, dataclasses.replace(spec, policy=p),
                           **engine_kw).run()
            for p in policies}


def frontier(results: dict[str, FleetResult]) -> dict:
    """The errors-avoided vs latency-given-back frontier.

    Per policy, relative to static-forever: `errors_avoided` is the
    drop in total ECC events (served + scrub), `latency_given_back`
    the raw-latency reduction surrendered to guardband steps and
    JEDEC fallbacks, and `eff_reduction` the reduction AFTER event
    penalties — the axis on which error-driven recalibration must
    strictly dominate the static deployment.
    """
    if "static" not in results:
        raise ValueError("frontier is anchored on static-forever: run "
                         "the 'static' policy")
    summaries = {p: r.summary() for p, r in results.items()}
    s0 = summaries["static"]
    out = {"policies": {}, "summaries": summaries}
    for p, s in summaries.items():
        out["policies"][p] = {
            "errors_avoided": s0["total_events"] - s["total_events"],
            "latency_given_back": s0["raw_reduction"] - s["raw_reduction"],
            "raw_reduction": s["raw_reduction"],
            "eff_reduction": s["eff_reduction"],
            "total_unc": s["total_unc"],
        }
    return out


__all__ = ["POLICIES", "FleetSpec", "FleetEngine", "FleetResult",
           "run_policies", "frontier"]

"""Adaptive-Latency DRAM: the mechanism (paper Sec. 4), port of
`repro.core.aldram` at module and per-bank granularity.

The controller holds one timing table per (module, temperature bin) —
and, by default, per rank-level bank within it — built by the profiler,
and selects at runtime the table of the module's current temperature,
always rounding the temperature UP to the next profiled bin.  The
paper's reliability argument is enforced as an invariant (`verify`):
every selected row must be error-free for its whole module (and bank)
at the bin's maximum temperature.

`profile()` is one refresh launch plus ONE fused (temperature bins x
read/write) timing launch; `verify()` is one launch per module group;
`evaluate_system()` replays the workload pool under the profiled rows
in one `SimEngine` campaign.  The tables are small and live on the
host; the margin grids live on the controller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.profiler import Profiler
from repro_torch.core.sweep import Op, param_reductions
from repro_torch.core.variation import Population
from repro_torch.device import resolve_device

DEFAULT_TEMP_BINS = (45.0, 55.0, 65.0, 75.0, 85.0)


def default_scenarios():
    """The stock dynamic-ambient suite of `evaluate_dynamic`: steady
    (the near-static case), a diurnal ramp spanning several bins, a
    cooling failure stepping into the hot bins mid-trace, and a bursty
    square wave hovering around a bin edge (the hysteresis stress)."""
    from repro_torch.core import thermal
    return (thermal.steady(42.0),
            thermal.diurnal(38.0, 72.0, period_ns=1.2e5),
            thermal.cooling_failure(44.0, 28.0, at_ns=3.0e4),
            thermal.bursty(42.0, 16.0, period_ns=6.0e4, duty=0.5))


def _combine(cr: np.ndarray, cw: np.ndarray) -> np.ndarray:
    """One register set must satisfy both tests: the safer (larger) of
    the read/write choices per parameter; tRAS from the read test, tWR
    from the write test."""
    p = np.empty(cr.shape[:-1] + (4,), np.float32)
    p[..., 0] = np.maximum(cr[..., 0], cw[..., 0])
    p[..., 1] = cr[..., 1]
    p[..., 2] = cw[..., 2]
    p[..., 3] = np.maximum(cr[..., 3], cw[..., 3])
    return p


@dataclasses.dataclass
class TimingTable:
    """Timing parameters for each temperature bin.

    `params` is the per-module table [modules, bins, 4] (trcd, tras,
    twr, trp in ns) or the per-bank table [modules, bins, banks, 4]; a
    per-bank table also carries `params_module`, the module-envelope
    table selected on the intersected (all-banks) envelope of the SAME
    campaign.  The module-level methods always answer from the module
    envelope."""

    temp_bins: tuple[float, ...]
    params: np.ndarray
    safe_trefi_read: np.ndarray     # [modules] ms
    safe_trefi_write: np.ndarray    # [modules] ms
    params_module: np.ndarray | None = None

    def __post_init__(self):
        if self.params.ndim not in (3, 4):
            raise ValueError(f"params must be [modules, bins(, banks), 4], "
                             f"got {self.params.shape}")
        if self.per_bank and (self.params_module is None
                              or self.params_module.ndim != 3):
            raise ValueError("a per-bank table carries its "
                             "module-envelope table")

    @property
    def per_bank(self) -> bool:
        return self.params.ndim == 4

    @property
    def n_banks(self) -> int | None:
        return self.params.shape[2] if self.per_bank else None

    @property
    def bank_params(self) -> np.ndarray | None:
        """The per-bank [modules, bins, banks, 4] view, if any."""
        return self.params if self.per_bank else None

    @property
    def module_params(self) -> np.ndarray:
        """The per-module [modules, bins, 4] view."""
        return self.params_module if self.per_bank else self.params

    def reduce_banks(self) -> "TimingTable":
        """Collapse to the per-module table: exactly the table a
        per-module-only profile builds."""
        if not self.per_bank:
            return self
        return TimingTable(self.temp_bins, self.module_params,
                           self.safe_trefi_read, self.safe_trefi_write)

    def patch(self, **updates) -> "TimingTable":
        raise NotImplementedError(
            "TimingTable.patch (fleet recalibration lineage) is not "
            "ported yet: ROADMAP queue A items 8 and 12")

    def rollback(self) -> "TimingTable":
        raise NotImplementedError(
            "TimingTable.rollback (fleet recalibration lineage) is not "
            "ported yet: ROADMAP queue A items 8 and 12")

    def lookup(self, module: int, temp_c: float) -> T.TimingParams:
        """Conservative selection: smallest profiled bin >= temp; above
        the hottest bin fall back to standard JEDEC timings."""
        return T.TimingParams.from_row(
            self.lookup_many(np.array([module]), np.array([temp_c]))[0])

    def _lookup_rows(self, temps_c: np.ndarray, gather) -> np.ndarray:
        """The selection core: `searchsorted` picks the smallest bin >=
        temp; queries above the hottest bin get JEDEC timings; tREFI and
        tCL ride along.  `gather(bin_idx)` returns each query's [K, 4]."""
        bins = np.asarray(self.temp_bins, np.float64)
        bi = np.searchsorted(bins, temps_c, side="left")
        over = bi >= len(bins)
        rows = np.empty((temps_c.shape[0], 6), np.float32)
        rows[:, :4] = np.where(
            over[:, None], np.asarray(T.DDR3_1600.as_row()[:4]),
            gather(np.minimum(bi, len(bins) - 1)))
        rows[:, 4] = T.STANDARD_TREFI_MS
        rows[:, 5] = T.DDR3_1600.tcl
        return rows

    def lookup_many(self, modules, temps_c) -> np.ndarray:
        """Pairwise (module, temperature) queries -> [K, 6] timing rows
        (`TimingParams.as_row` layout)."""
        modules, temps_c = np.broadcast_arrays(
            np.atleast_1d(np.asarray(modules, np.int64)),
            np.atleast_1d(np.asarray(temps_c, np.float64)))
        return self._lookup_rows(
            temps_c, lambda bi: self.module_params[modules, bi])

    def lookup_many_banks(self, modules, banks, temps_c) -> np.ndarray:
        """Pairwise (module, bank, temperature) queries -> [K, 6] rows."""
        if not self.per_bank:
            raise ValueError("per-module table has no bank axis")
        modules, banks, temps_c = np.broadcast_arrays(
            np.atleast_1d(np.asarray(modules, np.int64)),
            np.atleast_1d(np.asarray(banks, np.int64)),
            np.atleast_1d(np.asarray(temps_c, np.float64)))
        return self._lookup_rows(
            temps_c, lambda bi: self.bank_params[modules, bi, banks])

    def safe_stack(self) -> tuple[np.ndarray, np.ndarray]:
        """The table stack the adaptive replay selects over: ([bins + 1,
        6] rows, [bins] edges).  Row b is the all-module-safe row of
        bin b (max over modules per parameter), forced bin-monotone by
        a running max over bins; the JEDEC fallback row is last.
        Switching up through these rows is immediate, switching down
        waits for the hysteresis margin (`thermal.ThermalConfig`)."""
        return self._stack_rows(
            lambda mods, tc: self.lookup_many(
                mods, np.full(mods.shape[0], tc)).max(axis=0))

    def safe_stack_banks(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-bank `safe_stack`: ([bins + 1, banks, 6] rows, [bins]
        edges) — one all-module-safe row per (bin, bank), bin-monotone
        per bank, the JEDEC row last (broadcast across banks).  The
        adaptive replay gathers row (selected bin, request's bank)."""
        if not self.per_bank:
            raise ValueError("per-module table has no bank axis")
        banks = self.n_banks

        def bin_rows(mods, tc):
            m = mods.shape[0]
            return np.stack([self.lookup_many_banks(
                mods, np.full(m, b), np.full(m, tc)).max(axis=0)
                for b in range(banks)])

        return self._stack_rows(bin_rows)

    def _stack_rows(self, bin_rows) -> tuple[np.ndarray, np.ndarray]:
        """The stack-construction core of both granularities:
        `bin_rows(modules, bin_temp)` -> the all-module-safe row(s) of
        that bin ([6] or [banks, 6]); a running max forces the stack
        bin-monotone and the JEDEC fallback row rides last."""
        nb = len(self.temp_bins)
        mods = np.arange(self.params.shape[0])
        first = bin_rows(mods, self.temp_bins[0])
        rows = np.empty((nb + 1,) + first.shape, np.float32)
        rows[0] = first
        for bi, tc in enumerate(self.temp_bins[1:], start=1):
            rows[bi] = bin_rows(mods, tc)
        rows[:nb] = np.maximum.accumulate(rows[:nb], axis=0)
        rows[nb] = T.DDR3_1600.as_row()
        return rows, np.asarray(self.temp_bins, np.float32)

    def average_reductions(self, temp_c: float,
                           std: T.TimingParams = T.DDR3_1600) -> dict:
        """Module-envelope Sec. 5.2 statistics at the bin serving
        `temp_c` (0% above the hottest bin: JEDEC fallback)."""
        bi = next((i for i, b in enumerate(self.temp_bins)
                   if temp_c <= b), None)
        if bi is None:
            return {k: 0.0 for k in ("trcd", "tras", "twr", "trp")}
        return param_reductions(self.module_params[:, bi, :], std)


class ALDRAMController:
    """Profile once; select per (module, temperature) at runtime.

    `per_bank=True` (the default) builds a per-bank `TimingTable` from
    the SAME fused campaign launch, alongside the module-envelope table
    every module-level method answers from.  `device` (default "cuda")
    is where the margin grids and replays run; it must match the
    profiler's."""

    def __init__(self, profiler: Profiler | None = None,
                 temp_bins: tuple[float, ...] = DEFAULT_TEMP_BINS,
                 per_bank: bool = True, regions: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if regions != 1:
            raise NotImplementedError(
                "regions > 1 (subarray-region tables) is not ported yet: "
                "ROADMAP queue A item 8")
        self.profiler = profiler or Profiler(device=self.device)
        if self.profiler.device != self.device:
            raise ValueError(f"profiler runs on {self.profiler.device}, "
                             f"controller on {self.device}")
        self.engine = self.profiler.engine
        self.temp_bins = tuple(temp_bins)
        self.per_bank = per_bank
        self.table: TimingTable | None = None
        self.sweep_result = None

    # ------------------------------------------------------------ profile
    def profile(self, pop: Population) -> TimingTable:
        """Build the (module x bin[, bank]) table from one refresh
        launch and ONE fused multi-temperature read+write launch."""
        prof = self.profiler
        rp_read, rp_write = prof.refresh_campaign(pop, 85.0)
        res = self.engine.sweep(
            pop, prof.campaign_spec(self.temp_bins, rp_read, rp_write))
        # keep the selection views, drop the device margin grids (12 GB
        # at the full campaign) so the controller does not pin them
        self.sweep_result = dataclasses.replace(res, margins=())
        kr, kw = res.index(Op.READ), res.index(Op.WRITE)
        params_module = _combine(res.chosen[kr], res.chosen[kw])
        if self.per_bank:
            # [modules, banks, bins, 4] -> [modules, bins, banks, 4]
            params_bank = _combine(res.chosen_bank[kr],
                                   res.chosen_bank[kw]).transpose(0, 2, 1, 3)
            self.table = TimingTable(self.temp_bins,
                                     np.ascontiguousarray(params_bank),
                                     rp_read.safe, rp_write.safe,
                                     params_module=params_module)
        else:
            self.table = TimingTable(self.temp_bins, params_module,
                                     rp_read.safe, rp_write.safe)
        return self.table

    def region_table(self, level: int):
        raise NotImplementedError(
            "region_table is not ported yet: ROADMAP queue A item 8")

    # ------------------------------------------------------------- select
    def select(self, module: int, temp_c: float) -> T.TimingParams:
        if self.table is None:
            raise RuntimeError("profile() first")
        return self.table.lookup(module, temp_c)

    # -------------------------------------------------------------- verify
    def verify(self, pop: Population,
               max_grid_elems: int = 8_000_000) -> bool:
        """The zero-error invariant (the paper's stress test, Sec. 6):
        for every module and bin the selected rows are error-free at the
        bin's max temperature with the safe refresh interval, and for a
        per-bank table every (module, bin, bank) row is error-free for
        every cell of ITS rank-level bank.

        Every (module, bin[, bank]) row becomes a combo column with its
        bin temperature; the safe refresh intervals ride the per-cell
        overrides; the module (and bank) diagonals of the grid are
        reduced on the device.  Module groups keep each launch under
        `max_grid_elems` (12 launches at the full 115-module size)."""
        if self.table is None:
            raise RuntimeError("profile() first")
        tbl = self.table
        m, b = tbl.module_params.shape[:2]
        ch, bk, kc = pop.cells.shape[1:4]
        cpm = ch * bk * kc                           # cells per module
        banks = tbl.n_banks if tbl.per_bank else 0
        if banks and banks != bk:
            raise ValueError(f"table has {banks} banks, population {bk}")
        cols = b * (1 + banks)                       # combos per module
        g = max(1, min(m, int((max_grid_elems / (cpm * cols)) ** 0.5)))

        dev = self.device
        cells = torch.as_tensor(pop.cells, device=dev).reshape(m, cpm, -1)
        trefi_r = tbl.safe_trefi_read.astype(np.float32)
        trefi_w = tbl.safe_trefi_write.astype(np.float32)
        temps_bins = np.asarray(tbl.temp_bins, np.float32)
        temps_mod = temps_bins
        if banks:
            temps_mod = np.concatenate([temps_mod,
                                        np.repeat(temps_bins, banks)])

        for lo in range(0, m, g):
            sl = slice(lo, min(lo + g, m))
            n = sl.stop - sl.start
            combos = np.empty((n * cols, 5), np.float32)
            rows_m = tbl.module_params[sl].reshape(n, b, 4)
            if banks:
                rows_b = tbl.bank_params[sl].reshape(n, b * banks, 4)
                combos[:, :4] = np.concatenate(
                    [rows_m, rows_b], axis=1).reshape(n * cols, 4)
            else:
                combos[:, :4] = rows_m.reshape(n * cols, 4)
            combos[:, 4] = T.STANDARD_TREFI_MS       # overridden per cell
            read_m, write_m = self.engine.margins(
                cells[sl].reshape(n * cpm, -1), combos,
                temps_combo=np.tile(temps_mod, n),
                trefi_read=np.repeat(trefi_r[sl], cpm),
                trefi_write=np.repeat(trefi_w[sl], cpm))
            mi = torch.arange(n, device=dev)
            for grid in (read_m, write_m):
                grid = grid.view(n, cpm, n, cols)
                # module-diagonal of the envelope block: [mods, cpm, b]
                if bool(grid[mi, :, mi, :b].min() < 0.0):
                    return False
                if banks:
                    # bank block: module-diagonal, then pair each cell's
                    # bank with its combo's bank
                    gb = grid[mi, :, mi, b:].reshape(n, ch, bk, kc, b, banks)
                    bj = torch.arange(banks, device=dev)
                    if bool(gb[:, :, bj, :, :, bj].min() < 0.0):
                        return False
        return True

    # ------------------------------------------------------ system closure
    def evaluate_system(self, pop: Population,
                        temps: tuple[float, ...] | None = None,
                        n: int = 4096, seed: int = 0,
                        policies=None, engine=None) -> dict:
        """Close the loop from profiling to the paper's Fig. 4: replay
        the workload pool under the all-module-safe profiled row of
        every temperature bin (plus the DDR3 baseline) in ONE batched
        `SimEngine` campaign on the controller's device."""
        from repro_torch.core import dram_sim, perf_model
        from repro_torch.core.sim_engine import SimEngine
        if self.table is None:
            self.profile(pop)
        tbl = self.table
        temps = tuple(temps if temps is not None else tbl.temp_bins)
        policies = policies or (dram_sim.OPEN_FCFS,)
        engine = engine or SimEngine(device=self.device)
        m = tbl.module_params.shape[0]
        rows = np.empty((1 + len(temps), 6), np.float32)
        rows[0] = T.DDR3_1600.as_row()
        mods = np.arange(m)
        for si, tc in enumerate(temps):
            rows[1 + si] = tbl.lookup_many(mods, np.full(m, tc)).max(axis=0)

        em = perf_model.evaluate_many(rows, n=n, seed=seed, engine=engine,
                                      policies=policies, n_banks=pop.n_banks)
        sp = perf_model.cpi_speedups(em["mean_latency_ns"])
        intensive = np.array([w.intensive for w in perf_model.WORKLOADS])
        per_policy = []
        for pi in range(len(policies)):
            d = {}
            for si, tc in enumerate(temps):
                s_multi = sp[1, :, pi, 1 + si]       # multi-core
                d[float(tc)] = {
                    "multi_intensive_gmean":
                        perf_model.gmean_speedup(s_multi[intensive]),
                    "multi_nonintensive_gmean":
                        perf_model.gmean_speedup(s_multi[~intensive]),
                    "multi_all_gmean": perf_model.gmean_speedup(s_multi),
                    "single_all_gmean":
                        perf_model.gmean_speedup(sp[0, :, pi, 1 + si]),
                }
            per_policy.append(d)
        return {"temps": temps, "rows": rows, "speedups": sp,
                "mean_latency_ns": em["mean_latency_ns"],
                "workloads": em["workloads"], "per_temp": per_policy[0],
                "per_policy": per_policy, "policies": policies,
                "source": "profiled-table"}

    def evaluate_bank_system(self, pop: Population,
                             temps: tuple[float, ...] | None = None,
                             n: int = 4096, seed: int = 0,
                             policies=None, engine=None,
                             traces=None) -> dict:
        """FLY-DRAM's headline on the system side: replay the workload
        pool under the all-module-safe PER-BANK rows of every
        temperature bin against the per-module envelope rows of the
        same bins, in ONE campaign.  The timing axis is a [1 + 2*T,
        banks, 6] per-bank stack: the JEDEC baseline and the module
        rows ride it constant across banks (which replays bit-identical
        to the per-module path), the per-bank rows vary per bank.
        `traces` replaces the synthesized pool with a given [70, N]
        batch.  Also reports the table-level mean latency-sum
        reductions per test at both granularities."""
        from repro_torch.core import dram_sim, perf_model
        from repro_torch.core.sim_engine import SimEngine
        if self.table is None:
            self.profile(pop)
        tbl = self.table
        if not tbl.per_bank:
            raise ValueError("profile() a per_bank controller first")
        temps = tuple(temps if temps is not None else tbl.temp_bins)
        policies = policies or (dram_sim.OPEN_FCFS,)
        engine = engine or SimEngine(device=self.device)
        m, banks = tbl.module_params.shape[0], tbl.n_banks
        if banks != pop.n_banks:
            raise ValueError(f"table has {banks} banks, population "
                             f"{pop.n_banks}")
        nt = len(temps)
        rows = np.empty((1 + 2 * nt, banks, 6), np.float32)
        rows[0] = T.DDR3_1600.as_row()[None, :]
        mods = np.arange(m)
        for si, tc in enumerate(temps):
            rows[1 + si] = tbl.lookup_many(
                mods, np.full(m, tc)).max(axis=0)[None, :]
            for bb in range(banks):
                rows[1 + nt + si, bb] = tbl.lookup_many_banks(
                    mods, np.full(m, bb), np.full(m, tc)).max(axis=0)

        em = perf_model.evaluate_many(rows, n=n, seed=seed, engine=engine,
                                      policies=policies, n_banks=banks,
                                      traces=traces)
        sp = perf_model.cpi_speedups(em["mean_latency_ns"])
        intensive = np.array([w.intensive for w in perf_model.WORKLOADS])
        gm = perf_model.gmean_speedup
        per_temp = {}
        for si, tc in enumerate(temps):
            s_mod = sp[1, :, 0, 1 + si]              # multi-core
            s_bank = sp[1, :, 0, 1 + nt + si]
            per_temp[float(tc)] = {
                "module_all_gmean": gm(s_mod),
                "bank_all_gmean": gm(s_bank),
                "module_intensive_gmean": gm(s_mod[intensive]),
                "bank_intensive_gmean": gm(s_bank[intensive]),
                "bank_minus_module": gm(s_bank) - gm(s_mod),
            }
        red = {}
        res_sweep = self.sweep_result
        std = self.profiler.std
        for op in Op:
            k = res_sweep.index(op)
            base = std.read_sum() if op is Op.READ else std.write_sum()
            red[op.value] = {
                "module": float(
                    1 - (res_sweep.latency_sum[k] / base).mean()),
                "bank": float(
                    1 - (res_sweep.latency_sum_bank[k] / base).mean()),
            }
        return {"temps": temps, "rows": rows, "speedups": sp,
                "mean_latency_ns": em["mean_latency_ns"],
                "workloads": em["workloads"], "per_temp": per_temp,
                "reductions": red, "policies": policies,
                "source": "profiled-bank-table"}

    def evaluate_region_system(self, *args, **kwargs) -> dict:
        raise NotImplementedError(
            "evaluate_region_system is not ported yet: ROADMAP queue A "
            "item 8")

    def evaluate_dynamic(self, pop: Population, scenarios=None,
                         config=None, n: int = 4096, seed: int = 0,
                         policies=None, engine=None,
                         per_bank: bool = False, fused: bool = False,
                         traces=None) -> dict:
        """The paper's mechanism end to end: profile the population,
        stack the per-bin all-module-safe rows (`safe_stack`, or
        `safe_stack_banks` with `per_bank=True`), and replay the
        workload pool with the controller's bin switching — sensing,
        round-up, hysteresis, JEDEC fallback — running per request
        inside the replay launch under dynamic thermal scenarios
        (`default_scenarios()` when None), bracketed by the
        static-worst-case and oracle deployments
        (`perf_model.evaluate_adaptive`: two launches; `fused=True`
        rounds the peaks up on the device with no host round trip).
        `traces` replaces the synthesized pool with a given batch."""
        from repro_torch.core import dram_sim, perf_model
        from repro_torch.core.sim_engine import SimEngine
        if self.table is None:
            self.profile(pop)
        if scenarios is None:
            scenarios = default_scenarios()
        policies = policies or (dram_sim.OPEN_FCFS,)
        rows, bins = (self.table.safe_stack_banks() if per_bank
                      else self.table.safe_stack())
        out = perf_model.evaluate_adaptive(
            rows, bins, scenarios, config=config, n=n, seed=seed,
            engine=engine or SimEngine(device=self.device),
            policies=policies, n_banks=pop.n_banks, fused=fused,
            traces=traces)
        out["source"] = "profiled-table-dynamic"
        out["policies"] = policies
        return out

    # ----------------------------------------------------------- reporting
    def average_reductions(self, temp_c: float,
                           std: T.TimingParams = T.DDR3_1600) -> dict:
        """Module-envelope Sec. 5.2 statistics (see
        `TimingTable.average_reductions`)."""
        if self.table is None:
            raise RuntimeError("profile() first")
        return self.table.average_reductions(temp_c, std)

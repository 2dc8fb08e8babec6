"""Adaptive-Latency DRAM: the mechanism (paper Sec. 4), port of
`repro.core.aldram` at module, per-bank and subarray-region granularity.

The controller holds one timing table per (module, temperature bin) —
and, by default, per rank-level bank within it, and optionally per
(bank, subarray region) in a mask-compressed store — built by the
profiler,
and selects at runtime the table of the module's current temperature,
always rounding the temperature UP to the next profiled bin.  The
paper's reliability argument is enforced as an invariant (`verify`):
every selected row must be error-free for its whole module (and bank)
at the bin's maximum temperature.

`profile()` is one refresh launch plus ONE fused (temperature bins x
read/write) timing launch; `verify()` is one launch per module group;
`evaluate_system()` replays the workload pool under the profiled rows
in one `SimEngine` campaign; `evaluate_region_system()` replays every
spatial resolution level (module, bank, 2/4/8 regions) in one.  The tables are small and live on the
host; the margin grids live on the controller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.profiler import Profiler
from repro_torch.core.sweep import Op, param_reductions, select_combos
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
    envelope.

    A subarray-region table is mask-compressed: `params` is then the
    [modules, bins, U, 4] unique-row store, `region_index` the int32
    [modules, bins, banks, regions] map into it, and `params_bank` the
    per-bank table selected on the bank envelope of the same campaign
    (not derivable from the region rows), so every bank-level answer is
    the per-bank profile's.  `patch` installs a new version whose
    `parent` is this one; `rollback` returns to it."""

    temp_bins: tuple[float, ...]
    # [modules, bins, 4] | [modules, bins, banks, 4] |
    # [modules, bins, U, 4] unique-row store (when `region_index` is set)
    params: np.ndarray
    safe_trefi_read: np.ndarray     # [modules] ms
    safe_trefi_write: np.ndarray    # [modules] ms
    params_module: np.ndarray | None = None
    region_index: np.ndarray | None = None
    params_bank: np.ndarray | None = None   # [modules, bins, banks, 4]
    version: int = 0
    parent: "TimingTable | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.params.ndim not in (3, 4):
            raise ValueError(f"params must be [modules, bins(, banks), 4], "
                             f"got {self.params.shape}")
        if self.per_region:
            ri, pb = self.region_index, self.params_bank
            if not (self.params.ndim == 4 and ri.ndim == 4
                    and pb is not None and pb.ndim == 4):
                raise ValueError("a per-region table is a unique store, an "
                                 "index map and the per-bank table of the "
                                 "same campaign")
            if ri.shape[:2] != self.params.shape[:2] \
                    or pb.shape[:3] != ri.shape[:3]:
                raise ValueError(f"region table shapes disagree: params "
                                 f"{self.params.shape}, region_index "
                                 f"{ri.shape}, params_bank {pb.shape}")
            if int(ri.min()) < 0 or int(ri.max()) >= self.params.shape[2]:
                raise ValueError("region_index out of range of the "
                                 "unique-row store")
        if self.per_bank and (self.params_module is None
                              or self.params_module.ndim != 3):
            raise ValueError("a per-bank table carries its "
                             "module-envelope table")

    @property
    def per_bank(self) -> bool:
        return self.params.ndim == 4

    @property
    def per_region(self) -> bool:
        return self.region_index is not None

    @property
    def regions(self) -> int:
        return self.region_index.shape[3] if self.per_region else 1

    @property
    def n_unique(self) -> int | None:
        """Unique-row count U of the compressed region store."""
        return self.params.shape[2] if self.per_region else None

    @property
    def n_banks(self) -> int | None:
        if self.per_region:
            return self.region_index.shape[2]
        return self.params.shape[2] if self.per_bank else None

    @property
    def bank_params(self) -> np.ndarray | None:
        """The per-bank [modules, bins, banks, 4] view, if any (the
        carried bank table of a region-compressed one)."""
        if self.per_region:
            return self.params_bank
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

    def reduce_regions(self) -> "TimingTable":
        """Collapse a region-compressed table to the per-bank table of
        the same campaign: exactly the table a per-bank profile builds."""
        if not self.per_region:
            return self
        return TimingTable(self.temp_bins, self.params_bank,
                           self.safe_trefi_read, self.safe_trefi_write,
                           params_module=self.params_module)

    def expand_regions(self) -> np.ndarray:
        """Decompress the region store to the dense [modules, bins,
        banks, regions, 4] table (bit-exact)."""
        if not self.per_region:
            raise ValueError("not a region-compressed table")
        from repro_torch.runtime.compression import decompress_rows
        m, nb, banks, regions = self.region_index.shape
        dense = decompress_rows(self.params,
                                self.region_index.reshape(m, nb, -1))
        return dense.reshape(m, nb, banks, regions, 4)

    def compression_ratio(self) -> float:
        """Stored unique rows / dense (banks x regions) rows."""
        if not self.per_region:
            raise ValueError("not a region-compressed table")
        return float(self.n_unique) / float(self.n_banks * self.regions)

    # ---------------------------------------------------- online lineage
    def _check_patch(self, name: str, new) -> None:
        """A patched field must keep this version's rank and shape; the
        unique-row axis of a region store is the one axis that may
        resize (re-compression), checked against the index map after."""
        cur = getattr(self, name)
        if cur is None:
            raise ValueError(
                f"patch cannot introduce '{name}': version {self.version} "
                "does not carry it (rank change mid-lineage)")
        new = np.asarray(new)
        if new.ndim != cur.ndim:
            raise ValueError(
                f"patch '{name}': rank {new.ndim} incompatible with parent "
                f"version {self.version} rank {cur.ndim} ({new.shape} vs "
                f"{cur.shape})")
        if name == "params" and self.per_region:
            ok = (new.shape[:2] == cur.shape[:2]
                  and new.shape[3:] == cur.shape[3:])
        else:
            ok = new.shape == cur.shape
        if not ok:
            raise ValueError(
                f"patch '{name}': shape {new.shape} incompatible with parent "
                f"version {self.version} shape {cur.shape}")

    def patch(self, **updates) -> "TimingTable":
        """A new table version with the given field updates (`params`,
        `params_module`, `params_bank`, `region_index`,
        `safe_trefi_read`, `safe_trefi_write`): `version` + 1 and this
        table as its `parent`.  Each update must keep this version's
        rank and shape (`ValueError` otherwise, see `_check_patch`); the
        caller verifies the new rows before deploying them."""
        allowed = {"params", "params_module", "params_bank",
                   "region_index", "safe_trefi_read", "safe_trefi_write"}
        if set(updates) - allowed:
            raise ValueError(f"patch: unknown fields "
                             f"{sorted(set(updates) - allowed)}")
        for name, new in updates.items():
            self._check_patch(name, new)
        if self.per_region:
            nxt_params = np.asarray(updates.get("params", self.params))
            nxt_index = np.asarray(updates.get("region_index",
                                               self.region_index))
            if int(nxt_index.max()) >= nxt_params.shape[2]:
                raise ValueError(
                    "patch: region_index indexes past the unique-row store "
                    f"(max {int(nxt_index.max())} >= "
                    f"U={nxt_params.shape[2]})")
        return dataclasses.replace(self, version=self.version + 1,
                                   parent=self, **updates)

    def rollback(self) -> "TimingTable":
        """The previous deployed version (self at the root)."""
        return self.parent if self.parent is not None else self

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

    def lookup_many_regions(self, modules, banks, regions,
                            temps_c) -> np.ndarray:
        """Pairwise (module, bank, region, temperature) queries -> [K, 6]
        rows, gathered through the compressed store's index map."""
        if not self.per_region:
            raise ValueError("not a region-compressed table")
        modules, banks, regions, temps_c = np.broadcast_arrays(
            np.atleast_1d(np.asarray(modules, np.int64)),
            np.atleast_1d(np.asarray(banks, np.int64)),
            np.atleast_1d(np.asarray(regions, np.int64)),
            np.atleast_1d(np.asarray(temps_c, np.float64)))

        def gather(bi):
            u = self.region_index[modules, bi, banks, regions]
            return self.params[modules, bi, u]

        return self._lookup_rows(temps_c, gather)

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

    def safe_stack_regions(self) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """Per-region `safe_stack` in deployed compressed form: ([bins +
        1, U', 6] unique columns, [bins] edges, [banks, regions] int32
        region map).  The dense all-module-safe per-(bin, bank, region)
        stack (bin-monotone, JEDEC row last) is re-compressed with one
        map shared across bins — the replay gathers row (selected bin,
        map[bank, region]) and the map must not vary with the bin — so
        U' counts whole (bank, region) columns."""
        if not self.per_region:
            raise ValueError("not a region-compressed table")
        from repro_torch.runtime.compression import compress_stack
        banks, regions = self.n_banks, self.regions

        def bin_rows(mods, tc):
            m = mods.shape[0]
            out = np.empty((banks, regions, 6), np.float32)
            for b in range(banks):
                for r in range(regions):
                    out[b, r] = self.lookup_many_regions(
                        mods, np.full(m, b), np.full(m, r),
                        np.full(m, tc)).max(axis=0)
            return out

        dense, edges = self._stack_rows(bin_rows)
        rows, idx = compress_stack(
            dense.reshape(dense.shape[0], banks * regions, 6))
        return rows, edges, idx.reshape(banks, regions)

    def _stack_rows(self, bin_rows) -> tuple[np.ndarray, np.ndarray]:
        """The stack-construction core of both granularities:
        `bin_rows(modules, bin_temp)` -> the all-module-safe row(s) of
        that bin ([6], [banks, 6] or [banks, regions, 6]); a running max
        forces the stack
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
    every module-level method answers from; `regions` > 1 additionally
    reduces that launch per (bank, subarray region) into a
    mask-compressed region table.  `device` (default "cuda") is where
    the margin grids and replays run; it must match the profiler's."""

    def __init__(self, profiler: Profiler | None = None,
                 temp_bins: tuple[float, ...] = DEFAULT_TEMP_BINS,
                 per_bank: bool = True, regions: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if regions < 1 or (regions > 1 and not per_bank):
            raise ValueError(f"regions={regions}: subarray regions refine "
                             "the per-bank table (per_bank=True)")
        self.profiler = profiler or Profiler(device=self.device)
        if self.profiler.device != self.device:
            raise ValueError(f"profiler runs on {self.profiler.device}, "
                             f"controller on {self.device}")
        self.engine = self.profiler.engine
        self.temp_bins = tuple(temp_bins)
        self.per_bank = per_bank
        self.regions = regions
        self.table: TimingTable | None = None
        self.sweep_result = None

    # ------------------------------------------------------------ profile
    def profile(self, pop: Population) -> TimingTable:
        """Build the (module x bin[, bank[, region]]) table from one
        refresh launch and ONE fused multi-temperature read+write
        launch."""
        prof = self.profiler
        rp_read, rp_write = prof.refresh_campaign(pop, 85.0)
        res = self.engine.sweep(
            pop, prof.campaign_spec(self.temp_bins, rp_read, rp_write),
            regions=self.regions)
        # keep the selection views, drop the device margin grids (12 GB
        # at the full campaign) so the controller does not pin them
        self.sweep_result = dataclasses.replace(res, margins=())
        kr, kw = res.index(Op.READ), res.index(Op.WRITE)
        params_module = _combine(res.chosen[kr], res.chosen[kw])
        if self.regions > 1:
            from repro_torch.runtime.compression import compress_rows
            params_bank = _combine(res.chosen_bank[kr],
                                   res.chosen_bank[kw]).transpose(0, 2, 1, 3)
            # [modules, banks, regions, bins, 4] -> [modules, bins, banks *
            # regions, 4], mask-compressed per (module, bin)
            dense = _combine(res.chosen_region[kr], res.chosen_region[kw]
                             ).transpose(0, 3, 1, 2, 4)
            m, nb, banks, regions = dense.shape[:4]
            store, idx = compress_rows(dense.reshape(m, nb, banks * regions,
                                                     4))
            self.table = TimingTable(
                self.temp_bins, store.astype(np.float32), rp_read.safe,
                rp_write.safe, params_module=params_module,
                region_index=idx.reshape(m, nb, banks, regions),
                params_bank=np.ascontiguousarray(params_bank))
        elif self.per_bank:
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

    def _level_ok(self, k: int, level: int) -> np.ndarray:
        """Test k's pass envelope at `level` regions per bank: the
        intersection of each group of R // level fine regions (exact
        booleans) -> [modules, banks, level, temps, combos]."""
        okr = self.sweep_result.ok_region[k]
        return okr.reshape(okr.shape[:2] + (level, self.regions // level)
                           + okr.shape[3:]).all(3)

    def _check_level(self, level: int) -> None:
        if self.table is None or not self.table.per_region:
            raise RuntimeError("profile() a regions > 1 controller first")
        if not (1 <= level <= self.regions and self.regions % level == 0):
            raise ValueError(f"level {level} must divide the profiled "
                             f"{self.regions} regions")

    def region_table(self, level: int) -> TimingTable:
        """The table a `regions=level` profile would build, derived from
        the stored campaign views without a new launch: re-select on the
        grouped envelope.  `level == 1` is the per-bank table
        (`reduce_regions`), `level == regions` the table itself."""
        self._check_level(level)
        if level == self.regions:
            return self.table
        if level == 1:
            return self.table.reduce_regions()
        from repro_torch.runtime.compression import compress_rows
        res = self.sweep_result
        m = self.table.module_params.shape[0]
        chosen = {}
        for op in Op:
            k = res.index(op)
            chosen[op], _ = select_combos(
                res.spec.tests[k].combos, self._level_ok(k, level), op,
                res.spec.op_trefi(op, m), self.profiler.std)
        dense = _combine(chosen[Op.READ], chosen[Op.WRITE]
                         ).transpose(0, 3, 1, 2, 4)
        nb, banks = dense.shape[1:3]
        store, idx = compress_rows(dense.reshape(m, nb, banks * level, 4))
        return TimingTable(
            self.temp_bins, store.astype(np.float32),
            self.table.safe_trefi_read, self.table.safe_trefi_write,
            params_module=self.table.params_module,
            region_index=idx.reshape(m, nb, banks, level),
            params_bank=self.table.params_bank)

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
        bin's max temperature with the safe refresh interval, for a
        per-bank table every (module, bin, bank) row is error-free for
        every cell of ITS rank-level bank, and for a region table every
        (module, bin, bank, region) row for every cell of its region.

        Every (module, bin[, bank]) row becomes a combo column with its
        bin temperature; the safe refresh intervals ride the per-cell
        overrides; the module (bank, region) diagonals of the grid are
        reduced on the device.  Module groups keep each launch under
        `max_grid_elems` (12 launches at the full 115-module size, 39
        with 8 regions)."""
        if self.table is None:
            raise RuntimeError("profile() first")
        tbl = self.table
        m, b = tbl.module_params.shape[:2]
        ch, bk, kc = pop.cells.shape[1:4]
        cpm = ch * bk * kc                           # cells per module
        banks = tbl.n_banks if tbl.per_bank else 0
        if banks and banks != bk:
            raise ValueError(f"table has {banks} banks, population {bk}")
        rg = tbl.regions if tbl.per_region else 0
        if rg and kc % rg:
            raise ValueError(f"{rg} regions do not divide {kc} tail cells")
        # combos per module: b envelope rows, [b, banks] bank rows, and
        # for a region table [b, banks, regions] region rows
        cols = b * (1 + banks + banks * rg)
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
        if rg:
            temps_mod = np.concatenate(
                [temps_mod, np.repeat(temps_bins, banks * rg)])
        dense_r = tbl.expand_regions() if rg else None

        for lo in range(0, m, g):
            sl = slice(lo, min(lo + g, m))
            n = sl.stop - sl.start
            combos = np.empty((n * cols, 5), np.float32)
            rows_m = tbl.module_params[sl].reshape(n, b, 4)
            if banks:
                parts = [rows_m, tbl.bank_params[sl].reshape(n, b * banks, 4)]
                if rg:
                    parts.append(dense_r[sl].reshape(n, b * banks * rg, 4))
                combos[:, :4] = np.concatenate(
                    parts, axis=1).reshape(n * cols, 4)
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
                    gb = grid[mi, :, mi, b:b * (1 + banks)].reshape(
                        n, ch, bk, kc, b, banks)
                    bj = torch.arange(banks, device=dev)
                    if bool(gb[:, :, bj, :, :, bj].min() < 0.0):
                        return False
                if rg:
                    # region block: module-diagonal, then pair each cell's
                    # (bank, row-position group) with its combo's (bank,
                    # region)
                    gr = grid[mi, :, mi, b * (1 + banks):].reshape(
                        n, ch, bk, rg, kc // rg, b, banks, rg)
                    bj = torch.arange(banks, device=dev)[:, None]
                    rj = torch.arange(rg, device=dev)[None, :]
                    if bool(gr[:, :, bj, rj, :, :, bj, rj].min() < 0.0):
                        return False
        return True

    # ------------------------------------------------------ system closure
    def evaluate_system(self, pop: Population,
                        temps: tuple[float, ...] | None = None,
                        n: int = 4096, seed: int = 0,
                        policies=None, engine=None, traces=None) -> dict:
        """Close the loop from profiling to the paper's Fig. 4: replay
        the workload pool under the all-module-safe profiled row of
        every temperature bin (plus the DDR3 baseline) in ONE batched
        `SimEngine` campaign on the controller's device.  `traces`
        replaces the synthesized pool with a given [70, N] batch."""
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
                                      policies=policies, n_banks=pop.n_banks,
                                      traces=traces)
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

    def region_reductions(self, levels: tuple[int, ...] = ()
                          ) -> dict[str, dict[str, float]]:
        """Table-level mean latency-sum reductions (the Sec. 5.2
        statistic) per test at every spatial level: module envelope,
        per-bank, and per-(bank, region) at each `levels` entry, all
        from the one stored campaign.  Structurally monotone: every
        finer envelope contains its coarser group's."""
        res = self.sweep_result
        if res is None:
            raise RuntimeError("profile() first")
        m = self.table.module_params.shape[0]
        std = self.profiler.std
        out: dict[str, dict[str, float]] = {}
        for op in Op:
            k = res.index(op)
            base = std.read_sum() if op is Op.READ else std.write_sum()
            d = {"module": float(1 - (res.latency_sum[k] / base).mean()),
                 "bank": float(1 - (res.latency_sum_bank[k] / base).mean())}
            for lv in levels:
                self._check_level(lv)
                if lv == self.regions:
                    sums = res.latency_sum_region[k]
                else:
                    _, sums = select_combos(
                        res.spec.tests[k].combos, self._level_ok(k, lv), op,
                        res.spec.op_trefi(op, m), std)
                d[f"region{lv}"] = float(1 - (sums / base).mean())
            out[op.value] = d
        return out

    def evaluate_region_system(self, pop: Population,
                               levels: tuple[int, ...] | None = None,
                               temps: tuple[float, ...] | None = None,
                               n: int = 4096, seed: int = 0,
                               policies=None, engine=None,
                               traces=None) -> dict:
        """The subarray-region headline on the system side: replay the
        workload pool under the all-module-safe rows of every spatial
        level — module envelope, per-bank, and per-(bank, region) at
        each `levels` entry (default the divisors 2, 4, 8 of the
        profiled count) — in ONE campaign.  The dense [rows, banks,
        regions, 6] stack (JEDEC baseline, module rows, bank rows, one
        block of region rows per level, coarser levels broadcast into
        the finest layout) rides the launch compressed
        (`compress_stack`): a [rows, U, 6] unique-row stack and one
        [banks * regions] index map.  `traces` replaces the synthesized
        pool with a given [70, N] batch.  Also reports
        `region_reductions` and each level's compression ratio."""
        from repro_torch.core import dram_sim, perf_model
        from repro_torch.core.sim_engine import SimEngine
        from repro_torch.runtime.compression import compress_stack
        if self.table is None:
            self.profile(pop)
        tbl = self.table
        if not tbl.per_region:
            raise RuntimeError("profile() a regions > 1 controller first")
        R = tbl.regions
        if levels is None:
            levels = tuple(lv for lv in (2, 4, 8) if lv <= R and R % lv == 0)
        temps = tuple(temps if temps is not None else tbl.temp_bins)
        policies = policies or (dram_sim.OPEN_FCFS,)
        engine = engine or SimEngine(device=self.device)
        m, banks = tbl.module_params.shape[0], tbl.n_banks
        if banks != pop.n_banks:
            raise ValueError(f"table has {banks} banks, population "
                             f"{pop.n_banks}")
        tables = {lv: self.region_table(lv) for lv in levels}
        nt, nl = len(temps), len(levels)
        s_rows = 1 + (2 + nl) * nt
        dense = np.empty((s_rows, banks, R, 6), np.float32)
        dense[0] = T.DDR3_1600.as_row()[None, None, :]
        mods = np.arange(m)
        for si, tc in enumerate(temps):
            dense[1 + si] = tbl.lookup_many(
                mods, np.full(m, tc)).max(axis=0)[None, None, :]
            for bb in range(banks):
                dense[1 + nt + si, bb] = tbl.lookup_many_banks(
                    mods, np.full(m, bb), np.full(m, tc)).max(axis=0)
        for li, lv in enumerate(levels):
            t_lv = tables[lv]
            off = 1 + (2 + li) * nt
            for si, tc in enumerate(temps):
                for bb in range(banks):
                    seg = dense[off + si, bb].reshape(lv, R // lv, 6)
                    for j in range(lv):
                        seg[j] = t_lv.lookup_many_regions(
                            mods, np.full(m, bb), np.full(m, j),
                            np.full(m, tc)).max(axis=0)[None, :]
        rows_u, region_map = compress_stack(
            dense.reshape(s_rows, banks * R, 6))

        em = perf_model.evaluate_many(rows_u, n=n, seed=seed, engine=engine,
                                      policies=policies, n_banks=banks,
                                      traces=traces, region_map=region_map)
        sp = perf_model.cpi_speedups(em["mean_latency_ns"])
        gm = perf_model.gmean_speedup
        per_temp = {}
        for si, tc in enumerate(temps):
            d = {"module_all_gmean": gm(sp[1, :, 0, 1 + si]),
                 "bank_all_gmean": gm(sp[1, :, 0, 1 + nt + si])}
            for li, lv in enumerate(levels):
                d[f"region{lv}_all_gmean"] = gm(
                    sp[1, :, 0, 1 + (2 + li) * nt + si])
            per_temp[float(tc)] = d
        return {"temps": temps, "levels": levels, "rows": rows_u,
                "region_map": region_map, "speedups": sp,
                "mean_latency_ns": em["mean_latency_ns"],
                "workloads": em["workloads"], "per_temp": per_temp,
                "reductions": self.region_reductions(levels),
                "compression_ratio": {lv: tables[lv].compression_ratio()
                                      for lv in levels},
                "policies": policies, "source": "profiled-region-table"}

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

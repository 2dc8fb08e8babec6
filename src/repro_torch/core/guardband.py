"""Guardband semantics shared by the profiler, the controller and the
fleet recalibration service (port of `repro.core.guardband`).

The paper's procedure (Sec. 5.1): the safe operating point is the
maximum error-free point minus one sweep step (8 ms for the refresh
interval, one timing step for timing parameters).  The reliability
invariant (Sec. 4): the charge at the chosen operating point must never
fall below the worst-case-cell-at-85C reference level — AL-DRAM gives
up only the slack above the manufacturer's own worst case.
`reference_margin` and `design_quantile` evaluate that worst case
through `sweep.MarginEngine`, so on a card every evaluation is one
launch of the `margin_grid` kernel (1 cell x 1 combo).

The online half (`tighten_rows` / `relax_rows`, for fleet
recalibration): a deployed table is correct only for the population it
was profiled on.  When errors are observed under a deployed row,
`tighten_rows` steps it back toward the JEDEC anchor, one profiling-grid
step per call, and the caller re-probes the margins after every step;
`relax_rows` is the symmetric clean-streak move back toward the
profiled floor, deployed only after a margin probe confirms it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.charge import ChargeConstants
from repro_torch.core.variation import worst_case_reference


def safe_refresh(max_passing_ms: np.ndarray,
                 step_ms: float = T.REFRESH_STEP_MS) -> np.ndarray:
    return np.maximum(max_passing_ms - step_ms, step_ms)


def reference_margin(constants: ChargeConstants,
                     std: T.TimingParams = T.DDR3_1600,
                     quantile: float = 4.0,
                     device: str | torch.device = "cuda") -> float:
    """Margin of a `quantile`-sigma compound worst-case cell at 85C
    under standard JEDEC timings: one `MarginEngine.margins` launch on
    `device`."""
    from repro_torch.core.sweep import MarginEngine

    eng = MarginEngine(constants=constants, std=std, device=device)
    wc = worst_case_reference(quantile=quantile)
    combo = std.as_array()[None, :]
    r, w = eng.margins(wc, combo, temp_c=85.0)
    return float(torch.minimum(r.min(), w.min()))


def design_quantile(constants: ChargeConstants,
                    std: T.TimingParams = T.DDR3_1600,
                    hi: float = 8.0,
                    device: str | torch.device = "cuda") -> float:
    """The implied JEDEC design point: the largest compound-sigma
    worst-case cell that still passes standard timings at 85C, by 24
    bisection steps after the two bracket ends (26 `reference_margin`
    launches).  It must exceed the realised population quantile
    (`variation.compound_quantile(...).max()`).

    The bisection assumes `reference_margin` decreases in `quantile`
    with a sign change inside [0, hi]; an unbracketed search raises
    rather than report an end point as if it were measured."""
    m_lo = reference_margin(constants, std, quantile=0.0, device=device)
    if m_lo < 0:
        raise ValueError(
            f"design_quantile bracket broken: the MEDIAN worst-case "
            f"cell already fails standard timings at 85C "
            f"(margin {m_lo:.4f} < 0 at quantile 0) — these charge "
            f"constants violate the JEDEC guarantee outright")
    m_hi = reference_margin(constants, std, quantile=hi, device=device)
    if m_hi >= 0:
        raise ValueError(
            f"design_quantile bracket broken: a {hi:.1f}-sigma compound "
            f"worst-case cell still passes standard timings at 85C "
            f"(margin {m_hi:.4f} >= 0) — raise `hi`; returning the "
            f"endpoint would understate the design point")
    lo = 0.0
    for _ in range(24):
        mid = (lo + hi) / 2
        if reference_margin(constants, std, quantile=mid,
                            device=device) >= 0:
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Online (fleet) guardband moves.  Rows use the stacked 6-column layout
# of `timing.TimingParams.as_row`: (trcd, tras, twr, trp, trefi, tcl).
# ---------------------------------------------------------------------------

def tighten_rows(rows: np.ndarray, mask: np.ndarray | None = None,
                 std: T.TimingParams = T.DDR3_1600,
                 step_ns: float = T.TIMING_STEP_NS,
                 step_ms: float = T.REFRESH_STEP_MS
                 ) -> tuple[np.ndarray, np.ndarray]:
    """One error-driven guardband step toward the JEDEC anchor.

    rows: [..., 6] deployed timing rows; mask: [...] bool of the rows
    implicated (None = all).  Each masked row's four timing parameters
    step up by one profiling-grid step (clamped at the standard values)
    and its refresh interval steps down by one refresh-grid step
    (clamped at the standard tREFI): drift can erode either the access
    or the retention margin, and an error event does not say which.

    Returns (new rows, at_jedec [...] bool): `at_jedec` marks masked
    rows that were already at the standard anchor before this call,
    which must be escalated (re-profile or retire the module).  The
    zero-error invariant is restored only once the caller has
    re-probed the margins under the new rows."""
    rows = np.asarray(rows, np.float32)
    std_row = std.as_row()
    if mask is None:
        mask = np.ones(rows.shape[:-1], bool)
    at_jedec = mask & np.all(rows[..., :5] == std_row[:5], axis=-1)
    out = rows.copy()
    m = mask[..., None]
    out[..., :4] = np.where(m, np.minimum(rows[..., :4] + step_ns,
                                          std_row[:4]), rows[..., :4])
    out[..., 4] = np.where(mask, np.maximum(rows[..., 4] - step_ms,
                                            std_row[4]), rows[..., 4])
    return out, at_jedec


def relax_rows(rows: np.ndarray, floor_rows: np.ndarray,
               mask: np.ndarray | None = None,
               step_ns: float = T.TIMING_STEP_NS,
               step_ms: float = T.REFRESH_STEP_MS) -> np.ndarray:
    """One clean-streak guardband step back toward the profiled floor:
    timing parameters step down (clamped at `floor_rows`, the last full
    profile's choices) and the refresh interval steps back up (same
    clamp).  A relaxed row is deployed only after a margin probe of the
    current population confirms it is still error-free."""
    rows = np.asarray(rows, np.float32)
    floor_rows = np.asarray(floor_rows, np.float32)
    if mask is None:
        mask = np.ones(rows.shape[:-1], bool)
    out = rows.copy()
    m = mask[..., None]
    out[..., :4] = np.where(m, np.maximum(rows[..., :4] - step_ns,
                                          floor_rows[..., :4]),
                            rows[..., :4])
    out[..., 4] = np.where(mask, np.minimum(rows[..., 4] + step_ms,
                                            floor_rows[..., 4]),
                           rows[..., 4])
    return out

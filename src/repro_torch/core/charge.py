"""Charge <-> latency interdependence model (paper Sec. 3), in PyTorch
(port of `repro.core.charge`).

All voltages are normalised to VDD = 1; the bitline is precharged to
0.5; a cell's state `q` is its voltage in [0, 1].  Every map below is
affine in `q`, so the steady state of the refresh/access loop is the
fixed point of an affine contraction, iterated `_FIXED_POINT_ITERS`
times inside the margin computation.

These functions are the plain version of the `margin_grid` CUDA kernel
(`repro_torch.kernels.charge_sim`): elementwise tensor code on
whatever device the inputs live on.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class CellParams(NamedTuple):
    """Per-cell electrical parameters (tensors broadcast together).

    tau_r    : sense-path RC constant (ns)
    xfer     : charge-transfer ratio C_cell / (C_cell + C_bl)
    tau_ret85: retention time constant at 85C (ms)
    tau_p    : bitline precharge RC constant (ns)
    tau_w    : cell charging RC constant (ns) -- restore & write drive
    """

    tau_r: torch.Tensor
    xfer: torch.Tensor
    tau_ret85: torch.Tensor
    tau_p: torch.Tensor
    tau_w: torch.Tensor

    @staticmethod
    def unstack(arr: torch.Tensor) -> "CellParams":
        n = len(CellParams._fields)
        if arr.shape[-1] != n:
            raise ValueError(f"stacked CellParams needs {n} trailing "
                             f"columns (one per field), got "
                             f"{tuple(arr.shape)}")
        return CellParams(*(arr[..., i] for i in range(n)))


@dataclasses.dataclass(frozen=True)
class ChargeConstants:
    """Global (non-varying) physics constants; calibrated values live in
    `repro_torch.core.calibration`."""

    t_wl: float = 1.3          # wordline rise + command overhead (ns)
    alpha_share: float = 0.55  # charge-share time as multiple of tau_r
    tau_s: float = 1.85        # sense-amp regeneration time constant (ns)
    dv_full: float = 0.26      # bitline swing the sense amp must develop
    dv_min: float = 0.035      # minimum differential for correct sensing
    t_p0: float = 1.1          # precharge driver dead time (ns)
    t_wr_base: float = 7.5     # write drive time outside tWR (ns)
    t_wr_floor: float = 6.5    # bitline write-driver swing floor (ns)
    kappa_w: float = 0.77      # write-test retention derating
    beta_w: float = 0.60       # write-path RC as multiple of tau_r
    dv_full_w: float = 0.055   # row-open swing needed before a WRITE
    k_ret: float = 0.0693      # retention ~halves per +10C (ln 2 / 10)
    k_rc: float = 0.0020       # RC slowdown per +C above 55C
    v_precharge: float = 0.5

    def as_tuple(self) -> tuple:
        return dataclasses.astuple(self)


DEFAULT_CONSTANTS = ChargeConstants()

_FIXED_POINT_ITERS = 8


def retention_tau(tau_ret85_ms, temp_c,
                  c: ChargeConstants = DEFAULT_CONSTANTS):
    """Retention time constant at `temp_c` (leakage accelerates hot)."""
    return tau_ret85_ms * torch.exp(c.k_ret * (85.0 - temp_c))


def rc_at_temp(tau_r, temp_c, c: ChargeConstants = DEFAULT_CONSTANTS):
    """Cell RC grows mildly with temperature (mobility degradation)."""
    return tau_r * (1.0 + c.k_rc * torch.clamp(temp_c - 55.0, min=0.0))


def bitline_residual(trp_ns, tau_p, c: ChargeConstants = DEFAULT_CONSTANTS):
    """Residual bitline differential after a precharge of tRP ns
    (Observation 3: the tail of precharge is asymptotic)."""
    t = torch.clamp(trp_ns - c.t_p0, min=0.0)
    return c.v_precharge * torch.exp(-t / tau_p)


def sense_delta_v(q, xfer):
    """Initial bitline perturbation from charge-sharing with a cell at
    voltage q (Observation 1: proportional to stored charge)."""
    return (q - 0.5) * xfer


def sense_time(q, residual, tau_r_t, xfer,
               c: ChargeConstants = DEFAULT_CONSTANTS):
    """Time for the sense amplifier to develop the full bitline swing;
    regeneration is exponential, so the time is logarithmic in the
    initial differential."""
    dv_eff = torch.clamp(sense_delta_v(q, xfer) - residual, min=1e-6)
    return (c.t_wl + c.alpha_share * tau_r_t
            + c.tau_s * torch.log(c.dv_full / dv_eff))


def row_open_time(residual, q, tau_r_t, xfer,
                  c: ChargeConstants = DEFAULT_CONSTANTS):
    """Weaker sensing requirement before a WRITE (only dv_full_w of
    swing is needed for the row to be safely open)."""
    dv_eff = torch.clamp(sense_delta_v(q, xfer) - residual, min=1e-6)
    return (c.t_wl + c.alpha_share * tau_r_t
            + c.tau_s * torch.log(torch.clamp(c.dv_full_w / dv_eff,
                                              min=1e-6)))


# combo layout (see repro_torch.core.timing): [trcd, tras, twr, trp, trefi]

def read_margin(cell: CellParams, combo: torch.Tensor, temp_c,
                c: ChargeConstants = DEFAULT_CONSTANTS,
                trefi=None) -> torch.Tensor:
    """Margin (>= 0 means error-free) of the read/refresh steady state:
    min(sense margin, tRCD - sense time) at the fixed point of the
    refresh/restore loop."""
    trcd, tras, trp = combo[..., 0], combo[..., 1], combo[..., 3]
    trefi = combo[..., 4] if trefi is None else trefi
    tau_r_t = rc_at_temp(cell.tau_r, temp_c, c)
    tau_w_t = rc_at_temp(cell.tau_w, temp_c, c)
    tau_ret = retention_tau(cell.tau_ret85, temp_c, c)
    leak = torch.exp(-trefi / tau_ret)
    residual = bitline_residual(trp, cell.tau_p, c)

    q_r = torch.full_like(leak + tras, 0.95)
    for _ in range(_FIXED_POINT_ITERS):
        q_acc = 0.5 + (q_r - 0.5) * leak
        ts = sense_time(q_acc, residual, tau_r_t, cell.xfer, c)
        t_rest = torch.clamp(tras - ts, min=0.0)
        # restore starts from the charge-shared level (paper Fig. 1)
        q_shared = 0.5 + (q_acc - 0.5) * cell.xfer
        q_r = 1.0 - (1.0 - q_shared) * torch.exp(-t_rest / tau_w_t)
    q_acc = 0.5 + (q_r - 0.5) * leak
    ts = sense_time(q_acc, residual, tau_r_t, cell.xfer, c)

    m_sense = ((sense_delta_v(q_acc, cell.xfer) - residual - c.dv_min)
               / c.dv_min)
    m_rcd = (trcd - ts) / 1.0   # ns-scale margin
    return torch.minimum(m_sense, m_rcd)


def write_margin(cell: CellParams, combo: torch.Tensor, temp_c,
                 c: ChargeConstants = DEFAULT_CONSTANTS,
                 trefi=None) -> torch.Tensor:
    """Margin of the write/refresh steady state: a write cut short by
    tWR must survive a full tREFI of leakage before being sensed; tWR
    also has a hard circuit floor."""
    trcd, twr, trp = combo[..., 0], combo[..., 2], combo[..., 3]
    trefi = combo[..., 4] if trefi is None else trefi
    tau_r_t = rc_at_temp(cell.tau_r, temp_c, c)
    tau_w = rc_at_temp(cell.tau_w, temp_c, c) * c.beta_w   # write driver
    tau_ret = retention_tau(cell.tau_ret85, temp_c, c) * c.kappa_w
    leak = torch.exp(-trefi / tau_ret)
    residual = bitline_residual(trp, cell.tau_p, c)

    q_low = torch.full_like(leak, 0.05)
    t_drive = torch.clamp(twr + c.t_wr_base, min=0.0)
    q_written = 1.0 - (1.0 - q_low) * torch.exp(-t_drive / tau_w)
    q_at_sense = 0.5 + (q_written - 0.5) * leak

    t_open = row_open_time(residual, q_at_sense, tau_r_t, cell.xfer, c)
    m_sense = ((sense_delta_v(q_at_sense, cell.xfer) - residual - c.dv_min)
               / c.dv_min)
    m_rcd = (trcd - t_open) / 1.0
    m_floor = twr - c.t_wr_floor * (tau_r_t / 4.5)
    return torch.minimum(torch.minimum(m_sense, m_rcd), m_floor)


def margin_sweep(cell_stack: torch.Tensor, combos: torch.Tensor,
                 temps_combo: torch.Tensor,
                 c: ChargeConstants = DEFAULT_CONSTANTS,
                 trefi_read_cells: torch.Tensor | None = None,
                 trefi_write_cells: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (cells x combos) margin grids with a per-combo temperature.

    cell_stack: [n, 5] stacked CellParams; combos: [m, 5];
    temps_combo: [m]; trefi_read_cells / trefi_write_cells: optional
    [n] per-cell refresh-interval overrides for the read / write test.
    Returns (read_margins, write_margins), each [n, m].
    """
    cell = CellParams.unstack(cell_stack[:, None, :])       # [n, 1, 5]
    cm = combos[None, :, :]                                  # [1, m, 5]
    t = temps_combo.to(cell_stack.dtype)[None, :]            # [1, m]
    tr = None if trefi_read_cells is None else trefi_read_cells[:, None]
    tw = None if trefi_write_cells is None else trefi_write_cells[:, None]
    return (read_margin(cell, cm, t, c, tr),
            write_margin(cell, cm, t, c, tw))


def combo_margins(cell_stack: torch.Tensor, combos: torch.Tensor,
                  temp_c: float,
                  c: ChargeConstants = DEFAULT_CONSTANTS,
                  trefi_cells: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (cells x combos) margin grids for read and write tests at a
    single temperature — the scalar-temperature case of `margin_sweep`.

    cell_stack: [n, 5] stacked CellParams; combos: [m, 5];
    trefi_cells: optional [n] per-cell refresh interval override for
    both tests.  Returns (read_margins, write_margins), each [n, m], in
    ONE `margin_grid` call: the CUDA kernel on a card, its plain
    version on the CPU."""
    from repro_torch.kernels.charge_sim import ops
    return ops.combo_margins(cell_stack, combos, temp_c, c, trefi_cells)


def row_positions(n_cells: int) -> torch.Tensor:
    """[n_cells] normalized row position of each sampled tail cell
    within its bank: 0 = next to the sense amplifiers / wordline
    drivers, 1 = the far end of the subarray.  The spatial hierarchy
    splits this axis into contiguous subarray regions (cell k ->
    region k * regions // n_cells)."""
    return (torch.arange(n_cells, dtype=torch.float32) + 0.5) / n_cells


def region_gradient(positions: torch.Tensor, k_region: float,
                    weak_signs) -> torch.Tensor:
    """[n_cells, 5] multiplicative within-bank margin gradient
    (design-induced variation): every field shifts toward its weak
    direction in proportion to the centered row position.  `k_region`
    is the ln-scale gradient over the whole bank (0.0 = off);
    `weak_signs` is `variation.FIELD_WEAK_SIGNS`."""
    signs = torch.as_tensor(weak_signs, dtype=torch.float32,
                            device=positions.device)
    return torch.exp(k_region * (positions[:, None] - 0.5) * signs[None, :])


def refresh_margin(cell_stack: torch.Tensor, trefi_ms: torch.Tensor,
                   std_combo: torch.Tensor, temp_c: float, op: str,
                   c: ChargeConstants = DEFAULT_CONSTANTS) -> torch.Tensor:
    """Margins over a refresh-interval sweep at standard timings
    (Fig. 2a).  trefi_ms: [k]; returns [n_cells, k]."""
    combos = std_combo.to(cell_stack).expand(trefi_ms.shape[0], 5).clone()
    combos[:, 4] = trefi_ms
    cell = CellParams.unstack(cell_stack[:, None, :])
    t = torch.as_tensor(temp_c, dtype=cell_stack.dtype,
                        device=cell_stack.device)
    fn = read_margin if op == "read" else write_margin
    return fn(cell, combos[None, :, :], t, c)

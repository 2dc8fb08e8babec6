"""Process-variation population model (paper Sec. 2, 5.2), on a
`torch.Generator` (port of `repro.core.variation`).

For every (module, chip, bank) triple we sample K "tail cells" that
represent the weak end of that unit's cell distribution.  Each
electrical parameter is hierarchical-lognormal:

    ln x = ln mu + N(0, s_module) + N(0, s_chip) + N(0, s_bank) + tail

with `tail` a one-sided half-normal pushing sampled cells toward the
weak side.  The draw is the same distribution as the JAX reference's
threefry draw, not the same bits: parity tests hand the JAX-sampled
cells across through `repro_torch.convert`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

N_MODULES = 115
N_CHIPS = 8
N_BANKS = 8
N_TAIL_CELLS = 24      # tail cells sampled per (module, chip, bank)

# weak direction of each stacked CellParams field (tau_r, xfer,
# tau_ret85, tau_p, tau_w): +1 = a larger value is the weaker cell
FIELD_WEAK_SIGNS = (+1.0, -1.0, -1.0, +1.0, +1.0)


@dataclasses.dataclass(frozen=True)
class VariationConfig:
    """Population hyper-parameters (medians + spreads, lognormal)."""

    # medians of the WORST-CELL distribution per unit
    mu_tau_r: float = 4.7          # ns     (sense-path RC constant)
    mu_xfer: float = 0.185         # -      (charge transfer ratio)
    mu_tau_ret85: float = 650.0    # ms     (retention tau at 85C)
    mu_tau_p: float = 0.28         # ns     (precharge RC)
    mu_tau_w: float = 2.0          # ns     (cell charging RC)

    # hierarchical spreads (sigma of ln-value), scaled per field below
    s_module: float = 0.16
    s_chip: float = 0.065
    s_bank: float = 0.055
    s_cell: float = 0.12           # one-sided tail spread

    # per-field sigma scale factors
    k_tau_r: float = 0.04
    k_xfer: float = 0.03
    k_tau_ret: float = 2.0
    k_tau_p: float = 0.45
    k_tau_w: float = 1.5

    # correlated-weakness: a slow cell also retains worse
    rc_ret_corr: float = 0.15

    # within-bank row-position gradient (subarray regions): ln-scale
    # shift toward the weak side across the bank; 0.0 = off
    k_region: float = 0.0

    n_modules: int = N_MODULES
    n_chips: int = N_CHIPS
    n_banks: int = N_BANKS
    n_cells: int = N_TAIL_CELLS


class Population(NamedTuple):
    """cells: [modules, chips, banks, K, 5] float32 stacked CellParams
    (tau_r, xfer, tau_ret85, tau_p, tau_w).  The bank axis is the
    RANK-level bank: index b spans bank b of every chip."""

    cells: torch.Tensor

    @property
    def n_modules(self) -> int:
        return self.cells.shape[0]

    @property
    def n_banks(self) -> int:
        return self.cells.shape[2]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[3]

    def flat_cells(self) -> torch.Tensor:
        return self.cells.reshape(-1, self.cells.shape[-1])

    def to(self, device: str | torch.device) -> "Population":
        return Population(self.cells.to(device))


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _hier_field(gen: torch.Generator, cfg: VariationConfig, mu: float,
                weak_sign: float, k_field: float,
                extra_cell: torch.Tensor | None = None) -> torch.Tensor:
    """One lognormal field over the full population hierarchy; the
    one-sided cell tail always pushes toward the weak side."""
    m, ch, bk, k = cfg.n_modules, cfg.n_chips, cfg.n_banks, cfg.n_cells
    z = (_randn(gen, (m, 1, 1, 1)) * cfg.s_module
         + _randn(gen, (m, ch, 1, 1)) * cfg.s_chip
         + _randn(gen, (m, ch, bk, 1)) * cfg.s_bank)
    tail = _randn(gen, (m, ch, bk, k)).abs() * cfg.s_cell
    if extra_cell is not None:
        tail = tail + extra_cell * cfg.s_cell
    return mu * torch.exp(k_field * (z + weak_sign * tail))


def sample_population(generator: torch.Generator,
                      cfg: VariationConfig = VariationConfig(),
                      device: str | torch.device = "cuda") -> Population:
    """Draw the simulated module population from `generator` (a CPU
    `torch.Generator`, so one seed gives the same cells on every
    device) and place it on `device`."""
    dev = resolve_device(device)
    shape = (cfg.n_modules, cfg.n_chips, cfg.n_banks, cfg.n_cells)
    # shared weakness component: correlates slow-RC with short retention
    shared = _randn(generator, shape).abs() * cfg.rc_ret_corr

    tau_r = _hier_field(generator, cfg, cfg.mu_tau_r, +1.0, cfg.k_tau_r,
                        shared)
    xfer = _hier_field(generator, cfg, cfg.mu_xfer, -1.0, cfg.k_xfer)
    tau_ret = _hier_field(generator, cfg, cfg.mu_tau_ret85, -1.0,
                          cfg.k_tau_ret, shared)
    tau_p = _hier_field(generator, cfg, cfg.mu_tau_p, +1.0, cfg.k_tau_p)
    tau_w = _hier_field(generator, cfg, cfg.mu_tau_w, +1.0, cfg.k_tau_w)

    cells = torch.stack([tau_r, xfer, tau_ret, tau_p, tau_w], dim=-1)
    if cfg.k_region != 0.0:
        # within-bank row-position gradient: the tail-cell axis is the
        # row-position axis (charge.row_positions), so cells far from
        # the sense amps shift toward the weak side
        from repro_torch.core.charge import region_gradient, row_positions
        grad = region_gradient(row_positions(cfg.n_cells), cfg.k_region,
                               FIELD_WEAK_SIGNS)
        cells = cells * grad[None, None, None, :, :]
    return Population(cells=cells.to(dev))

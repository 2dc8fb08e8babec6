"""Closed-loop thermal model for adaptive-timing replay (port of
`repro.core.thermal`; paper Sec. 4).

AL-DRAM's defining feature is *online* adaptation: the memory
controller reads the module's current temperature and switches timing
registers on the fly.  This module supplies the temperature side of
that loop as a first-order RC model that runs inside the replay
(`repro_torch.core.dram_sim.replay_adaptive_cells`, the
`adaptive_blocks` CUDA kernel):

  * every access deposits heat on its bank, proportional to the access
    energy of `repro_torch.core.power` (a row miss pays the ACT/PRE
    pair plus the row-active window of the *currently selected* tRAS,
    so faster timings run cooler — the loop is closed),
  * between requests the per-bank heat decays toward a time-varying
    ambient with time constant `tau_ns`,
  * the module's sensed temperature is the ambient plus the summed
    bank overheat, and the controller re-selects its temperature bin
    from it per request (count of bin edges below it, with hysteresis).

A scenario row is

    [base, amp_sin, period_sin_ns, amp_step, t_step_ns,
     amp_burst, period_burst_ns, duty, hyst_scale]

and `ambient_at(row, t)` evaluates

    base + amp_sin * sin(2*pi*t/period_sin)          (diurnal ramp)
         + amp_step * (t >= t_step)                  (cooling failure)
         + amp_burst * ((t mod period_burst) < duty*period_burst)
                                                     (bursty load)

`hyst_scale` scales the config's hysteresis for this scenario only; the
`oracle()` variant of a scenario has hyst_scale = 0 (instant bin
selection), which prices the real controller's hysteresis.

Hysteresis: switching UP to a hotter bin is immediate, switching DOWN
needs the sensed temperature `hyst_c` below the cooler bin's edge.
Above the hottest bin the JEDEC row (last in the table stack) serves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.power import PowerParams, energy_terms

# scenario-row columns (see module docstring)
SCN_COLS = 9
# 2*pi rounded to float32, the constant every evaluation of `ambient_at`
# multiplies by (the CUDA kernel uses the same float)
TWO_PI_F32 = float(np.float32(2.0 * math.pi))


@dataclasses.dataclass(frozen=True)
class ThermalConfig:
    """Physical constants of the RC model (one per campaign).

    tau_ns : RC time constant of the heat decay toward ambient.
    c_heat : degrees C deposited per unit of access energy (0 disables
             activity heating).
    hyst_c : down-switch hysteresis in degrees C (scaled per scenario
             by `hyst_scale`).
    power  : energy decomposition used for the per-access deposit.
    """

    tau_ns: float = 2.0e5
    # equilibrium overheat ~= c_heat * energy_per_access * tau / gap:
    # ~1 C at desktop traffic (20 ns gaps), ~2-8 C for a saturating
    # multi-core stream (4-5 ns gaps)
    c_heat: float = 2.0e-5
    hyst_c: float = 2.0
    power: PowerParams = dataclasses.field(default_factory=PowerParams)

    def as_row(self) -> np.ndarray:
        """[6] float32 row consumed by the replay: (tau_ns, c_heat,
        hyst_c, e_burst, e_act_pre, p_act_standby)."""
        return np.concatenate([
            np.array([self.tau_ns, self.c_heat, self.hyst_c],
                     np.float32), energy_terms(self.power)])


@dataclasses.dataclass(frozen=True)
class ThermalScenario:
    """One ambient/cooling trajectory (a campaign axis cell)."""

    name: str
    base_c: float
    amp_sin: float = 0.0
    period_sin_ns: float = 1.0
    amp_step: float = 0.0
    t_step_ns: float = 0.0
    amp_burst: float = 0.0
    period_burst_ns: float = 1.0
    duty: float = 0.0
    hyst_scale: float = 1.0

    def as_row(self) -> np.ndarray:
        return np.array([self.base_c, self.amp_sin, self.period_sin_ns,
                         self.amp_step, self.t_step_ns, self.amp_burst,
                         self.period_burst_ns, self.duty,
                         self.hyst_scale], np.float32)

    def oracle(self) -> "ThermalScenario":
        """Zero-hysteresis variant: the controller tracks the sensed
        temperature instantly (the upper bound on adaptive gains)."""
        return dataclasses.replace(self, name=self.name + "+oracle",
                                   hyst_scale=0.0)


# ------------------------------------------------------- scenario builders
def steady(temp_c: float, name: str | None = None) -> ThermalScenario:
    """Constant ambient: with `c_heat = 0` it reproduces the static
    replay bit for bit."""
    return ThermalScenario(name or f"steady{temp_c:.0f}C", base_c=temp_c)


def diurnal(lo_c: float, hi_c: float, period_ns: float = 4.0e5,
            name: str | None = None) -> ThermalScenario:
    """Sinusoidal ramp between `lo_c` and `hi_c`."""
    mid, amp = (lo_c + hi_c) / 2.0, (hi_c - lo_c) / 2.0
    return ThermalScenario(name or f"diurnal{lo_c:.0f}-{hi_c:.0f}C",
                           base_c=mid, amp_sin=amp,
                           period_sin_ns=period_ns)


def cooling_failure(base_c: float, jump_c: float,
                    at_ns: float = 2.0e4,
                    name: str | None = None) -> ThermalScenario:
    """Step: the ambient jumps by `jump_c` at `at_ns` and stays."""
    return ThermalScenario(name or f"coolfail+{jump_c:.0f}C",
                           base_c=base_c, amp_step=jump_c, t_step_ns=at_ns)


def bursty(base_c: float, amp_c: float, period_ns: float = 1.0e5,
           duty: float = 0.5, name: str | None = None) -> ThermalScenario:
    """Square-wave ambient: hot bursts of `duty` fraction of each
    period."""
    return ThermalScenario(name or f"bursty+{amp_c:.0f}C", base_c=base_c,
                           amp_burst=amp_c, period_burst_ns=period_ns,
                           duty=duty)


def stack_scenarios(scns: Sequence[ThermalScenario]) -> np.ndarray:
    """[C, SCN_COLS] scenario-row matrix for one campaign."""
    return np.stack([s.as_row() for s in scns], axis=0)


def rate_scenario(kind: str) -> ThermalScenario:
    """Arrival-rate modulation for multi-tenant traffic: the same
    encoding read as a dimensionless rate multiplier.  "poisson" is a
    flat 1.0, "diurnal" swings 0.4x-1.6x, "bursty" square-waves
    1.0x-2.5x."""
    if kind == "poisson":
        return steady(1.0, name="poisson-rate")
    if kind == "diurnal":
        return diurnal(0.4, 1.6, name="diurnal-rate")
    if kind == "bursty":
        return bursty(1.0, 1.5, duty=0.3, name="bursty-rate")
    raise ValueError(f"unknown rate scenario {kind!r}")


def ambient_at(scn_row: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Ambient temperature of scenario row(s) at time(s) `t` (ns).
    `scn_row` is indexed on its FIRST axis ([SCN_COLS] or [SCN_COLS,
    ...lanes]) and broadcasts against `t`.  float32 throughout, every
    division a true division by a tensor, summed left to right — the
    operation order the `adaptive_blocks` kernel repeats."""
    base, a_sin, p_sin, a_step, t_step, a_b, p_b, duty = (
        scn_row[i] for i in range(8))
    two_pi = torch.tensor(TWO_PI_F32, dtype=torch.float32, device=t.device)
    sin_part = a_sin * torch.sin(two_pi * t / p_sin)
    step_part = a_step * (t >= t_step).to(torch.float32)
    burst_part = a_b * (torch.remainder(t, p_b)
                        < duty * p_b).to(torch.float32)
    return base + sin_part + step_part + burst_part


def ambient_at_host(scn: ThermalScenario, t: float) -> float:
    """Host-side float64 reference of `ambient_at`."""
    r = scn.as_row().astype(np.float64)
    return float(r[0] + r[1] * np.sin(2.0 * np.pi * t / r[2])
                 + r[3] * (t >= r[4])
                 + r[5] * ((t % r[6]) < r[7] * r[6]))


@dataclasses.dataclass(frozen=True)
class ThermalSpec:
    """The thermal axis of a `sim_engine.SimSpec` campaign: scenarios,
    the bin edges the in-replay controller selects over, and the RC
    constants.  Attaching one switches the engine to the adaptive
    replay; the timing axis is then a stack of TABLES ([K,
    len(temp_bins)+1, 6] or per-bank [K, len(temp_bins)+1, banks, 6],
    last row = JEDEC fallback)."""

    scenarios: tuple[ThermalScenario, ...]
    temp_bins: tuple[float, ...]
    config: ThermalConfig = dataclasses.field(default_factory=ThermalConfig)

    def __post_init__(self):
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "temp_bins", tuple(self.temp_bins))
        if not self.scenarios:
            raise ValueError("empty thermal axis")
        if list(self.temp_bins) != sorted(self.temp_bins):
            raise ValueError(f"temp_bins must ascend: {self.temp_bins}")

    def pack(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(scenario rows [C, SCN_COLS], bin edges [S], config row [6])."""
        return (stack_scenarios(self.scenarios),
                np.asarray(self.temp_bins, np.float32),
                self.config.as_row())


__all__ = ["SCN_COLS", "ThermalConfig", "ThermalScenario", "ThermalSpec",
           "steady", "diurnal", "cooling_failure", "bursty",
           "stack_scenarios", "rate_scenario", "ambient_at",
           "ambient_at_host"]

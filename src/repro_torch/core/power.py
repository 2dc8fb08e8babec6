"""DRAM energy model (port of `repro.core.power`; paper Sec. 7: AL-DRAM
reduces DRAM power by 5.8%).

Micron-style decomposition for a fixed amount of work W:

    E = P_background * T  +  N * (e_burst + miss * (e_act_pre + p_as * tRAS))

AL-DRAM reduces E two ways: the shorter tRAS shrinks the row-active
(IDD3N) window per miss, and the end-to-end speedup shrinks the
background term.

The same decomposition drives the closed-loop thermal model
(`repro_torch.core.thermal`, `dram_sim.replay_adaptive_cells` and the
`adaptive_blocks` kernel): each replayed access deposits heat in
proportion to `access_energy_from_terms`, with the row-hit flag and the
*selected* tRAS taken from the live replay state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.timing import ALDRAM_55C_EVAL, DDR3_1600, TimingParams


@dataclasses.dataclass(frozen=True)
class PowerParams:
    # representative DDR3 rank; relative units calibrated so the
    # background share of total energy is ~35% and the row-active
    # window is ~15% of access energy (Micron TN-41-01 ballpark)
    background_share: float = 0.35   # of total energy at standard timings
    e_burst: float = 4.0             # per column burst
    e_act_pre: float = 5.0           # per ACT/PRE pair
    p_act_standby: float = 0.055     # per ns of row-active window


def energy_terms(pw: PowerParams) -> np.ndarray:
    """(e_burst, e_act_pre, p_act_standby) float32, in the order the
    adaptive replay consumes them (`thermal.ThermalConfig.as_row`)."""
    return np.array([pw.e_burst, pw.e_act_pre, pw.p_act_standby],
                    np.float32)


def access_energy_from_terms(e_burst, e_act_pre, p_act_standby, miss,
                             tras):
    """Energy of one access from the decomposed terms: the one formula
    for Python floats (`access_energy`) and tensors (the adaptive
    replay's heat deposit; the CUDA kernel repeats it operation for
    operation)."""
    return e_burst + miss * (e_act_pre + p_act_standby * tras)


def access_energy(tp: TimingParams, row_hit: float, pw: PowerParams) -> float:
    return float(access_energy_from_terms(
        pw.e_burst, pw.e_act_pre, pw.p_act_standby, 1.0 - row_hit,
        tp.tras))


def power_reduction(row_hit: float = 0.55, speedup: float = 0.105,
                    std: TimingParams = DDR3_1600,
                    fast: TimingParams = ALDRAM_55C_EVAL,
                    pw: PowerParams = PowerParams()) -> dict:
    """Energy for identical work under standard vs AL-DRAM timings."""
    e_std = access_energy(std, row_hit, pw)
    e_fast = access_energy(fast, row_hit, pw)
    beta = pw.background_share
    ratio = beta / (1.0 + speedup) + (1 - beta) * (e_fast / e_std)
    return {
        "power_reduction": 1.0 - ratio,
        "per_access_reduction": 1.0 - e_fast / e_std,
        "background_share": beta,
    }

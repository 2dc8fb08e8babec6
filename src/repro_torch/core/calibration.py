"""Calibrated charge/variation constants (port of the frozen values in
`repro.core.calibration`; the search loop that fitted them is not
ported yet).

The constants were fitted so the simulated population pushed through
the profiling procedure reproduces the paper's Sec. 5 statistics.
"""

from __future__ import annotations

from repro_torch.core.charge import ChargeConstants
from repro_torch.core.variation import VariationConfig

CALIBRATED_CONSTANTS = ChargeConstants(
    t_wl=1.8840, alpha_share=1.435, tau_s=1.2, dv_full=0.26,
    dv_min=0.0340, t_p0=8.0, t_wr_base=0.6444, t_wr_floor=3.4530,
    kappa_w=0.7540, beta_w=0.3326, dv_full_w=0.055,
    k_ret=0.0693, k_rc=0.0020,
)

CALIBRATED_VARIATION = VariationConfig(
    mu_tau_r=4.1441, mu_xfer=0.185, mu_tau_ret85=573.7, mu_tau_p=0.1,
    mu_tau_w=5.4428,
    s_module=0.0511, s_chip=0.065, s_bank=0.055, s_cell=0.12,
    k_tau_r=0.02, k_xfer=0.0241, k_tau_ret=1.857, k_tau_p=0.9195,
    k_tau_w=2.3105,
    rc_ret_corr=0.2876,
)

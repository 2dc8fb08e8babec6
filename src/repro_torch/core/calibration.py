"""Calibration of the charge/variation model against the paper's
measured population statistics (Sec. 5), port of
`repro.core.calibration`: the frozen constants and the search that
fitted them.

The paper measures 115 physical DIMMs; we cannot.  Instead the
simulation constants are fitted so that the *simulated* population
pushed through the *same profiling procedure* reproduces the paper's
reported statistics (`TARGETS`): the representative module's maximum
error-free refresh interval at 85C (208 ms read, 160 ms write), the
average per-parameter timing reductions at 55C and 85C, and the read /
write latency-sum reductions.

    PYTHONPATH=src python -m repro_torch.core.calibration --iters 200
    PYTHONPATH=src python -m repro_torch.core.calibration --full-eval

`evaluate` is the profiling procedure: one refresh campaign (both
ops) and one fused (55C, 85C) x (read, write) timing campaign on a
`Profiler` at the full 1.25 ns grid, two margin-grid launches on the
card.  `run_search` is the seeded random-perturbation coordinate search
over the physics constants; its proposals are numpy draws from
`np.random.default_rng(seed)` in the reference's order, while each
candidate's population is the port's own draw from a
`torch.Generator`.  The *profiling mechanism* itself (sweeps,
guardbands, combo selection) is never fitted, only the simulated
silicon.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from repro_torch.core import timing as T
from repro_torch.core.charge import ChargeConstants
from repro_torch.core.variation import (Population, VariationConfig,
                                        sample_population)

# ---------------------------------------------------------------------------
# Paper targets
# ---------------------------------------------------------------------------

TARGETS = {
    "refresh_read_median_85": 208.0,   # ms, representative module (Fig. 2a)
    "refresh_write_median_85": 160.0,  # ms
    "red55_trcd": 0.173, "red55_tras": 0.377,
    "red55_twr": 0.548, "red55_trp": 0.352,
    "red85_trcd": 0.156, "red85_tras": 0.204,
    "red85_twr": 0.206, "red85_trp": 0.285,
    "red55_read_sum": 0.327, "red85_read_sum": 0.211,
    "red55_write_sum": 0.551, "red85_write_sum": 0.344,
}

WEIGHTS = {k: (3.0 if "sum" in k else 1.0) for k in TARGETS}
WEIGHTS["refresh_read_median_85"] = 0.01   # ms-scale -> weight down
WEIGHTS["refresh_write_median_85"] = 0.01

# ---------------------------------------------------------------------------
# Calibrated values (output of run_search seed 0 on the full 1.25 ns
# grid, final loss 0.0719)
# ---------------------------------------------------------------------------

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

_SEARCH_FIELDS = [
    # (object, field, lo, hi)
    ("c", "t_wl", 0.5, 4.0),
    ("c", "alpha_share", 0.8, 3.5),
    ("c", "tau_s", 0.05, 1.2),
    ("c", "dv_min", 0.02, 0.06),
    ("c", "t_p0", 5.0, 11.0),
    ("c", "t_wr_base", -8.0, 6.0),
    ("c", "beta_w", 0.08, 2.2),
    ("c", "t_wr_floor", 2.0, 11.0),
    ("c", "kappa_w", 0.5, 0.95),
    ("v", "mu_tau_r", 2.0, 7.0),
    ("v", "mu_tau_ret85", 120.0, 1200.0),
    ("v", "mu_tau_p", 0.1, 0.9),
    ("v", "s_module", 0.05, 0.3),
    ("v", "s_cell", 0.04, 0.25),
    ("v", "rc_ret_corr", 0.0, 0.6),
    ("v", "k_tau_r", 0.02, 0.6),
    ("v", "k_xfer", 0.02, 0.5),
    ("v", "k_tau_ret", 0.6, 3.5),
    ("v", "k_tau_p", 0.1, 1.2),
    ("v", "mu_tau_w", 0.5, 6.0),
    ("v", "k_tau_w", 0.2, 3.5),
]


class OutOfRangeCandidate(ValueError):
    """A candidate whose simulated silicon leaves the model's range: its
    population or its statistics are not finite (an overflowing
    lognormal field, a margin that is NaN).  `run_search` skips such a
    candidate; any other error propagates."""


def evaluate(constants: ChargeConstants, variation: VariationConfig,
             seed: int = 0, fast: bool = True, *,
             pop: Population | None = None,
             device: str | torch.device = "cuda") -> dict[str, float]:
    """Run the full profiling procedure on a simulated population and
    return the paper-comparable statistics: one refresh campaign (both
    ops) and one fused (55C, 85C) x (read, write) timing campaign, two
    margin-grid launches.  `pop` is the population to profile (e.g. one
    handed across through `repro_torch.convert.population`); without
    it the port samples `variation` from `torch.Generator().manual_seed(
    seed)`, cut to 64 modules x 8 cells when `fast` (the FULL 1.25 ns
    grid either way: combo quantisation shifts the chosen cuts, so the
    search must see the grid the benchmarks use).  Raises
    `OutOfRangeCandidate` when the population or a statistic is not
    finite."""
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sweep import Op

    if pop is None:
        if fast:
            variation = dataclasses.replace(variation, n_modules=64,
                                            n_cells=8)
        pop = sample_population(torch.Generator().manual_seed(seed),
                                variation, device=device)
    if not bool(torch.isfinite(pop.cells).all()):
        raise OutOfRangeCandidate("the sampled population is not finite")
    prof = Profiler(constants, grid_step=T.TIMING_STEP_NS, device=device)

    stats: dict[str, float] = {}
    rp_read, rp_write = prof.refresh_campaign(pop, 85.0)
    stats["refresh_read_median_85"] = float(np.median(rp_read.per_module))
    stats["refresh_write_median_85"] = float(np.median(rp_write.per_module))
    stats["refresh_read_min_85"] = float(rp_read.per_module.min())
    stats["refresh_read_max_bank_85"] = float(rp_read.per_bank.max())

    temps = ((55.0, "red55"), (85.0, "red85"))
    res = prof.engine.sweep(pop, prof.campaign_spec(
        tuple(t for t, _ in temps), rp_read, rp_write))
    red_r = res.reductions(Op.READ)
    red_w = res.reductions(Op.WRITE)
    for ti, (_, tag) in enumerate(temps):
        stats[f"{tag}_trcd"] = red_r[ti]["trcd"]
        stats[f"{tag}_tras"] = red_r[ti]["tras"]
        stats[f"{tag}_trp"] = red_r[ti]["trp"]
        stats[f"{tag}_twr"] = red_w[ti]["twr"]
        stats[f"{tag}_read_sum"] = red_r[ti]["latency_sum"]
        stats[f"{tag}_write_sum"] = red_w[ti]["latency_sum"]
    bad = [k for k, v in stats.items() if not math.isfinite(v)]
    if bad:
        raise OutOfRangeCandidate(f"statistics not finite: {bad}")
    return stats


def loss(stats: dict[str, float]) -> float:
    return float(sum(WEIGHTS[k] * (stats.get(k, 0.0) - v) ** 2
                     for k, v in TARGETS.items()))


def residuals(stats: dict[str, float]) -> dict[str, float]:
    return {k: stats.get(k, float("nan")) - v for k, v in TARGETS.items()}


def run_search(iters: int = 200, seed: int = 0,
               start_c: ChargeConstants | None = None,
               start_v: VariationConfig | None = None,
               verbose: bool = True, *,
               device: str | torch.device = "cuda"):
    """Seeded random-perturbation coordinate search (annealing-lite):
    each iteration draws a field and a normal step from
    `np.random.default_rng(seed)` (the reference's draws, in its order),
    evaluates the candidate and keeps it if the loss drops.  Returns
    (constants, variation, stats, loss) of the best candidate."""
    rng = np.random.default_rng(seed)
    best_c = start_c or CALIBRATED_CONSTANTS
    best_v = start_v or CALIBRATED_VARIATION
    best_stats = evaluate(best_c, best_v, seed=seed, device=device)
    best = loss(best_stats)
    if verbose:
        print(f"init loss {best:.5f}")

    for it in range(iters):
        scale = 0.25 * (1.0 - it / iters) + 0.03
        obj, field, lo, hi = _SEARCH_FIELDS[rng.integers(len(_SEARCH_FIELDS))]
        src = best_c if obj == "c" else best_v
        cur = getattr(src, field)
        step = (hi - lo) * scale * rng.normal()
        new = float(np.clip(cur + step, lo, hi))
        cand_c = dataclasses.replace(best_c, **{field: new}) if obj == "c" else best_c
        cand_v = dataclasses.replace(best_v, **{field: new}) if obj == "v" else best_v
        try:
            stats = evaluate(cand_c, cand_v, seed=seed, device=device)
        except OutOfRangeCandidate:
            # a bad candidate, not a bad run: a CUDA or launch error
            # propagates
            continue
        cand = loss(stats)
        if cand < best:
            best, best_c, best_v, best_stats = cand, cand_c, cand_v, stats
            if verbose:
                print(f"[{it:4d}] loss {best:.5f}  {obj}.{field} -> {new:.4g}")
    return best_c, best_v, best_stats, best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full-eval", action="store_true",
                   help="evaluate the frozen constants on the full population")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.full_eval:
        stats = evaluate(CALIBRATED_CONSTANTS, CALIBRATED_VARIATION,
                         seed=args.seed, fast=False, device=args.device)
        print(json.dumps({"stats": stats,
                          "residuals": residuals(stats),
                          "loss": loss(stats)}, indent=2))
        return 0

    c, v, stats, best = run_search(args.iters, args.seed, device=args.device)
    print("\nbest loss:", best)
    print("constants:", c)
    print("variation:", v)
    print(json.dumps({"stats": stats, "residuals": residuals(stats)},
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

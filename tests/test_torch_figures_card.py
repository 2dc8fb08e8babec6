"""The port's figure driver and calibration evaluation on the card against
the same runs on the CPU (`benchmarks/port_fig2_timing.py`,
`repro_torch.core.calibration.evaluate`), at `--fast`, from the same
cells.  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src:. python -m pytest -q --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_figures_card.py

Every test needs an NVIDIA card and skips without one (decided inside
the `cuda` fixture, never at import).  Card and CPU must give equal
results, or differ only where a campaign's pass/fail flipped at a margin
within 2e-4 of zero (the margin kernel differs from its plain version in
the last bits); such flips are counted and printed, and the test then
records itself as xfailed (equality not compared)."""

import dataclasses

import numpy as np
import pytest
import torch

TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _flips(card, cpu) -> int:
    card, cpu = card.cpu().numpy(), cpu.numpy()
    d = (card >= 0) != (cpu >= 0)
    assert (np.abs(cpu[d]) <= TOL).all(), cpu[d]
    return int(d.sum())


def _campaign_flips(pop, temps, grid_step) -> int:
    """Pass/fail flips between the card and the CPU in the 85C refresh
    sweep and the fused timing sweep over `temps`, on `pop`'s cells."""
    from repro_torch.core.calibration import CALIBRATED_CONSTANTS
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.timing import DDR3_1600, refresh_grid
    grid = refresh_grid()
    combos = np.repeat(DDR3_1600.as_array().numpy()[None], len(grid), 0)
    combos[:, 4] = grid
    out = {}
    for dev in ("cuda", "cpu"):
        prof = Profiler(CALIBRATED_CONSTANTS, grid_step=grid_step, device=dev)
        p = pop.to(dev)
        rm = prof.engine.margins(p.flat_cells(), combos, temp_c=85.0)
        res = prof.engine.sweep(p, prof.campaign_spec(
            temps, *prof.refresh_campaign(p, 85.0)))
        out[dev] = list(rm) + list(res.margins)
    return sum(_flips(a, b) for a, b in zip(out["cuda"], out["cpu"]))


@pytest.mark.gpu
def test_fig2_timing_card_matches_cpu(cuda):
    from benchmarks import port_fig2_timing as PF
    from benchmarks.port_common import population
    pop = population(True, device="cpu")
    card = PF.run(True, pop=pop.to("cuda"), device="cuda")
    cpu = PF.run(True, pop=pop, device="cpu")
    if card != cpu:
        n = _campaign_flips(pop, PF.TEMPS, 2.5)
        print(f"fig2_timing --fast card vs CPU: {n} pass/fail flips")
        assert n > 0, (card, cpu)
        pytest.xfail(f"fig2_timing --fast: {n} near-zero pass/fail flips, "
                     "equality not compared")
    else:
        print("fig2_timing --fast card vs CPU: equal")


@pytest.mark.gpu
def test_calibration_evaluate_card_matches_cpu(cuda):
    from repro_torch.core import calibration as C
    from repro_torch.core.variation import sample_population
    cfg = dataclasses.replace(C.CALIBRATED_VARIATION, n_modules=64,
                              n_cells=8)
    pop = sample_population(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    card = C.evaluate(C.CALIBRATED_CONSTANTS, cfg, pop=pop.to("cuda"),
                      device="cuda")
    cpu = C.evaluate(C.CALIBRATED_CONSTANTS, cfg, pop=pop, device="cpu")
    # without a population the card samples the same cells (a CPU
    # generator) and so gives the same statistics
    assert C.evaluate(C.CALIBRATED_CONSTANTS, C.CALIBRATED_VARIATION,
                      device="cuda") == card
    if card != cpu:
        n = _campaign_flips(pop, (55.0, 85.0), 1.25)
        print(f"calibration.evaluate --fast card vs CPU: {n} pass/fail "
              "flips")
        assert n > 0, (card, cpu)
        pytest.xfail(f"calibration.evaluate --fast: {n} near-zero pass/fail "
                     "flips, equality not compared")
    else:
        print(f"calibration.evaluate --fast card vs CPU: equal, loss "
              f"{C.loss(card):.6f}")

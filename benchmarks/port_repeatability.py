"""Sec. 7.6 on the port: the repeatability of cell failures under
reduced timings, `benchmarks/repeatability.py` on `repro_torch`.

    PYTHONPATH=src python -m benchmarks.port_repeatability [--fast] \
        [--device cpu]

The paper repeats failing tests and finds > 95 % of erroneous cells
fail consistently.  Per-test operational noise (power / beat noise on
the sense margin, sigma 0.02) is drawn on top of each cell's
deterministic margin under one deliberately aggressive combo at 55C,
and the bench reports the fraction of failing cells that fail in >= 9
of 10 repeats.  The margins are ONE `MarginEngine` launch over every
cell of the population (176,640 x 1 at full size: the margin kernel on
a card, its plain version on the CPU); the noise is
`np.random.default_rng(0)`, drawn in the reference's order, so on the
reference's population only cells whose noisy margin lies within the
kernel's last bits of zero can differ.  This module imports neither JAX
nor the reference package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from benchmarks.port_common import emit, population, timed

MARGIN_NOISE = 0.02      # operational noise, in margin units


def stress_combo() -> np.ndarray:
    """[1, 5]: a deliberately aggressive combo, so a fraction of cells
    fail, at a 256 ms refresh interval to stress retention too."""
    from repro_torch.core import timing as T
    combo = T.DDR3_1600.as_array().numpy()[None, :].copy()
    combo[0, :4] *= [0.7, 0.45, 0.40, 0.60]
    combo[0, 4] = 256.0
    return combo


def run(fast: bool = False, repeats: int = 10, *, pop=None,
        device="cuda") -> dict:
    import torch

    from repro_torch.core.calibration import CALIBRATED_CONSTANTS
    from repro_torch.core.sweep import MarginEngine
    pop = population(fast, device=device) if pop is None else pop
    eng = MarginEngine(constants=CALIBRATED_CONSTANTS, device=device)
    combo = stress_combo()
    with timed(device) as t:
        r, w = eng.margins(pop.flat_cells(), combo, temp_c=55.0)
        margin = torch.minimum(r, w)[:, 0].cpu().numpy()
        rng = np.random.default_rng(0)
        noisy = np.stack([margin + rng.normal(0, MARGIN_NOISE, margin.shape)
                          for _ in range(repeats)])
        fails = noisy < 0
    ever = fails.any(0)
    consistent = (fails.sum(0) >= repeats - 1) & ever
    frac = consistent.sum() / max(ever.sum(), 1)
    out = {"failing_cells": int(ever.sum()),
           "repeatable_fraction": float(frac)}
    emit("sec76_repeatability", t.us,
         f"repeatable={frac:.1%}(paper >95%)|failing={int(ever.sum())}")
    out["margin"] = margin
    out["noisy"] = noisy
    out["dispatches"] = {"margin": eng.dispatch_count}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.fast, device=args.device)
    print(json.dumps({k: out[k] for k in ("failing_cells",
                                          "repeatable_fraction")}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

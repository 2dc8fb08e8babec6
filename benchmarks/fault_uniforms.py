"""Write the JAX reference's error uniforms of the fault benchmark for
the port: `benchmarks/data/fault_uniforms_seed11.npz`.

    PYTHONPATH=src python -m benchmarks.fault_uniforms

`benchmarks/fault_bench.py` replays its grid under the uniforms the
reference engine draws in-launch — `faults.fault_uniforms(PRNGKey(11),
2, n)` at the padded stream length n = 2048 (fast) and 4096 (full).
The port draws its own from a `torch.Generator` (the same distribution,
other bits), so `benchmarks/port_fault_bench.py` replays the
reference's grid bit for bit only when given these arrays; the file
carries them to a machine without JAX.  Arrays "fast" [2, 2048] and
"full" [2, 4096], float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "fault_uniforms_seed11.npz"


def reference_uniforms() -> dict[str, np.ndarray]:
    import jax
    from repro.core import faults
    key = jax.random.PRNGKey(11)
    return {name: np.asarray(faults.fault_uniforms(key, 2, n))
            for name, n in (("fast", 2048), ("full", 4096))}


if __name__ == "__main__":
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez(PATH, **reference_uniforms())
    print(f"wrote {PATH}")

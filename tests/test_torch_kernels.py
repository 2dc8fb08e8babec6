"""The port's two CUDA kernels against their plain PyTorch versions, and
the rules every kernel wrapper keeps.  This file imports neither JAX nor
the reference package, so its card tests run on a machine that has only
PyTorch:

    python -m pytest -q --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tests marked `gpu` need an NVIDIA Hopper card and skip without one
(decided inside the `cuda` fixture, never at import).  The margin grid
is held to rtol = atol = 2e-4 (the reference's bound for its own kernel);
the replay to bitwise equality (its arithmetic is add, max and select)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import charge, dram_sim
from repro_torch.core import timing as T
from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                          CALIBRATED_VARIATION)
from repro_torch.kernels import build
from repro_torch.kernels.charge_sim import ops as charge_ops
from repro_torch.kernels.charge_sim import ref as charge_ref
from repro_torch.kernels.replay import ops as replay_ops

ROOT = Path(__file__).resolve().parents[1]
C = CALIBRATED_CONSTANTS
ROWS = T.stack_timing([T.DDR3_1600, T.ALDRAM_55C_EVAL,
                       T.DDR3_1600.scaled(0.8, 0.7, 0.6, 0.9)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _grid_inputs(n: int, m: int, seed: int = 0):
    """n cells from the calibrated sampler, m combos from both grids,
    per-combo temperatures and per-cell tREFI overrides (half unset)."""
    import dataclasses
    from repro_torch.core.variation import sample_population
    g = torch.Generator().manual_seed(seed)
    k = -(-n // (8 * 8 * 4))
    cfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=k, n_cells=4)
    cells = sample_population(g, cfg, device="cpu").flat_cells()[:n]
    combos = np.concatenate([T.read_combo_grid(), T.write_combo_grid()])
    rng = np.random.default_rng(seed)
    combos = torch.tensor(combos[rng.choice(combos.shape[0], m)])
    temps = torch.tensor(rng.choice([45.0, 55.0, 85.0], m), dtype=torch.float32)
    tr = torch.tensor(rng.uniform(40, 320, n), dtype=torch.float32)
    tr[::2] = -1.0
    return charge_ops.pack_inputs(cells, combos, temps, tr, None)


def _streams(g: int, n: int, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    tr = [dram_sim.synth_trace(gen, n, row_hit=0.3 + 0.1 * i,
                               inter_arrival_ns=4.0 + 3 * i, device="cpu")
          for i in range(g)]
    valid = torch.ones((g, n), dtype=torch.int32)
    valid[1, n // 3:] = 0                      # ragged padding suffixes
    valid[-1, 5:] = 0
    closed = torch.tensor([float(i % 2) for i in range(g)])
    return (closed, torch.stack([t.arrival for t in tr]),
            torch.stack([t.bank for t in tr]), torch.stack([t.row for t in tr]),
            torch.stack([t.is_write for t in tr]).to(torch.int32), valid)


# --------------------------------------------------------------- the card

@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(1, 1), (8, 8), (300, 70), (4100, 33)])
def test_margin_grid_kernel_matches_plain(cuda, n, m):
    ct, mt = (x.to(cuda) for x in _grid_inputs(n, m))
    before = charge_ops.margin_grid.launches
    r1, w1 = charge_ops.margin_grid(ct, mt, C)
    torch.cuda.synchronize()
    assert charge_ops.margin_grid.launches == before + 1
    r2, w2 = charge_ref.margin_grid(ct, mt, C)
    torch.testing.assert_close(r1, r2, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(w1, w2, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("s_rows", [2, 3, 130])
def test_replay_kernel_bitwise_equals_plain(cuda, s_rows):
    ins = [x.to(cuda) for x in _streams(5, 700)]
    tim = torch.tensor(np.tile(ROWS, (-(-s_rows // 3), 1))[:s_rows],
                       device=cuda)
    before = replay_ops.replay_blocks.launches
    lat, total = replay_ops.replay_blocks(*ins, tim.T.contiguous())
    torch.cuda.synchronize()
    assert replay_ops.replay_blocks.launches == before + 1
    closed, arr, bank, row, wr, valid = ins
    lat2, total2 = dram_sim.replay_cells(arr, bank, row, wr.bool(),
                                         valid.bool(), tim, closed > 0.5)
    assert torch.equal(lat.view(torch.int32), lat2.view(torch.int32))
    assert torch.equal(total.view(torch.int32), total2.view(torch.int32))


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    ct, mt = (x.to(cuda) for x in _grid_inputs(16, 8))
    with pytest.raises(ValueError):
        charge_ops.margin_grid(ct.double(), mt, C)
    with pytest.raises(ValueError):
        charge_ops.margin_grid(ct, mt.cpu(), C)
    ins = [x.to(cuda) for x in _streams(3, 50)]
    tim = torch.tensor(ROWS, device=cuda).T.contiguous()
    with pytest.raises(ValueError):
        replay_ops.replay_blocks(*ins[:-1], ins[-1].bool(), tim)
    bad = ins[2].clone()
    bad[0, 0] = 8
    with pytest.raises(ValueError, match="bank"):
        replay_ops.replay_blocks(ins[0], ins[1], bad, *ins[3:], tim)


# ---------------------------------------------------------------- the CPU

def test_margin_grid_cpu_runs_plain_version():
    ct, mt = _grid_inputs(40, 30)
    before = charge_ops.margin_grid.launches
    r1, w1 = charge_ops.margin_grid(ct, mt, C)
    assert charge_ops.margin_grid.launches == before
    r2, w2 = charge_ref.margin_grid(ct, mt, C)
    assert torch.equal(r1, r2) and torch.equal(w1, w2)
    # the plain version is the core physics under the kernel's layout
    cells = charge.CellParams(*(ct[k][:, None] for k in range(5)))
    trefi = torch.where(ct[5][:, None] > 0, ct[5][:, None], mt[4][None, :])
    r3 = charge.read_margin(cells, mt[:5].T[None], mt[5][None], C, trefi)
    assert torch.equal(r1, r3)


def test_replay_blocks_cpu_runs_plain_version():
    ins = _streams(3, 90)
    tim = torch.tensor(ROWS)
    before = replay_ops.replay_blocks.launches
    lat, total = replay_ops.replay_blocks(*ins, tim.T.contiguous())
    assert replay_ops.replay_blocks.launches == before
    assert lat.shape == (3, 90, 3) and total.shape == (3, 3)
    assert bool((lat[1, 30:] == 0).all())          # padding: zero latency
    closed, arr, bank, row, wr, valid = ins
    for g in range(3):
        lr, tr = dram_sim.replay_rows(arr[g], bank[g], row[g], wr[g].bool(),
                                      valid[g].bool(), tim,
                                      bool(closed[g] > 0.5))
        assert torch.equal(lat[g].T, lr) and torch.equal(total[g], tr)


def test_port_never_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in pat.finditer(f.read_text())]
    assert not bad, bad


def test_default_device_is_cuda_and_never_falls_back():
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine
    from repro_torch.core.sweep import MarginEngine
    from repro_torch.core.variation import sample_population
    entry = [MarginEngine, Profiler, ALDRAMController, SimEngine,
             lambda: perf_model.evaluate(n=8),
             lambda: sample_population(torch.Generator())]
    if torch.cuda.is_available():
        assert MarginEngine().device.type == "cuda"
        assert SimEngine().device.type == "cuda"
        return
    for fn in entry:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_build_is_content_addressed_and_ignored():
    flags = " ".join(build.NVCC_FLAGS)
    assert "sm_90a" in flags and "fast_math" not in flags
    assert "-fmad=false" in flags
    for name, src in build.SOURCES.items():
        assert (Path(build.__file__).parent / src).is_file()
        p = build.lib_path(name)
        assert p.parent == build.BUILD_DIR and name in p.name
    ignored = (ROOT / ".gitignore").read_text()
    assert "src/repro_torch/kernels/_build/" in ignored

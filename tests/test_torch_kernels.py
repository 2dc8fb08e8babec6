"""The port's CUDA kernels against their plain PyTorch versions, and
the rules every kernel wrapper keeps.  This file imports neither JAX nor
the reference package, so its card tests run on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m gpu tests/test_torch_kernels.py

Tests marked `gpu` need an NVIDIA Hopper card and skip without one
(decided inside the `cuda` fixture, never at import).  The margin grid
is held to rtol = atol = 2e-4 (the reference's bound for its own kernel);
the static replay, module, per-bank and regioned, to bitwise equality
(its arithmetic is add, max and select, and the region gather is a
selection); the adaptive replay to equal bins on
every request, latencies within rtol 1e-5 and temperatures / heat within
rtol 1e-5, atol 1e-4 (the reference's bound for its own adaptive kernel;
the kernel aims at bitwise and the tests print how far it is)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import charge, dram_sim
from repro_torch.core import thermal as TH
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


def _adaptive_inputs(lanes: int, banked: bool, s: int = 3, seed: int = 1):
    """Lane-tiled tables (S bin rows + JEDEC, per lane scaled), scenario
    rows cycling through the default suite and its oracles, bin edges
    and a thermal config that heats fast enough to switch bins."""
    rng = np.random.default_rng(seed)
    base = np.stack([T.DDR3_1600.scaled(f, f, f, f).as_row()
                     for f in np.linspace(0.7, 0.9, s)]
                    + [T.DDR3_1600.as_row()])
    scale = rng.uniform(0.95, 1.05, (lanes, 1, 1))
    tabs = base[None] * scale                             # [L, S+1, 6]
    if banked:
        tabs = tabs[:, :, None, :] * np.linspace(1.0, 1.1, 8)[None, None,
                                                               :, None]
    suite = [TH.steady(42.0), TH.diurnal(38.0, 72.0, period_ns=1.2e4),
             TH.cooling_failure(44.0, 36.0, at_ns=3.0e3),
             TH.bursty(42.0, 16.0, period_ns=6.0e3, duty=0.5)]
    suite += [x.oracle() for x in suite]
    scns = TH.stack_scenarios([suite[i % 8] for i in range(lanes)])
    tile = torch.tensor(tabs, dtype=torch.float32)
    tile = (tile.permute(1, 2, 0) if not banked
            else tile.permute(2, 1, 3, 0)).contiguous()
    return (tile, torch.tensor(scns.T.copy()),
            torch.tensor(np.linspace(45.0, 75.0, s), dtype=torch.float32),
            torch.tensor(TH.ThermalConfig(tau_ns=5e3, c_heat=2e-4).as_row()))


def _region_inputs(lanes: int, u: int, regions: int, per_lane: bool,
                   seed: int = 4):
    """A [U, 6, S] unique-row store (each column a scaled DDR3 row) and
    a kernel-layout index map, [banks * R] shared or [banks * R, S] per
    lane, that reaches every column."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.55, 1.0, (u, lanes))
    tile = np.broadcast_to(T.DDR3_1600.as_row()[None, :, None],
                           (u, 6, lanes)).copy()
    tile[:, :4] *= f[:, None, :]
    shape = (8 * regions, lanes) if per_lane else (8 * regions,)
    rmap = rng.integers(0, u, shape)
    rmap.reshape(-1)[:u] = np.arange(u)
    return (torch.tensor(tile, dtype=torch.float32),
            torch.tensor(rmap, dtype=torch.int32))


def _region_tables(lanes: int, u: int, regions: int, per_lane: bool):
    """The adaptive variant: [U, S+1, 6, L] unique-column tables (three
    bin rows per column plus the JEDEC row) and its map."""
    base, rmap = _region_inputs(lanes, u, regions, per_lane)
    tabs = _adaptive_inputs(lanes, False)
    f = base[:, 0, :] / float(T.DDR3_1600.trcd)               # [U, L]
    tile = tabs[0][None].repeat(u, 1, 1, 1)                   # [U, 4, 6, L]
    tile[:, :3, :4] *= (0.9 + 0.1 * f)[:, None, None, :]
    return (tile.contiguous(), rmap) + tabs[1:]


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
@pytest.mark.parametrize("s_rows", [3, 40])
def test_banked_replay_kernel_bitwise_equals_plain(cuda, s_rows):
    ins = [x.to(cuda) for x in _streams(5, 700, seed=2)]
    rows = np.tile(ROWS, (-(-s_rows // 3), 1))[:s_rows]
    tim = torch.tensor(rows[:, None, :] * np.linspace(1.0, 1.2, 8)[None, :,
                                                                   None],
                       dtype=torch.float32, device=cuda)      # [S, 8, 6]
    before = replay_ops.replay_blocks.launches_banked
    lat, total = replay_ops.replay_blocks(
        *ins, tim.permute(1, 2, 0).contiguous())
    torch.cuda.synchronize()
    assert replay_ops.replay_blocks.launches_banked == before + 1
    closed, arr, bank, row, wr, valid = ins
    lat2, total2 = dram_sim.replay_cells(arr, bank, row, wr.bool(),
                                         valid.bool(), tim, closed > 0.5)
    assert torch.equal(lat.view(torch.int32), lat2.view(torch.int32))
    assert torch.equal(total.view(torch.int32), total2.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lane"])
@pytest.mark.parametrize("s_rows,regions", [(3, 2), (26, 8), (130, 4)])
def test_regioned_replay_kernel_bitwise_equals_plain(cuda, s_rows, regions,
                                                     per_lane):
    ins = [x.to(cuda) for x in _streams(5, 700, seed=6)]
    tile, rmap = (x.to(cuda) for x in _region_inputs(s_rows, 11, regions,
                                                       per_lane))
    before = (replay_ops.replay_blocks.launches,
              replay_ops.replay_blocks.launches_regioned)
    lat, total = replay_ops.replay_blocks(*ins, tile, region_map=rmap)
    torch.cuda.synchronize()
    assert (replay_ops.replay_blocks.launches,
            replay_ops.replay_blocks.launches_regioned) == \
        (before[0] + 1, before[1] + 1)
    closed, arr, bank, row, wr, valid = ins
    lat2, total2 = dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tile.permute(2, 0, 1),
        closed > 0.5, region_map=rmap.T if per_lane else rmap)
    assert torch.equal(lat.view(torch.int32), lat2.view(torch.int32))
    assert torch.equal(total.view(torch.int32), total2.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("regions", [1, 4])
def test_bank_constant_region_map_equals_banked_kernel(cuda, regions):
    """A map sending every region of bank b to column b (for R = 1 the
    identity) is variant (b), bit for bit, in both kernels."""
    ins = [x.to(cuda) for x in _streams(5, 700, seed=7)]
    rmap = torch.arange(8, dtype=torch.int32, device=cuda) \
        .repeat_interleave(regions)
    tim_b = torch.tensor(np.tile(ROWS, (4, 1))[:, None, :]
                         * np.linspace(1.0, 1.2, 8)[None, :, None],
                         dtype=torch.float32, device=cuda)
    tile = tim_b.permute(1, 2, 0).contiguous()                # [8, 6, S]
    a = replay_ops.replay_blocks(*ins, tile)
    b = replay_ops.replay_blocks(*ins, tile, region_map=rmap)
    torch.cuda.synchronize()
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))
    tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(8, True))
    a = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   emit_raw=True)
    b = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   emit_raw=True, region_map=rmap)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lane"])
@pytest.mark.parametrize("lanes", [8, 130])
def test_regioned_adaptive_kernel_matches_plain(cuda, lanes, per_lane):
    ins = [x.to(cuda) for x in _streams(5, 900, seed=8)]
    tile, rmap, scn, bins, tcfg = (x.to(cuda) for x in _region_tables(
        lanes, 9, 8, per_lane))
    before = replay_ops.adaptive_blocks.launches_regioned
    out = replay_ops.adaptive_blocks(*ins, tile, scn, bins, tcfg,
                                     emit_raw=True, region_map=rmap)
    torch.cuda.synchronize()
    assert replay_ops.adaptive_blocks.launches_regioned == before + 1
    closed, arr, bank, row, wr, valid = ins
    from repro_torch.kernels.replay import ref as replay_ref
    plat, ptot, ptemps, psel, pheat, pdiag = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), replay_ref.lane_stacks(tile),
        bins, scn.T, tcfg, closed > 0.5,
        region_map=rmap.T if per_lane else rmap)
    lat, total, tmax, tmean, sw, heat, temps, sel = out
    assert torch.equal(sel, psel) and torch.equal(sw, pdiag[2])
    assert int(sel.max()) == 3 and int(sw.sum()) > 0
    torch.testing.assert_close(lat, plat, rtol=1e-5, atol=0)
    torch.testing.assert_close(total, ptot, rtol=1e-5, atol=0)
    for a, b in ((temps, ptemps), (heat, pheat), (tmax, pdiag[0]),
                 (tmean, pdiag[1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_regioned_wrappers_reject_bad_maps_and_rows(cuda):
    ins = [x.to(cuda) for x in _streams(3, 60)]
    tile, rmap = (x.to(cuda) for x in _region_inputs(3, 5, 4, False))
    bad = rmap.clone()
    bad[7] = 5                                   # = U
    with pytest.raises(ValueError, match="region_map"):
        replay_ops.replay_blocks(*ins, tile, region_map=bad)
    bad[7] = -1
    with pytest.raises(ValueError, match="region_map"):
        replay_ops.replay_blocks(*ins, tile, region_map=bad)
    row = ins[3].clone()
    row[2, 4] = -3
    with pytest.raises(ValueError, match="negative row"):
        replay_ops.replay_blocks(*ins[:3], row, *ins[4:], tile,
                                 region_map=rmap)
    with pytest.raises(ValueError):                  # map length % banks
        replay_ops.replay_blocks(*ins, tile, region_map=rmap[:-1].clone())
    with pytest.raises(ValueError):                  # int64 map
        replay_ops.replay_blocks(*ins, tile, region_map=rmap.long())
    tabs, rm8, scn, bins, tcfg = (x.to(cuda) for x in _region_tables(
        8, 5, 4, True))
    bad8 = rm8.clone()
    bad8[0, 3] = 5
    with pytest.raises(ValueError, match="region_map"):
        replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   region_map=bad8)
    with pytest.raises(ValueError, match="negative row"):
        replay_ops.adaptive_blocks(*ins[:3], row, *ins[4:], tabs, scn, bins,
                                   tcfg, region_map=rm8)
    with pytest.raises(ValueError):                  # [L, banks * R] layout
        replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   region_map=rm8.T.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
@pytest.mark.parametrize("lanes", [3, 8, 130])
def test_adaptive_kernel_matches_plain(cuda, banked, lanes):
    ins = [x.to(cuda) for x in _streams(5, 900, seed=3)]
    tabs, scn, bins, tcfg = (x.to(cuda) for x in
                             _adaptive_inputs(lanes, banked))
    before = (replay_ops.adaptive_blocks.launches,
              replay_ops.adaptive_blocks.launches_banked)
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     emit_raw=True)
    torch.cuda.synchronize()
    assert (replay_ops.adaptive_blocks.launches,
            replay_ops.adaptive_blocks.launches_banked) == \
        (before[0] + 1, before[1] + int(banked))
    closed, arr, bank, row, wr, valid = ins
    from repro_torch.kernels.replay import ref as replay_ref
    plat, ptot, ptemps, psel, pheat, pdiag = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), replay_ref.lane_stacks(tabs),
        bins, scn.T, tcfg, closed > 0.5)
    lat, total, tmax, tmean, sw, heat, temps, sel = out
    assert torch.equal(sel, psel) and torch.equal(sw, pdiag[2])
    assert int(sel.max()) == 3 and int(sw.sum()) > 0   # JEDEC row reached
    torch.testing.assert_close(lat, plat, rtol=1e-5, atol=0)
    torch.testing.assert_close(total, ptot, rtol=1e-5, atol=0)
    for a, b in ((temps, ptemps), (heat, pheat), (tmax, pdiag[0]),
                 (tmean, pdiag[1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    nonbit = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                 for a, b in ((lat, plat), (temps, ptemps), (heat, pheat)))
    print(f"adaptive_blocks lanes={lanes} banked={banked}: {nonbit} "
          "elements not bitwise equal to the plain version")


@pytest.mark.gpu
def test_adaptive_wrapper_rejects_bad_inputs(cuda):
    ins = [x.to(cuda) for x in _streams(3, 50)]
    tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(8, False))
    with pytest.raises(ValueError, match="JEDEC"):
        replay_ops.adaptive_blocks(*ins, tabs[:-1].contiguous(), scn, bins,
                                   tcfg)
    bad = ins[2].clone()
    bad[1, 3] = -1
    with pytest.raises(ValueError, match="bank"):
        replay_ops.adaptive_blocks(ins[0], ins[1], bad, *ins[3:], tabs, scn,
                                   bins, tcfg)
    with pytest.raises(ValueError):
        replay_ops.adaptive_blocks(*ins, tabs, scn[:8].contiguous(), bins,
                                   tcfg)
    tabs_b = _adaptive_inputs(8, True)[0].to(cuda)
    with pytest.raises(ValueError):
        replay_ops.adaptive_blocks(*ins, tabs_b, scn, bins, tcfg, n_banks=4)
    with pytest.raises(ValueError):
        replay_ops.adaptive_blocks(*ins, tabs, scn, bins.cpu(), tcfg)
    tim_b = torch.ones((4, 6, 3), device=cuda)
    with pytest.raises(ValueError):
        replay_ops.replay_blocks(*ins, tim_b)


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


@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
def test_adaptive_blocks_cpu_runs_plain_version(banked):
    ins = _streams(3, 90)
    tabs, scn, bins, tcfg = _adaptive_inputs(5, banked)
    before = replay_ops.adaptive_blocks.launches
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg)
    assert replay_ops.adaptive_blocks.launches == before
    lat, total, tmax, tmean, sw, heat, temps, sel = out
    assert temps is None and sel is None
    assert lat.shape == (3, 90, 5) and heat.shape == (3, 8, 5)
    assert bool((lat[1, 30:] == 0).all())          # padding: zero latency
    raw = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     emit_raw=True)
    assert bool((raw[7][1, 30:] == -1).all()) and bool((raw[6][1, 30:] == 0)
                                                       .all())
    for a, b in zip(out[:6], raw[:6]):
        assert torch.equal(a, b)
    # the wrapper's lane tile is the plain version's per-lane stacks
    from repro_torch.kernels.replay import ref as replay_ref
    closed, arr, bank, row, wr, valid = ins
    p = dram_sim.replay_adaptive_cells(arr, bank, row, wr.bool(),
                                       valid.bool(),
                                       replay_ref.lane_stacks(tabs), bins,
                                       scn.T, tcfg, closed > 0.5)
    assert torch.equal(p[0], lat) and torch.equal(p[4], heat)


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "lane"])
def test_regioned_wrappers_cpu_run_plain_versions(per_lane):
    ins = _streams(3, 90)
    closed, arr, bank, row, wr, valid = ins
    tile, rmap = _region_inputs(4, 6, 4, per_lane)
    before = replay_ops.replay_blocks.launches
    lat, total = replay_ops.replay_blocks(*ins, tile, region_map=rmap)
    assert replay_ops.replay_blocks.launches == before
    lane_map = rmap.T if per_lane else rmap
    p = dram_sim.replay_cells(arr, bank, row, wr.bool(), valid.bool(),
                              tile.permute(2, 0, 1), closed > 0.5,
                              region_map=lane_map)
    assert torch.equal(lat, p[0]) and torch.equal(total, p[1])
    # lane s of the regioned replay is replay_one under its gathered rows
    s = 2
    one = dram_sim.replay_one(arr[0], bank[0], row[0], wr[0].bool(),
                              valid[0].bool(), tile[:, :, s],
                              bool(closed[0] > 0.5),
                              region_map=lane_map[s] if per_lane else rmap)
    assert torch.equal(lat[0, :, s], one[0])
    tabs, rm8, scn, bins, tcfg = _region_tables(5, 6, 4, per_lane)
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     region_map=rm8)
    from repro_torch.kernels.replay import ref as replay_ref
    pa = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), replay_ref.lane_stacks(tabs),
        bins, scn.T, tcfg, closed > 0.5,
        region_map=rm8.T if per_lane else rm8)
    assert torch.equal(out[0], pa[0]) and torch.equal(out[5], pa[4])


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
             lambda: perf_model.evaluate_adaptive(
                 np.zeros((2, 6), np.float32), (45.0,), (TH.steady(40.0),),
                 n=8),
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

"""The port's CUDA kernels against their plain PyTorch versions, and
the rules every kernel wrapper keeps.  This file imports neither JAX nor
the reference package, so its card tests run on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m gpu tests/test_torch_kernels.py

Tests marked `gpu` need an NVIDIA Hopper card and skip without one
(decided inside the `cuda` fixture, never at import).  The margin grid
is held to rtol = atol = 2e-4 (the reference's bound for its own kernel);
the static replay, module, per-bank, regioned, faulted and
multi-channel, to bitwise equality (its arithmetic is add, max and
select, and the region and channel maps are selections); the adaptive replay to equal bins on
every request, latencies within rtol 1e-5 and temperatures / heat within
rtol 1e-5, atol 1e-4 (the reference's bound for its own adaptive kernel;
the kernel aims at bitwise and the tests print how far it is); flash
attention to rtol = atol = 2e-3 in float32 and 2e-2 in bfloat16 (the
reference's bound for its own flash kernel, tests/test_kernels.py) and,
inside that, to max abs 1e-5 of the float32 plain version (float32) and
atol 1e-3 + rtol 1.6e-2 of the float32 math rounded to bfloat16
(bfloat16), with two launches bitwise equal; the
WKV and selective-scan kernels, outputs and final states, to rtol = atol
= 3e-4 (the reference's bound for its own two kernels, same file)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import charge, dram_sim
from repro_torch.core import faults as F
from repro_torch.core import thermal as TH
from repro_torch.core import timing as T
from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                          CALIBRATED_VARIATION)
from repro_torch.kernels import build
from repro_torch.kernels.charge_sim import ops as charge_ops
from repro_torch.kernels.charge_sim import ref as charge_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.replay import ops as replay_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from _torch_parity import one_thread as _one_thread  # noqa: F401


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


# every fault mode, cycled over the lanes: inert, margin errors (with and
# without the watchdog), a cold stuck-at sensor, drift + lag +
# quantization, noise and dropout with the implausibility watchdog
FAULT_ROWS = (
    F.FaultScenario(),
    F.FaultScenario(err_scale=0.8, err_free_red=0.0, detect_frac=0.9,
                    retry_ns=60.0),
    F.FaultScenario(err_scale=0.8, err_free_red=0.0, wd_err_n=4,
                    wd_probe=16, wd_recover_n=2),
    F.FaultScenario(stuck_c=30.0, stuck_from_ns=100.0, err_scale=0.5,
                    err_bin_c=0.02, err_free_red=0.0, detect_frac=0.75),
    F.FaultScenario(drift_c_per_ns=2e-3, lag_tau_ns=400.0, quant_c=0.5,
                    err_bin_c=0.05, wd_err_n=3, wd_probe=8, wd_recover_n=2),
    F.FaultScenario(noise_c=6.0, dropout_p=0.3, err_scale=0.5,
                    err_free_red=0.0, wd_err_n=3, wd_sense_n=4,
                    wd_jump_c=8.0, wd_probe=12, wd_recover_n=2, seed=5),
)


def _fault_inputs(lanes: int, g: int, n: int, inert: bool = False,
                  seed: int = 9):
    """The kernel-layout fault tile [F_COLS, lanes] (FAULT_ROWS cycled,
    or all inert) and [G, N] uniforms."""
    rows = [FAULT_ROWS[0 if inert else i % len(FAULT_ROWS)]
            for i in range(lanes)]
    tile = torch.tensor(np.stack([r.as_row() for r in rows]).T.copy())
    gen = torch.Generator().manual_seed(seed)
    return tile, torch.rand((g, n), generator=gen)


def _bitwise(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


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
@pytest.mark.parametrize("lanes,s", [(3, 3), (8, 3), (130, 3), (130, 30)],
                         ids=["3", "8", "130", "130-unstaged"])
def test_adaptive_kernel_matches_plain(cuda, banked, lanes, s):
    """Every launch plan: 3, 8 and 130 lanes (two blocks) with staged
    stacks and edges in registers, and 130 lanes with 30 edges (more
    than the register set) whose per-bank stacks do not fit in shared
    memory."""
    ins = [x.to(cuda) for x in _streams(5, 900, seed=3)]
    tabs, scn, bins, tcfg = (x.to(cuda) for x in
                             _adaptive_inputs(lanes, banked, s=s))
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
    assert int(sel.max()) == s and int(sw.sum()) > 0   # JEDEC row reached
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
@pytest.mark.parametrize("n_banks", [5, 12, 16])
def test_adaptive_kernel_other_bank_counts_match_plain(cuda, n_banks):
    """The heat registers' two widths (8, and 16 past 8 banks): module
    tables on streams that use every bank."""
    closed, arr, bank, row, wr, valid = _streams(5, 900, seed=13)
    bank = ((bank * 7 + row) % n_banks).to(torch.int32)
    ins = [x.to(cuda) for x in (closed, arr, bank, row, wr, valid)]
    tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(8, False))
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     n_banks=n_banks, emit_raw=True)
    closed, arr, bank, row, wr, valid = ins
    from repro_torch.kernels.replay import ref as replay_ref
    plat, ptot, ptemps, psel, pheat, pdiag = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), replay_ref.lane_stacks(tabs),
        bins, scn.T, tcfg, closed > 0.5, n_banks=n_banks)
    lat, total, tmax, tmean, sw, heat, temps, sel = out
    assert heat.shape == (5, n_banks, 8)
    assert torch.equal(sel, psel) and torch.equal(sw, pdiag[2])
    torch.testing.assert_close(lat, plat, rtol=1e-5, atol=0)
    torch.testing.assert_close(total, ptot, rtol=1e-5, atol=0)
    for a, b in ((temps, ptemps), (heat, pheat), (tmax, pdiag[0]),
                 (tmean, pdiag[1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


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
@pytest.mark.parametrize("faulted", [False, True], ids=["plain", "faulted"])
@pytest.mark.parametrize("lanes", [8, 72, 130])
def test_adaptive_producer_stage_bitwise_equals_stream_terms(cuda, faulted,
                                                            lanes):
    """The kernel's producer stage (the stream terms it computes ahead of
    each lane's chain) against `ref.adaptive_stream_terms` on the card,
    bit for bit, with padding in the middle of a stream."""
    from repro_torch.kernels.replay import ref as replay_ref
    _, arr, _, _, _, valid = (x.to(cuda) for x in _streams(5, 700, seed=5))
    valid[2, 100:140] = 0
    _, scn, _, tcfg = (x.to(cuda) for x in _adaptive_inputs(lanes, False))
    ftile = _fault_inputs(lanes, 5, 700)[0].to(cuda) if faulted else None
    before = replay_ops.adaptive_stream_terms.launches
    got = replay_ops.adaptive_stream_terms(arr, valid, scn, tcfg, ftile)
    torch.cuda.synchronize()
    assert replay_ops.adaptive_stream_terms.launches == before + 1
    want = replay_ref.adaptive_stream_terms(arr, valid, scn, tcfg, ftile)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bitwise(got[k], want[k].contiguous()), k


@pytest.mark.gpu
def test_adaptive_plan_stages_small_stacks_only(cuda):
    """The launch plan: the thermal campaign's module and per-bank stacks
    at 8 lanes are staged in shared memory with 256-request buffers, the
    region tiles never are, the fault campaigns' 72 lanes fit, and every
    plan stays within the card's 227 KB."""
    plan = replay_ops.adaptive_plan
    for banked in (False, True):
        p = plan(8, 5, 6, 8, 8, banked, False, False)
        assert p["tables_staged"] and p["chunk"] == 256, p
        assert p["threads"] == 32 + 256
    p = plan(8, 5, 6, 8, 8, True, True, False)
    assert not p["tables_staged"] and p["chunk"] == 256, p
    for banked, regioned in ((False, False), (True, False), (True, True)):
        p = plan(72, 5, 6, 8, 8, banked, regioned, True)
        assert p["chunk"] >= 32 and p["threads"] == 96 + 256, p
        assert p["smem_bytes"] <= replay_ops.SMEM_LIMIT
    assert not plan(130, 30, 31, 8, 8, True, False, False)["tables_staged"]


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


def _campaign_inputs(n_modules: int = 2, seed: int = 0):
    """The profiling campaign's columns as the main path builds them: a
    small calibrated population, its refresh envelopes at 85C, the read
    and write combo grids at the controller's five temperature bins and
    the per-cell read and write tREFI overrides -> (cells_t, combos_t)
    on the CPU."""
    import dataclasses
    from repro_torch.core.aldram import DEFAULT_TEMP_BINS
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population
    cfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=n_modules,
                              n_cells=4)
    pop = sample_population(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")
    prof = Profiler(C, grid_step=1.25, device="cpu")
    spec = prof.campaign_spec(DEFAULT_TEMP_BINS,
                              *prof.refresh_campaign(pop, 85.0))
    combos, temps, _, tc = prof.engine.campaign_columns(pop, spec)
    return charge_ops.pack_inputs(pop.flat_cells(), torch.tensor(combos),
                                  torch.tensor(temps),
                                  torch.tensor(tc[Op.READ]),
                                  torch.tensor(tc[Op.WRITE]))


@pytest.mark.gpu
def test_margin_grid_kernel_on_campaign_columns(cuda):
    """The campaign's 8,505 structured columns (450 read and 495 write
    keys) with per-cell read and write overrides, on 300 cells (the
    per-element kernel) and on 4,096 (a grid large enough for the key
    search): within 2e-4 of the plain version, one launch each."""
    ct, mt = (x.to(cuda) for x in _campaign_inputs(n_modules=16))
    assert bool((ct[5] > 0).all()) and bool((ct[6] > 0).all())
    assert 300 * 8505 < charge_ops.SEARCH_MIN_ELEMS <= 4096 * 8505
    for n in (300, 4096):
        _margin_grid_matches_plain(ct[:, :n].contiguous(), mt)


def _margin_grid_matches_plain(ct, mt):
    before = charge_ops.margin_grid.launches
    r1, w1 = charge_ops.margin_grid(ct, mt, C)
    torch.cuda.synchronize()
    assert charge_ops.margin_grid.launches == before + 1
    r2, w2 = charge_ref.margin_grid(ct, mt, C)
    torch.testing.assert_close(r1, r2, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(w1, w2, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_margin_grid_sharing_a_key_never_changes_a_value(cuda):
    """The full campaign grid on 4,096 cells shares each key among ~18
    columns; a random subset of 777 of its columns (the per-element
    kernel: no search at that size) and a permutation of all of them
    (the keys in another order) give bitwise the matching columns of the
    full grid's output."""
    ct, mt = (x.to(cuda) for x in _campaign_inputs(n_modules=16, seed=1))
    assert 4096 * 777 < charge_ops.SEARCH_MIN_ELEMS <= 4096 * 8505
    full = charge_ops.margin_grid(ct, mt, C)
    g = torch.Generator().manual_seed(5)
    for cols in (torch.randperm(mt.shape[1], generator=g)[:777],
                 torch.randperm(mt.shape[1], generator=g)):
        cols = cols.to(cuda)
        part = charge_ops.margin_grid(ct, mt[:, cols].contiguous(), C)
        for a, b in zip(part, full):
            assert _bitwise(a, b[:, cols])


def _random_combo_inputs(n: int, m: int):
    """n calibrated cells (read overrides on half) and m random combos,
    every key distinct."""
    g = torch.Generator().manual_seed(9)
    lo = torch.tensor([3.75, 12.5, 2.5, 3.75, 8.0])
    span = torch.tensor([10.0, 25.0, 12.5, 10.0, 500.0])
    combos = lo + span * torch.rand((m, 5), generator=g)
    temps = 40.0 + 50.0 * torch.rand(m, generator=g)
    ct, _ = _grid_inputs(n, 1)
    return charge_ops.pack_inputs(ct[:5].T, combos, temps, ct[5], None)


@pytest.mark.gpu
def test_margin_grid_per_element_kernel_equals_key_kernel(cuda):
    """The two kernels behind the wrapper on the same grids: the
    campaign's columns on 300 cells with read and write overrides, and
    9,000 random combos on 260 cells (the key kernel in column groups):
    bitwise equal outputs, and no launch counted."""
    ct, mt = (x.to(cuda) for x in _campaign_inputs(n_modules=16))
    grids = [(ct[:, :300].contiguous(), mt),
             tuple(x.to(cuda) for x in _random_combo_inputs(260, 9000))]
    before = charge_ops.margin_grid.launches
    for ct, mt in grids:
        n, m = ct.shape[1], mt.shape[1]
        outs = [[torch.empty((n, m), device=cuda) for _ in range(2)]
                for _ in range(2)]
        for by_key, out in zip((False, True), outs):
            charge_ops.launch(ct, mt, C, *out, by_key=by_key)
        for a, b in zip(*outs):
            assert _bitwise(a, b)
    assert charge_ops.margin_grid.launches == before


@pytest.mark.gpu
def test_margin_grid_kernel_with_more_keys_than_a_tile(cuda):
    """9,000 random combos, every key distinct: one cell's key tables
    exceed the kernel's buffer, so the key search cuts the columns into
    groups (3,800 cells); with the per-element kernel too (260 cells);
    within 2e-4 of the plain version and one launch each."""
    ct, mt = (x.to(cuda) for x in _random_combo_inputs(3800, 9000))
    assert 260 * 9000 < charge_ops.SEARCH_MIN_ELEMS <= 3800 * 9000
    budget = charge_ops._lib().margin_grid_group_bytes()
    kg = charge_ops.key_groups(mt, budget)
    assert kg.rkeys.shape[1] == kg.wkeys.shape[1] == 9000
    assert kg.n_groups > 1
    for n in (260, 3800):
        _margin_grid_matches_plain(ct[:, :n].contiguous(), mt)


@pytest.mark.gpu
@pytest.mark.parametrize("s_rows", [6, 54, 130])
def test_faulted_replay_kernel_bitwise_equals_plain(cuda, s_rows):
    """Variant (e): module rows x fault rows on the lanes as the engine
    lays them out (l = s*F + f), the JEDEC row last; latencies, totals
    and the five counters bitwise."""
    ins = [x.to(cuda) for x in _streams(5, 900, seed=10)]
    idx = (np.arange(s_rows) // len(FAULT_ROWS)) % 3
    tim = torch.tensor(ROWS[::-1][idx], device=cuda)
    ftile, u = (x.to(cuda) for x in _fault_inputs(s_rows, 5, 900))
    jed = torch.tensor(ROWS[0], device=cuda)
    before = (replay_ops.replay_blocks.launches,
              replay_ops.replay_blocks.launches_faulted)
    lat, total, cnt = replay_ops.replay_blocks(*ins, tim.T.contiguous(),
                                               fault=(ftile, jed, u))
    torch.cuda.synchronize()
    assert (replay_ops.replay_blocks.launches,
            replay_ops.replay_blocks.launches_faulted) == \
        (before[0] + 1, before[1] + 1)
    closed, arr, bank, row, wr, valid = ins
    lat2, total2, cnt2 = dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5,
        fault=(ftile.T, jed, u))
    assert cnt.shape == (5, 5, s_rows)
    assert _bitwise(lat, lat2) and _bitwise(total, total2)
    assert torch.equal(cnt, cnt2)
    assert all(int(c.sum()) > 0 for c in cnt)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["module", "bank", "region"])
@pytest.mark.parametrize("lanes", [12, 130])
def test_faulted_adaptive_kernel_bitwise_equals_plain(cuda, layout, lanes):
    """Variant (d) on every table layout with every fault mode, raw temps
    and bins emitted: latencies, totals, bins, switches and counters
    bitwise; temperatures and heat within rtol 1e-5, atol 1e-4 (printed
    if not bitwise)."""
    from repro_torch.kernels.replay import ref as replay_ref
    ins = [x.to(cuda) for x in _streams(5, 900, seed=11)]
    rmap = None
    if layout == "region":
        tabs, rmap, scn, bins, tcfg = (x.to(cuda) for x in _region_tables(
            lanes, 7, 4, True))
    else:
        tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(
            lanes, layout == "bank"))
    ftile, u = (x.to(cuda) for x in _fault_inputs(lanes, 5, 900))
    before = (replay_ops.adaptive_blocks.launches,
              replay_ops.adaptive_blocks.launches_faulted)
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     emit_raw=True, region_map=rmap,
                                     fault=(ftile, u))
    torch.cuda.synchronize()
    assert (replay_ops.adaptive_blocks.launches,
            replay_ops.adaptive_blocks.launches_faulted) == \
        (before[0] + 1, before[1] + 1)
    closed, arr, bank, row, wr, valid = ins
    p = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), replay_ref.lane_stacks(tabs),
        bins, scn.T, tcfg, closed > 0.5,
        region_map=None if rmap is None else rmap.T, fault=(ftile.T, u))
    lat, total, tmax, tmean, sw, heat, temps, sel, cnt = out
    plat, ptot, ptemps, psel, pheat, (ptmax, ptmean, psw), pcnt = p
    assert torch.equal(sel, psel) and torch.equal(sw, psw)
    assert torch.equal(cnt, pcnt)
    assert _bitwise(lat, plat) and _bitwise(total, ptot)
    assert int(cnt[0].sum()) > 0 and int(cnt[2].sum()) > 0
    assert int(cnt[4].sum()) > 0 and int(sel.max()) == 3
    for a, b in ((temps, ptemps), (heat, pheat), (tmax, ptmax),
                 (tmean, ptmean)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    nonbit = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                 for a, b in ((temps, ptemps), (heat, pheat)))
    print(f"adaptive_blocks (d) {layout} lanes={lanes}: {nonbit} temperature"
          " elements not bitwise equal to the plain version")


@pytest.mark.gpu
def test_inert_fault_rows_equal_unfaulted_kernels(cuda):
    """All-inert fault rows reproduce variants (a) of both kernels bit
    for bit, with zero counters."""
    ins = [x.to(cuda) for x in _streams(5, 700, seed=12)]
    tim = torch.tensor(ROWS[::-1].copy(), device=cuda).T.contiguous()
    ftile, u = (x.to(cuda) for x in _fault_inputs(3, 5, 700, inert=True))
    a = replay_ops.replay_blocks(*ins, tim)
    b = replay_ops.replay_blocks(*ins, tim, fault=(
        ftile, torch.tensor(ROWS[0], device=cuda), u))
    torch.cuda.synchronize()
    assert all(_bitwise(x, y) for x, y in zip(a, b[:2]))
    assert int(b[2].abs().sum()) == 0
    tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(8, False))
    ftile, u = (x.to(cuda) for x in _fault_inputs(8, 5, 700, inert=True))
    a = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   emit_raw=True)
    b = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   emit_raw=True, fault=(ftile, u))
    torch.cuda.synchronize()
    assert all(_bitwise(x, y) for x, y in zip(a, b[:8]))
    assert int(b[8].abs().sum()) == 0


@pytest.mark.gpu
def test_fault_wrappers_reject_bad_inputs(cuda):
    ins = [x.to(cuda) for x in _streams(3, 50)]
    tim = torch.tensor(ROWS, device=cuda).T.contiguous()
    jed = torch.tensor(ROWS[0], device=cuda)
    ftile, u = (x.to(cuda) for x in _fault_inputs(3, 3, 50))
    for bad in ((ftile[:-1].contiguous(), jed, u),       # F_COLS - 1 rows
                (ftile.double(), jed, u),
                (ftile, jed[:5].contiguous(), u),
                (ftile, jed, u[:, :-1].contiguous()),
                (ftile, jed, u.T.contiguous().T),          # not contiguous
                (ftile, u)):                               # no JEDEC column
        with pytest.raises(ValueError):
            replay_ops.replay_blocks(*ins, tim, fault=bad)
    with pytest.raises(ValueError):                        # a mix of devices
        replay_ops.replay_blocks(*ins, tim, fault=(ftile, jed, u.cpu()))
    tim_b = torch.ones((8, 6, 3), device=cuda)
    with pytest.raises(ValueError, match="module rows"):
        replay_ops.replay_blocks(*ins, tim_b, fault=(ftile, jed, u))
    tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(8, False))
    ftile, u = (x.to(cuda) for x in _fault_inputs(8, 3, 50))
    for bad in ((ftile[:, :7].contiguous(), u), (ftile, u[:2].contiguous()),
                (ftile, u.half()), (ftile, jed, u)):
        with pytest.raises(ValueError):
            replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                       fault=bad)


def _multi_inputs(layout: str, s_rows: int, cuda, g: int = 5,
                  n: int = 900):
    """Streams, a timing tile of `layout` (module rows, the per-bank
    tile, a per-lane region store, or module rows under every fault
    mode with the JEDEC column), its map and fault tuple, and [G]
    interleave codes cycling 0, 1, 2."""
    ins = [x.to(cuda) for x in _streams(g, n, seed=13)]
    rows = np.tile(ROWS, (-(-s_rows // 3), 1))[:s_rows]
    rmap = fault = None
    if layout == "bank":
        tile = torch.tensor(rows[:, None, :] * np.linspace(1.0, 1.2, 8)[
            None, :, None], dtype=torch.float32).permute(1, 2, 0)
    elif layout == "region":
        tile, rmap = _region_inputs(s_rows, 9, 4, True)
    else:
        tile = torch.tensor(rows).T
    if layout == "faulted":
        ftile, u = _fault_inputs(s_rows, g, n)
        fault = (ftile.to(cuda), torch.tensor(ROWS[0], device=cuda),
                 u.to(cuda))
    codes = torch.tensor([i % 3 for i in range(g)], dtype=torch.int32,
                         device=cuda)
    return (ins, tile.contiguous().to(cuda),
            None if rmap is None else rmap.to(cuda), fault, codes)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,s_rows", [("module", 3), ("bank", 40),
                                           ("region", 26), ("faulted", 54),
                                           ("module", 130)])
@pytest.mark.parametrize("chan", [(2, 1), (2, 2), (4, 1), (4, 2)],
                         ids=lambda c: f"{c[0]}x{c[1]}")
def test_multi_channel_replay_kernel_bitwise_equals_plain(cuda, layout,
                                                          s_rows, chan):
    """Variant (d) on module rows, the per-bank tile, the region store
    and faulted module rows, lane counts that do not fill a block (and
    two blocks at 130): latencies, totals and counters bitwise equal to
    the plain version."""
    ins, tile, rmap, fault, codes = _multi_inputs(layout, s_rows, cuda)
    ch = (chan[0], chan[1], 5.0)
    before = (replay_ops.replay_blocks.launches,
              replay_ops.replay_blocks.launches_multi)
    out = replay_ops.replay_blocks(*ins, tile, region_map=rmap, fault=fault,
                                   chan=ch, ileave=codes)
    torch.cuda.synchronize()
    assert (replay_ops.replay_blocks.launches,
            replay_ops.replay_blocks.launches_multi) == \
        (before[0] + 1, before[1] + 1)
    closed, arr, bank, row, wr, valid = ins
    tim = tile.permute(2, 0, 1) if tile.dim() == 3 else tile.T
    p = dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5,
        region_map=None if rmap is None else rmap.T,
        fault=None if fault is None else (fault[0].T, fault[1], fault[2]),
        n_channels=chan[0], n_ranks=chan[1], ileave=codes, t_burst=5.0)
    assert len(out) == len(p)
    assert _bitwise(out[0], p[0]) and _bitwise(out[1], p[1])
    if fault is not None:
        assert torch.equal(out[2], p[2]) and int(out[2][0].sum()) > 0
    # the channels matter: one channel replays other latencies
    one = replay_ops.replay_blocks(*ins, tile, region_map=rmap, fault=fault)
    assert not _bitwise(out[0], one[0])


@pytest.mark.gpu
def test_single_channel_chan_launches_the_old_variants(cuda):
    """chan = (1, 1, t) with interleave codes launches (a)/(e) as
    without them, bit for bit, and counts no multi-channel launch."""
    for layout in ("module", "faulted"):
        ins, tile, _, fault, codes = _multi_inputs(layout, 6, cuda)
        before = (replay_ops.replay_blocks.launches,
                  replay_ops.replay_blocks.launches_multi,
                  replay_ops.replay_blocks.launches_faulted)
        a = replay_ops.replay_blocks(*ins, tile, fault=fault,
                                     chan=(1, 1, 9.0), ileave=codes)
        b = replay_ops.replay_blocks(*ins, tile, fault=fault)
        torch.cuda.synchronize()
        f = int(fault is not None)
        assert (replay_ops.replay_blocks.launches,
                replay_ops.replay_blocks.launches_multi,
                replay_ops.replay_blocks.launches_faulted) == \
            (before[0] + 2, before[1], before[2] + 2 * f)
        assert all(_bitwise(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_multi_channel_wrapper_refuses_oversized_and_bad_inputs(cuda):
    """A geometry whose block state exceeds 227 KB is refused with a
    message (at 128 lanes, C = 4 x R = 1 the bank state takes 64 KB and
    the bus row 2 KB beside two 64-request buffers of two 16-byte words
    a request, with 8 padding entries each; mlp_window 8 keeps its ring
    in registers); a misshapen code column is refused."""
    lib = replay_ops._replay_lib()
    assert lib.replay_smem_bytes(128, 8, 8, 0, 4, 1, 0) == \
        32 * 128 * 16 + 2 * 2 * (64 + 8) * 16 + 4 * 128 * 4
    assert lib.replay_smem_bytes(128, 8, 3, 0, 4, 1, 0) == \
        32 * 128 * 16 + 2 * 2 * (64 + 8) * 16 + (3 + 4) * 128 * 4
    assert lib.replay_smem_bytes(128, 8, 8, 0, 16, 4, 0) > \
        replay_ops.SMEM_LIMIT
    # a 32-lane block holds a quarter of the bank state
    assert lib.replay_smem_bytes(128, 8, 8, 0, 4, 1, 32) == \
        32 * 32 * 16 + 2 * 2 * (64 + 8) * 16 + 4 * 32 * 4
    ins, tile, _, _, codes = _multi_inputs("module", 128, cuda, n=50)
    with pytest.raises(ValueError, match="shared memory"):
        replay_ops.replay_blocks(*ins, tile, chan=(16, 4, 5.0),
                                 ileave=codes)
    for bad in (codes[:-1].contiguous(), codes.long(), codes.cpu()):
        with pytest.raises(ValueError):
            replay_ops.replay_blocks(*ins, tile, chan=(2, 1, 5.0),
                                     ileave=bad)
    with pytest.raises(ValueError, match="n_channels"):
        replay_ops.replay_blocks(*ins, tile, chan=(0, 1, 5.0), ileave=codes)


# edge streams for the replay kernel's step-ahead loads and forwarding:
# two chunks and a ragged third, not a multiple of 8, padded suffixes
EDGE_N = 1100


def _edge_streams(kind: str, g: int = 4, n: int = EDGE_N, n_banks: int = 8,
                  seed: int = 20):
    """Streams whose bank slots repeat as the forwarding must handle:
    "one_bank" (every request of a cell on one bank), "alternate" (two
    banks in turn) or "repeat" (the previous request's bank, the one
    before it, or a new one); few rows (hits and conflicts, several
    regions and channels), queueing arrivals, a padded suffix in every
    cell but the first, open and closed pages."""
    rng = np.random.default_rng(seed)
    if kind == "one_bank":
        bank = np.repeat(rng.integers(0, n_banks, (g, 1)), n, 1)
    elif kind == "alternate":
        b0 = rng.integers(0, n_banks, g)
        b1 = (b0 + 1 + rng.integers(0, n_banks - 1, g)) % n_banks
        bank = np.where(np.arange(n)[None] % 2 == 0, b0[:, None],
                        b1[:, None])
    else:
        bank = rng.integers(0, n_banks, (g, n))
        pick = rng.random((g, n))
        for k in range(2, n):
            bank[:, k] = np.where(pick[:, k] < 0.35, bank[:, k - 1],
                                  np.where(pick[:, k] < 0.7, bank[:, k - 2],
                                           bank[:, k]))
    row = rng.integers(0, 6, (g, n)) * 97 + rng.integers(0, 3, (g, 1)) * 512
    valid = np.ones((g, n), np.int32)
    cut = rng.integers(n // 2, n, g)
    cut[0] = n
    valid[np.arange(n)[None] >= cut[:, None]] = 0
    return (torch.tensor(np.arange(g) % 2, dtype=torch.float32),
            torch.tensor(np.cumsum(rng.exponential(6.0, (g, n)), 1),
                         dtype=torch.float32),
            torch.tensor(bank, dtype=torch.int32),
            torch.tensor(row, dtype=torch.int32),
            torch.tensor(rng.random((g, n)) < 0.3, dtype=torch.int32),
            torch.tensor(valid))


def _edge_tile(layout: str, s_rows: int, n_banks: int = 8, u: int = 9):
    """(timing tile in the kernel's layout, region map or None, fault
    tuple or None) for `layout`: module rows, the per-bank tile, the
    region store with a shared or a per-lane map, or faulted module
    rows (every fault mode, the JEDEC column)."""
    rows = np.tile(ROWS, (-(-s_rows // 3), 1))[:s_rows]
    rmap = fault = None
    if layout == "bank":
        tile = torch.tensor(rows[:, None, :] * np.linspace(
            1.0, 1.2, n_banks)[None, :, None],
            dtype=torch.float32).permute(1, 2, 0)
    elif layout.startswith("region"):
        tile, rmap = _region_inputs(s_rows, u, 4, layout == "region-lane")
        if n_banks != 8:
            rmap = rmap[:n_banks * 4]
    else:
        tile = torch.tensor(rows).T
    if layout == "faulted":
        ftile, uu = _fault_inputs(s_rows, 4, EDGE_N)
        fault = (ftile, torch.tensor(ROWS[0]), uu)
    return tile.contiguous(), rmap, fault


def _kernel_vs_plain(cuda, ins, tile, rmap, fault, n_banks: int = 8,
                     mlp_window: int = 8, chan=(1, 1, 5.0), codes=None):
    """Launch replay_blocks on the card and hold every output bitwise to
    dram_sim.replay_cells on the same inputs; returns the kernel's."""
    ins = [x.to(cuda) for x in ins]
    tile = tile.to(cuda)
    rmap = None if rmap is None else rmap.to(cuda)
    fault = None if fault is None else tuple(x.to(cuda) for x in fault)
    before = replay_ops.replay_blocks.launches
    out = replay_ops.replay_blocks(*ins, tile, n_banks, mlp_window,
                                   region_map=rmap, fault=fault, chan=chan,
                                   ileave=codes)
    torch.cuda.synchronize()
    assert replay_ops.replay_blocks.launches == before + 1
    closed, arr, bank, row, wr, valid = ins
    p = dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(),
        tile.permute(2, 0, 1) if tile.dim() == 3 else tile.T, closed > 0.5,
        n_banks, mlp_window,
        region_map=None if rmap is None else (rmap.T if rmap.dim() == 2
                                              else rmap),
        fault=None if fault is None else (fault[0].T, fault[1], fault[2]),
        n_channels=chan[0], n_ranks=chan[1], ileave=codes,
        t_burst=chan[2])
    assert len(out) == len(p)
    for a, b in zip(out, p):
        assert _bitwise(a, b)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("layout,s_rows", [
    ("module", 3), ("bank", 33), ("region-shared", 33), ("region-lane", 33),
    ("faulted", 12)])
@pytest.mark.parametrize("mlp_window", [1, 3, 8])
@pytest.mark.parametrize("kind", ["one_bank", "alternate", "repeat"])
def test_replay_kernel_edge_streams_bitwise_equal_plain(cuda, kind,
                                                        mlp_window, layout,
                                                        s_rows):
    """Every variant on streams whose slots repeat at distance 1 and 2
    (the forwarding), under the register ring (mlp_window 8) and the
    shared one (1, which forwards the ring gate, and 3), across chunk
    boundaries and ragged padded suffixes."""
    tile, rmap, fault = _edge_tile(layout, s_rows)
    out = _kernel_vs_plain(cuda, _edge_streams(kind), tile, rmap, fault,
                           mlp_window=mlp_window)
    if fault is not None:
        assert int(out[2][0].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("s_rows", [1, 2, 33, 130])
@pytest.mark.parametrize("n_banks", [4, 8, 16])
@pytest.mark.parametrize("layout", ["module", "bank", "region-shared"])
def test_replay_kernel_bank_counts_and_lane_blocks_bitwise(cuda, layout,
                                                           n_banks, s_rows):
    """4, 8 and 16 banks, one lane to two blocks of lanes (130), the
    timing rows in registers, staged per bank, or staged per region."""
    tile, rmap, _ = _edge_tile(layout, s_rows, n_banks)
    _kernel_vs_plain(cuda, _edge_streams("repeat", n_banks=n_banks, seed=22),
                     tile, rmap, None, n_banks=n_banks)


@pytest.mark.gpu
@pytest.mark.parametrize("mlp_window", [1, 8])
@pytest.mark.parametrize("faulted", [False, True], ids=["plain", "faulted"])
@pytest.mark.parametrize("chan", [(2, 1), (4, 1), (2, 2)],
                         ids=lambda c: f"{c[0]}x{c[1]}")
def test_multi_channel_edge_streams_bitwise_equal_plain(cuda, chan, faulted,
                                                        mlp_window):
    """Variant (d), plain and faulted, on slots and channels repeating at
    distance 1 and 2 (the bus is forwarded like the bank state), every
    interleave code."""
    tile, _, fault = _edge_tile("faulted" if faulted else "module", 12)
    codes = torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=cuda)
    out = _kernel_vs_plain(cuda, _edge_streams("repeat", seed=23), tile,
                           None, fault, mlp_window=mlp_window,
                           chan=(chan[0], chan[1], 5.0), codes=codes)
    if faulted:
        assert int(out[2][0].sum()) > 0


# the lanes-per-block cap (the replay tuner's lever) and what each
# layout runs: 130 lanes are two blocks at the default 128, five at 32
BLOCKS = [32, 64, 128]


def _replay_block_case(layout: str):
    """(streams, tile, region map, fault, chan, codes) of one
    replay_blocks variant at 130 lanes."""
    ins = _edge_streams("repeat", seed=26)
    if layout == "multi":
        tile, rmap, fault = _edge_tile("module", 130)
        return ins, tile, rmap, fault, (4, 1, 5.0), torch.tensor(
            [0, 1, 2, 0], dtype=torch.int32)
    tile, rmap, fault = _edge_tile(layout, 130)
    return ins, tile, rmap, fault, (1, 1, 5.0), None


@pytest.mark.gpu
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("layout", ["module", "bank", "region-shared",
                                    "multi", "faulted"],
                         ids=["a", "b", "c", "d", "e"])
def test_replay_block_lanes_bitwise_equal_default(cuda, layout, block):
    """replay_blocks (a)-(e) with 32, 64 and 128 chain lanes a block:
    every output bitwise the default block's, and the plan reports the
    block used."""
    ins, tile, rmap, fault, chan, codes = _replay_block_case(layout)
    ins = [x.to(cuda) for x in ins]
    tile = tile.to(cuda)
    rmap = None if rmap is None else rmap.to(cuda)
    fault = None if fault is None else tuple(x.to(cuda) for x in fault)
    codes = None if codes is None else codes.to(cuda)

    def launch(b):
        return replay_ops.replay_blocks(*ins, tile, region_map=rmap,
                                        fault=fault, chan=chan, ileave=codes,
                                        block_lanes=b)

    base, out = launch(None), launch(block)
    torch.cuda.synchronize()
    assert len(base) == len(out)
    for a, b in zip(base, out):
        assert _bitwise(a, b)
    n_cols = 0 if tile.dim() == 2 else tile.shape[0]
    plan = replay_ops.replay_plan(130, 8, 8, n_cols, fault is not None,
                                  chan[0], chan[1], block_lanes=block)
    assert plan["lanes"] == block and plan["threads"] == block + 64
    assert replay_ops.replay_plan(130, 8, 8, n_cols, fault is not None,
                                  chan[0], chan[1])["lanes"] == 128


@pytest.mark.gpu
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("layout", ["module", "bank", "region", "faulted"],
                         ids=["a", "b", "c", "d"])
def test_adaptive_block_lanes_bitwise_equal_default(cuda, layout, block):
    """adaptive_blocks (a)-(d) at 130 lanes with 32, 64 and 128 chain
    lanes a block, raw temperatures and bins emitted: every output
    bitwise the default block's, and the plan reports the block used."""
    ins = [x.to(cuda) for x in _streams(5, 900, seed=27)]
    rmap = fault = None
    if layout == "region":
        tabs, rmap, scn, bins, tcfg = (x.to(cuda) for x in _region_tables(
            130, 7, 4, True))
    else:
        tabs, scn, bins, tcfg = (x.to(cuda) for x in _adaptive_inputs(
            130, layout == "bank"))
    if layout == "faulted":
        fault = tuple(x.to(cuda) for x in _fault_inputs(130, 5, 900))

    def launch(b):
        return replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                          emit_raw=True, region_map=rmap,
                                          fault=fault, block_lanes=b)

    base, out = launch(None), launch(block)
    torch.cuda.synchronize()
    assert len(base) == len(out)
    for a, b in zip(base, out):
        assert _bitwise(a, b)
    plan = replay_ops.adaptive_plan(130, 3, 4, 8, 8, tabs.dim() == 4,
                                    rmap is not None, fault is not None,
                                    block_lanes=block)
    assert plan["lanes"] == block and plan["threads"] == block + 256


@pytest.mark.gpu
@pytest.mark.parametrize("mlp_window", [1, 8])
def test_faulted_replay_lanes_trip_probe_and_recover(cuda, mlp_window):
    """Variant (e) with watchdog rows that trip, probe at the adaptive
    row and recover (a lane that trips twice has recovered in between):
    the lane constants hold the error draw bitwise."""
    wd_rows = [F.FaultScenario(err_scale=e, err_free_red=0.0,
                               detect_frac=d, wd_err_n=m, wd_probe=pr,
                               wd_recover_n=r, retry_ns=40.0)
               for e, d, m, pr, r in ((0.8, 1.0, 2, 4, 1),
                                      (0.5, 0.9, 3, 6, 1),
                                      (0.3, 1.0, 2, 3, 2),
                                      (0.8, 0.5, 4, 16, 2))]
    s_rows = 24
    rows = [wd_rows[i % 4] for i in range(s_rows)]
    ftile = torch.tensor(np.stack([r.as_row() for r in rows]).T.copy())
    idx = (np.arange(s_rows) // 4) % 3
    tim = torch.tensor(ROWS[::-1][idx].T.copy())
    gen = torch.Generator().manual_seed(24)
    u = torch.rand((4, EDGE_N), generator=gen)
    out = _kernel_vs_plain(cuda, _edge_streams("repeat", seed=24), tim, None,
                           (ftile, torch.tensor(ROWS[0]), u),
                           mlp_window=mlp_window)
    cnt = out[2]
    assert int(cnt[2].max()) >= 2                 # tripped, recovered, again
    assert int(cnt[3].sum()) > 0 and int(cnt[4].sum()) > 0


@pytest.mark.gpu
def test_replay_plan_stages_tiles_that_fit(cuda):
    """The launch plan stages the region store where it fits beside the
    buffers (U = 62 at 26 lanes, as chip_smoke's region shape) and
    reads a wide one through the read-only path, bitwise the same."""
    plan = replay_ops.replay_plan
    p = plan(26, 8, 8, 62, False)
    assert p["tile_staged"] and p["chunk"] % 8 == 0
    assert p["threads"] == 32 + 64 and p["smem_bytes"] <= replay_ops.SMEM_LIMIT
    assert not plan(3, 8, 8, 0, True)["tile_staged"]
    wide = plan(130, 8, 8, 400, False)
    assert not wide["tile_staged"] and wide["chunk"] >= 64
    tile, rmap, _ = _edge_tile("region-lane", 130, u=400)
    _kernel_vs_plain(cuda, _edge_streams("repeat", seed=25), tile, rmap,
                     None)


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


def test_combo_keys_factor_the_campaign_columns():
    """The campaign's 8,505 columns hold 450 read keys and 495 write keys
    (one group), and every column is rebuilt exactly from its keys and
    its tRCD."""
    _, mt = _campaign_inputs()
    assert mt.shape == (6, 8505)
    mt = mt.numpy()
    rk, wk, ri, wi = charge_ops.combo_keys(mt)
    assert (rk.shape[1], wk.shape[1]) == (450, 495)
    assert ri.dtype == wi.dtype == np.int32
    assert np.array_equal(rk[:, ri], mt[[1, 3, 4, 5]])
    assert np.array_equal(wk[:, wi], mt[[2, 3, 4, 5]])
    kg = charge_ops.key_groups(torch.from_numpy(mt), 48 * 1024)
    assert kg.groups.tolist() == [[0, 8505, 0, 450, 0, 495]]
    assert kg.max_keys == 2 * 450 + 3 * 495
    assert np.array_equal(kg.col_keys.numpy() & 0xFFFF, ri)
    assert np.array_equal(kg.col_keys.numpy() >> 16, wi)
    assert torch.equal(kg.rkeys, torch.from_numpy(rk))
    assert torch.equal(kg.wkeys, torch.from_numpy(wk))


def test_combo_keys_follow_a_column_permutation():
    """Permuted columns map to the same key values, permuted."""
    mt = _campaign_inputs()[1].numpy()
    perm = np.random.default_rng(3).permutation(mt.shape[1])
    rk, wk, ri, wi = charge_ops.combo_keys(mt)
    rk2, wk2, ri2, wi2 = charge_ops.combo_keys(mt[:, perm])
    assert (rk2.shape, wk2.shape) == (rk.shape, wk.shape)
    assert np.array_equal(rk2[:, ri2], rk[:, ri][:, perm])
    assert np.array_equal(wk2[:, wi2], wk[:, wi][:, perm])


@pytest.mark.parametrize("m,max_bytes", [(9000, 48 * 1024), (300, 1000),
                                         (1, 20)])
def test_key_groups_cut_columns_until_each_group_fits(m, max_bytes):
    """Distinct keys everywhere: the columns are cut into contiguous
    groups whose tables fit `max_bytes`, and each column's local keys
    rebuild it."""
    g = torch.Generator().manual_seed(m)
    mt = (10.0 * torch.rand((6, m), generator=g)).contiguous()
    kg = charge_ops.key_groups(mt, max_bytes)
    assert kg.n_groups == kg.groups.shape[0]
    rows = kg.groups.tolist()
    assert rows[0][0] == 0 and rows[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    for c0, c1, r0, nr, w0, nw in rows:
        assert 4 * (2 * nr + 3 * nw) <= max_bytes
        ri = (kg.col_keys[c0:c1] & 0xFFFF).long() + r0
        wi = (kg.col_keys[c0:c1] >> 16).long() + w0
        assert int(ri.max()) < r0 + nr and int(wi.max()) < w0 + nw
        assert torch.equal(kg.rkeys[:, ri], mt[[1, 3, 4, 5], c0:c1])
        assert torch.equal(kg.wkeys[:, wi], mt[[2, 3, 4, 5], c0:c1])


def test_margin_grid_key_flops_count_the_factored_work():
    n, m = 176_640, 8505
    per_elem = charge_ops.margin_grid_flops(n, m)
    keyed = charge_ops.margin_grid_key_flops(n, 450, 495, m)
    assert keyed == n * (240 * 450 + 54 * 495 + 5 * m)
    assert 3.0e10 < keyed < 3.2e10 and per_elem / keyed > 15


@pytest.mark.parametrize("bad", [0, 16, 48, 96, 256, True, 64.5])
def test_block_lanes_refuses_other_values_on_every_device(bad):
    """`block_lanes` takes None, 32, 64 or 128; anything else raises,
    on CPU tensors too (where the plain version has no blocks)."""
    ins = _streams(2, 40, seed=28)
    tim = torch.tensor(ROWS).T.contiguous()
    with pytest.raises(ValueError, match="block_lanes"):
        replay_ops.replay_blocks(*ins, tim, block_lanes=bad)
    tabs, scn, bins, tcfg = _adaptive_inputs(3, False)
    with pytest.raises(ValueError, match="block_lanes"):
        replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                   block_lanes=bad)
    with pytest.raises(ValueError, match="block_lanes"):
        replay_ops.check_block_lanes("x", bad)


@pytest.mark.parametrize("block", [None, 32, 64, 128])
def test_block_lanes_on_the_cpu_runs_the_plain_version(block):
    """On CPU tensors every allowed `block_lanes` runs the same plain
    version (no launch counted), bitwise; the grid wrappers pass it on."""
    ins = _streams(3, 60, seed=29)
    tim = torch.tensor(ROWS).T.contiguous()
    before = (replay_ops.replay_blocks.launches,
              replay_ops.adaptive_blocks.launches)
    base = replay_ops.replay_blocks(*ins, tim)
    out = replay_ops.replay_blocks(*ins, tim, block_lanes=block)
    for a, b in zip(base, out):
        assert _bitwise(a, b)
    tabs, scn, bins, tcfg = _adaptive_inputs(3, True)
    base = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg)
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     block_lanes=block)
    for a, b in zip(base[:6], out[:6]):
        assert _bitwise(a, b)
    assert (replay_ops.replay_blocks.launches,
            replay_ops.adaptive_blocks.launches) == before
    arr = torch.tensor(np.cumsum(np.ones((2, 1, 30)), -1), dtype=torch.float32)
    zi = torch.zeros((2, 1, 30), dtype=torch.int32)
    lat, total = replay_ops.replay_grid(
        arr, zi, zi, zi.bool(), torch.ones((2, 30), dtype=torch.bool),
        torch.tensor(ROWS), torch.tensor([False]), block_lanes=block)
    assert lat.shape == (2, 1, 3, 30) and total.shape == (2, 1, 3)


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


def _padded_streams():
    """Five streams with padding in the middle of one and at the head of
    another (the plain step loop skips any invalid request)."""
    closed, arr, bank, row, wr, valid = _streams(5, 400, seed=7)
    valid[2, 100:140] = 0
    valid[0, :3] = 0
    return closed, arr, bank, row, wr, valid


@pytest.mark.parametrize("banked", [False, True], ids=["module", "bank"])
def test_adaptive_stream_terms_are_the_plain_loops_ambient(banked):
    """With c_heat = 0 the bank heats stay 0, so the plain step loop's
    raw temperature on every valid request is the ambient: the stream
    terms' ambient equals it bit for bit; dt follows the last valid
    arrival and decay is exp(-dt / tau)."""
    closed, arr, bank, row, wr, valid = _padded_streams()
    tabs, scn, bins, tcfg = _adaptive_inputs(8, banked)
    tcfg = tcfg.clone()
    tcfg[1] = 0.0                                      # c_heat
    temps = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(),
        replay_ops.ref.lane_stacks(tabs), bins, scn.T, tcfg, closed > 0.5)[2]
    before = replay_ops.adaptive_stream_terms.launches
    st = replay_ops.adaptive_stream_terms(arr, valid, scn, tcfg)
    assert replay_ops.adaptive_stream_terms.launches == before
    v = valid.bool()[..., None].expand_as(temps)
    assert _bitwise(st["ambient"][v], temps[v])
    t_prev = torch.zeros(arr.shape[0])
    for k in range(arr.shape[1]):
        dt = torch.clamp(arr[:, k] - t_prev, min=0.0)
        assert _bitwise(st["dt"][:, k], dt)
        t_prev = torch.where(valid[:, k].bool(), arr[:, k], t_prev)
    assert _bitwise(st["decay"], torch.exp(-st["dt"] / tcfg[0]))
    assert sorted(st) == ["ambient", "decay", "dt"]


def test_adaptive_stream_terms_faulted_terms_match_faults():
    """The faulted terms against `faults.fault_sensor`, one stage at a
    time: alpha is the lag output from lag 0 toward a reading of 1; the
    noise term the reading of 0 with every other stage off; the stuck-at
    and dropout flags where the reading becomes the stuck value or the
    held one."""
    _, arr, _, _, _, valid = _padded_streams()
    _, scn, _, tcfg = _adaptive_inputs(12, False)
    ftile, _ = _fault_inputs(12, 5, 400)
    st = replay_ops.adaptive_stream_terms(arr, valid, scn, tcfg, ftile)
    g, n = arr.shape
    t, dt = arr[..., None], st["dt"][..., None]
    k = torch.arange(n, dtype=torch.int32)[None, :, None]
    one, zero = torch.ones((g, n, 12)), torch.zeros((g, n, 12))
    none = torch.full((g, n, 12), F.NO_READING)

    def sensor(rows, raw, lag, held):
        fp = rows[:, None, None, :]
        return F.fault_sensor(fp, t, dt, raw, lag, held, k)

    assert _bitwise(st["alpha"], sensor(ftile, one, zero, none)[1])
    quiet = ftile.clone()
    for col, off in ((F.LAG_TAU, 0.0), (F.DRIFT, 0.0), (F.STUCK_FROM, -1.0),
                     (F.DROP_P, 0.0), (F.QUANT, 0.0)):
        quiet[col] = off
    noise = sensor(quiet, zero, zero, none)[0]
    loud = (ftile[F.NOISE] != 0)[None, None, :].expand_as(noise)
    assert _bitwise(st["noise"][loud], noise[loud])
    assert bool((st["noise"][~loud] == 0).all() and (noise[~loud] == 0).all())
    assert bool(loud.any() and (~loud).any())
    stuck_row = quiet.clone()
    stuck_row[F.STUCK_FROM] = ftile[F.STUCK_FROM]
    stuck_row[F.STUCK_C] = 777.0
    stuck_row[F.NOISE] = 0.0
    stuck = sensor(stuck_row, zero, zero, none)[0] == 777.0
    drop_row = quiet.clone()
    drop_row[F.DROP_P] = ftile[F.DROP_P]
    drop_row[F.NOISE] = 0.0
    drop = sensor(drop_row, zero, zero, torch.full_like(zero, 555.0))[0] \
        == 555.0
    assert torch.equal(st["flags"], stuck.to(torch.int32)
                       + 2 * drop.to(torch.int32))
    assert bool(stuck.any() and drop.any())


def test_replay_chain_ops_count_the_dependent_steps():
    """The chain model against hand counts.  replay_blocks (a): the
    forwarding select and service_math's 10 dependent operations (two
    maxes to the start, the conflict max, + tRP, + tRCD, + tCL, two
    maxes to the precharge start, + tRP, the page select), the bank
    state forwarded in registers; (d) adds the bus to the gate; (e)'s
    static watchdog loop (probe gate 2, served-row select 1, the
    probability's select 1, the draw 3, wd_update 4) ties with the bank
    loop.  adaptive_blocks (a) at 8 banks and 5 edges: the heat loop —
    decay 1, the sum 7, + ambient 1, + hysteresis 1, compare 1, count
    tree 3, bin max/min 2, row address 1, energy 4, deposit 2: 23 — and
    the table row's read.  (d) adds the sensor's 12 and one division and
    the watchdog's served-bin select."""
    ops = replay_ops
    assert ops.replay_chain_ops("2a") == {"alu": 11}
    assert ops.replay_chain_cycles("2a") == 44
    assert ops.replay_chain_ops("2d") == {"alu": 12}
    assert ops.replay_chain_ops("2e") == {"alu": 11}
    assert ops.replay_chain_ops("3a", 8, 5) == {"alu": 23, "smem": 1}
    assert ops.replay_chain_cycles("3a", 8, 5) == 23 * 4 + 30
    assert ops.replay_chain_cycles("3c", 8, 5, "l1") == 23 * 4 + 35
    assert ops.replay_chain_ops("3a", 16, 5)["alu"] == 31
    assert ops.replay_chain_ops("3a", 8, 30)["alu"] == 23 - 3 + 30
    assert ops.replay_chain_ops("3d", 8, 5) == {"alu": 36, "smem": 1,
                                                "div": 1}
    assert ops.replay_chain_cycles("3d", 8, 5) == 36 * 4 + 36 + 30
    with pytest.raises(ValueError):
        ops.replay_chain_ops("3e")


# the chain rows of PERF.md: (variant, kwargs) -> (operations, cycles)
CHAIN_ROWS = [
    (("2a", {}), ({"alu": 11}, 44)),
    (("2b", {}), ({"alu": 11}, 44)),
    (("2c", {}), ({"alu": 11}, 44)),
    (("2d", {}), ({"alu": 12}, 48)),
    (("2d", {"faulted": True}), ({"alu": 12}, 48)),
    (("2e", {}), ({"alu": 11}, 44)),
    (("3a", {"n_banks": 8, "n_edges": 5}), ({"alu": 23, "smem": 1}, 122)),
    (("3b", {"n_banks": 8, "n_edges": 5}), ({"alu": 23, "smem": 1}, 122)),
    (("3c", {"n_banks": 8, "n_edges": 5, "table": "l1"}),
     ({"alu": 23, "l1": 1}, 127)),
    (("3d", {"n_banks": 8, "n_edges": 5}),
     ({"alu": 36, "smem": 1, "div": 1}, 210)),
]


@pytest.mark.parametrize("variant,want", CHAIN_ROWS,
                         ids=[f"{v}{'-faulted' if kw else ''}"
                              if v[0] == "2" else v
                              for (v, kw), _ in CHAIN_ROWS])
def test_replay_chain_model_prices_each_row(variant, want):
    """The chain bound of each kernel row: replay_blocks (a)-(e) and
    faulted (d) priced with the bank state forwarded (no shared round
    trip) and the static error probability a lane constant (no
    division); adaptive_blocks (a)-(d) keep the heat loop, (d) its
    division.  At 1,980 MHz, (a) at N = 8192 is 0.182 ms."""
    name, kw = variant
    ops, cycles = want
    assert replay_ops.replay_chain_ops(name, **kw) == ops
    assert replay_ops.replay_chain_cycles(name, **kw) == cycles
    if name == "2a":
        assert round(cycles * 8192 / 1.98e9 * 1e3, 3) == 0.182


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


@pytest.mark.parametrize("layout", ["module", "bank"])
def test_faulted_wrappers_cpu_run_plain_versions(layout):
    """On CPU tensors the faulted wrappers run the plain versions (no
    launch counted); all-inert fault rows equal the unfaulted replay."""
    ins = _streams(3, 90)
    closed, arr, bank, row, wr, valid = ins
    ftile, u = _fault_inputs(6, 3, 90)
    before = (replay_ops.replay_blocks.launches,
              replay_ops.adaptive_blocks.launches)
    if layout == "module":
        tim = torch.tensor(np.tile(ROWS[::-1], (2, 1)))
        jed = torch.tensor(ROWS[0])
        lat, total, cnt = replay_ops.replay_blocks(
            *ins, tim.T.contiguous(), fault=(ftile, jed, u))
        p = dram_sim.replay_cells(arr, bank, row, wr.bool(), valid.bool(),
                                  tim, closed > 0.5, fault=(ftile.T, jed, u))
        assert all(torch.equal(x, y) for x, y in zip((lat, total, cnt), p))
        assert cnt.shape == (5, 3, 6) and int(cnt[0].sum()) > 0
        inert, _ = _fault_inputs(6, 3, 90, inert=True)
        a = replay_ops.replay_blocks(*ins, tim.T.contiguous())
        b = replay_ops.replay_blocks(*ins, tim.T.contiguous(),
                                     fault=(inert, jed, u))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    tabs, scn, bins, tcfg = _adaptive_inputs(6, layout == "bank")
    out = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg,
                                     emit_raw=True, fault=(ftile, u))
    from repro_torch.kernels.replay import ref as replay_ref
    p = dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), replay_ref.lane_stacks(tabs),
        bins, scn.T, tcfg, closed > 0.5, fault=(ftile.T, u))
    assert torch.equal(out[0], p[0]) and torch.equal(out[7], p[3])
    assert torch.equal(out[8], p[6]) and out[8].shape == (5, 3, 6)
    inert, _ = _fault_inputs(6, 3, 90, inert=True)
    a = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg, emit_raw=True)
    b = replay_ops.adaptive_blocks(*ins, tabs, scn, bins, tcfg, emit_raw=True,
                                   fault=(inert, u))
    assert all(torch.equal(x, y) for x, y in zip(a, b[:8]))
    assert int(b[8].sum()) == 0
    assert (replay_ops.replay_blocks.launches,
            replay_ops.adaptive_blocks.launches) == before


# ------------------------------------------------------------ flash attention
def _flash_inputs(b, sq, sk, hq, hkv, d, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(device)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    return q, k, v


FLASH_CASES = [
    # b, sq, sk, hq, hkv, d, causal, window
    (1, 256, 256, 8, 2, 128, True, None),       # GQA 4:1
    (1, 200, 200, 4, 1, 64, True, None),        # MQA, ragged tiles
    (2, 130, 130, 4, 2, 256, True, None),       # D = 256, B > 1
    (1, 300, 300, 4, 2, 256, True, 64),         # windowed D = 256
    (1, 257, 257, 32, 2, 128, True, 100),       # GQA 16 (glm4), window
    (1, 64, 64, 4, 4, 64, True, 1),             # window 1: the diagonal
    (1, 100, 150, 4, 2, 64, False, None),       # non-causal, ragged Sk
    (2, 150, 100, 8, 2, 128, True, None),       # causal, Sq > Sk
    (1, 33, 70, 2, 1, 256, False, 40),          # non-causal window
    (2, 45, 45, 4, 2, 32, True, None),          # D = 32 (reduced configs)
    # the tile edges: 64 query rows / 64 keys (float32), 128 query rows
    # in two warpgroups of 64 / 64-key TMA tiles (bfloat16)
    (1, 63, 63, 4, 2, 64, True, None),
    (1, 64, 64, 4, 2, 128, True, None),
    (1, 65, 65, 4, 2, 256, True, None),
    (1, 127, 127, 4, 2, 32, True, None),
    (1, 128, 128, 4, 2, 64, True, None),
    (2, 129, 129, 4, 2, 128, True, None),
    (1, 40, 20, 4, 2, 128, False, None),        # Sk < one key tile
    (2, 48, 30, 4, 1, 64, True, None),          # causal, Sk < one tile
    (1, 200, 200, 4, 2, 128, True, 37),         # window edge inside a tile
    (1, 300, 300, 4, 2, 64, True, 128),         # window spans two tiles
    (2, 200, 200, 8, 2, 32, True, None),        # D = 32 (wgmma n32)
    (1, 257, 257, 4, 1, 256, True, None),       # D = 256 (4 column blocks)
    (1, 129, 65, 4, 2, 128, True, None),        # causal, Sq > Sk
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, case, dtype):
    b, sq, sk, hq, hkv, d, causal, window = case
    q, k, v = _flash_inputs(b, sq, sk, hq, hkv, d, dtype, cuda)
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    want = flash_ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    err = (out.float() - want.float()).abs().max().item()
    print(f"flash {case} {dtype}: max abs {err:.3e}")
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_float32_within_1e5_of_plain(cuda, case):
    """The float32 kernel (register-tiled on the CUDA cores, no TF32)
    against the float32 plain version: max abs 1e-5."""
    b, sq, sk, hq, hkv, d, causal, window = case
    q, k, v = _flash_inputs(b, sq, sk, hq, hkv, d, torch.float32, cuda)
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_ref.flash_attention(q, k, v, causal=causal, window=window)
    err = (out - want).abs().max().item()
    print(f"flash float32 {case}: max abs {err:.3e}")
    assert err <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_bfloat16_within_2_ulps_of_float32_math(cuda, case):
    """The bfloat16 kernel (wgmma) against the plain version run in
    float32 on the same inputs and rounded to bfloat16: atol 1e-3 + rtol
    1.6e-2 (about 2 bfloat16 ulps; the kernel feeds P to P V as two
    bfloat16 terms)."""
    b, sq, sk, hq, hkv, d, causal, window = case
    q, k, v = _flash_inputs(b, sq, sk, hq, hkv, d, torch.bfloat16, cuda)
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    want = want.to(torch.bfloat16).float()
    diff = (out.float() - want).abs()
    print(f"flash bfloat16 {case}: max abs {diff.max().item():.3e}")
    assert bool((diff <= 1e-3 + 1.6e-2 * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_launches_are_bitwise_repeatable(cuda, dtype):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v = _flash_inputs(2, 300, 300, 8, 2, 128, dtype, cuda, seed=3)
    a = flash_ops.flash_attention(q, k, v, window=100)
    b = flash_ops.flash_attention(q, k, v, window=100)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_attention_reads_strided_views(cuda):
    """[B, H, S, D] storage read as [B, S, H, D] through its strides (no
    copy), and a sliced batch; both equal the contiguous launch."""
    q, k, v = _flash_inputs(3, 96, 96, 4, 2, 64, torch.float32, cuda, seed=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qt.is_contiguous()
    want = flash_ops.flash_attention(q, k, v)
    torch.testing.assert_close(flash_ops.flash_attention(qt, kt, vt), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        flash_ops.flash_attention(q[1:], k[1:], v[1:]), want[1:], rtol=0,
        atol=0)


@pytest.mark.gpu
def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 64, 64, 4, 2, 64, torch.float32, cuda)
    before = flash_ops.flash_attention.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one dtype"):
        flash_ops.flash_attention(q, k.bfloat16(), v)
    q96, k96, v96 = _flash_inputs(1, 64, 64, 4, 2, 96, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(q96, k96, v96)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_ops.flash_attention(q[:, :, :3], k, v)
    assert flash_ops.flash_attention.launches == before


@pytest.mark.gpu
def test_serve_engine_prefills_through_the_kernel(cuda):
    """On the card every prefill layer launches the kernel once and no
    decode step launches it: the engine has no plain path there."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduced(get_config("glm4-9b"))
    params = TF.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                            cuda)
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=64, device=cuda)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=np.arange(5 + 4 * i,
                                                   dtype=np.int32),
                           max_new_tokens=3))
    before = flash_ops.flash_attention.launches
    done = eng.run_until_drained()
    assert sorted(len(r.out) for r in done) == [3, 3, 3]
    assert flash_ops.flash_attention.launches == before + 3 * cfg.n_layers


def test_bfloat16_probabilities_need_two_terms_for_the_tight_bound():
    """Why the bfloat16 kernel feeds P to P V as two bfloat16 terms: with
    P rounded once (as flash kernels usually do) the output leaves the
    tight bound of the float32 math (atol 1e-3 + rtol 1.6e-2) on rows
    with few keys; with P = hi + lo it stays inside.  The kernel's
    arithmetic on the CPU: bf16 inputs, float32 scores and
    probabilities, the normaliser summed from float32 P."""
    b, s, hq, hkv, d = 1, 200, 4, 2, 128
    q, k, v = (x.float() for x in _flash_inputs(b, s, s, hq, hkv, d,
                                                 torch.bfloat16, "cpu"))
    kk, vv = (x.repeat_interleave(hq // hkv, 2) for x in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) * d ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True)
    want = torch.einsum("bhqk,bkhd->bqhd", p / den, vv).bfloat16().float()

    def violations(p_used):
        out = torch.einsum("bhqk,bkhd->bqhd", p_used / den, vv)
        diff = (out.bfloat16().float() - want).abs()
        return int((diff > 1e-3 + 1.6e-2 * want.abs()).sum())

    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    assert violations(hi) > 0
    assert violations(hi + lo) == 0


def test_flash_attention_cpu_runs_the_plain_version():
    q, k, v = _flash_inputs(1, 40, 40, 4, 2, 96, torch.float32, "cpu")
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(q, k, v, window=16)
    assert flash_ops.flash_attention.launches == before
    assert torch.equal(out, flash_ref.flash_attention(q, k, v, window=16))


# ----------------------------------------------------- wkv and mamba_scan
SSM_TOL = 3e-4     # the reference's Pallas-vs-oracle bound for both


def _wkv_inputs(b, t, h, d, device, seed=0, state=False):
    """The reference test's distribution (tests/test_kernels.py): r, k, v
    0.5 N(0, 1), log decay -exp(N(0, 1) - 2), u 0.3 N(0, 1); a state
    0.5 N(0, 1) where asked."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.5 * torch.randn((b, t, h, d), generator=g)
               for _ in range(3))
    w = -torch.exp(torch.randn((b, t, h, d), generator=g) - 2.0)
    u = 0.3 * torch.randn((h, d), generator=g)
    s = 0.5 * torch.randn((b, h, d, d), generator=g) if state else None
    return tuple(None if x is None else x.to(device)
                 for x in (r, k, v, w, u, s))


def _scan_inputs(b, t, di, ds, device, seed=0, state=False):
    """The reference test's distribution: x 0.5 N, dt softplus(N - 1),
    B and C 0.5 N, A -exp(0.3 N); an initial state 0.5 N where asked."""
    g = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn((b, t, di), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, t, di), generator=g)
                                      - 1.0)
    bm, cm = (0.5 * torch.randn((b, t, ds), generator=g) for _ in range(2))
    a = -torch.exp(0.3 * torch.randn((di, ds), generator=g))
    h0 = 0.5 * torch.randn((b, di, ds), generator=g) if state else None
    return tuple(None if z is None else z.to(device)
                 for z in (x, dt, bm, cm, a, h0))


WKV_CASES = [
    # b, t, h, d, initial state
    (1, 64, 2, 64, False),       # one whole chunk
    (2, 128, 3, 64, False),      # two chunks, B > 1
    (1, 100, 2, 64, False),      # ragged T
    (1, 1, 4, 64, True),         # one step from a state
    (2, 1300, 4, 64, True),      # the serve path's ragged prompt
    (2, 45, 4, 32, True),        # D = 32 (the reduced configs)
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_kernel_matches_plain(cuda, case):
    b, t, h, d, with_state = case
    r, k, v, w, u, s0 = _wkv_inputs(b, t, h, d, cuda, state=with_state)
    before = wkv_ops.wkv.launches
    o, s = wkv_ops.wkv(r, k, v, w, u, state=s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == before + 1
    assert o.shape == r.shape and s.shape == (b, h, d, d)
    o_ref, s_ref = wkv_ref.wkv(r, k, v, w, u, state=s0)
    print(f"wkv {case}: max abs {(o - o_ref).abs().max().item():.3e}, "
          f"state {(s - s_ref).abs().max().item():.3e}")
    torch.testing.assert_close(o, o_ref, rtol=SSM_TOL, atol=SSM_TOL)
    torch.testing.assert_close(s, s_ref, rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.gpu
def test_wkv_kernel_strong_decay_is_finite(cuda):
    """The reference's strong-decay case: log decay -7 per step (1e-3)
    must not overflow, and matches the plain version."""
    r, k, v, _, u, _ = _wkv_inputs(1, 128, 2, 64, cuda, seed=1)
    w = torch.full_like(r, -7.0)
    o, s = wkv_ops.wkv(r, k, v, w, u)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(o, wkv_ref.wkv(r, k, v, w, u)[0],
                               rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.gpu
def test_wkv_kernel_reads_strided_views(cuda):
    """[B, H, T, D] storage read as [B, T, H, D] through its strides, and
    a sliced batch: both equal the contiguous launch."""
    r, k, v, w, u, _ = _wkv_inputs(3, 80, 2, 64, cuda, seed=2)
    o, s = wkv_ops.wkv(r, k, v, w, u)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (r, k, v, w)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(wkv_ops.wkv(*views, u), (o, s), rtol=0,
                               atol=0)
    torch.testing.assert_close(wkv_ops.wkv(r[1:], k[1:], v[1:], w[1:], u),
                               (o[1:], s[1:]), rtol=0, atol=0)


@pytest.mark.gpu
def test_wkv_refuses_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u, _ = _wkv_inputs(1, 16, 2, 64, cuda)
    before = wkv_ops.wkv.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_ops.wkv(r, k.cpu(), v, w, u)
    with pytest.raises(ValueError, match="float32"):
        wkv_ops.wkv(r.double(), k, v, w, u)
    r2, k2, v2, w2, u2, _ = _wkv_inputs(1, 16, 2, 48, cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv_ops.wkv(r2, k2, v2, w2, u2)
    with pytest.raises(ValueError, match="state"):
        wkv_ops.wkv(r, k, v, w, u, state=torch.zeros((1, 2, 64, 32),
                                                     device=cuda))
    with pytest.raises(ValueError, match="u"):
        wkv_ops.wkv(r, k, v, w, u[:1])
    assert wkv_ops.wkv.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 4096, 2, 64, True),      # a 64-chunk state scan from a state
    (2, 64 * 5 + 1, 3, 64, True),  # T = 64 k + 1
    (1, 64 * 3 + 1, 2, 32, True),
])
def test_wkv_kernel_long_and_ragged_from_a_state(cuda, case):
    b, t, h, d, with_state = case
    r, k, v, w, u, s0 = _wkv_inputs(b, t, h, d, cuda, seed=4,
                                    state=with_state)
    o, s = wkv_ops.wkv(r, k, v, w, u, state=s0)
    o_ref, s_ref = wkv_ref.wkv(r, k, v, w, u, state=s0)
    torch.testing.assert_close(o, o_ref, rtol=SSM_TOL, atol=SSM_TOL)
    torch.testing.assert_close(s, s_ref, rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.gpu
def test_wkv_kernel_strong_decay_from_a_state_is_finite(cuda):
    """Log decay -7 per step from a nonzero state over 3 chunks: every
    sub-chunk factor underflows far from its block, nothing overflows,
    outputs and final state match the plain version."""
    r, k, v, _, u, s0 = _wkv_inputs(2, 64 * 3 - 5, 2, 64, cuda, seed=6,
                                    state=True)
    w = torch.full_like(r, -7.0)
    o, s = wkv_ops.wkv(r, k, v, w, u, state=s0)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    o_ref, s_ref = wkv_ref.wkv(r, k, v, w, u, state=s0)
    torch.testing.assert_close(o, o_ref, rtol=SSM_TOL, atol=SSM_TOL)
    torch.testing.assert_close(s, s_ref, rtol=SSM_TOL, atol=SSM_TOL)


SCAN_CASES = [
    # b, t, di, ds, initial state
    (1, 32, 64, 8, False),        # the reference's shapes
    (2, 48, 128, 16, False),
    (1, 30, 96, 8, False),        # ragged T and di
    (2, 1, 16384, 16, True),      # a decode step of jamba's width
    (2, 1300, 1000, 16, True),    # ragged T and di from a state
]


def _scan_plans(ds: int):
    """Every team the kernel is built for at state dim ds, each at a
    mid-size block and tile, a small block with a ragged 7-step tile and
    the largest block."""
    return [scan_ops.ScanPlan(p, c // p, st) for p in scan_ops.TEAMS[ds]
            for c, st in ((256, 32), (32 * p, 7),
                          (scan_ops.MAX_THREADS, 16))]


# each case under `scan_plan`'s own plan (None) and every plan of its ds
SCAN_PLAN_CASES = [(case, plan) for case in SCAN_CASES
                   for plan in [None] + _scan_plans(case[3])]


@pytest.mark.gpu
@pytest.mark.parametrize("case,plan", SCAN_PLAN_CASES, ids=[
    f"{c}-{'planned' if p is None else f'P{p.team}-c{p.channels}-s{p.steps}'}"
    for c, p in SCAN_PLAN_CASES])
def test_mamba_scan_kernel_matches_plain(cuda, case, plan):
    b, t, di, ds, with_state = case
    x, dt, bm, cm, a, h0 = _scan_inputs(b, t, di, ds, cuda, state=with_state)
    before = scan_ops.mamba_scan.launches
    y, h = scan_ops.mamba_scan(x, dt, bm, cm, a, h0=h0, plan=plan)
    torch.cuda.synchronize()
    assert scan_ops.mamba_scan.launches == before + 1
    assert y.shape == x.shape and h.shape == (b, di, ds)
    y_ref, h_ref = scan_ref.mamba_scan(x, dt, bm, cm, a, h0=h0)
    print(f"mamba_scan {case}: max abs {(y - y_ref).abs().max().item():.3e},"
          f" state {(h - h_ref).abs().max().item():.3e}")
    torch.testing.assert_close(y, y_ref, rtol=SSM_TOL, atol=SSM_TOL)
    torch.testing.assert_close(h, h_ref, rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.gpu
def test_mamba_scan_kernel_reads_strided_views(cuda):
    """B and C as column slices of one projection (the model's x_proj
    output), x and dt transposed storage and a sliced batch: each equals
    the contiguous launch."""
    x, dt, bm, cm, a, _ = _scan_inputs(3, 70, 200, 16, cuda, seed=3)
    y, h = scan_ops.mamba_scan(x, dt, bm, cm, a)
    proj = torch.cat([torch.zeros_like(bm[..., :5]), bm, cm], dim=-1)
    bv, cv = proj[..., 5:21], proj[..., 21:]
    assert not bv.is_contiguous()
    xv, dv = (z.transpose(0, 1).contiguous().transpose(0, 1)
              for z in (x, dt))
    torch.testing.assert_close(scan_ops.mamba_scan(xv, dv, bv, cv, a), (y, h),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        scan_ops.mamba_scan(x[1:], dt[1:], bm[1:], cm[1:], a),
        (y[1:], h[1:]), rtol=0, atol=0)


@pytest.mark.gpu
def test_mamba_scan_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, bm, cm, a, _ = _scan_inputs(1, 8, 64, 16, cuda)
    before = scan_ops.mamba_scan.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_ops.mamba_scan(x, dt.cpu(), bm, cm, a)
    with pytest.raises(ValueError, match="float32"):
        scan_ops.mamba_scan(x.half(), dt, bm, cm, a)
    x4, dt4, bm4, cm4, a4, _ = _scan_inputs(1, 8, 64, 4, cuda)
    with pytest.raises(ValueError, match="state dim"):
        scan_ops.mamba_scan(x4, dt4, bm4, cm4, a4)
    with pytest.raises(ValueError, match="h0"):
        scan_ops.mamba_scan(x, dt, bm, cm, a,
                            h0=torch.zeros((1, 64, 8), device=cuda))
    with pytest.raises(ValueError, match="A"):
        scan_ops.mamba_scan(x, dt, bm, cm, a[:32])
    assert scan_ops.mamba_scan.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_serve_engine_runs_the_ssm_kernels(cuda, arch):
    """On the card every RWKV6 prefill layer launches wkv once and decode
    none; every Mamba layer launches mamba_scan once per prefill and per
    decode tick; the tokens equal the CPU's from the same weights."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(reduced(get_config(arch)), n_experts=0,
                              top_k=0)
    spec = cfg.group_spec()
    per_rep = {m: sum(s.mixer == m for s in spec) for m in ("rwkv6",
                                                             "mamba")}
    reps = cfg.n_layers // len(spec)
    cpu = TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    outs, ticks = {}, 0
    for dev in ("cpu", cuda):
        params = cpu if dev == "cpu" else _to(cpu, dev)
        eng = ServeEngine(params, cfg, batch_slots=2, max_len=64,
                          device=dev)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=np.arange(5 + 4 * i,
                                                       dtype=np.int32),
                               max_new_tokens=3))
        before = (wkv_ops.wkv.launches, scan_ops.mamba_scan.launches)
        while eng.step():
            ticks += dev != "cpu"
        outs[str(dev)] = {r.rid: r.out for r in eng.drain_retired()}
        n_wkv = wkv_ops.wkv.launches - before[0]
        n_scan = scan_ops.mamba_scan.launches - before[1]
    assert outs["cpu"] == outs[str(cuda)]
    assert n_wkv == 3 * reps * per_rep["rwkv6"]
    assert n_scan == (3 + ticks) * reps * per_rep["mamba"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_wkv_cpu_runs_the_plain_version():
    r, k, v, w, u, s0 = _wkv_inputs(2, 40, 3, 48, "cpu", state=True)
    before = wkv_ops.wkv.launches
    o, s = wkv_ops.wkv(r, k, v, w, u, state=s0)
    assert wkv_ops.wkv.launches == before
    o_ref, s_ref = wkv_ref.wkv(r, k, v, w, u, state=s0)
    assert torch.equal(o, o_ref) and torch.equal(s, s_ref)


# The kernel's factored A (wkv.cu, pass 3), modelled on the CPU: chunks of
# 64 steps, sub-chunks of 16, lprev_i = lcum_{i-1}.
WKV_L, WKV_SUB = 64, 16


def _wkv_chunk_logs(w):
    """w [..., L, D] log decays -> (lcum, lprev) with lprev_i = lcum_{i-1}
    (0 at i = 0), as the kernel takes them."""
    lcum = torch.cumsum(w, -2)
    return lcum, torch.cat([torch.zeros_like(lcum[..., :1, :]),
                            lcum[..., :-1, :]], -2)


def _wkv_pairwise_a(r, k, w):
    """The plain version's A[i, j] = sum_d r_id k_jd exp(lprev_id -
    lcum_jd) for j < i, pairwise in log space (lprev = lcum - w)."""
    lcum = torch.cumsum(w, -2)
    lprev = lcum - w
    tri = torch.ones(r.shape[-2], r.shape[-2], dtype=torch.bool).tril(-1)
    ex = torch.where(tri[:, :, None], lprev[..., :, None, :]
                     - lcum[..., None, :, :], -torch.inf)
    return torch.einsum("...id,...jd,...ijd->...ij", r, k, torch.exp(ex))


def _wkv_subchunk_a(r, k, w):
    """The kernel's A: the diagonal 16 x 16 sub-blocks pairwise, each
    off-diagonal one (I > J) a product of two scaled tiles split at
    lam_J, the inclusive log at J's last step.  Also returns every
    exponent of the off-diagonal factors and the (factor, pairwise)
    pairs, for the safety argument."""
    lcum, lprev = _wkv_chunk_logs(w)
    a = torch.zeros(*r.shape[:-1], r.shape[-2])
    exps, pairs = [], []
    tri = torch.ones(WKV_SUB, WKV_SUB, dtype=torch.bool).tril(-1)
    for bi in range(WKV_L // WKV_SUB):
        ri = slice(bi * WKV_SUB, (bi + 1) * WKV_SUB)
        ex = torch.where(tri[:, :, None], lprev[..., ri, None, :]
                         - lcum[..., None, ri, :], -torch.inf)
        a[..., ri, ri] = torch.einsum("...id,...jd,...ijd->...ij", r[..., ri, :],
                                      k[..., ri, :], torch.exp(ex))
        for bj in range(bi):
            rj = slice(bj * WKV_SUB, (bj + 1) * WKV_SUB)
            lam = lcum[..., (bj + 1) * WKV_SUB - 1:(bj + 1) * WKV_SUB, :]
            e_r, e_k = lprev[..., ri, :] - lam, lam - lcum[..., rj, :]
            exps += [e_r, e_k]
            a[..., ri, rj] = (r[..., ri, :] * torch.exp(e_r)) \
                @ (k[..., rj, :] * torch.exp(e_k)).transpose(-1, -2)
            pairs.append((torch.exp(e_r)[..., :, None, :],
                          torch.exp(e_k)[..., None, :, :],
                          torch.exp(e_r[..., :, None, :]
                                    + e_k[..., None, :, :])))
    return a, exps, pairs


def _wkv_chunks(x):
    """[B, T, H, D] with T % 64 == 0 -> [B, H, T / 64, 64, D]."""
    b, t, h, d = x.shape
    return x.reshape(b, t // WKV_L, WKV_L, h, d).permute(0, 3, 1, 2, 4)


def test_wkv_subchunk_factorisation_matches_pairwise_a():
    """On the reference's input distribution the sub-chunk products give
    the pairwise A within 3e-4."""
    r, k, v, w, _, _ = _wkv_inputs(2, 256, 3, 64, "cpu", seed=7)
    r, k, w = map(_wkv_chunks, (r, k, w))
    got, _, _ = _wkv_subchunk_a(r, k, w)
    torch.testing.assert_close(got, _wkv_pairwise_a(r, k, w),
                               rtol=SSM_TOL, atol=SSM_TOL)


def test_wkv_subchunk_factors_are_safe_at_any_decay():
    """Why the off-diagonal sub-blocks are split at lam_J: every exponent
    of both factors is <= 0 (the float cumulative logs never grow), so
    at log decay -7 per step A stays finite and equal to the pairwise A;
    where a factor underflows to 0 the pairwise term is 0 as well.  A
    split at the chunk's start instead, (r * exp(lprev)) @ (k *
    exp(-lcum))^T, overflows at that decay."""
    r, k, v, w, _, _ = _wkv_inputs(1, 128, 2, 64, "cpu", seed=8)
    r, k = map(_wkv_chunks, (r, k))
    for w in (_wkv_chunks(w), torch.full_like(r, -7.0)):
        got, exps, pairs = _wkv_subchunk_a(r, k, w)
        assert all(bool((e <= 0).all()) for e in exps)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, _wkv_pairwise_a(r, k, w),
                                   rtol=SSM_TOL, atol=SSM_TOL)
        for f_r, f_k, both in pairs:
            gone = (f_r == 0) | (f_k == 0)
            assert bool((both.expand_as(gone)[gone] == 0).all())
    assert any(bool(((f_r == 0) | (f_k == 0)).any())
               for f_r, f_k, _ in pairs)
    lcum, lprev = _wkv_chunk_logs(w)
    naive = (r * torch.exp(lprev)) @ (k * torch.exp(-lcum)).transpose(-1, -2)
    assert not bool(torch.isfinite(naive).all())


@pytest.mark.gpu
def test_mamba_scan_plans_agree_bitwise_on_the_state(cuda):
    """Every team and tile holds the same state arithmetic, so the final
    states are bitwise equal across plans (y's sum order follows the
    team)."""
    x, dt, bm, cm, a, h0 = _scan_inputs(2, 300, 1000, 16, cuda, seed=5,
                                        state=True)
    y0, h_ref = scan_ops.mamba_scan(x, dt, bm, cm, a, h0=h0)
    for plan in _scan_plans(16):
        y, h = scan_ops.mamba_scan(x, dt, bm, cm, a, h0=h0, plan=plan)
        assert _bitwise(h, h_ref), plan
        torch.testing.assert_close(y, y0, rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("t", [1, 1300, 4096])
@pytest.mark.parametrize("di", [1000, 16384])
@pytest.mark.parametrize("b", [1, 2])
def test_mamba_scan_plan_covers_every_state_once(ds, t, di, b):
    """The launch plan at the serve path's shapes: its team divides ds,
    the block is whole warps, and the kernel's index arithmetic (as
    `scan_thread_map` repeats it) gives every (batch row, channel,
    state) to exactly one thread."""
    plan = scan_ops.scan_plan(t, ds)
    assert ds % plan.team == 0 and plan.steps == min(plan.steps, t)
    scan_ops.check_plan(plan, ds)
    cover = scan_ops.scan_thread_map(plan, b, di, ds)
    key = (cover[:, 0] * di + cover[:, 1]) * ds + cover[:, 2]
    assert cover.shape[0] == b * di * ds
    assert torch.equal(torch.bincount(key, minlength=b * di * ds),
                       torch.ones(b * di * ds, dtype=torch.int64))


def test_mamba_scan_refuses_a_plan_it_was_not_built_for():
    for plan, ds in ((scan_ops.ScanPlan(16, 8, 4), 8),
                     (scan_ops.ScanPlan(3, 32, 4), 16),
                     (scan_ops.ScanPlan(4, 9, 4), 16),
                     (scan_ops.ScanPlan(4, 512, 4), 16),
                     (scan_ops.ScanPlan(4, 32, 0), 16),
                     (scan_ops.ScanPlan(2, 256, 128), 16),
                     (scan_ops.ScanPlan(2, 512, 16), 16)):
        with pytest.raises(ValueError, match="plan"):
            scan_ops.check_plan(plan, ds)


def test_mamba_scan_cpu_runs_the_plain_version():
    x, dt, bm, cm, a, h0 = _scan_inputs(2, 30, 96, 4, "cpu", state=True)
    before = scan_ops.mamba_scan.launches
    y, h = scan_ops.mamba_scan(x, dt, bm, cm, a, h0=h0)
    assert scan_ops.mamba_scan.launches == before
    y_ref, h_ref = scan_ref.mamba_scan(x, dt, bm, cm, a, h0=h0)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


def test_port_never_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "examples" / "port_serve_batch.py",
              ROOT / "benchmarks" / "port_kernel_redesign.py"] + [
        ROOT / "benchmarks" / f"port_{b}_bench.py" for b in ("fault",
                                                             "traffic")]
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
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import ServeEngine
    cfg = reduced(get_config("glm4-9b"), n_layers=1, d_model=64, n_heads=2,
                  d_ff=64, vocab=32)
    rwkv = reduced(get_config("rwkv6-3b"), n_layers=1, d_model=64,
                   n_heads=2, d_ff=64, vocab=32)
    cpu_params = TF.init_params(torch.Generator(), cfg, device="cpu")
    entry = [MarginEngine, Profiler, ALDRAMController, SimEngine,
             lambda: TF.init_params(torch.Generator(), cfg),
             lambda: TF.init_cache(cfg, 1, 8),
             lambda: ServeEngine(cpu_params, cfg),
             lambda: launch_serve.main(["--arch", "glm4-9b"]),
             lambda: TF.init_params(torch.Generator(), rwkv),
             lambda: TF.init_cache(rwkv, 1, 8),
             lambda: launch_serve.main(["--arch", "rwkv6-3b"]),
             lambda: perf_model.evaluate(n=8),
             lambda: perf_model.evaluate_adaptive(
                 np.zeros((2, 6), np.float32), (45.0,), (TH.steady(40.0),),
                 n=8),
             lambda: sample_population(torch.Generator()),
             lambda: F.fault_uniforms(0, 1, 4),
             lambda: perf_model.tenant_spec(n=4, n_streams=1).materialize()]
    if torch.cuda.is_available():
        assert MarginEngine().device.type == "cuda"
        assert SimEngine().device.type == "cuda"
        params = TF.init_params(torch.Generator("cuda"), cfg)
        assert params["embed"].device.type == "cuda"
        assert ServeEngine(params, cfg).device.type == "cuda"
        q = torch.zeros((1, 8, 2, 64), device="cuda")
        before = flash_ops.flash_attention.launches
        flash_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
        assert flash_ops.flash_attention.launches == before + 1
        assert TF.init_params(torch.Generator("cuda"), rwkv)[
            "embed"].device.type == "cuda"
        assert TF.init_cache(rwkv, 1, 8)["l0"]["wkv"].device.type == "cuda"
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

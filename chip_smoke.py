#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's AL-DRAM main, thermal, subarray-region,
fault-injection, multi-channel traffic and fleet recalibration paths,
its LLM serving path (dense attention, RWKV6, MoE and the Mamba hybrid)
and its training path (RWKV6, MoE and the Mamba hybrid), on one NVIDIA
card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result line):

  1. build every CUDA kernel from the sources in this checkout (nvcc,
     one process per source, in parallel) and print the compiler's
     register / spill report;
  2. the main path at full width, kernel launch counts reset just
     before and read just after: sample the calibrated 115-module
     population (176,640 cells); profile it (one refresh launch, one
     176,640 x 8,505 margin-grid launch); report the Sec. 5.2 / Fig. 3
     reductions at 55C and 85C; verify the zero-error invariant (12
     launches); replay the 70-trace pool under the profiled rows
     (`evaluate_system`, n = 4096) and under the paper's 55C set
     (`perf_model.evaluate`, n = 8192);
     then the same path once more under `torch.profiler` for the
     device busy share and device time by kernel;
  3. margin_grid against its plain PyTorch version on the card, on the
     first 8 modules' 12,288 cells x all 8,505 campaign combos (rtol =
     atol = 2e-4); its device time (mean of 5 launches after a warm-up,
     from torch.profiler's kernel records) and its wrapper call's time
     (median of 5, CUDA events) beside its bound and the plain
     version's time (the same for every kernel below); the columns'
     read and write key counts, and its bound from the work they need
     (its 12 GB of stores) beside the reference's per-element count;
     the per-element kernel (small grids) against the key kernel on the
     whole 176,640 x 8,505 grid, bit for bit, and its time;
  4. the thermal path at full width on the table the main path
     profiled, launch counts reset just before and read just after:
     `evaluate_dynamic(n=4096)` with the default scenarios (70 traces,
     4 scenarios + 4 oracles, 5 bins + JEDEC) per-module and per-bank,
     each through the two-launch path and `fused=True` (`run_bracket`),
     which must agree (worst_bin equal, gmeans within 1e-5 relative);
     adaptive >= static_worst - 1e-9 for every scenario and policy; then
     `evaluate_bank_system(n=4096)`; the `fused=True` runs are
     `benchmarks/port_thermal_bench.py`'s (per-module and per-bank) and
     `evaluate_bank_system` is `port_fig_bank.py`'s, each through its
     driver (its CSV line and its assertions); then the same path under
     `torch.profiler` for the device busy share;
  5. the subarray-region path at full width on the same population,
     launch counts reset just before and read just after: a regions=8
     controller profiles it (one refresh launch, one margin-grid launch)
     and verifies it (must be True; 39 launches); `region_reductions((2,
     4, 8))` must be monotone module <= bank <= r2 <= r4 <= r8, the
     8-region store under 0.5 of dense; `evaluate_region_system(n=4096)`
     replays 70 traces x 26 rows (JEDEC, 5 module, 5 bank, 3 x 5 region
     rows) over <= 64 unique columns in ONE launch of replay_blocks (c),
     through `benchmarks/port_fig_region.py` (its CSV line and its
     assertions);
     the deployed `safe_stack_regions()` (5 bins + JEDEC, a [64] map)
     runs in closed loop through `SimEngine` under the default 4 + 4
     scenarios in ONE launch of adaptive_blocks (c), and its gmean must
     be >= that of the static replay of each scenario's worst bin; then
     the same path under `torch.profiler` for the device busy share;
  6. the fault path at full width on what the main path profiled, launch
     counts reset just before and read just after: the five profiled
     module rows with the JEDEC row last under open and closed page x
     the `fault_bench` grid (9 rows, seed 11) plus the reference's two
     static margin-error rows (ONE launch of replay_blocks (e)), and the
     deployed module, per-bank and region stacks under the 4 + 4
     scenarios x the 9-row grid (ONE launch of adaptive_blocks (d)
     each), all over the 70-trace pool at n = 4096 on the engine's own
     error uniforms; then `port_fault_bench.run(fast=False)` on the
     reference's seed-11 uniforms (ONE launch of (d), its acceptance
     bracket asserted).  The watchdog bound must be exact in every cell
     of every watchdog lane, the inert lane bitwise equal to the same
     campaign without a fault axis, and `FaultSpec.none()` must launch
     no faulted kernel; the bench on the engine's own CUDA draw is
     printed (its >= 10x bracket depends on the draw and is not
     asserted, its watchdog bound is); then the same path under
     `torch.profiler` for the device busy share;
  6c. the traffic path at full size, launch counts reset just before and
     read just after: `port_traffic_bench.run(fast=False)` — 16
     multi-tenant streams x n = 8192 (a `TenantSpec` axis on the
     campaign mesh of every visible card, drawn once before timing; no
     synthesis in a timed run, asserted)
     x 3 FR-FCFS interleave policies x 8 timing rows on 1, 2 and 4
     channels, per channel count a warm-up, the FR-FCFS prepass timed
     alone and 3 timed runs of ONE replay launch each (replay_blocks (a)
     on one channel, (d) on two and four, asserted), then one unsharded
     4-channel run (`sharded_rel` 0, asserted); then a multi-channel
     closed-loop campaign (2 channels,
     the 8 default thermal lanes on the deployed module stack, 16
     streams x n = 2048), which runs the plain step loop on the card
     (the adaptive kernel is single-channel, as the reference's); then
     one 4-channel run on the first 512 requests of each stream under
     `torch.profiler` for the busy share, after phases 7 and 9-11 (its
     kernel records, ~262k at 8192, once left the next profiler
     session of a kernel timing with no record); the profile is cut to
     the first 512 requests to keep the run near half its time limit
     (the share swings with the host: 5.9-12.5 % at 2048, 9.3 % at
     4096, 7.6 % at 512 on an H100 80GB HBM3 at 700 W);
  6d. the campaign engine, launch counts reset just before and read
     just after: the Fig. 4 pool (70 traces x 8192, DDR3-1600 and the
     55C set) unsharded, on `make_campaign_mesh(1)` and on a 3-entry
     mesh repeating the card (T = 70 pads to 72), the thermal path's
     adaptive campaign (70 x 4096, the deployed module stack, 4 + 4
     scenarios) and `run_bracket` on the 3-entry mesh: one `campaign
     mesh <kind> shards=<k> shard_shape=<...>: 0 differing` line each
     (one dispatch, one launch per shard); `perf_model.synth_spec` as a
     declarative axis against `trace_batch`, static and adaptive, twice
     (0 differing, dispatches +1 each run, syntheses +1 on the first
     run, which draws the pool, and +0 on the second, which replays it
     from its cache); the replay tuner (`ReplayTuner(platform="cuda")`,
     its table written to `chiprun_out/replay_tune_cuda.json`)
     profiling its two CUDA candidates (the default block and 32 lanes)
     on both declarative campaigns (FCFS), each candidate's
     seconds and the winner, every candidate and the `backend="auto"`
     run bitwise the default; the guardband: `design_quantile` on the
     card (26 margin_grid launches) against the CPU's (within one
     bisection step) and above the 115-module population's realised
     compound quantile, and a tighten x 3 / relax x 5 round trip on the
     deployed module and per-bank stacks that must be the identity;
     then replay_blocks (a) and adaptive_blocks (a) at 32, 64 and 128
     chain lanes a block against the kernels' own choice at the Fig. 4
     shape (S = 2), at 66 and 128 rows, at the thermal campaign's 8
     lanes and at 72 and 128 lanes: bitwise the default block, with
     paired, interleaved CUDA-event times beside each chain bound;
  6e. the fleet recalibration service at full width on the main path's
     population, launch counts reset just before and read just after:
     `FleetEngine.autotune_epoch` records the epoch campaign's CUDA
     candidate first (not counted), then `examples/aldram_fleet.py`'s
     fleet-month (30 epochs at 48C, the chiller failing (+9C) at epoch
     15, module 3 dead at epoch 10, rows (0, 17, 19) x 1,024 requests)
     under the static, error and periodic policies through a
     `backend="auto"` engine: exactly one launch of replay_blocks (b) an
     epoch and one margin_grid launch per probe chunk and two per
     profile (asserted), the error policy's uncorrectable events exactly 0
     (asserted); each policy's summary, seconds per epoch and frontier;
     then the error policy's first 10 epochs under `torch.profiler` for
     the busy share;
  6f. `fleet_bench`'s --fast fleet-month (8 modules x 4 cells, rows (0,
     19) x 512, the three policies), a 10-epoch regions=4 fleet
     (replay_blocks (c)) and a 10-epoch faulted fleet (replay_blocks
     (e)) on the card, launch counts reset just before and read just
     after, and on the CPU from the same cells, pool and error
     uniforms: every telemetry field equal, or a divergence that only
     cells within 2e-4 of zero explain (`port_fleet_bench.compare`: the
     first differing scrub or profile re-run on both devices, its
     sign-differing cells printed with both margins); the bench's
     bracket asserted on the card;
  6g. the paper-figure drivers at full width on the main path's
     population, launch counts reset just before and read just after:
     `port_fig2_refresh`, `port_fig2_timing`, `port_multi_timing` (its
     frontier in ONE replay launch over an 8,192-request trace),
     `port_repeatability` (176,640 x 1 margins, noise from
     `np.random.default_rng(0)`), `port_power_bench`, `port_sim_bench
     --fast` (the full 8,192 is a `benchmarks/port_run.py` run: its
     reference pipeline is a pure-Python FR-FCFS loop) and
     `calibration.evaluate(fast=False)` on the population (its
     statistics, residuals and loss printed): each driver's CSV line
     with its own assertions, 8 margin_grid launches (asserted), the
     launches by kernel variant of this phase and, with the drivers
     phases 4 and 5 ran, of all nine figure drivers (margin_grid,
     replay_blocks (a), (b), (c) and adaptive_blocks (a), (b) each > 0);
     every margin_sweep call and the first replay_grid call
     (multi_timing's) recorded for phase 7;
  7. margin_grid at every shape below the key search that the main,
     region, fleet and figure paths gave it (the fleet's scrub chunks:
     38,400 x 200 and 23,040 x 120 with per-cell tREFI overrides;
     repeatability's 176,640 x 1 stress combo), on the inputs of its
     first call there: the wrapper (the per-element kernel) against the
     plain version (rtol = atol = 2e-4), the key kernel against it bit
     for bit, and both times; margin_grid at every key-kernel shape of
     the figure path (fig2_timing's, multi_timing's and
     `calibration.evaluate`'s campaigns), on a row slice of its first
     call's inputs above the key search's threshold: the wrapper (the
     key kernel) against the plain version (rtol = atol = 2e-4), the
     per-element kernel against it bit for bit; then replay_blocks (a)
     at both Fig. 4 shapes and on multi_timing's frontier replay
     (bitwise), replay_blocks (b) at the thermal
     path's shape and on the fleet path's first epoch (its [116, 8, 6]
     per-bank tile at the tuned block, bitwise), and adaptive_blocks
     (module and per-bank tables, raw temps and bins emitted) against
     their plain versions on the
     card at the thermal path's full shapes (bins identical on every
     request, latencies within rtol 1e-5, temperatures / heat /
     diagnostics within rtol 1e-5, atol 1e-4; the per-bank replay
     bitwise), replay_blocks (c) at
     `evaluate_region_system`'s shape (bitwise on every lane; a
     bank-constant map and R = 1 with the identity map bitwise equal to
     variant (b)) and adaptive_blocks (c) at the regioned closed loop's
     shape (bins identical on every request, raw temps and bins
     emitted), replay_blocks (e) at the static fault campaign's shape
     and adaptive_blocks (d) at the closed-loop fault campaigns' shape
     for all three table layouts (latencies, totals, bins, switches and
     counters bitwise; temperatures within rtol 1e-5, atol 1e-4), and
     replay_blocks (d) at the traffic shape (48 cells x 8192 requests x
     8 rows on 2 and 4 channels, and faulted with 3 fault rows per row;
     latencies, totals and counters bitwise), with their times; each
     replay and adaptive variant also prints its chain bound
     (`ops.replay_chain_cycles` per step x N at the card's maximum SM
     clock; replay_blocks' priced with the bank state forwarded in
     registers and, faulted, the error probability a lane constant) and
     the kernel's ratio to it, and each adaptive variant its
     launch plan (chunk, staged tables, shared bytes, threads);
  8. the main path at --fast scale (24 modules, 8 cells, 2.5 ns grid) on
     the card and on the CPU: chosen combos must agree (a flip only
     where the CPU's deciding margin is within 2e-4 of 0) and the
     Fig. 4 gmeans within 1e-5 relative; then `evaluate_dynamic(n=1024)`
     on both: worst_bin equal, gmeans within 1e-4 relative, and a
     selected bin may differ only where the CPU's sensed temperature
     lies within 1e-3 C of a switching threshold (an edge, or an edge
     minus the hysteresis) or where the lane's previous request already
     differed (the hysteresis carries the earlier choice); then the region
     path at --fast scale (regions=8) on both: chosen region rows equal
     up to flips whose deciding margin lies within 2e-4 of 0,
     `region_reductions` and compression ratios equal, and the
     `evaluate_region_system(n=1024)` gmeans within 1e-5 relative; then
     `port_fault_bench` at --fast scale on the reference's uniforms on
     both: every served bin and counter equal (a mismatch is printed
     with its cell, lane, request and |u - p|); then
     `port_traffic_bench.run(fast=True)` on the same tenant streams on
     both: per channel count the mean, p99 and gap equal, and the
     4-channel latency grid bitwise equal; then the campaign engine on
     a declarative axis of the pool's first 13 traces (n = 1024) on
     both: on
     each device the 3-entry mesh, the bracket on it and every tuner
     candidate of the platform bitwise the device's default run, and
     the card's static runs and bracket static half bitwise the CPU's.

  9. the serve path at full width, after the AL-DRAM phases' memory is
     freed: glm4-9b unreduced (9.40 B parameters, float32, 37.6 GB of
     seeded random weights drawn on the card, TF32 off) served through
     `ServeEngine(batch_slots=2, max_len=8192)`, whose prefill goes
     through the flash kernel, four
     requests of 4096, 2000, 1300 and 700 prompt tokens (numpy, seeded)
     with 16 new tokens each, launch counts reset just before and read
     just after: exactly 40 layers x 4 prefills = 160 flash launches, none
     in decode and no other kernel; then the same requests with the
     three serve kernel wrappers swapped for their plain versions (the
     plain path, `plain_serve`): every served token equal, except
     after a step where the plain path's top-2 logit gap is below 1e-3
     (those requests are not compared further and are counted), and each
     prefill's last-token logits within 1e-3; wall seconds per prefill
     and decode tick, tokens per second; one short request under
     `torch.profiler` for the busy share;
  10. `python -m repro_torch.launch.serve --arch glm4-9b --device cuda`
     and `--arch rwkv6-3b` as subprocesses, with phase 20: exit 0 and 4
     requests printed by each;
  11. flash_attention's ptxas report per instantiation (registers,
     spills, stack, dynamic shared memory) from the build log; the
     kernel against its plain version in float32 and bfloat16
     (the reference's rtol = atol = 2e-3 / 2e-2, and within them max abs
     1e-5 in float32 and, against the plain version's float32 math on the
     same inputs, atol 1e-3 + rtol 1.6e-2, about 2 bfloat16 ulps, in
     bfloat16) at glm4-9b's prefill shape (1, 4096,
     32/2, 128), an unaligned 2000, gemma3-12b's local (16/8, 256, window
     1024) and global layers at 4096, musicgen's MHA (2048, 32/32, 64)
     and a batched (2, 1024, 8/2, 128); its time at the glm4 4096 shape
     in both dtypes (CUDA events, median of 10 calls) beside its bound
     (and its share of it), the plain version's and
     `scaled_dot_product_attention`'s under each backend that takes it
     (and the kernel's ratio to the fastest);
  12. (with phase 8) reduced glm4-9b, gemma3-12b, rwkv6-3b, jamba (with
     its experts), granite (with its 32 experts) and arctic served on
     the card (kernels) and on the CPU from the same seeded weights, the
     6 requests of `examples/port_serve_batch.py`: tokens equal;
  13. rwkv6-3b at full width and depth (32 RWKV6 layers, 3.60 B
     parameters, 14.4 GB float32), served as in phase 9: exactly 32 x 4
     = 128 wkv launches, all in prefill, and no flash or mamba_scan
     launch; the same requests with the WKV wrapper swapped for its
     plain version (chunk 16) in this script only: tokens equal up to
     near ties, last-token logits within 1e-3; the parameter count held
     to the `init_params` tree on the meta device (the config's
     `param_count()` printed beside it: its RWKV6 and Mamba formulas are
     approximations); its busy share;
  14. jamba-1.5-large at full width without its experts (a full-width
     period's four MoE layers would take 154 GB), cut to one 8-layer
     period (7 Mamba + 1 attention, 9.00 B parameters, 36.0 GB), the
     same requests and checks: 4 flash launches and 7 x (4 prefills
     + the decode ticks) mamba_scan launches; the plain path swaps the
     selective-scan wrapper for its step loop;
  15. wkv against its plain version at rwkv6-3b's prefill shape (1,
     4096, 40, 64), a ragged T = 1300, a reduced D = 32 with B = 2,
     from a nonzero initial state and a 64-chunk state scan with 2
     heads from a nonzero state, outputs and final states within rtol
     = atol = 3e-4 (the reference's Pallas-vs-oracle bound); its time at
     the full shape (CUDA events, median of 10) beside its bound
     (`wkv_flops` at 67 TFLOP/s) and the plain version's;
  16. mamba_scan the same way at jamba's prefill shape (1, 4096, 16384,
     16), a ragged T = 1300 with B = 2, ds = 8 and a T = 1 step from a
     nonzero state, timed at the prefill shape and at the decode step
     (2, 1, 16384, 16) (device time from torch.profiler, the wrapper
     call's CUDA-event time beside it); bound: `mamba_scan_hbm_bytes`
     plus A and the
     state (read when given, written) at 3.35 TB/s; the serve path's
     launches by shape (prefill, decode at T = 1) and each shape's
     launch plan.

  17. rwkv6-3b trained at full width and depth (`Trainer`, bf16
     compute, float32 parameters and AdamW moments, remat, accum 2, 2 x
     4096 tokens of `SyntheticLM(seed=0)` a step, 3 steps), launch
     counts reset just before and read just after: exactly 128 wkv and
     64 wkv_bwd launches a step and nothing else; seconds per step split
     into forward + backward and the optimizer, tokens per second, peak
     memory; a fourth step under `torch.profiler` (device time by
     kernel, the WKV kernels' among it); the same steps with the WKV
     wrapper swapped for its plain version (losses within 1e-3;
     grad-norm gaps printed); float32 gradients of one 4096-token
     microbatch through both at 2 and 32 layers: losses within 1e-3,
     grad norms within max(1e-2, twice the largest move of either
     path's under one float32 ulp of parameter noise, three draws
     each), and each path's distance to a float64 witness (the plain
     version in float64) printed;
  17c. (after phase 17 has freed its trainers) the same training on a
     mesh: `Trainer(mesh=make_smoke_mesh())`, the parameters, gradient
     buffers and moments `DTensor`s on a (1, 1) ("data", "model") mesh
     in an NCCL world of one (a `HashStore`, no port), launch counts
     reset just before and read just after: exactly phase 17's 128 wkv
     and 64 wkv_bwd launches a step and nothing else; losses, lr and
     grad norms equal to phase 17's run as it ran (the largest gaps
     printed), seconds per step and peak memory beside phase 17's with
     the card's name and power limit; one more full-width gradient,
     whose largest leaf goes through the top-k (with error feedback)
     and int8 gradient compressors on the card and on the CPU, bit for
     bit, and through one 8-bit AdamW update (with its parameter, from
     a zero state, no clipping) on the card and on the CPU: moment codes,
     row scales and parameters bit for bit; a reduced rwkv6-3b mesh
     trainer's checkpoint restored with `shardings=` onto
     `make_mesh_for(1, model_parallel=1)`, bit for bit; the process
     group is destroyed at the end;
  17d. (inside phase 17c, after its gradient for the compressors and
     before its trainer is freed; no new model) one warm training step
     of that trainer counted on the card by the cost counter
     (`repro_torch.launch.hlo_cost`), launch counts reset just before
     and read just after: exactly 128 wkv and 64 wkv_bwd launches; the
     same step counted on fake CPU tensors by `repro_torch.launch.
     dryrun`: equal flops and collectives, and the HBM bytes equal or
     each differing op printed; one line with the flops, HBM bytes, model
     flops, useful ratio, the H100 roofline's compute and memory seconds,
     phase 17's warm step and the model-flops share of 989 TFLOP/s in
     it, with the card's name and power limit;
  18. the WKV backward kernel against autograd through its plain
     version at (1, 4096, 40, 64), a ragged 1300, D = 32 with B = 2 and
     from a nonzero state with a nonzero final-state gradient, every
     gradient within rtol = atol = 1e-3 (each max abs beside the first
     backward kernel's on the same inputs); its time at the full shape
     beside its bound and the plain version's, and the device time of
     each of its four CUDA kernels (torch.profiler);
  19. flash_attention refuses grad-requiring inputs; mamba_scan returns
     outputs with a grad_fn (its backward kernel);
  20. `python -m repro_torch.launch.train --arch
     rwkv6-3b|glm4-9b|granite-moe-1b-a400m --device cuda --steps 3` and
     `python -m repro_torch.launch.serve --arch glm4-9b|rwkv6-3b|granite-
     moe-1b-a400m --device cuda`, all in the background during the
     cross-device phases: exit 0 and the loss line (training) or the 4
     requests (serving);
  21. (with phase 12) reduced rwkv6-3b, granite (32 experts) and one
     period of Jamba with its experts (its Mamba layers through the scan
     kernel and its backward) trained 3 steps in float32 on the card and
     on the CPU: losses within 1e-5, grad norms within 1e-5 (or twice
     the CPU's own 1-ulp spread), parameters within atol 1e-6 + rtol
     1e-4, and exactly the expected kernel launches per model;
  22. (after phase 16) granite-moe-1b-a400m at full width and depth (24
     layers of 32 experts, top-8, 1.335 B parameters, float32) served as
     in phase 9: exactly 24 x 4 = 96 flash launches and no other kernel,
     the plain path's tokens, the routing choices in which the two
     paths differ per request, the logits with the kernel path's routes
     forced on the plain path, the parameter count; then one
     4096-token prefill with the MoE's one-hot dispatch and combine
     contractions timed beside its expert products (CUDA events);
  23. (after phase 18) granite-moe-1b-a400m trained at full width and
     depth with phase 17's recipe: no hand-written kernel launched, losses
     finite, every MoE layer's aux in (0, 32], seconds per step, tokens
     per second, peak memory, a fourth step under torch.profiler;
  24. (last) the selective-scan backward kernel against autograd through
     its plain version at jamba's (1, 4096, 16384, 16), a ragged T =
     1300 with B = 2 and ds = 8, and from a nonzero state with a nonzero
     final-state gradient, every gradient within rtol = atol = 1e-3; its
     time beside its bound and the plain version's; then one full-width
     Jamba Mamba mixer at T = 4096: every parameter gradient through the
     kernels and through the plain scan within a relative norm gap of
     1e-3.

Phases 13-19 run after phase 11; glm4-9b's weights are freed before
rwkv6-3b's are drawn, those before jamba's, jamba's before granite's,
and granite's before training.

Before them a `phase seconds:` line gives each phase's host seconds.
A `host probe:` line before phase 1 and another after the total time
give the seconds of a fixed host workload (`host_probe`), so that runs
on different hosts can be compared.  The last lines are the card (`nvidia-smi` name and power limit), one
JSON object of per-kernel numbers, and the result object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 2e-4
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores (both at the full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12     # dense, on the tensor cores
REPLAY_OPS_PER_STEP = 25     # service_math: adds, maxes, compares, selects
# thermal step on top of service_math: decay and sum of 8 bank heats,
# ambient (sin, fmod, compares), 2 x 5 bin compares, energy and deposit
ADAPTIVE_OPS_PER_STEP = 75
HYST_EDGE_TOL = 1e-3         # C: a bin may flip only this close to a threshold


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device time of `fn` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


class NoProfilerRecord(RuntimeError):
    """torch.profiler kept no record of a kernel in three sessions."""


def kernel_ms(fn, kernel: str, reps: int = 5) -> float:
    """Mean device time in ms of the CUDA kernels whose names contain
    `kernel` in one call of `fn`, over `reps` calls (each followed by a
    synchronize) after a warm-up, from torch.profiler's CUPTI kernel
    records: per distinct kernel the mean of its launches, summed over
    the kernels (a call that launches several sums them).  Unlike
    `cuda_ms` it leaves out what the wrapper does around the launch,
    such as input checks that wait for the device.  The profiler has
    dropped a record now and then, and right after a large session all
    of a session's records: each mean is over the records it kept (a
    shortfall is printed), and a session that kept none is opened again,
    up to three times; if none of them keeps a record (it happened after
    the Jamba profile) it raises `NoProfilerRecord`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key
                and e.self_device_time_total > 0]
        if hits:
            break
        print(f"  (profiler session {attempt + 1} kept no record of "
              f"{kernel})")
    if not hits:
        raise NoProfilerRecord(f"no profiler record of {kernel} in 3 "
                               "sessions")
    check(all(1 <= e.count <= reps for e in hits),
          f"profiler saw {[(e.key, e.count) for e in hits]} for {kernel}")
    for e in hits:
        if e.count != reps:
            print(f"  (profiler kept {e.count} of {reps} records of "
                  f"{e.key[:60]})")
    return sum(e.self_device_time_total / e.count for e in hits) / 1e3


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clock_hz() -> float:
    """The card's maximum SM clock (`nvidia-smi ... clocks.max.sm`)."""
    if not hasattr(sm_clock_hz, "hz"):
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        sm_clock_hz.hz = float(out.stdout.strip()) * 1e6
    return sm_clock_hz.hz


def chain_bound(variant: str, n: int, ms: float, **kw) -> dict:
    """A replay kernel variant's chain bound — `ops.replay_chain_cycles`
    per step x N dependent steps at the SM clock — printed beside the
    kernel's time and its ratio to it."""
    from repro_torch.kernels.replay import ops
    cyc = ops.replay_chain_cycles(variant, **kw)
    c_ms = cyc * n / sm_clock_hz() * 1e3
    print(f"  chain bound ({variant}): {c_ms:.4f} ms ({cyc} cycles/step x "
          f"{n} steps at {sm_clock_hz() / 1e6:.0f} MHz; "
          f"{json.dumps(ops.replay_chain_ops(variant, **kw))}); kernel "
          f"{ms:.3f} ms = {ms / c_ms:.2f}x it")
    return {"chain_ms": c_ms, "chain_cycles_per_step": cyc}


def _adaptive_table_class(tile, bins, n_banks: int, regioned: bool,
                          faulted: bool) -> str:
    """Where the adaptive kernel's chain reads its table row at this
    shape: "smem" when its plan stages the stacks, else "l1"."""
    from repro_torch.kernels.replay import ops
    plan = ops.adaptive_plan(tile.shape[-1], max(bins.shape[0], 1),
                             bins.shape[0] + 1, n_banks, 8, tile.dim() == 4,
                             regioned, faulted)
    print(f"  adaptive_blocks plan: {json.dumps(plan)}")
    return "smem" if plan["tables_staged"] else "l1"


# the variant counters of each replay wrapper (every launch also counts
# in `launches`; a launch counted in none of these is variant (a))
VARIANTS = {"replay_blocks": {"b": "launches_banked",
                              "c": "launches_regioned",
                              "d": "launches_multi",
                              "e": "launches_faulted"},
            "adaptive_blocks": {"b": "launches_banked",
                                "c": "launches_regioned",
                                "d": "launches_faulted"}}


def _replay_fns():
    from repro_torch.kernels.replay import ops as replay_ops
    return {"replay_blocks": replay_ops.replay_blocks,
            "adaptive_blocks": replay_ops.adaptive_blocks}


def _serve_fns():
    """The LLM paths' kernel wrappers by kernel name (the two backward
    kernels launch only in training)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    return {"flash_attention": flash_ops.flash_attention,
            "wkv": wkv_ops.wkv, "wkv_bwd": wkv_ops.wkv_backward,
            "mamba_scan": scan_ops.mamba_scan,
            "mamba_scan_bwd": scan_ops.mamba_scan_backward}


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.charge_sim import ops as charge_ops
    charge_ops.margin_grid.launches = 0
    for fn in _serve_fns().values():
        fn.launches = 0
    for name, fn in _replay_fns().items():
        fn.launches = 0
        for attr in VARIANTS[name].values():
            setattr(fn, attr, 0)


def read_counts() -> dict:
    """Launches per kernel variant since `reset_counts`."""
    from repro_torch.kernels.charge_sim import ops as charge_ops
    out = {"margin_grid": charge_ops.margin_grid.launches}
    out.update({name: fn.launches for name, fn in _serve_fns().items()})
    for name, fn in _replay_fns().items():
        var = {v: getattr(fn, attr) for v, attr in VARIANTS[name].items()}
        out[f"{name} (a)"] = fn.launches - sum(var.values())
        out.update({f"{name} ({v})": c for v, c in var.items()})
    return out


PHASE_SECONDS: dict = {}


def phase(fn, *args):
    """Run one phase, adding its host seconds to `PHASE_SECONDS`."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[fn.__name__] = round(
        PHASE_SECONDS.get(fn.__name__, 0.0) + time.perf_counter() - t0, 1)
    return out


HOST_PROBE_REPS = 3


def host_probe() -> str:
    """A fixed host workload, timed (median of 3): a pure-Python loop
    (the interpreter, as in the phases' host loops) and a float64 numpy
    sort of 2^22 seeded values (memory and one core).  Printed at the
    start and the end of a run, so that runs on different hosts can be
    compared: the card plays no part in it."""
    import numpy as np
    vals = np.random.default_rng(SEED).random(1 << 22)

    def loop():
        acc = 0
        for i in range(2_000_000):
            acc += i * i
        return acc

    out = []
    for fn in (loop, lambda: np.sort(vals)):
        ts = []
        for _ in range(HOST_PROBE_REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        out.append(sorted(ts)[HOST_PROBE_REPS // 2])
    return (f"host probe: python loop {out[0]:.4f} s, numpy sort "
            f"{out[1]:.4f} s (median of {HOST_PROBE_REPS})")


def wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phases

def driver_run(env, name: str, fn):
    """Run one figure driver inside a phase: (its result, its seconds,
    its launches by kernel variant), the launches also kept in
    `env["figure_drivers"]` for phase 6g's totals.  The counts are read
    around the call, not reset."""
    before = read_counts()
    out, t = wall(fn)
    after = read_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    env.setdefault("figure_drivers", {})[name] = {"seconds": round(t, 3),
                                                  "launches": launches}
    return out, t, launches


def main_path(env) -> dict:
    """Phase 2: the full-width main path through the kernels."""
    import torch
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population

    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    pop, t_pop = wall(lambda: sample_population(
        torch.Generator().manual_seed(SEED), CALIBRATED_VARIATION,
        device="cuda"))
    ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=1.25),
                            device="cuda")
    mlog = []
    with margin_log(mlog):
        table, t_prof = wall(lambda: ctrl.profile(pop))
        d_prof = ctrl.engine.dispatch_count
        ok, t_ver = wall(lambda: ctrl.verify(pop))
    red = {t: ctrl.average_reductions(t) for t in (55.0, 85.0)}
    res = ctrl.sweep_result
    fig3 = {}
    for t in (55.0, 85.0):
        ti = res.temps.index(t)
        r, w = res.reductions(Op.READ)[ti], res.reductions(Op.WRITE)[ti]
        fig3[t] = {"read_sum": r["latency_sum"], "write_sum": w["latency_sum"],
                   "trcd": r["trcd"], "tras": r["tras"], "twr": w["twr"],
                   "trp": r["trp"]}
    d_ver = ctrl.engine.dispatch_count - d_prof
    eng_sys, eng_ev = SimEngine(device="cuda"), SimEngine(device="cuda")
    sys_res, t_sys = wall(lambda: ctrl.evaluate_system(pop, n=4096,
                                                       engine=eng_sys))
    ev, t_ev = wall(lambda: perf_model.evaluate(n=8192, engine=eng_ev))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"population: {tuple(pop.cells.shape)} = "
          f"{pop.flat_cells().shape[0]} cells ({t_pop:.3f} s)")
    shapes = margin_shapes(mlog)
    print(f"profile: table {table.params.shape}, {d_prof} launches "
          f"({t_prof:.3f} s); verify: {ok}, {d_ver} launches ({t_ver:.3f} s)")
    print(f"margin_grid calls by shape (margin_sweep calls, CUDA events): "
          f"{json.dumps(shapes)}")
    for t in (55.0, 85.0):
        f = fig3[t]
        print(f"fig3 @{t:.0f}C: read_sum {f['read_sum']:.2%} write_sum "
              f"{f['write_sum']:.2%} | tRCD {f['trcd']:.2%} tRAS "
              f"{f['tras']:.2%} tWR {f['twr']:.2%} tRP {f['trp']:.2%}")
        print(f"average_reductions({t:.0f}): " + " ".join(
            f"{k} {v:.2%}" for k, v in red[t].items()))
    for t, d in sys_res["per_temp"].items():
        print(f"evaluate_system @{t:.0f}C: " + " ".join(
            f"{k} {v:.2%}" for k, v in d.items()))
    s = ev["summary"]
    print(f"evaluate (55C set): multi intensive {s['multi_intensive_gmean']:.2%}"
          f" non-intensive {s['multi_nonintensive_gmean']:.2%} all "
          f"{s['multi_all_gmean']:.2%} best {s['best_multi'][0]} "
          f"{s['best_multi'][1]:.2%}")
    print(f"dispatches: profile+verify {ctrl.engine.dispatch_count}, "
          f"evaluate_system {eng_sys.dispatch_count}, evaluate "
          f"{eng_ev.dispatch_count}")
    print(f"phase seconds: profile {t_prof:.3f} verify {t_ver:.3f} "
          f"evaluate_system {t_sys:.3f} evaluate {t_ev:.3f}; peak device "
          f"memory {peak_gb:.2f} GB")
    print("kernels: " + json.dumps(launches))

    check(ok is True, "verify() found a negative margin")
    check(all(launches[k] > 0 for k in ("margin_grid", "replay_blocks (a)")),
          f"a kernel of the main path never launched: {launches}")
    check(table.params.shape == (115, 5, 8, 4), str(table.params.shape))
    check(d_prof == 2 and d_ver == 12, f"launches {d_prof}+{d_ver}")
    for t in (55.0, 85.0):
        check(all(0.0 < v < 1.0 for v in fig3[t].values()), str(fig3[t]))
    check(fig3[55.0]["read_sum"] > fig3[85.0]["read_sum"],
          "55C must allow deeper cuts than 85C")
    vals = [v for d in sys_res["per_temp"].values() for v in d.values()]
    vals += [s["multi_intensive_gmean"], s["multi_nonintensive_gmean"],
             s["multi_all_gmean"]]
    check(all(-1.0 < v < 1.0 for v in vals), f"speedups {vals}")
    check(s["multi_intensive_gmean"] > s["multi_nonintensive_gmean"] > 0,
          "intensive workloads must gain more than non-intensive ones")
    check(shapes["campaign"]["launches"] == 1 and shapes["campaign"][
        "launches"] + shapes["other"]["launches"] == launches["margin_grid"],
          f"margin shapes {shapes}, launches {launches['margin_grid']}")
    env.update(pop=pop, ctrl=ctrl, sys_res=sys_res, launches=launches,
               launches_main=launches, margin_shapes_main=shapes,
               margin_small_main=small_grid_inputs(mlog))
    return env


def busy_share(label: str, fn, watch: tuple = ()) -> None:
    """Run `fn` once under `torch.profiler`: wall time, device busy and
    idle share, device time by name (the six largest, and every record
    whose name contains one of `watch`).  A measurement only: if the
    profiler records no device time it reports "not measured".  The
    profiler records the device's activity alone: host-side records
    feed no number here and would only slow the run under it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    # device-side records only (kernels, copies, fills): a CPU op such as
    # aten::copy_ repeats its children's device time as its own
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    gather_s = time.perf_counter() - t0 - t
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"{label}: device busy share not measured (the profiler "
              "recorded no device time)")
        return
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    top = ranked[:6] + [e for e in ranked[6:]
                        if any(w in e.key for w in watch)]
    print(f"{label} under torch.profiler: {t:.3f} s wall, device busy "
          f"{dev_us / 1e6:.3f} s = {dev_us / 1e6 / t:.1%} (idle "
          f"{1 - dev_us / 1e6 / t:.1%}); gathering the records "
          f"{gather_s:.1f} s more")
    for e in top:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")


def time_breakdown(env) -> None:
    """Phase 2b: the main path once more under `torch.profiler`."""
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController

    pop = env["pop"]
    ctrl = ALDRAMController(env["ctrl"].profiler, device="cuda")
    busy_share("main path", lambda: (
        ctrl.profile(pop), ctrl.verify(pop),
        ctrl.evaluate_system(pop, n=4096),
        perf_model.evaluate(n=8192, device="cuda")))


def path_launches(env, kernel: str) -> dict:
    """A kernel variant's launches: the total over the paths driven,
    and per path."""
    by_path = {path: env[f"launches_{path}"][kernel]
               for path in ("main", "thermal", "region", "fault",
                            "traffic", "campaign", "fleet", "fleet_fast",
                            "figures")
               if f"launches_{path}" in env}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


CAMPAIGN_GRID = (176_640, 8505)     # cells x columns of one campaign


@contextlib.contextmanager
def margin_log(log: list):
    """Record every `margin_sweep` call made inside (each makes one
    `margin_grid` call; `MarginEngine` reaches the kernel through it): its
    (n, m), a pair of CUDA events around it (no synchronize), for the
    launches by shape, and, for the first call at each (n, m), its
    arguments by name.  The wrapper's own count is untouched."""
    import torch
    from repro_torch.kernels.charge_sim import ops
    orig = ops.margin_sweep
    sig = inspect.signature(orig)
    seen = set()

    def logged(cells, combos, *args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(cells, combos, *args, **kw)
        e1.record()
        shape, named = (cells.shape[0], combos.shape[0]), None
        if shape not in seen:       # holding every call's inputs would
            seen.add(shape)         # keep each epoch's cells on the card
            bound = sig.bind(cells, combos, *args, **kw)
            bound.apply_defaults()
            named = bound.arguments
        log.append((*shape, e0, e1, named))
        return out

    ops.margin_sweep = logged
    try:
        yield log
    finally:
        ops.margin_sweep = orig


@contextlib.contextmanager
def first_call(module, name: str, log: dict):
    """Record the arguments (by name, defaults applied, tensors cloned)
    of the first call of `module.name` made inside."""
    import torch
    orig = getattr(module, name)
    sig = inspect.signature(orig)

    def logged(*args, **kw):
        if not log:
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            log.update({k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in bound.arguments.items()})
        return orig(*args, **kw)

    setattr(module, name, logged)
    try:
        yield log
    finally:
        setattr(module, name, orig)


def margin_shapes(log: list) -> dict:
    """margin_grid calls split into the campaign grid and the rest: count
    and summed call ms (CUDA events) of each."""
    import torch
    torch.cuda.synchronize()
    out = {"campaign": [0, 0.0], "other": [0, 0.0]}
    for n, m, e0, e1, _ in log:
        k = "campaign" if (n, m) == CAMPAIGN_GRID else "other"
        out[k][0] += 1
        out[k][1] += e0.elapsed_time(e1)
    return {k: {"launches": c, "ms": round(t, 3)}
            for k, (c, t) in out.items()}


def small_grid_inputs(log: list, skip=(CAMPAIGN_GRID,)) -> dict:
    """(n, m) -> [cells_t, combos_t, constants, calls]: the packed inputs
    of the first `margin_sweep` call at each shape not in `skip` (by
    default the campaign grid, which phase 3 holds), and the number of
    calls at that shape."""
    from repro_torch.kernels.charge_sim import ops
    out = {}
    for n, m, _, _, a in log:
        if (n, m) in skip:
            continue
        if (n, m) not in out:
            out[(n, m)] = [*ops.pack_inputs(
                a["cells"], a["combos"], a["temps_combo"],
                a["trefi_read_cells"], a["trefi_write_cells"]),
                a["constants"], 0]
        out[(n, m)][3] += 1
    return out


def vs_plain(k_outs, p_outs) -> tuple[float, float, int, int]:
    """(kernel, plain) output pairs -> max abs and max relative error,
    elements beyond rtol = atol = TOL, and elements not bitwise equal."""
    import torch
    err_abs = err_rel = 0.0
    viol = nonbit = 0
    for k_out, p_out in zip(k_outs, p_outs):
        d = (k_out - p_out).abs()
        err_abs = max(err_abs, d.max().item())
        err_rel = max(err_rel, (d / p_out.abs().clamp(min=1e-30)).max().item())
        viol += int((d > TOL + TOL * p_out.abs()).sum())
        nonbit += int((k_out.view(torch.int32)
                       != p_out.view(torch.int32)).sum())
    return err_abs, err_rel, viol, nonbit


def kernel_margin_grid(env) -> dict:
    """Phase 3: margin_grid vs its plain version, and its times."""
    import torch
    from repro_torch.core.calibration import CALIBRATED_CONSTANTS as C
    from repro_torch.core.sweep import Op
    from repro_torch.kernels.charge_sim import ops, ref

    pop, ctrl = env["pop"], env["ctrl"]
    combos, temps, _, tc = ctrl.engine.campaign_columns(
        pop, ctrl.sweep_result.spec)
    dev = torch.device("cuda")
    cells_t, combos_t = ops.pack_inputs(
        pop.flat_cells(), torch.tensor(combos, device=dev),
        torch.tensor(temps, device=dev), torch.tensor(tc[Op.READ], device=dev),
        torch.tensor(tc[Op.WRITE], device=dev))
    n, m = cells_t.shape[1], combos_t.shape[1]
    n_slice = 8 * 8 * 8 * 24
    sl = cells_t[:, :n_slice].contiguous()
    check(n_slice * m >= ops.SEARCH_MIN_ELEMS, "the slice skips the keys")
    err_abs, err_rel, viol, nonbit = vs_plain(
        ops.margin_grid(sl, combos_t, C), ref.margin_grid(sl, combos_t, C))
    print(f"margin_grid vs plain on {n_slice} x {m} (x2 outputs): max abs "
          f"{err_abs:.3e}, max rel {err_rel:.3e}, {viol} elements beyond "
          f"rtol=atol={TOL:g}, {nonbit} not bitwise equal")
    check(viol == 0, f"margin_grid disagrees with its plain version at "
                     f"{viol} elements")

    kg = ops.key_groups(combos_t, ops._lib().margin_grid_group_bytes())
    kr, kw, groups = kg.rkeys.shape[1], kg.wkeys.shape[1], kg.groups.shape[0]
    call = cuda_ms(lambda: ops.margin_grid(cells_t, combos_t, C))
    ms = kernel_ms(lambda: ops.margin_grid(cells_t, combos_t, C),
                   "margin_grid_kernel")
    plain = cuda_ms(lambda: ref.margin_grid(cells_t, combos_t, C), reps=2)
    n_bytes = 4 * (7 * n + 6 * m) + 2 * 4 * n * m
    # the bound counts what these inputs need: one fixed point per (cell,
    # read key), one write evaluation per (cell, write key); beside it
    # the reference's per-element count
    key_ops = ops.margin_grid_key_flops(n, kr, kw, m)
    b_ms, b_by = bound_ms(n_bytes, key_ops)
    elem_ms, elem_by = bound_ms(n_bytes, ops.margin_grid_flops(n, m))
    print(f"margin_grid columns: {kr} read keys, {kw} write keys, {groups} "
          f"group(s) of {m} columns ({m / kr:.1f} columns per read key)")
    print(f"margin_grid at {n} x {m}: kernel {ms:.3f} ms (wrapper call "
          f"{call:.3f} ms), plain {plain:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}: {n_bytes / 1e9:.2f} GB at 3.35 TB/s, {key_ops:.3e} "
          f"operations by key at 67 TFLOP/s), {ms / b_ms:.2f}x the bound; "
          f"the per-element count's bound {elem_ms:.3f} ms ({elem_by}: "
          f"{ops.margin_grid_flops(n, m):.3e} flop, "
          f"{ops.TRANSCENDENTALS_PER_ELEM * n * m:.3e} expf/logf)")

    # the per-element kernel (small grids' path) against the key kernel
    # on the whole campaign grid, in row blocks: bit for bit, and timed
    full = [torch.empty((n, m), device=dev) for _ in range(2)]
    ops.launch(cells_t, combos_t, C, *full, by_key=True)
    rows = -(-n // 8)
    part = [torch.empty((rows, m), device=dev) for _ in range(2)]
    paths_differ = 0
    for a in range(0, n, rows):
        b = min(n, a + rows)
        ops.launch(cells_t[:, a:b].contiguous(), combos_t, C,
                   *(x[:b - a] for x in part), by_key=False)
        paths_differ += sum(
            int((x[:b - a].view(torch.int32)
                 != y[a:b].view(torch.int32)).sum())
            for x, y in zip(part, full))
    del part
    elem_ms_full = kernel_ms(
        lambda: ops.launch(cells_t, combos_t, C, *full, by_key=False),
        "margin_grid_elem_kernel")
    del full
    print(f"margin_grid per-element kernel vs key kernel on {n} x {m}: "
          f"{paths_differ} of {2 * n * m} elements differ bit for bit; "
          f"per-element {elem_ms_full:.3f} ms vs key {ms:.3f} ms")
    check(paths_differ == 0, f"the per-element and key kernels differ at "
                             f"{paths_differ} elements")
    return {"name": "margin_grid", "route": "cuda",
            "source": "src/repro_torch/kernels/charge_sim/margin_grid.cu",
            "replaces": "src/repro/kernels/charge_sim/charge_sim.py:119",
            **path_launches(env, "margin_grid"),
            "max_abs_err": err_abs, "not_bitwise": nonbit, "ms": ms,
            "call_ms": call, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "keys": {"read": kr, "write": kw, "groups": groups},
            "elem_ms": elem_ms_full, "elem_vs_key_differ": paths_differ}


def kernel_margin_small(env) -> dict:
    """Phase 7: margin_grid at every shape below the key search that the
    main, region, fleet and figure paths gave it, on the inputs of its
    first call there:
    the wrapper (the per-element kernel) vs the plain version, the key
    kernel vs the per-element kernel bit for bit, and both times (CUDA
    events; the key kernel's with its host key search)."""
    import torch
    from repro_torch.kernels.charge_sim import ops, ref

    grids, worst = [], 0.0
    for path in ("main", "region", "fleet", "figures"):
        for (n, m), (ct, mt, consts, calls) in env[
                f"margin_small_{path}"].items():
            check(n * m < ops.SEARCH_MIN_ELEMS, f"{n} x {m} takes the keys")
            k_out = ops.margin_grid(ct, mt, consts)
            err_abs, err_rel, viol, nonbit = vs_plain(
                k_out, ref.margin_grid(ct, mt, consts))
            out = [torch.empty((n, m), device=ct.device) for _ in range(2)]
            ops.launch(ct, mt, consts, *out, by_key=True)
            differ = sum(int((x.view(torch.int32)
                              != y.view(torch.int32)).sum())
                         for x, y in zip(out, k_out))
            ms = cuda_ms(lambda: ops.launch(ct, mt, consts, *out,
                                            by_key=False))
            key_ms = cuda_ms(lambda: ops.launch(ct, mt, consts, *out,
                                                by_key=True))
            print(f"margin_grid {path} {n} x {m} ({calls} calls): vs plain "
                  f"max abs {err_abs:.3e}, max rel {err_rel:.3e}, {viol} "
                  f"beyond rtol=atol={TOL:g}, {nonbit} not bitwise equal; "
                  f"key kernel vs per-element: {differ} differ; per-element "
                  f"{ms:.4f} ms, key kernel {key_ms:.4f} ms with its key "
                  f"search")
            check(viol == 0, f"margin_grid disagrees with its plain version "
                             f"at {viol} elements of {n} x {m}")
            check(differ == 0, f"the key and per-element kernels differ at "
                               f"{differ} elements of {n} x {m}")
            worst = max(worst, err_abs)
            grids.append({"path": path, "shape": [n, m], "calls": calls,
                          "ms": ms, "key_ms": key_ms, "max_abs_err": err_abs,
                          "not_bitwise": nonbit})
    check(grids, "no small margin grid on the paths")
    return {"max_abs_err_small": worst, "small_grids": grids}


def kernel_margin_keyed(env) -> dict:
    """Phase 7: margin_grid at every key-kernel shape of the figure path
    (its campaigns' column sets differ from the main campaign's, which
    phase 3 holds), on a row slice of its first call's inputs that keeps
    the slice above `SEARCH_MIN_ELEMS`: the wrapper (the key kernel)
    against the plain version (rtol = atol = 2e-4), and the per-element
    kernel against it bit for bit."""
    import torch
    from repro_torch.kernels.charge_sim import ops, ref

    grids, worst = [], 0.0
    for (n, m), (ct, mt, consts, calls) in env["margin_keyed_figures"].items():
        check(n * m >= ops.SEARCH_MIN_ELEMS, f"{n} x {m} skips the keys")
        n_slice = min(n, -(-ops.SEARCH_MIN_ELEMS // m))
        sl = ct[:, :n_slice].contiguous()
        k_out = ops.margin_grid(sl, mt, consts)
        err_abs, err_rel, viol, nonbit = vs_plain(
            k_out, ref.margin_grid(sl, mt, consts))
        out = [torch.empty((n_slice, m), device=ct.device) for _ in range(2)]
        ops.launch(sl, mt, consts, *out, by_key=False)
        differ = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                     for x, y in zip(out, k_out))
        print(f"margin_grid figures {n} x {m} ({calls} calls) on rows "
              f"0..{n_slice}: vs plain max abs {err_abs:.3e}, max rel "
              f"{err_rel:.3e}, {viol} beyond rtol=atol={TOL:g}, {nonbit} not "
              f"bitwise equal; per-element kernel vs key: {differ} differ")
        check(viol == 0, f"margin_grid disagrees with its plain version "
                         f"at {viol} elements of {n_slice} x {m}")
        check(differ == 0, f"the key and per-element kernels differ at "
                           f"{differ} elements of {n_slice} x {m}")
        worst = max(worst, err_abs)
        grids.append({"path": "figures", "shape": [n, m], "rows": n_slice,
                      "calls": calls, "max_abs_err": err_abs,
                      "not_bitwise": nonbit})
    check(grids, "no key-kernel margin grid on the figure path")
    return {"max_abs_err_keyed": worst, "keyed_grids": grids}


def recorded_replay(fr: dict, label: str) -> tuple[int, float]:
    """A `replay_grid` call recorded by `first_call`, launched again on
    its cells and timing tile (at its block) and held against
    `dram_sim.replay_cells` on the same inputs: (lanes not bitwise
    equal, max abs error), printed."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    check(fr["region_map"] is None and fr["fault"] is None
          and fr["chan"][0] == 1, f"{label}: not a static one-channel "
          "replay")
    cells = ref.to_cells(fr["arrival"], fr["bank"], fr["row"],
                         fr["is_write"], fr["valid"], fr["closed"])
    closed, arr, bank, row, wr, valid = cells
    tim = torch.as_tensor(fr["timings"], device=arr.device)
    lat, total = ops.replay_blocks(
        *cells, ref.timing_tile(tim), fr["n_banks"], fr["mlp_window"],
        block_lanes=fr["block_lanes"])
    lat2, total2 = dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5,
        fr["n_banks"], fr["mlp_window"])
    n_bad = int(((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
                 | (total.view(torch.int32)
                    != total2.view(torch.int32))).sum())
    err = max((lat - lat2).abs().max().item(),
              (total - total2).abs().max().item())
    print(f"{label} G={arr.shape[0]} N={arr.shape[1]} tile "
          f"{list(tim.shape)} block_lanes {fr['block_lanes']}: {n_bad} of "
          f"{arr.shape[0] * tim.shape[0]} lanes not bitwise equal to plain "
          f"(max abs {err:.3e})")
    return n_bad, err


def kernel_replay(env) -> dict:
    """Phase 5a: replay_blocks (a) vs its plain version at both Fig. 4
    shapes, and its times; then on multi_timing's frontier replay,
    bitwise."""
    import torch
    from repro_torch.core import dram_sim, perf_model
    from repro_torch.core import timing as T
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    shapes = (("evaluate", 8192, T.stack_timing([T.DDR3_1600,
                                                 T.ALDRAM_55C_EVAL])),
              ("evaluate_system", 4096, env["sys_res"]["rows"]))
    entry = None
    for name, n, rows in shapes:
        tb = perf_model.trace_batch(n, SEED, device=dev)
        g = tb.arrival.shape[0]
        cells = ref.to_cells(*(f[:, None] for f in tb),
                             torch.ones((g, n), dtype=torch.bool, device=dev),
                             torch.tensor([False], device=dev))
        tim = torch.tensor(rows, device=dev)
        tim_t = tim.T.contiguous()
        s = tim.shape[0]
        lat, total = ops.replay_blocks(*cells, tim_t)
        closed, arr, bank, row, wr, valid = cells
        plain_fn = lambda: dram_sim.replay_cells(   # noqa: E731
            arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5)
        (lat2, total2), _ = wall(plain_fn)
        lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
                 | (total.view(torch.int32) != total2.view(torch.int32)))
        n_bad = int(lanes.sum())
        err = max((lat - lat2).abs().max().item(),
                  (total - total2).abs().max().item())
        call = cuda_ms(lambda: ops.replay_blocks(*cells, tim_t))
        ms = kernel_ms(lambda: ops.replay_blocks(*cells, tim_t),
                       "replay_kernel")
        plain = cuda_ms(plain_fn, reps=1, warmup=0)
        n_bytes = g * n * 5 * 4 + g * n * s * 4 + g * s * 4 + 6 * s * 4 + g * 4
        b_ms, b_by = bound_ms(n_bytes, REPLAY_OPS_PER_STEP * g * n * s)
        print(f"replay_blocks ({name}) G={g} N={n} S={s}: {n_bad} of "
              f"{g * s} lanes not bitwise equal to plain (max abs "
              f"{err:.3e}); kernel {ms:.3f} ms (wrapper call {call:.3f} ms "
              f"with its host-side input checks), plain {plain:.3f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
              f"path {n} dependent requests")
        chain = chain_bound("2a", n, ms)
        check(n_bad == 0, f"replay_blocks: {n_bad} lanes differ ({name})")
        if entry is None:
            entry = {"name": "replay_blocks", "variant": "a",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/replay/replay.cu",
                     "replaces": "src/repro/kernels/replay/replay.py:640",
                     **path_launches(env, "replay_blocks (a)"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     **chain}
    m_bad, m_err = recorded_replay(env["figures_replay"],
                                   "replay_blocks (a) on multi_timing's "
                                   "frontier")
    check(m_bad == 0, f"replay_blocks (a): {m_bad} frontier lanes differ")
    entry["max_abs_err"] = max(entry["max_abs_err"], m_err)
    entry["max_abs_err_frontier"] = m_err
    return entry


def thermal_path(env) -> None:
    """Phase 4: the thermal closed loop at full width on the table the
    main path profiled, kernel launch counts reset just before and read
    just after."""
    import numpy as np
    from repro_torch.core.sim_engine import SimEngine

    from benchmarks import port_fig_bank, port_thermal_bench

    pop, ctrl = env["pop"], env["ctrl"]
    runs, secs, calls = {}, {}, {}
    reset_counts()
    for per_bank in (False, True):
        for fused in (False, True):
            key = (per_bank, fused)
            if fused:
                # the thermal bench's campaign: its driver, with its
                # CSV line and its bracket asserted
                runs[key], secs[key], _ = driver_run(
                    env, "thermal_bench" + (" per-bank" if per_bank else ""),
                    lambda: port_thermal_bench.run(pop=pop, ctrl=ctrl,
                                                   per_bank=per_bank))
                calls[key] = runs[key]["dispatches"]["replay"]
                continue
            eng = SimEngine(device="cuda")
            runs[key], secs[key] = wall(lambda: ctrl.evaluate_dynamic(
                pop, n=4096, per_bank=per_bank, fused=fused, engine=eng))
            calls[key] = eng.dispatch_count
    # `evaluate_bank_system` through the per-bank tables' driver
    bank, t_bank, _ = driver_run(env, "fig_bank", lambda: port_fig_bank.run(
        pop=pop, ctrl=ctrl))
    launches = read_counts()

    for key, res in runs.items():
        tag = (("per-bank" if key[0] else "per-module") + " "
               + ("fused" if key[1] else "two-launch"))
        print(f"evaluate_dynamic {tag}: {secs[key]:.3f} s, {calls[key]} "
              f"engine calls, worst_bin {res['worst_bin'].tolist()}")
        for name, d in res["per_scenario"].items():
            print(f"  {name}: adaptive {d['adaptive_gmean']:.4%} "
                  f"static_worst {d['static_worst_gmean']:.4%} oracle "
                  f"{d['oracle_gmean']:.4%} temp_peak {d['temp_peak']:.3f} "
                  f"worst_bin {d['worst_bin']} mean_bin_switches "
                  f"{d['mean_bin_switches']:.3f}")
    for t, d in bank["per_temp"].items():
        print(f"evaluate_bank_system @{t:.0f}C: " + " ".join(
            f"{k} {v:.3%}" for k, v in d.items()))
    print("evaluate_bank_system reductions: " + json.dumps(
        bank["reductions"]))
    print("thermal path seconds: " + " ".join(
        f"dynamic[{'bank' if k[0] else 'module'},"
        f"{'fused' if k[1] else 'two'}] {v:.3f}" for k, v in secs.items())
        + f" bank_system {t_bank:.3f}")
    print("thermal path kernels: " + json.dumps(launches))

    for per_bank in (False, True):
        a, b = runs[(per_bank, False)], runs[(per_bank, True)]
        check(np.array_equal(a["worst_bin"], b["worst_bin"]),
              f"worst_bin two-launch {a['worst_bin']} vs fused "
              f"{b['worst_bin']}")
        for name, d in a["per_scenario"].items():
            for k in ("adaptive_gmean", "static_worst_gmean",
                      "oracle_gmean"):
                x, y = d[k], b["per_scenario"][name][k]
                check(abs(x - y) <= 1e-5 * max(abs(x), abs(y)),
                      f"{name} {k}: two-launch {x} vs fused {y}")
    for key, res in runs.items():
        check(calls[key] == (1 if key[1] else 2), f"engine calls {calls}")
        check(res["adaptive"].shape == (2, 35, 1, 4),
              str(res["adaptive"].shape))
        for pd in res["per_policy"]:
            for name, d in pd.items():
                check(all(np.isfinite(v) for v in d.values()
                          if isinstance(v, float)), f"{name}: {d}")
                check(d["adaptive_gmean"] >= d["static_worst_gmean"] - 1e-9,
                      f"adaptive < static_worst for {name}: {d}")
    check(all(np.isfinite(v) and -1.0 < v < 1.0
              for d in bank["per_temp"].values() for v in d.values()),
          str(bank["per_temp"]))
    check(all(launches[k] > 0 for k in ("replay_blocks (a)",
                                        "replay_blocks (b)",
                                        "adaptive_blocks (a)",
                                        "adaptive_blocks (b)")),
          f"a kernel of the thermal path never launched: {launches}")
    env.update(launches_thermal=launches, bank_res=bank)


def thermal_breakdown(env) -> None:
    """Phase 4b: the thermal path once more under `torch.profiler`."""
    pop, ctrl = env["pop"], env["ctrl"]
    busy_share("thermal path", lambda: (
        [ctrl.evaluate_dynamic(pop, n=4096, per_bank=pb, fused=f)
         for pb in (False, True) for f in (False, True)],
        ctrl.evaluate_bank_system(pop, n=4096)))


def _campaign_cells(n: int):
    """The 70-trace pool at length n as kernel cells (open page)."""
    import torch
    from repro_torch.core import perf_model
    from repro_torch.kernels.replay import ref

    dev = torch.device("cuda")
    tb = perf_model.trace_batch(n, SEED, device=dev)
    g = tb.arrival.shape[0]
    return ref.to_cells(*(f[:, None] for f in tb),
                        torch.ones((g, n), dtype=torch.bool, device=dev),
                        torch.tensor([False], device=dev))


def kernel_adaptive(env) -> list:
    """Phase 5c: adaptive_blocks (module and per-bank tables) against
    its plain version at the thermal path's full shape (70 cells x 4096
    requests x 8 lanes, raw temps and bins emitted), and its times."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    scn_t = torch.tensor(TH.stack_scenarios(scns).T.copy(), device=dev)
    tcfg = torch.tensor(TH.ThermalConfig().as_row(), device=dev)
    table = env["ctrl"].table
    entries = []
    for variant, (rows, edges) in (("a", table.safe_stack()),
                                   ("b", table.safe_stack_banks())):
        tile = ref.table_tile(ref.lane_tables(
            torch.tensor(rows, device=dev)[None], len(scns)))
        bins = torch.tensor(edges, device=dev)
        lanes = tile.shape[-1]
        out = ops.adaptive_blocks(*cells, tile, scn_t, bins, tcfg,
                                  emit_raw=True)
        plain, plain_s = wall(lambda: dram_sim.replay_adaptive_cells(
            arr, bank, row, wr.bool(), valid.bool(), ref.lane_stacks(tile),
            bins, scn_t.T, tcfg, closed > 0.5))
        lat, total, tmax, tmean, sw, heat, temps, sel = out
        plat, ptot, ptemps, psel, pheat, (ptmax, ptmean, psw) = plain
        pairs = ((lat, plat), (total, ptot), (temps, ptemps), (heat, pheat),
                 (tmax, ptmax), (tmean, ptmean))
        err = max((a - b).abs().max().item() for a, b in pairs)
        same_bins = bool(torch.equal(sel, psel) and torch.equal(sw, psw))

        def lane_bits(a, b):
            d = a.view(torch.int32) != b.view(torch.int32)
            return d.reshape(g, -1, lanes).any(1)

        lanes_off = lane_bits(lat, plat) | lane_bits(temps, ptemps) \
            | lane_bits(heat, pheat) | lane_bits(total, ptot) \
            | lane_bits(tmean, ptmean) | (sel != psel).any(1)
        n_off = int(lanes_off.sum())
        close = all(torch.allclose(a, b, rtol=1e-5, atol=0)
                    for a, b in pairs[:2]) and all(
            torch.allclose(a, b, rtol=1e-5, atol=1e-4) for a, b in pairs[2:])
        call = cuda_ms(lambda: ops.adaptive_blocks(*cells, tile, scn_t, bins,
                                                   tcfg))
        ms = kernel_ms(lambda: ops.adaptive_blocks(*cells, tile, scn_t, bins,
                                                   tcfg), "adaptive_kernel")
        n_bytes = (g * n * 5 * 4 + g * n * lanes * 4 + g * 4
                   + tile.numel() * 4 + scn_t.numel() * 4 + bins.numel() * 4
                   + 24 + g * lanes * 4 * 4 + heat.numel() * 4)
        b_ms, b_by = bound_ms(n_bytes, (REPLAY_OPS_PER_STEP
                                        + ADAPTIVE_OPS_PER_STEP) * g * n * lanes)
        print(f"adaptive_blocks ({variant}, {'per-bank' if variant == 'b' else 'module'} "
              f"tables) G={g} N={n} L={lanes}: bins identical {same_bins}, "
              f"{int(sw.sum())} switches, {n_off} of {g * lanes} lanes not "
              f"bitwise equal to plain (max abs {err:.3e}); kernel {ms:.3f} ms "
              f"(wrapper call {call:.3f} ms), plain {plain_s * 1e3:.1f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
              f"path {n} dependent requests")
        chain = chain_bound(
            f"3{variant}", n, ms, n_banks=8, n_edges=bins.numel(),
            table=_adaptive_table_class(tile, bins, 8, False, False))
        check(same_bins, f"adaptive_blocks ({variant}): bins differ")
        check(close, f"adaptive_blocks ({variant}): outputs beyond tolerance "
                     f"(max abs {err:.3e})")
        entries.append({
            "name": "adaptive_blocks", "variant": variant, "route": "cuda",
            "source": "src/repro_torch/kernels/replay/adaptive.cu",
            "replaces": "src/repro/kernels/replay/replay.py:522",
            **path_launches(env, f"adaptive_blocks ({variant})"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            **chain})
    return entries


def kernel_replay_banked(env) -> dict:
    """Phase 5b: replay_blocks (b), the per-bank tile, against its plain
    version at `evaluate_bank_system`'s shape, and its times; then on
    the fleet path's first epoch at the tuned block, bitwise."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    tim = torch.tensor(env["bank_res"]["rows"], device=arr.device)
    tile = ref.timing_tile(tim)
    s, banks = tim.shape[0], tim.shape[1]
    lat, total = ops.replay_blocks(*cells, tile)
    (lat2, total2), plain_s = wall(lambda: dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5))
    lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
             | (total.view(torch.int32) != total2.view(torch.int32)))
    n_bad = int(lanes.sum())
    err = max((lat - lat2).abs().max().item(),
              (total - total2).abs().max().item())
    call = cuda_ms(lambda: ops.replay_blocks(*cells, tile))
    ms = kernel_ms(lambda: ops.replay_blocks(*cells, tile), "replay_kernel")
    n_bytes = (g * n * 5 * 4 + g * n * s * 4 + g * s * 4 + banks * 6 * s * 4
               + g * 4)
    b_ms, b_by = bound_ms(n_bytes, REPLAY_OPS_PER_STEP * g * n * s)
    print(f"replay_blocks (b, per-bank tile) G={g} N={n} S={s} banks={banks}: "
          f"{n_bad} of {g * s} lanes not bitwise equal to plain (max abs "
          f"{err:.3e}); kernel {ms:.3f} ms (wrapper call {call:.3f} ms), "
          f"plain {plain_s * 1e3:.1f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{n_bytes / 1e6:.2f} MB)")
    chain = chain_bound("2b", n, ms)
    check(n_bad == 0, f"replay_blocks (b): {n_bad} lanes differ")

    # the fleet path's first epoch: the [S = 116, 8, 6] tile of 115
    # module envelopes and JEDEC, at the tuner's block
    f_bad, f_err = recorded_replay(env["fleet_replay"],
                                   "replay_blocks (b) on the fleet's first "
                                   "epoch")
    check(f_bad == 0, f"replay_blocks (b): {f_bad} fleet lanes differ")
    return {"name": "replay_blocks", "variant": "b", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/replay.cu",
            "replaces": "src/repro/kernels/replay/replay.py:640",
            **path_launches(env, "replay_blocks (b)"),
            "max_abs_err": max(err, f_err), "max_abs_err_fleet": f_err,
            "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **chain}


def cross_device() -> dict:
    """Phase 6a: the --fast-scale main path on the card vs on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population

    cfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=24, n_cells=8)
    pop_cpu = sample_population(torch.Generator().manual_seed(SEED), cfg,
                                device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        pop = pop_cpu.to(dev)
        ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=2.5,
                                         device=dev), device=dev)
        t0 = time.perf_counter()
        tbl = ctrl.profile(pop)
        ok = ctrl.verify(pop)
        sys_res = ctrl.evaluate_system(pop, n=1024)
        ev = perf_model.evaluate(n=2048, device=dev)
        out[dev] = dict(ctrl=ctrl, tbl=tbl, ok=ok, sys=sys_res, ev=ev,
                        pop=pop, s=time.perf_counter() - t0)
    g, c = out["cuda"], out["cpu"]
    check(g["ok"] and c["ok"], "verify failed at --fast scale")
    diff_rows = int((g["tbl"].params != c["tbl"].params).any(-1).sum()
                    + (g["tbl"].params_module
                       != c["tbl"].params_module).any(-1).sum())
    flips = unexplained = 0
    if diff_rows:
        # a differing choice must come from a pass/fail flip whose
        # deciding (bank-minimum) margin lies within TOL of zero
        spec = c["ctrl"].sweep_result.spec
        rg = g["ctrl"].engine.sweep(g["pop"], spec)
        rc = c["ctrl"].engine.sweep(c["pop"], spec)
        m, ch, bk, kc = c["pop"].cells.shape[:4]
        for op in Op:
            k = rc.index(op)
            flip = rg.ok_bank[k] != rc.ok_bank[k]
            mm = rc.margins[k].reshape(m, ch, bk, kc, *rc.margins[k].shape[1:])
            mmin = mm.amin(dim=(1, 3)).numpy()
            flips += int(flip.sum())
            unexplained += int((np.abs(mmin[flip]) > TOL).sum())
    rel = []
    for tc_, d in g["sys"]["per_temp"].items():
        same = np.array_equal(g["sys"]["rows"][1 + list(
            g["sys"]["temps"]).index(tc_)], c["sys"]["rows"][1 + list(
                c["sys"]["temps"]).index(tc_)])
        if same:
            rel += [abs(v / c["sys"]["per_temp"][tc_][k] - 1)
                    for k, v in d.items()]
    for k in ("multi_intensive_gmean", "multi_nonintensive_gmean",
              "multi_all_gmean", "single_intensive_gmean"):
        rel.append(abs(g["ev"]["summary"][k] / c["ev"]["summary"][k] - 1))
    max_rel = max(rel)
    print(f"cross-device --fast (24 modules, 8 cells, 2.5 ns grid): "
          f"{diff_rows} differing chosen rows, {flips} pass/fail flips "
          f"({unexplained} unexplained), max rel gmean diff {max_rel:.3e}; "
          f"card {g['s']:.2f} s, CPU {c['s']:.2f} s")
    check(unexplained == 0, "card and CPU choices differ beyond 2e-4")
    check(max_rel <= 1e-5, f"card vs CPU gmeans differ by {max_rel:.3e}")
    return out


def cross_device_thermal(out) -> None:
    """Phase 6b: `evaluate_dynamic` at --fast scale (n = 1024) on the
    card and on the CPU, both on the CPU controller's table, and the
    selected bin of every request of the same campaign on both."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.sim_engine import SimEngine, SimSpec

    table = out["cpu"]["tbl"]
    out["cuda"]["ctrl"].table = table
    dyn, secs = {}, {}
    for dev in ("cuda", "cpu"):
        o = out[dev]
        t0 = time.perf_counter()
        dyn[dev] = {pb: o["ctrl"].evaluate_dynamic(o["pop"], n=1024,
                                                    per_bank=pb)
                    for pb in (False, True)}
        secs[dev] = time.perf_counter() - t0
    rel = 0.0
    for pb in (False, True):
        g, c = dyn["cuda"][pb], dyn["cpu"][pb]
        check(np.array_equal(g["worst_bin"], c["worst_bin"]),
              f"worst_bin card {g['worst_bin']} vs CPU {c['worst_bin']}")
        for name, d in c["per_scenario"].items():
            for k in ("adaptive_gmean", "static_worst_gmean",
                      "oracle_gmean"):
                x, y = g["per_scenario"][name][k], d[k]
                rel = max(rel, abs(x - y) / max(abs(y), 1e-12))

    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    cfg = TH.ThermalConfig()
    hyst = cfg.hyst_c * TH.stack_scenarios(scns)[:, 8]          # [C]
    diff = near = carried = total = 0
    max_dt = 0.0
    for rows, edges in (table.safe_stack(), table.safe_stack_banks()):
        spec_kw = dict(timings=rows[None], collect=("temps", "bins"),
                       thermal=TH.ThermalSpec(scns, tuple(edges.tolist()),
                                              cfg))
        res = {dev: SimEngine(device=dev).run(SimSpec(
            traces=perf_model.trace_batch(1024, SEED, device=dev),
            **spec_kw)) for dev in ("cuda", "cpu")}
        bg, bc = res["cuda"].bins, res["cpu"].bins          # [T, 1, 1, C, N]
        temp = res["cpu"].temps
        max_dt = max(max_dt, float(np.abs(res["cuda"].temps - temp).max()))
        d = bg != bc
        thr = np.concatenate([np.broadcast_to(edges, hyst.shape + edges.shape),
                              edges[None, :] - hyst[:, None]], axis=1)
        dist = np.abs(temp[..., None] - thr[None, None, None, :, None, :])
        is_near = (dist <= HYST_EDGE_TOL).any(-1)
        prev = np.zeros_like(d)
        prev[..., 1:] = d[..., :-1]
        diff += int(d.sum())
        near += int((d & is_near).sum())
        carried += int((d & ~is_near & prev).sum())
        total += d.size
    unexplained = diff - near - carried
    print(f"cross-device evaluate_dynamic --fast (n=1024, module + per-bank): "
          f"worst_bin equal, max rel gmean diff {rel:.3e}; {diff} of {total} "
          f"selected bins differ ({near} within {HYST_EDGE_TOL:g} C of a "
          f"threshold, {carried} carried by hysteresis from a differing "
          f"previous request, {unexplained} unexplained); max sensed-temp "
          f"diff {max_dt:.3e} C; card {secs['cuda']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s")
    check(rel <= 1e-4, f"card vs CPU dynamic gmeans differ by {rel:.3e}")
    check(unexplained == 0, f"{unexplained} bins differ away from a "
                            "switching threshold")

REGIONS = 8
LEVELS = (2, 4, 8)


def _region_bracket(eng, rows_u, edges, idx, traces):
    """The deployed region stack in closed loop (ONE adaptive launch)
    and the static replay of each real scenario's worst bin (ONE static
    launch, JEDEC baseline first), both through `SimEngine`, priced as
    multi-core CPI gmeans per scenario the way
    `perf_model.evaluate_adaptive` prices the module stack."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core import timing as T
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.sim_engine import SimSpec

    scns = default_scenarios()
    nc = len(scns)
    cfg = TH.ThermalConfig()
    rmap = idx.reshape(-1)
    spec = SimSpec(traces=traces, timings=rows_u[None], region_map=rmap,
                   thermal=TH.ThermalSpec(scns + tuple(x.oracle()
                                                       for x in scns),
                                          tuple(edges.tolist()), cfg))
    res_a, t_a = wall(lambda: eng.run(spec))
    peak = res_a.temp_max[:, :, 0, :nc].max(axis=(0, 1))
    worst = np.searchsorted(edges, peak + np.float32(cfg.hyst_c),
                            side="left")
    base = np.broadcast_to(T.DDR3_1600.as_row(), rows_u.shape[1:])
    rows = np.concatenate([base[None], rows_u[worst]], axis=0)
    res_s, t_s = wall(lambda: eng.run(SimSpec(traces=traces, timings=rows,
                                              region_map=rmap)))
    lat = np.concatenate([res_s.mean_latency_ns,
                          res_a.mean_latency_ns[:, :, 0, :]], axis=-1)
    sp = perf_model.cpi_speedups(lat.reshape((2, -1) + lat.shape[1:]))
    out = {}
    for ci, x in enumerate(scns):
        out[x.name] = {
            "adaptive": perf_model.gmean_speedup(sp[1, :, 0, 1 + nc + ci]),
            "static_worst": perf_model.gmean_speedup(sp[1, :, 0, 1 + ci]),
            "oracle": perf_model.gmean_speedup(sp[1, :, 0, 1 + 2 * nc + ci]),
            "worst_bin": int(worst[ci]), "temp_peak": float(peak[ci]),
            "switches": float(res_a.bin_switches[:, 0, 0, ci].mean())}
    return out, t_a + t_s


def region_path(env) -> None:
    """Phase 5: the subarray-region path at full width on the main
    path's population, kernel launch counts reset just before and read
    just after."""
    import numpy as np
    from benchmarks import port_fig_region
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import CALIBRATED_CONSTANTS
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine

    pop = env["pop"]
    reset_counts()
    ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=1.25),
                            regions=REGIONS, device="cuda")
    mlog = []
    with margin_log(mlog):
        table, t_prof = wall(lambda: ctrl.profile(pop))
        d_prof = ctrl.engine.dispatch_count
        ok, t_ver = wall(lambda: ctrl.verify(pop))
    d_ver = ctrl.engine.dispatch_count - d_prof
    shapes = margin_shapes(mlog)
    red, t_red = wall(lambda: ctrl.region_reductions(LEVELS))
    ratios = {lv: ctrl.region_table(lv).compression_ratio() for lv in LEVELS}
    # `evaluate_region_system` through the region figure's driver (its
    # monotonicity, compression and one-launch assertions in force)
    sys_res, t_sys, _ = driver_run(env, "fig_region",
                                   lambda: port_fig_region.run(pop=pop,
                                                               ctrl=ctrl))
    before = read_counts()
    (rows_u, edges, idx), t_stack = wall(table.safe_stack_regions)
    eng_dyn = SimEngine(device="cuda")
    traces = perf_model.trace_batch(4096, SEED, device="cuda")
    dyn, t_dyn = _region_bracket(eng_dyn, rows_u, edges, idx, traces)
    launches = read_counts()
    ad_launch = (launches["adaptive_blocks (c)"]
                 - before["adaptive_blocks (c)"])

    print(f"region profile: store {table.params.shape} (U = "
          f"{table.n_unique}), map {table.region_index.shape}, {d_prof} "
          f"launches ({t_prof:.3f} s); verify: {ok}, {d_ver} launches "
          f"({t_ver:.3f} s)")
    print(f"region margin_grid calls by shape (margin_sweep calls, CUDA "
          f"events): {json.dumps(shapes)}")
    for op, d in red.items():
        print(f"region_reductions {op}: " + " ".join(
            f"{k} {v:.2%}" for k, v in d.items()))
    print("compression ratios: " + " ".join(
        f"r{lv} {v:.4f}" for lv, v in ratios.items())
        + f" (region_reductions {t_red:.3f} s)")
    print(f"evaluate_region_system: rows {sys_res['rows'].shape}, map "
          f"{sys_res['region_map'].shape}, "
          f"{sys_res['dispatches']['replay']} engine call ({t_sys:.3f} s)")
    for t, d in sys_res["per_temp"].items():
        print(f"  @{t:.0f}C: " + " ".join(f"{k} {v:.3%}"
                                          for k, v in d.items()))
    print(f"safe_stack_regions: rows {rows_u.shape}, map {idx.shape} "
          f"({t_stack:.3f} s); closed loop + static worst bins: "
          f"{eng_dyn.dispatch_count} engine calls ({t_dyn:.3f} s)")
    for name, d in dyn.items():
        print(f"  {name}: adaptive {d['adaptive']:.4%} static_worst "
              f"{d['static_worst']:.4%} oracle {d['oracle']:.4%} temp_peak "
              f"{d['temp_peak']:.3f} worst_bin {d['worst_bin']} "
              f"mean_bin_switches {d['switches']:.3f}")
    print("region path kernels: " + json.dumps(launches))

    check(ok is True, "verify() found a negative margin in the region table")
    check(d_prof == 2 and d_ver == 39, f"launches {d_prof}+{d_ver}")
    check(table.params.shape[:2] == (115, 5)
          and table.region_index.shape == (115, 5, 8, REGIONS),
          str(table.region_index.shape))
    for op, d in red.items():
        seq = [d["module"], d["bank"]] + [d[f"region{lv}"] for lv in LEVELS]
        check(all(b >= a - 1e-9 for a, b in zip(seq, seq[1:])),
              f"{op} reductions not monotone: {seq}")
    check(ratios[REGIONS] < 0.5, f"8-region store ratio {ratios}")
    check(sys_res["dispatches"]["replay"] == 1
          and sys_res["rows"].shape[0] == 26
          and sys_res["rows"].shape[1] <= 64
          and sys_res["region_map"].shape == (64,),
          f"evaluate_region_system {sys_res['rows'].shape}")
    check(all(np.isfinite(v) and -1.0 < v < 1.0
              for d in sys_res["per_temp"].values() for v in d.values()),
          str(sys_res["per_temp"]))
    check(before["replay_blocks (c)"] == 1,
          f"evaluate_region_system replay launches {before}")
    check(eng_dyn.dispatch_count == 2 and ad_launch == 1
          and idx.shape == (8, REGIONS) and rows_u.shape[0] == 6,
          f"closed loop launches {ad_launch}, stack {rows_u.shape}")
    for name, d in dyn.items():
        check(d["adaptive"] >= d["static_worst"] - 1e-9,
              f"adaptive < static_worst for {name}: {d}")
    check(all(launches[k] > 0 for k in ("margin_grid", "replay_blocks (c)",
                                        "adaptive_blocks (c)")),
          f"a kernel of the region path never launched: {launches}")
    check(shapes["campaign"]["launches"] == 1 and shapes["campaign"][
        "launches"] + shapes["other"]["launches"] == launches["margin_grid"],
          f"margin shapes {shapes}, launches {launches['margin_grid']}")
    env.update(launches_region=launches, margin_shapes_region=shapes,
               margin_small_region=small_grid_inputs(mlog), region_ctrl=ctrl,
               region_sys=sys_res, region_stack=(rows_u, edges, idx))


def region_breakdown(env) -> None:
    """Phase 5b: the region path once more under `torch.profiler`."""
    from repro_torch.core import perf_model
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.sim_engine import SimEngine

    pop, old = env["pop"], env["region_ctrl"]
    ctrl = ALDRAMController(old.profiler, regions=REGIONS, device="cuda")

    def run():
        ctrl.profile(pop)
        ctrl.verify(pop)
        ctrl.evaluate_region_system(pop, n=4096, levels=LEVELS)
        _region_bracket(SimEngine(device="cuda"),
                        *ctrl.table.safe_stack_regions(),
                        perf_model.trace_batch(4096, SEED, device="cuda"))

    busy_share("region path", run)


def kernel_replay_regioned(env) -> dict:
    """Phase 6d: replay_blocks (c), the region store gathered through the
    index map, against its plain version at `evaluate_region_system`'s
    shape, variant (b) reproduced by bank-constant maps, and its times."""
    import numpy as np
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    dev = arr.device
    g = arr.shape[0]
    tim = torch.tensor(env["region_sys"]["rows"], device=dev)  # [S, U, 6]
    rmap = torch.tensor(env["region_sys"]["region_map"], device=dev)
    tile = ref.timing_tile(tim)
    s, u = tim.shape[0], tim.shape[1]
    lat, total = ops.replay_blocks(*cells, tile, region_map=rmap)
    (lat2, total2), plain_s = wall(lambda: dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5,
        region_map=rmap))
    lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
             | (total.view(torch.int32) != total2.view(torch.int32)))
    n_bad = int(lanes.sum())
    err = max((lat - lat2).abs().max().item(),
              (total - total2).abs().max().item())
    # variant (b) is (c) with the bank as the column: a bank-constant
    # map over 8 regions, and R = 1 with the identity map
    bank_rows = torch.tensor(env["bank_res"]["rows"], device=dev)
    btile = ref.timing_tile(bank_rows)
    lb = ops.replay_blocks(*cells, btile)
    same_b = []
    for bmap in (np.repeat(np.arange(8), REGIONS), np.arange(8)):
        lc = ops.replay_blocks(*cells, btile, region_map=torch.tensor(
            bmap, dtype=torch.int32, device=dev))
        same_b.append(all(torch.equal(x.view(torch.int32),
                                      y.view(torch.int32))
                          for x, y in zip(lb, lc)))
    call = cuda_ms(lambda: ops.replay_blocks(*cells, tile, region_map=rmap))
    ms = kernel_ms(lambda: ops.replay_blocks(*cells, tile, region_map=rmap),
                   "replay_kernel")
    n_bytes = (g * n * 5 * 4 + g * n * s * 4 + g * s * 4 + u * 6 * s * 4
               + rmap.numel() * 4 + g * 4)
    b_ms, b_by = bound_ms(n_bytes, REPLAY_OPS_PER_STEP * g * n * s)
    print(f"replay_blocks (c, region store) G={g} N={n} S={s} U={u} "
          f"map={tuple(rmap.shape)}: {n_bad} of {g * s} lanes not bitwise "
          f"equal to plain (max abs {err:.3e}); bank-constant map and "
          f"identity map equal to variant (b): {same_b}; kernel {ms:.3f} ms "
          f"(wrapper call {call:.3f} ms), plain {plain_s * 1e3:.1f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
          f"path {n} dependent requests")
    chain = chain_bound("2c", n, ms)
    check(n_bad == 0, f"replay_blocks (c): {n_bad} lanes differ")
    check(all(same_b), "replay_blocks (c) with a bank map differs from (b)")
    return {"name": "replay_blocks", "variant": "c", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/replay.cu",
            "replaces": "src/repro/kernels/replay/replay.py:640",
            **path_launches(env, "replay_blocks (c)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **chain}


def kernel_adaptive_regioned(env) -> dict:
    """Phase 6e: adaptive_blocks (c), the deployed region stack gathered
    through its [64] map, against its plain version at the regioned
    closed loop's full shape (raw temps and bins emitted), and its
    times."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    scn_t = torch.tensor(TH.stack_scenarios(scns).T.copy(), device=dev)
    tcfg = torch.tensor(TH.ThermalConfig().as_row(), device=dev)
    rows_u, edges, idx = env["region_stack"]
    tile = ref.table_tile(ref.lane_tables(
        torch.tensor(rows_u, device=dev)[None], len(scns)))  # [U, S+1, 6, L]
    rmap = torch.tensor(idx.reshape(-1), device=dev)
    bins = torch.tensor(edges, device=dev)
    lanes = tile.shape[-1]
    out = ops.adaptive_blocks(*cells, tile, scn_t, bins, tcfg, emit_raw=True,
                              region_map=rmap)
    plain, plain_s = wall(lambda: dram_sim.replay_adaptive_cells(
        arr, bank, row, wr.bool(), valid.bool(), ref.lane_stacks(tile),
        bins, scn_t.T, tcfg, closed > 0.5, region_map=rmap))
    lat, total, tmax, tmean, sw, heat, temps, sel = out
    plat, ptot, ptemps, psel, pheat, (ptmax, ptmean, psw) = plain
    pairs = ((lat, plat), (total, ptot), (temps, ptemps), (heat, pheat),
             (tmax, ptmax), (tmean, ptmean))
    err = max((a - b).abs().max().item() for a, b in pairs)
    same_bins = bool(torch.equal(sel, psel) and torch.equal(sw, psw))

    def lane_bits(a, b):
        d = a.view(torch.int32) != b.view(torch.int32)
        return d.reshape(g, -1, lanes).any(1)

    n_off = int((lane_bits(lat, plat) | lane_bits(temps, ptemps)
                 | lane_bits(heat, pheat) | lane_bits(total, ptot)
                 | (sel != psel).any(1)).sum())
    close = all(torch.allclose(a, b, rtol=1e-5, atol=0)
                for a, b in pairs[:2]) and all(
        torch.allclose(a, b, rtol=1e-5, atol=1e-4) for a, b in pairs[2:])
    fn = lambda: ops.adaptive_blocks(*cells, tile, scn_t, bins, tcfg,  # noqa: E731
                                     region_map=rmap)
    call = cuda_ms(fn)
    ms = kernel_ms(fn, "adaptive_kernel")
    n_bytes = (g * n * 5 * 4 + g * n * lanes * 4 + g * 4 + tile.numel() * 4
               + rmap.numel() * 4 + scn_t.numel() * 4 + bins.numel() * 4
               + 24 + g * lanes * 4 * 4 + heat.numel() * 4)
    b_ms, b_by = bound_ms(n_bytes, (REPLAY_OPS_PER_STEP
                                    + ADAPTIVE_OPS_PER_STEP) * g * n * lanes)
    print(f"adaptive_blocks (c, region tables) G={g} N={n} L={lanes} "
          f"U={tile.shape[0]}: bins identical {same_bins}, {int(sw.sum())} "
          f"switches, {n_off} of {g * lanes} lanes not bitwise equal to plain "
          f"(max abs {err:.3e}); kernel {ms:.3f} ms (wrapper call {call:.3f} "
          f"ms), plain {plain_s * 1e3:.1f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{n_bytes / 1e6:.2f} MB); critical path {n} dependent requests")
    chain = chain_bound("3c", n, ms, n_banks=8, n_edges=bins.numel(),
                        table=_adaptive_table_class(tile, bins, 8, True,
                                                    False))
    check(same_bins, "adaptive_blocks (c): bins differ")
    check(close, f"adaptive_blocks (c): outputs beyond tolerance (max abs "
                 f"{err:.3e})")
    return {"name": "adaptive_blocks", "variant": "c", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/adaptive.cu",
            "replaces": "src/repro/kernels/replay/replay.py:522",
            **path_launches(env, "adaptive_blocks (c)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **chain}


def cross_device_region() -> None:
    """Phase 7c: the region path at --fast scale (24 modules, 8 cells,
    2.5 ns grid, regions=8) on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core.aldram import ALDRAMController
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sweep import Op
    from repro_torch.core.variation import sample_population

    cfg = dataclasses.replace(CALIBRATED_VARIATION, n_modules=24, n_cells=8)
    pop_cpu = sample_population(torch.Generator().manual_seed(SEED), cfg,
                                device="cpu")
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        pop = pop_cpu.to(dev)
        ctrl = ALDRAMController(Profiler(CALIBRATED_CONSTANTS, grid_step=2.5,
                                         device=dev), regions=REGIONS,
                                device=dev)
        t0 = time.perf_counter()
        ctrl.profile(pop)
        red = ctrl.region_reductions(LEVELS)
        ratios = {lv: ctrl.region_table(lv).compression_ratio()
                  for lv in LEVELS}
        out[dev] = dict(ctrl=ctrl, pop=pop, red=red, ratios=ratios,
                        dense=ctrl.table.expand_regions())
        secs[dev] = time.perf_counter() - t0
    g, c = out["cuda"], out["cpu"]
    diff = int((g["dense"] != c["dense"]).any(-1).sum())
    flips = unexplained = 0
    if diff:
        spec = c["ctrl"].sweep_result.spec
        rg = g["ctrl"].engine.sweep(g["pop"], spec, regions=REGIONS)
        rc = c["ctrl"].engine.sweep(c["pop"], spec, regions=REGIONS)
        m, ch, bk, kc = c["pop"].cells.shape[:4]
        for op in Op:
            k = rc.index(op)
            flip = rg.ok_region[k] != rc.ok_region[k]
            mm = rc.margins[k].reshape(m, ch, bk, REGIONS, kc // REGIONS,
                                       *rc.margins[k].shape[1:])
            mmin = mm.amin(dim=(1, 4)).numpy()
            flips += int(flip.sum())
            unexplained += int((np.abs(mmin[flip]) > TOL).sum())
    # the system-side comparison replays the CPU controller's tables on
    # both devices
    g["ctrl"].table = c["ctrl"].table
    g["ctrl"].sweep_result = c["ctrl"].sweep_result
    sys_res = {}
    for dev in ("cuda", "cpu"):
        o = out[dev]
        t0 = time.perf_counter()
        sys_res[dev] = o["ctrl"].evaluate_region_system(o["pop"], n=1024,
                                                        levels=LEVELS)
        secs[dev] += time.perf_counter() - t0
    rel = 0.0
    for tc_, d in sys_res["cpu"]["per_temp"].items():
        for k, v in d.items():
            rel = max(rel, abs(sys_res["cuda"]["per_temp"][tc_][k] / v - 1))
    same_red = g["red"] == c["red"] and g["ratios"] == c["ratios"]
    print(f"cross-device region --fast (24 modules, 8 cells, 2.5 ns grid, "
          f"regions={REGIONS}): {diff} differing dense region rows, {flips} "
          f"pass/fail flips ({unexplained} unexplained); region_reductions "
          f"and ratios equal: {same_red} (ratios {c['ratios']}); "
          f"evaluate_region_system(n=1024) max rel gmean diff {rel:.3e}; "
          f"card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s")
    check(unexplained == 0, "card and CPU region choices differ beyond 2e-4")
    check(diff > 0 or same_red, "region reductions or ratios differ with "
                                "equal tables")
    check(rel <= 1e-5, f"card vs CPU region gmeans differ by {rel:.3e}")


# ------------------------------------------------------------ fault path

# operations per request per lane on top of service_math, for the bound:
# the watchdog gate and selects, the reduction (4 adds, a division), the
# error probability and draw, the surcharge, the watchdog transition and
# five counters
FAULT_OPS_STATIC = 40
# the same plus the faulted sensor (lag with its exp, drift, stuck-at,
# quantization, the hash draws where a row has noise or dropout), the
# JEDEC gather and sum, the edge excess and the implausibility check
FAULT_OPS_ADAPTIVE = 70


def _fault_campaigns(env):
    """The fault phase's campaigns at full width, on what the main path
    profiled: the five profiled module rows with the JEDEC row last
    under open and closed page, and the deployed module, per-bank and
    region stacks under the thermal path's 4 + 4 scenarios — each over
    the 70-trace pool at n = 4096 — under the `fault_bench` grid (9
    rows, seed 11).  The grid's rows err through the bin-excess term
    only, which the static replay does not have (no temperature), so the
    static campaign appends the margin-error rows of the reference's
    static fixture (`tests/test_faults.py` ACTIVE "err" and "wd").
    Returns ({name: SimSpec keywords with its `faults`})."""
    import numpy as np
    from benchmarks import port_fault_bench
    from repro_torch.core import faults
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.dram_sim import OPEN_FCFS, Policy

    traces = perf_model.trace_batch(4096, SEED, device="cuda")
    fspec, _ = port_fault_bench._fault_grid(
        False, float(traces.arrival[0, -1]))
    rows = env["sys_res"]["rows"]                    # JEDEC first, 5 bins
    scns = default_scenarios()
    scns = scns + tuple(x.oracle() for x in scns)
    table = env["ctrl"].table
    rows_u, edges_u, idx = env["region_stack"]
    stacks = {"module": table.safe_stack() + (None,),
              "bank": table.safe_stack_banks() + (None,),
              "region": (rows_u, edges_u, idx.reshape(-1))}
    static_f = faults.FaultSpec(scenarios=fspec.scenarios + (
        faults.FaultScenario(name="err", err_scale=0.8, err_free_red=0.0,
                             detect_frac=0.9, retry_ns=60.0),
        faults.FaultScenario(name="wd", err_scale=0.8, err_free_red=0.0,
                             detect_frac=1.0, wd_err_n=4, wd_probe=16,
                             wd_recover_n=2)), seed=fspec.seed)
    specs = {"static": dict(
        traces=traces, timings=np.concatenate([rows[1:], rows[:1]]),
        policies=(OPEN_FCFS, Policy(page="closed")), faults=static_f,
        collect=("latencies",))}
    for name, (r, e, rm) in stacks.items():
        specs[name] = dict(
            traces=traces, timings=r[None], region_map=rm, faults=fspec,
            thermal=TH.ThermalSpec(scns, tuple(e.tolist()),
                                   TH.ThermalConfig()),
            collect=("latencies", "bins"))
    return specs


def _bound_exact(res, fspec) -> bool:
    """detected <= wd_err_n * (trips + 1) + probes in every cell of
    every watchdog lane."""
    from repro_torch.core import faults
    wd_n = fspec.pack()[:, faults.WD_ERR_N]
    on = wd_n > 0
    bound = wd_n * (res.wd_trips + 1) + res.wd_probes
    return bool((res.detected_errors[..., on] <= bound[..., on]).all())


def fault_path(env) -> None:
    """Phase 6: the fault axis at full width, kernel launch counts reset
    just before and read just after: the static campaign (ONE launch of
    replay_blocks (e)), the module, per-bank and region stacks in closed
    loop (ONE launch of adaptive_blocks (d) each) and
    `port_fault_bench.run(fast=False)` on the reference's seed-11
    uniforms (ONE launch of (d), its acceptance bracket asserted)."""
    import numpy as np
    from benchmarks import port_fault_bench
    from repro_torch.core import faults
    from repro_torch.core.sim_engine import SimEngine, SimSpec

    specs = _fault_campaigns(env)
    eng = SimEngine(device="cuda")
    reset_counts()
    res, secs = {}, {}
    for name, kw in specs.items():
        res[name], secs[name] = wall(lambda: eng.run(SimSpec(**kw)))
    bench, t_bench = wall(lambda: port_fault_bench.run(
        False, "cuda", port_fault_bench.reference_uniforms(False)))
    launches = read_counts()
    # the same campaigns without a fault axis, and under FaultSpec.none()
    plain = {name: eng.run(SimSpec(**dict(kw, faults=None)))
             for name, kw in specs.items()}
    before = read_counts()
    none = {name: eng.run(SimSpec(**dict(specs[name],
                                         faults=faults.FaultSpec.none())))
            for name in ("static", "module")}
    after = read_counts()
    own = port_fault_bench.campaign(False, "cuda")
    own_sum = port_fault_bench.summarize(own["res"], own["fspec"],
                                         own["lanes"], own["n_req"],
                                         check=False)

    for name, r in res.items():
        names = specs[name]["faults"].names()
        tot = r.fault_counters.reshape(-1, len(names), faults.N_COUNTERS) \
            .sum(0)
        print(f"fault campaign {name}: grid {r.mean_latency_ns.shape}, "
              f"{secs[name]:.3f} s; counters (detected, silent, trips, "
              "degraded, probes) per fault row: " + "; ".join(
                  f"{n} {tuple(int(x) for x in c)}"
                  for n, c in zip(names, tot)))
    print(f"port_fault_bench.run(fast=False) on the reference's uniforms "
          f"({t_bench:.3f} s): reduction_none {bench['reduction_none']:.4%}, "
          "pairs " + json.dumps(bench["pairs"]))
    print("port_fault_bench on the engine's own CUDA draw (the >= 10x "
          "bracket is draw-dependent and not asserted here; the watchdog "
          f"bound is): bound exact {own_sum['bound_exact']}, ratios "
          + json.dumps({k: d["silent_ratio"] for k, d in
                        own_sum["pairs"].items()})
          + ", giveback_pt " + json.dumps({k: d["giveback_pt"] for k, d in
                                           own_sum["pairs"].items()}))
    print(f"fault path seconds: " + " ".join(
        f"{k} {v:.3f}" for k, v in secs.items()) + f" bench {t_bench:.3f}")
    print("fault path kernels: " + json.dumps(launches))

    for name, r in res.items():
        check(_bound_exact(r, specs[name]["faults"]),
              f"{name}: watchdog bound violated")
        check(int(np.abs(r.fault_counters[..., 0, :]).sum()) == 0,
              f"{name}: the inert row counted")
        check(r.wd_trips.sum() > 0 and r.detected_errors.sum() > 0,
              f"{name}: no error or trip in the grid")
        p = plain[name]
        inert = {k: np.take(getattr(r, k), 0, axis=3 if name == "static"
                            else 4) for k in ("latencies", "total_ns")}
        same = (np.array_equal(inert["latencies"].view(np.int32),
                               p.latencies.view(np.int32))
                and np.array_equal(inert["total_ns"].view(np.int32),
                                   p.total_ns.view(np.int32)))
        if name != "static":
            same = same and np.array_equal(r.bins[..., 0, :], p.bins)
        check(same, f"{name}: the inert lane differs from the unfaulted "
                    "campaign")
    check(_bound_exact(own["res"], own["fspec"]) and own["dispatches"] == 1,
          "own-draw fault bench: watchdog bound or dispatch count")
    check(launches["replay_blocks (e)"] == 1
          and launches["adaptive_blocks (d)"] == 4,
          f"fault path launches {launches}")
    check(after["replay_blocks (e)"] == before["replay_blocks (e)"]
          and after["adaptive_blocks (d)"] == before["adaptive_blocks (d)"],
          "FaultSpec.none() launched a faulted kernel")
    for name, r in none.items():
        p = plain[name]
        check(np.array_equal(r.latencies[..., 0, :], p.latencies)
              and r.fault_counters.sum() == 0,
              f"FaultSpec.none() differs from the unfaulted {name} campaign")
    print(f"fault path checks: watchdog bound exact in every cell of every "
          f"watchdog lane; inert lanes bitwise equal to the unfaulted "
          f"campaigns; FaultSpec.none() launched no faulted kernel "
          f"(launches {before} -> {after})")
    env.update(launches_fault=launches, fault_specs=specs)


def fault_breakdown(env) -> None:
    """Phase 6b: the fault path once more under `torch.profiler`, the
    campaigns without the raw latency and bin grids that phase 6 copies
    to the host for its checks."""
    from benchmarks import port_fault_bench
    from repro_torch.core.sim_engine import SimEngine, SimSpec

    specs = env["fault_specs"]
    u = port_fault_bench.reference_uniforms(False)

    def run():          # as a user runs them: no raw grids collected
        eng = SimEngine(device="cuda")
        for kw in specs.values():
            eng.run(SimSpec(**dict(kw, collect=())))
        port_fault_bench.run(False, "cuda", u)

    busy_share("fault path", run)


def _fault_uniforms(g: int, n: int):
    from repro_torch.core import faults
    return faults.fault_uniforms(SEED, g, n, device="cuda")


def kernel_replay_faulted(env) -> dict:
    """Phase 7f: replay_blocks (e) against its plain version at the
    static fault campaign's full shape (70 traces x 2 policies, 6 rows x
    11 fault rows = 66 lanes, n = 4096), and its times."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    kw = env["fault_specs"]["static"]
    fspec = kw["faults"]
    tb = kw["traces"]
    t, n = tb.arrival.shape
    nf = len(fspec)
    cells = ref.to_cells(*(f[:, None].expand(t, 2, n) for f in tb),
                         torch.ones((t, n), dtype=torch.bool, device="cuda"),
                         torch.tensor([False, True], device="cuda"))
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    rows = torch.tensor(kw["timings"], device="cuda")
    tim = rows.repeat_interleave(nf, dim=0)                 # l = s*F + f
    s = tim.shape[0]
    ftile = ref.fault_tile(torch.tensor(fspec.pack(), device="cuda")
                           .repeat(rows.shape[0], 1))
    jed = rows[-1].contiguous()
    u = ref.cell_uniforms(_fault_uniforms(t, n), 2)
    tile = ref.timing_tile(tim)
    def fn():
        return ops.replay_blocks(*cells, tile, fault=(ftile, jed, u))

    lat, total, cnt = fn()
    (lat2, total2, cnt2), plain_s = wall(lambda: dram_sim.replay_cells(
        arr, bank, row, wr.bool(), valid.bool(), tim, closed > 0.5,
        fault=(ftile.T, jed, u)))
    lanes = ((lat.view(torch.int32) != lat2.view(torch.int32)).any(1)
             | (total.view(torch.int32) != total2.view(torch.int32))
             | (cnt != cnt2).any(0))
    n_bad = int(lanes.sum())
    err = max((lat - lat2).abs().max().item(),
              (total - total2).abs().max().item())
    call = cuda_ms(fn)
    ms = kernel_ms(fn, "replay_kernel")
    n_bytes = (g * n * 6 * 4 + g * n * s * 4 + g * s * 4 * 6
               + (6 + 18) * s * 4 + 24 + g * 4)
    b_ms, b_by = bound_ms(n_bytes, (REPLAY_OPS_PER_STEP + FAULT_OPS_STATIC)
                          * g * n * s)
    print(f"replay_blocks (e, faulted module rows) G={g} N={n} S={s} "
          f"({rows.shape[0]} rows x {nf} fault rows): {n_bad} of {g * s} "
          f"lanes not bitwise equal to plain in latencies, totals or "
          f"counters (max abs {err:.3e}; {int(cnt.sum())} counted events); "
          f"kernel {ms:.3f} ms (wrapper call {call:.3f} ms), plain "
          f"{plain_s * 1e3:.1f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{n_bytes / 1e6:.2f} MB); critical path {n} dependent requests; "
          f"{path_launches(env, 'replay_blocks (e)')['launches']} launches "
          "on the paths driven")
    chain = chain_bound("2e", n, ms)
    check(n_bad == 0, f"replay_blocks (e): {n_bad} lanes differ")
    return {"name": "replay_blocks", "variant": "e", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/replay.cu",
            "replaces": "src/repro/kernels/replay/replay.py:640",
            **path_launches(env, "replay_blocks (e)"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_s * 1e3,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **chain}


def kernel_adaptive_faulted(env) -> dict:
    """Phase 7g: adaptive_blocks (d) against its plain version at the
    closed-loop fault campaigns' full shape (70 traces x 8 scenarios x
    9 fault rows = 72 lanes, n = 4096, raw temps and bins emitted) for
    the module, per-bank and region stacks, and its times (the entry's
    numbers are the module stack's; the others are printed)."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ops, ref

    fspec = env["fault_specs"]["module"]["faults"]
    nf = len(fspec)
    n = 4096
    cells = _campaign_cells(n)
    closed, arr, bank, row, wr, valid = cells
    g = arr.shape[0]
    u = _fault_uniforms(g, n)
    entry = None
    for name in ("module", "bank", "region"):
        kw = env["fault_specs"][name]
        scns, bins, tcfg = (torch.tensor(x, device="cuda")
                            for x in kw["thermal"].pack())
        c = scns.shape[0]
        tile = ref.table_tile(ref.lane_tables(
            torch.tensor(kw["timings"], device="cuda"), c * nf))
        lanes = tile.shape[-1]
        scn_t = ref.lane_scenarios(scns, 1, nf).T.contiguous()
        ftile = ref.fault_tile(ref.lane_faults(
            torch.tensor(fspec.pack(), device="cuda"), c))
        rmap = (None if kw["region_map"] is None
                else torch.tensor(kw["region_map"], device="cuda"))
        fn = lambda: ops.adaptive_blocks(  # noqa: E731
            *cells, tile, scn_t, bins, tcfg, emit_raw=True, region_map=rmap,
            fault=(ftile, u))
        lat, total, tmax, tmean, sw, heat, temps, sel, cnt = fn()
        plain, plain_s = wall(lambda: dram_sim.replay_adaptive_cells(
            arr, bank, row, wr.bool(), valid.bool(), ref.lane_stacks(tile),
            bins, scn_t.T, tcfg, closed > 0.5, region_map=rmap,
            fault=(ftile.T, u)))
        plat, ptot, ptemps, psel, pheat, (ptmax, ptmean, psw), pcnt = plain

        def lane_bits(a, b):
            d = a.view(torch.int32) != b.view(torch.int32)
            return d.reshape(g, -1, lanes).any(1)

        exact = (lane_bits(lat, plat) | lane_bits(total, ptot)
                 | (sel != psel).any(1) | (sw != psw) | (cnt != pcnt).any(0))
        n_bad = int(exact.sum())
        n_temp = int((lane_bits(temps, ptemps) | lane_bits(heat, pheat)
                      | lane_bits(tmax, ptmax) | lane_bits(tmean, ptmean))
                     .sum())
        close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-4)
                    for a, b in ((temps, ptemps), (heat, pheat),
                                 (tmax, ptmax), (tmean, ptmean)))
        err = max((a - b).abs().max().item()
                  for a, b in ((lat, plat), (total, ptot), (temps, ptemps),
                               (heat, pheat)))
        call = cuda_ms(lambda: ops.adaptive_blocks(
            *cells, tile, scn_t, bins, tcfg, region_map=rmap,
            fault=(ftile, u)))
        ms = kernel_ms(lambda: ops.adaptive_blocks(
            *cells, tile, scn_t, bins, tcfg, region_map=rmap,
            fault=(ftile, u)), "adaptive_kernel")
        n_bytes = (g * n * 6 * 4 + g * n * lanes * 4 + g * 4
                   + tile.numel() * 4 + scn_t.numel() * 4 + ftile.numel() * 4
                   + bins.numel() * 4 + 24 + g * lanes * 4 * 9
                   + heat.numel() * 4
                   + (0 if rmap is None else rmap.numel() * 4))
        b_ms, b_by = bound_ms(n_bytes, (REPLAY_OPS_PER_STEP
                                        + ADAPTIVE_OPS_PER_STEP
                                        + FAULT_OPS_ADAPTIVE) * g * n * lanes)
        print(f"adaptive_blocks (d, faulted, {name} tables) G={g} N={n} "
              f"L={lanes} ({c} scenarios x {nf} fault rows): {n_bad} of "
              f"{g * lanes} lanes not bitwise equal to plain in latencies, "
              f"totals, bins, switches or counters; {n_temp} lanes with "
              f"temperatures or heat not bitwise equal (within rtol 1e-5, "
              f"atol 1e-4: {close}; max abs {err:.3e}); {int(sw.sum())} "
              f"switches, {int(cnt.sum())} counted events; kernel {ms:.3f} "
              f"ms (wrapper call {call:.3f} ms), plain {plain_s * 1e3:.1f} "
              f"ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); "
              f"critical path {n} dependent requests; "
              f"{path_launches(env, 'adaptive_blocks (d)')['launches']} "
              "launches of (d) on the paths driven")
        chain = chain_bound("3d", n, ms, n_banks=8, n_edges=bins.numel(),
                            table=_adaptive_table_class(
                                tile, bins, 8, rmap is not None, True))
        check(n_bad == 0, f"adaptive_blocks (d, {name}): {n_bad} lanes "
                          "differ")
        check(close, f"adaptive_blocks (d, {name}): temperatures beyond "
                     "tolerance")
        if entry is None:
            entry = {"name": "adaptive_blocks", "variant": "d",
                     "route": "cuda",
                     "source": "src/repro_torch/kernels/replay/adaptive.cu",
                     "replaces": "src/repro/kernels/replay/replay.py:522",
                     **path_launches(env, "adaptive_blocks (d)"),
                     "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, **chain,
                     "ms_by_layout": {}, "plain_ms_by_layout": {},
                     "chain_ms_by_layout": {}}
        entry["ms_by_layout"][name] = ms
        entry["plain_ms_by_layout"][name] = plain_s * 1e3
        entry["chain_ms_by_layout"][name] = chain["chain_ms"]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry


def _fault_probs(c, u):
    """The CPU campaign's per-request error probabilities [G, N, L] (the
    plain version with `probs`), to print |u - p| at a mismatch."""
    import torch
    from repro_torch.core import dram_sim
    from repro_torch.kernels.replay import ref

    spec = c["spec"]
    arrival, bank, row, is_write, valid, closed = spec.pack(
        torch.device("cpu"))
    cl, arr, bk, rw, wr, val = ref.to_cells(
        arrival, bank, row, is_write, torch.as_tensor(valid),
        torch.as_tensor(closed))
    scns, bins, tcfg = spec.thermal.pack()
    k, nc, nf = spec.timings.shape[0], len(scns), len(spec.faults)
    return dram_sim.replay_adaptive_cells(
        arr, bk, rw, wr.bool(), val.bool(),
        ref.lane_tables(torch.tensor(spec.timings), nc * nf), bins,
        ref.lane_scenarios(torch.tensor(scns), k, nf), tcfg, cl > 0.5,
        spec.n_banks, spec.mlp_window,
        fault=(ref.lane_faults(torch.tensor(spec.faults.pack()), k * nc),
               ref.cell_uniforms(torch.tensor(u), arrival.shape[1])),
        probs=True)[-1]


def cross_device_fault() -> None:
    """Phase 8d: `port_fault_bench` at --fast scale on the card and on
    the CPU, both on the reference's uniforms: the counters and the
    served bin of every request equal."""
    import numpy as np
    from benchmarks import port_fault_bench

    u = port_fault_bench.reference_uniforms(True)
    c = {dev: port_fault_bench.campaign(True, dev, u, collect=("bins",))
         for dev in ("cuda", "cpu")}
    rg, rc = c["cuda"]["res"], c["cpu"]["res"]
    d_bins = rg.bins != rc.bins                     # [T, P, K, C, F, N]
    d_cnt = (rg.fault_counters != rc.fault_counters).any(-1)
    sums = {dev: port_fault_bench.summarize(
        x["res"], x["fspec"], x["lanes"], x["n_req"], check=False)
        for dev, x in c.items()}
    print(f"cross-device fault bench --fast (reference uniforms): "
          f"{int(d_bins.sum())} of {d_bins.size} served bins and "
          f"{int(d_cnt.sum())} of {d_cnt.size} counter lanes differ; pairs "
          f"equal {sums['cuda']['pairs'] == sums['cpu']['pairs']}; card "
          f"{c['cuda']['seconds']:.2f} s, CPU {c['cpu']['seconds']:.2f} s")
    if d_bins.any() or d_cnt.any():
        probs = _fault_probs(c["cpu"], u).numpy()   # [G, N, L]
        t_, p_, k_, c_, f_, n_ = rg.bins.shape
        where = np.argwhere(d_bins)
        if not len(where):
            where = [tuple(ix) + (0,) for ix in np.argwhere(d_cnt)]
        for ti, pi, ki, ci, fi, ni in where[:10]:
            gi, li = ti * p_ + pi, (ki * c_ + ci) * f_ + fi
            pv = probs[gi, ni, li]
            print(f"  mismatch at cell {gi} lane {li} request {ni}: bins "
                  f"card {rg.bins[ti, pi, ki, ci, fi, ni]} CPU "
                  f"{rc.bins[ti, pi, ki, ci, fi, ni]}, |u - p| = "
                  f"{abs(float(u[ti, ni]) - float(pv)):.3e}")
    check(not d_bins.any() and not d_cnt.any(),
          "card and CPU fault campaigns differ")


# ---------------------------------------------------------- traffic path

# operations per request per lane of variant (d) on top of service_math:
# the bus gather and max, the slot and channel unpack, the bus write
MULTI_OPS = 6
MULTI_ADAPTIVE_SHAPE = (16, 2048)     # streams x requests, 2 channels


def _multi_adaptive_spec(env, traces):
    """The one-off multi-channel closed-loop campaign: the deployed
    module stack (5 bins + JEDEC) under the 4 + 4 default thermal
    lanes, one FR-FCFS row-interleave policy, 2 channels."""
    from repro_torch.core import thermal as TH
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.dram_sim import Policy, Trace
    from repro_torch.core.sim_engine import SimSpec

    rows, edges = env["ctrl"].table.safe_stack()
    scns = default_scenarios()
    t, n = MULTI_ADAPTIVE_SHAPE
    return SimSpec(
        traces=tuple(Trace(*(f[:n] for f in tr)) for tr in traces[:t]),
        timings=rows[None], policies=(Policy(reorder_window=16),),
        thermal=TH.ThermalSpec(scns + tuple(x.oracle() for x in scns),
                               tuple(edges.tolist()), TH.ThermalConfig()),
        n_channels=2, collect=("bins",))


def traffic_path(env) -> None:
    """Phase 6c: the multi-channel, multi-tenant traffic path at full
    size, kernel launch counts reset just before and read just after:
    `port_traffic_bench.run(fast=False)` (one replay launch per run:
    (a) on one channel, (d) on two and four) and the multi-channel
    closed-loop campaign, which runs the plain step loop on the card."""
    import numpy as np
    from benchmarks import port_traffic_bench as B
    from repro_torch.core import perf_model
    from repro_torch.core.sim_engine import SimEngine

    n, n_streams, _ = B.grid(False)
    traces = perf_model.tenant_spec(n=n, n_streams=n_streams,
                                    seed=0).materialize("cuda")
    spec_a = _multi_adaptive_spec(env, traces)
    eng = SimEngine(device="cuda")
    reset_counts()
    bench, t_bench = wall(lambda: B.run(False, "cuda"))
    adap, t_adap = wall(lambda: eng.run(spec_a))
    launches = read_counts()

    for c, d in bench["per_channel"].items():
        print(f"traffic C={c}: mean {d['mean_ns']:.4f} ns, p99 "
              f"{d['p99_ns']:.4f} ns, gap {d['static_vs_adaptive_gap']:.5f}x,"
              f" wall {d['wall_s']:.4f} s (median of {d['replays']} runs), "
              f"prepass {d['prepass_s']:.4f} s ({d['prepass_share']:.1%} of "
              f"the wall), {d['throughput_req_s'] / 1e6:.3f} Mreq/s, "
              f"launches in the timed runs {json.dumps(d['launches'])}")
    print(f"traffic bench: {bench['requests']} requests per run, "
          f"{t_bench:.3f} s in all; gap slope "
          f"{bench['gap_contention_slope']:.5f}; tenant axis drawn once "
          f"in {bench['synth_s']:.3f} s before timing, on "
          f"{bench['devices']} device(s), shard {bench['shard']}, "
          f"sharded_rel {bench['sharded_rel']:.0e}")
    t, n_a = MULTI_ADAPTIVE_SHAPE
    print(f"multi-channel adaptive campaign (C=2, {t} streams x n={n_a}, "
          f"8 thermal lanes, FR-FCFS window 16) ran the plain step loop on "
          f"the card (the adaptive kernel is single-channel): {t_adap:.3f} "
          f"s; grid {adap.mean_latency_ns.shape}, mean "
          f"{float(adap.mean_latency_ns.mean()):.4f} ns, p99 "
          f"{float(adap.p99_latency_ns.mean()):.4f} ns, switches "
          f"{int(adap.bin_switches.sum())}, bank_heat "
          f"{adap.bank_heat.shape}")
    print("traffic path kernels: " + json.dumps(launches))

    per = bench["per_channel"]
    for c, d in per.items():
        check(d["replays"] == 3 and d["launches"]["total"] == 3,
              f"C={c}: {d['replays']} runs, launches {d['launches']}")
        check(np.isfinite([d["mean_ns"], d["p99_ns"],
                           d["static_vs_adaptive_gap"]]).all()
              and d["static_vs_adaptive_gap"] > 1.0, f"C={c}: {d}")
    check(per["1"]["launches"]["multi"] == 0
          and per["2"]["launches"]["multi"] == 3
          and per["4"]["launches"]["multi"] == 3,
          "one channel must launch (a), two and four (d)")
    check(per["1"]["p99_ns"] > per["2"]["p99_ns"] >= per["4"]["p99_ns"],
          "more channels must lower the p99")
    check(bench["declarative"] and bench["sharded_rel"] == 0.0,
          f"traffic bench sharded_rel {bench['sharded_rel']}")
    # per channel count a warm-up and 3 timed runs, then the unsharded
    # 4-channel check; the closed loop launches no adaptive kernel
    check(launches["replay_blocks (a)"] == 4
          and launches["replay_blocks (d)"] == 9
          and sum(v for k, v in launches.items()
                  if k.startswith("adaptive_blocks")) == 0,
          f"traffic path launches {launches}")
    check(adap.bank_heat.shape[-1] == 2 * 8
          and np.isfinite(adap.mean_latency_ns).all()
          and int(adap.bins.max()) <= 5 and int(adap.bins.min()) >= 0,
          "multi-channel adaptive campaign")
    env.update(launches_traffic=launches, traffic_traces=traces,
               traffic_bench=bench)


# requests per stream of the traffic profile: the first sixteenth of
# each stream, cut for time only.  The profile exists only for the busy
# share; its kernel records and its seconds shrink with the length
# (8,192 took 152.7 s, 4,096 took 64-82 s, 2,048 31-50 s, 512 7.6 s).
# The share swings with the host: 5.9-12.5 % in three runs at 2,048,
# 9.3 % in one at 4,096, 7.6 % at 512 (NVIDIA H100 80GB HBM3, 700 W)
TRAFFIC_PROFILE_N = 512


def traffic_breakdown(env) -> None:
    """Phase 6c, its profile (run after phases 7 and 9-11): one 4-channel
    traffic run (FR-FCFS prepass, one launch of (d), device statistics)
    under `torch.profiler`, on the first `TRAFFIC_PROFILE_N` requests of
    each stream."""
    from benchmarks import port_traffic_bench as B
    from repro_torch.core.dram_sim import Trace
    from repro_torch.core.sim_engine import SimEngine, SimSpec

    _, _, n_rows = B.grid(False)
    spec = SimSpec(traces=tuple(Trace(*(f[:TRAFFIC_PROFILE_N] for f in t))
                                for t in env["traffic_traces"]),
                   timings=B.timing_rows(n_rows), policies=B.policies(),
                   n_channels=4)
    eng = SimEngine(device="cuda")
    busy_share(f"traffic path (one 4-channel run, n={TRAFFIC_PROFILE_N})",
               lambda: eng.run(spec))


def kernel_replay_multi(env) -> dict:
    """Phase 7h: replay_blocks (d) against its plain version at the
    traffic shape — the 16 tenant streams x 3 policies in their FR-FCFS
    issue orders (48 cells), N = 8192, the 8 timing rows — on 2 and 4
    channels, and faulted (8 rows x 3 fault rows, 4 channels); its times
    (the entry's are the 4-channel unfaulted launch's)."""
    import numpy as np
    import torch
    from benchmarks import port_traffic_bench as B
    from repro_torch.core import dram_sim, faults
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.kernels.replay import ops, ref

    n, _, n_rows = B.grid(False)
    rows = torch.tensor(B.timing_rows(n_rows), device="cuda")
    spec = SimSpec(traces=env["traffic_traces"], timings=B.timing_rows(
        n_rows), policies=B.policies(), n_channels=4)
    arrival, bank, row, is_write, valid, closed = SimEngine(
        device="cuda").reorder_streams(spec)
    t, p, _ = arrival.shape
    cells = ref.to_cells(arrival, bank, row, is_write,
                         torch.tensor(valid, device="cuda"),
                         torch.tensor(closed, device="cuda"))
    closed_c, arr, bk, rw, wr, val = cells
    g = arr.shape[0]
    codes = ref.cell_codes(torch.tensor(spec.ileave_codes, device="cuda"),
                           t, p, "cuda")
    fspec = faults.FaultSpec(scenarios=(
        faults.FaultScenario(),
        faults.FaultScenario(name="err", err_scale=0.8, err_free_red=0.0,
                             detect_frac=0.9, retry_ns=60.0),
        faults.FaultScenario(name="wd", err_scale=0.8, err_free_red=0.0,
                             detect_frac=1.0, wd_err_n=4, wd_probe=16,
                             wd_recover_n=2)), seed=SEED)
    nf = len(fspec)
    cases = {"C=2": (2, rows, None), "C=4": (4, rows, None),
             "C=4 faulted": (4, rows.repeat_interleave(nf, dim=0), (
                 ref.fault_tile(torch.tensor(fspec.pack(), device="cuda")
                                .repeat(n_rows, 1)),
                 rows[0].contiguous(),
                 ref.cell_uniforms(_fault_uniforms(t, n), p)))}
    res = {}
    for name, (c, tim, fault) in cases.items():
        tile = ref.timing_tile(tim)
        s = tim.shape[0]
        chan = (c, 1, 5.0)

        def fn():
            return ops.replay_blocks(*cells, tile, fault=fault, chan=chan,
                                     ileave=codes)

        out = fn()
        plain, plain_s = wall(lambda: dram_sim.replay_cells(
            arr, bk, rw, wr.bool(), val.bool(), tim, closed_c > 0.5,
            fault=None if fault is None else (fault[0].T, fault[1],
                                              fault[2]),
            n_channels=c, n_ranks=1, ileave=codes, t_burst=5.0))
        lanes = ((out[0].view(torch.int32) != plain[0].view(torch.int32))
                 .any(1) | (out[1].view(torch.int32)
                            != plain[1].view(torch.int32)))
        if fault is not None:
            lanes |= (out[2] != plain[2]).any(0)
        n_bad = int(lanes.sum())
        err = max((out[0] - plain[0]).abs().max().item(),
                  (out[1] - plain[1]).abs().max().item())
        call = cuda_ms(fn)
        ms = kernel_ms(fn, "replay_kernel")
        n_bytes = (g * n * 5 * 4 + g * 4 * 2 + tim.numel() * 4
                   + g * n * s * 4 + g * s * 4
                   + (0 if fault is None else g * n * 4
                      + fault[0].numel() * 4 + 24 + g * s * 4 * 5))
        ops_step = REPLAY_OPS_PER_STEP + MULTI_OPS + (
            0 if fault is None else FAULT_OPS_STATIC)
        b_ms, b_by = bound_ms(n_bytes, ops_step * g * n * s)
        counted = ("" if fault is None else
                   f"; {int(out[2].sum())} counted events")
        print(f"replay_blocks (d, {name}) G={g} N={n} S={s}: {n_bad} of "
              f"{g * s} lanes not bitwise equal to plain in latencies, "
              f"totals{' or counters' if fault is not None else ''} (max "
              f"abs {err:.3e}{counted}); kernel {ms:.3f} ms (wrapper call "
              f"{call:.3f} ms), plain {plain_s * 1e3:.1f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB); critical "
              f"path {n} dependent requests; {ms / n * 1e3:.4f} us per "
              "step")
        chain = chain_bound("2d", n, ms, faulted=fault is not None)
        check(n_bad == 0, f"replay_blocks (d, {name}): {n_bad} lanes differ")
        if fault is not None:
            check(int(out[2][0].sum()) > 0, "faulted (d) counted nothing")
        res[name] = (ms, plain_s * 1e3, b_ms, b_by, err, chain)
    ms, plain_ms, b_ms, b_by, _, chain = res["C=4"]
    return {"name": "replay_blocks", "variant": "d", "route": "cuda",
            "source": "src/repro_torch/kernels/replay/replay.cu",
            "replaces": "src/repro/kernels/replay/replay.py:640",
            **path_launches(env, "replay_blocks (d)"),
            "max_abs_err": max(r[4] for r in res.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "ms_by_case": {k: r[0] for k, r in res.items()},
            "plain_ms_by_case": {k: r[1] for k, r in res.items()},
            "chain_ms_by_case": {k: r[5]["chain_ms"]
                                 for k, r in res.items()}, **chain}


def cross_device_traffic() -> None:
    """Phase 8e: `port_traffic_bench.run(fast=True)` on the card and on
    the CPU on the same tenant streams: the per-channel statistics
    equal, and the 4-channel latency grid bitwise equal."""
    import numpy as np
    from benchmarks import port_traffic_bench as B
    from repro_torch.core import perf_model
    from repro_torch.core.sim_engine import SimEngine, SimSpec

    n, n_streams, n_rows = B.grid(True)
    ten = perf_model.tenant_spec(n=n, n_streams=n_streams, seed=0)
    out, grids = {}, {}
    for dev in ("cuda", "cpu"):
        traces = ten.materialize(dev)
        out[dev], secs = wall(lambda: B.run(True, dev, traces))
        grids[dev] = SimEngine(device=dev).run(SimSpec(
            traces=traces, timings=B.timing_rows(n_rows),
            policies=B.policies(), n_channels=4, collect=("latencies",)))
        print(f"  port_traffic_bench --fast on {dev}: {secs:.2f} s")
    worst = 0.0
    for c in B.CHANNEL_SWEEP:
        a, b = out["cuda"]["per_channel"][str(c)], out["cpu"][
            "per_channel"][str(c)]
        for k in ("mean_ns", "p99_ns", "static_vs_adaptive_gap"):
            worst = max(worst, abs(a[k] / b[k] - 1.0))
    same = np.array_equal(grids["cuda"].latencies.view(np.int32),
                          grids["cpu"].latencies.view(np.int32))
    print(f"cross-device traffic bench --fast: max relative difference of "
          f"the per-channel mean / p99 / gap {worst:.3e}; 4-channel latency "
          f"grid {grids['cuda'].latencies.shape} bitwise equal: {same}")
    check(same and worst <= 1e-6, "card and CPU traffic campaigns differ")


# -------------------------------------------------------- campaign engine

BLOCK_CAPS = (None, 32, 64, 128)     # None: the kernels' own block
LANES_ROUNDS = 31                    # paired rounds of the lanes timings


def _differing(a: dict, b: dict) -> tuple[int, int]:
    """(differing elements, elements) over the arrays both dicts hold."""
    import numpy as np
    bad = tot = 0
    for k, x in a.items():
        x, y = np.asarray(x), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        check(x.shape == y.shape, f"{k}: shape {x.shape} vs {y.shape}")
        bad += int((x != y).sum())
        tot += x.size
    return bad, tot


def _fields(res, names) -> dict:
    return {f: getattr(res, f) for f in names}


def _bracket_fields(br) -> dict:
    out = {"worst_bin": br["worst_bin"], "temp_peak": br["temp_peak"]}
    for half in ("adaptive", "static"):
        out.update({f"{half}.{k}": v for k, v in br[half].items()})
    return out


STATIC_FIELDS = ("mean_latency_ns", "p99_latency_ns", "total_ns")
ADAPTIVE_FIELDS = STATIC_FIELDS + ("temp_max", "temp_mean", "bin_switches",
                                   "bank_heat")


def _campaign_specs(env):
    """The phase's campaigns: the Fig. 4 pool (70 traces x 8192) under
    DDR3-1600 and the 55C set, and the thermal path's adaptive campaign
    (70 traces x 4096, the deployed module stack, 4 + 4 scenarios),
    each over a materialized pool or the declarative `synth_spec`; FCFS,
    so the prepass does not dominate."""
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core import timing as T
    from repro_torch.core.aldram import default_scenarios
    from repro_torch.core.sim_engine import SimSpec

    rows = T.stack_timing([T.DDR3_1600, T.ALDRAM_55C_EVAL])
    stack, edges = env["ctrl"].table.safe_stack()
    scns = default_scenarios()
    tspec = TH.ThermalSpec(scns + tuple(x.oracle() for x in scns),
                           tuple(edges.tolist()), TH.ThermalConfig())
    out = {}
    for tag, n in (("static", 8192), ("adaptive", 4096)):
        kw = (dict(timings=rows) if tag == "static" else
              dict(timings=stack[None], thermal=tspec))
        out[tag] = SimSpec(traces=perf_model.trace_batch(n, SEED,
                                                         device="cuda"), **kw)
        out[tag + " declarative"] = SimSpec(
            traces=perf_model.synth_spec(n, SEED), **kw)
    return out


def campaign_engine(env) -> None:
    """Phase 6d: the campaign engine on the card, launch counts reset
    just before and read just after — the campaign mesh (one-entry and a
    3-entry mesh repeating the card: T = 70 pads to 72), the
    declarative pool (drawn by its first run, replayed from its cache by
    the next), the replay tuner over its CUDA candidates and the
    guardband's design point (`margin_grid` at 1 x 1, 26 launches);
    every sharded, declarative and tuned output bitwise the unsharded,
    materialized default run's."""
    import numpy as np
    import torch
    from repro_torch.core import guardband, perf_model
    from repro_torch.core import timing as T
    from repro_torch.core.autotune import ReplayTuner
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.sim_engine import SimEngine
    from repro_torch.core.variation import compound_quantile
    from repro_torch.launch.mesh import make_campaign_mesh

    specs = _campaign_specs(env)
    bracket_args = dict(base_row=T.DDR3_1600.as_row(), n_real=4)
    reset_counts()
    t_phase = time.perf_counter()
    base = {k: SimEngine(device="cuda").run(specs[k])
            for k in ("static", "adaptive")}
    base_br = SimEngine(device="cuda").run_bracket(specs["adaptive"],
                                                   **bracket_args)
    meshes = {1: make_campaign_mesh(1),
              3: make_campaign_mesh(devices=["cuda:0"] * 3)}
    runs = (("static", 1), ("static", 3), ("adaptive", 3), ("bracket", 3))
    for kind, k in runs:
        eng = SimEngine(device="cuda", mesh=meshes[k])
        l0 = read_counts()
        if kind == "bracket":
            out, secs = wall(lambda: eng.run_bracket(specs["adaptive"],
                                                     **bracket_args))
            bad, tot = _differing(_bracket_fields(out),
                                  _bracket_fields(base_br))
        else:
            out, secs = wall(lambda: eng.run(specs[kind]))
            names = STATIC_FIELDS if kind == "static" else ADAPTIVE_FIELDS
            bad, tot = _differing(_fields(out, names),
                                  _fields(base[kind], names))
        l1 = read_counts()
        dl = {v: l1[v] - l0[v] for v in l1 if l1[v] != l0[v]}
        print(f"campaign mesh {kind} shards={k} shard_shape="
              f"{eng.shard_shape}: {bad} differing (of {tot}) against the "
              f"unsharded run; {eng.dispatch_count} dispatch, launches "
              f"{json.dumps(dl)}, {secs:.3f} s")
        check(bad == 0, f"campaign mesh {kind} x{k}: {bad} differ")
        check(eng.dispatch_count == 1, f"{kind}: {eng.dispatch_count}")
        check(eng.shard_shape[:2] == (k, -(-70 // k)), str(eng.shard_shape))
        kern = "adaptive_blocks (a)" if kind != "static" else \
            "replay_blocks (a)"
        check(dl.get(kern, 0) == k, f"{kind} x{k}: launches {dl}")

    for kind in ("static", "adaptive"):
        spec = specs[kind + " declarative"]
        names = STATIC_FIELDS if kind == "static" else ADAPTIVE_FIELDS
        for run in ("first", "second"):
            eng = SimEngine(device="cuda")
            with perf_model.synth_dispatch_scope() as scope:
                out, secs = wall(lambda: eng.run(spec))
            bad, tot = _differing(_fields(out, names),
                                  _fields(base[kind], names))
            print(f"campaign declarative {kind} {run} run (synth_spec, n="
                  f"{spec.traces.n}): {bad} differing (of {tot}) against "
                  f"trace_batch; dispatches +{eng.dispatch_count}, "
                  f"syntheses +{scope.count}, {secs:.3f} s")
            want = 1 if run == "first" else 0     # drawn once, then cached
            check(bad == 0 and eng.dispatch_count == 1
                  and scope.count == want,
                  f"declarative {kind} {run}: {bad} differ, "
                  f"{eng.dispatch_count} dispatches, {scope.count} syntheses")

    tune_path = ROOT / "chiprun_out" / "replay_tune_cuda.json"
    tune_path.parent.mkdir(exist_ok=True)
    tuner = ReplayTuner(platform="cuda", path=str(tune_path))
    for kind in ("static", "adaptive"):
        spec = specs[kind + " declarative"]
        eng = SimEngine(device="cuda", backend="auto", tuner=tuner)
        (win, secs) = wall(lambda: eng.autotune(spec, reps=3))
        key = tuner.table._bin(tuner._condition(eng._tuner_key(spec)[1]))
        times = tuner.timings[(eng._tuner_key(spec)[0], key)]
        names = STATIC_FIELDS if kind == "static" else ADAPTIVE_FIELDS
        ref = _fields(base[kind], names)
        worst = 0
        for cfg in tuner.candidates:
            worst = max(worst, _differing(
                _fields(eng.run(spec, config=cfg), names), ref)[0])
        auto = _differing(_fields(eng.run(spec), names), ref)[0]
        print(f"campaign tuner {kind}: candidates " + "; ".join(
            f"{c.backend} lanes={c.block_rows or 'default'}: {t:.4f} s"
            for c, t in zip(tuner.candidates, times))
              + f" -> winner {win}; {worst} differing in the worst "
              f"candidate, {auto} in the backend='auto' run; "
              f"{eng.dispatch_count} dispatches, {secs:.3f} s")
        check(worst == 0 and auto == 0, f"tuner {kind}: {worst}, {auto}")
    check(tune_path.exists(), "the tuner table was not written")

    (q_card, secs) = wall(lambda: guardband.design_quantile(
        CALIBRATED_CONSTANTS, device="cuda"))
    q_cpu = guardband.design_quantile(CALIBRATED_CONSTANTS, device="cpu")
    realised = float(compound_quantile(env["pop"].cells,
                                       CALIBRATED_VARIATION).max())
    table = env["ctrl"].table
    same = True
    for floor in (table.safe_stack()[0], table.safe_stack_banks()[0]):
        rows = floor
        for _ in range(3):
            rows, _ = guardband.tighten_rows(rows)
        for _ in range(5):
            rows = guardband.relax_rows(rows, floor)
        same &= bool(np.array_equal(rows, floor))
    launches = read_counts()
    print(f"guardband: design quantile {q_card:.7f} on the card, "
          f"{q_cpu:.7f} on the CPU (|diff| {abs(q_card - q_cpu):.2e}, one "
          f"bisection step {8 / 2 ** 24:.2e}); realised over the 115 "
          f"modules {realised:.5f}; margin_grid launches "
          f"{launches['margin_grid']} ({secs:.3f} s); tighten x3 / relax x5 "
          f"on the module and per-bank stacks is the identity: {same}")
    check(q_card > realised, f"design {q_card} <= realised {realised}")
    check(abs(q_card - q_cpu) <= 8 / 2 ** 24, f"{q_card} vs {q_cpu}")
    check(launches["margin_grid"] == 26, str(launches))
    check(same, "tighten / relax round trip moved a row")
    print(f"campaign engine path kernels: {json.dumps(launches)}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    env.update(launches_campaign=launches)
    campaign_block_lanes(env)


def paired_ms(fns: dict, rounds: int) -> dict:
    """Paired, interleaved CUDA-event timings: each round calls every
    entry of `fns` once (after one warm-up call each), in an order
    rotated by one each round, with a synchronize around every call.
    Per key: the median call time in ms, and the median and the 10th /
    90th percentiles of the per-round ratio to the first key's call."""
    import numpy as np
    import torch
    keys = list(fns)
    for k in keys:
        fns[k]()
    torch.cuda.synchronize()
    t = {k: [] for k in keys}
    for r in range(rounds):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[k]()
            e1.record()
            e1.synchronize()
            t[k].append(e0.elapsed_time(e1))
    base = np.array(t[keys[0]])
    out = {}
    for k in keys:
        ratio = np.array(t[k]) / base
        out[k] = {"ms": float(np.median(t[k])),
                  "ratio": float(np.median(ratio)),
                  "ratio_p10": float(np.percentile(ratio, 10)),
                  "ratio_p90": float(np.percentile(ratio, 90))}
    return out


def _print_caps(label: str, times: dict, outs: dict, plan_fn) -> None:
    """One line per explicit cap: its paired time and ratio to the
    default block, the launch plan, and the elements that differ from
    the default block's outputs (which must be none)."""
    import torch
    for cap in BLOCK_CAPS[1:]:
        bad = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for a, b in zip(outs[cap], outs[None]))
        tc, td = times[cap], times[None]
        print(f"lanes per block {cap}: {label}: {tc['ms']:.4f} ms (default "
              f"block {td['ms']:.4f} ms; paired ratio {tc['ratio']:.3f}, "
              f"p10-p90 {tc['ratio_p10']:.3f}-{tc['ratio_p90']:.3f}); plan "
              f"{json.dumps(plan_fn(cap))}; {bad} elements differ from the "
              "default block")
        check(bad == 0, f"{label} at {cap} lanes: {bad} differ")


def campaign_block_lanes(env) -> None:
    """Phase 6d, its kernel times: replay_blocks (a) and adaptive_blocks
    (a) at 32, 64 and 128 chain lanes per block against the kernels' own
    choice, at chip_smoke's shapes (the Fig. 4 pool at 2 timing rows;
    the thermal campaign's 8 lanes), at the fault campaigns' lane counts
    (66 rows; 72 lanes) and at 128 (one full default block a cell, 70
    blocks on 132 SMs, which a cap spreads over more SMs): each bitwise
    the default block, with paired, interleaved CUDA-event times
    (`paired_ms`, 31 rounds) beside its chain bound."""
    import numpy as np
    import torch
    from repro_torch.core import thermal as TH
    from repro_torch.core import timing as T
    from repro_torch.kernels.replay import ops, ref

    dev = torch.device("cuda")
    rows2 = T.stack_timing([T.DDR3_1600, T.ALDRAM_55C_EVAL])
    stack, edges = env["ctrl"].table.safe_stack()
    scns = TH.stack_scenarios(_campaign_specs_scenarios())
    for n, s in ((8192, 2), (4096, 66), (4096, 128)):
        cells = _campaign_cells(n)
        tim = torch.tensor(np.tile(rows2, (s // 2, 1)), device=dev)
        tim_t = tim.T.contiguous()
        fns = {cap: (lambda c=cap: ops.replay_blocks(
            *cells, tim_t, validated=True, block_lanes=c))
            for cap in BLOCK_CAPS}
        outs = {cap: fn() for cap, fn in fns.items()}
        times = paired_ms(fns, LANES_ROUNDS)
        _print_caps(f"replay_blocks (a) G=70 N={n} S={s}", times, outs,
                    lambda c: ops.replay_plan(s, 8, 8, 0, False,
                                              block_lanes=c))
        chain_bound("2a", n, times[None]["ms"])
    for lanes in (8, 72, 128):
        cells = _campaign_cells(4096)
        k = lanes // 8
        tabs = ref.table_tile(ref.lane_tables(torch.tensor(
            np.repeat(stack[None], k, 0), device=dev), 8))
        scn = ref.lane_scenarios(torch.tensor(scns, device=dev), k).T \
            .contiguous()
        bins = torch.tensor(edges, dtype=torch.float32, device=dev)
        tcfg = torch.tensor(TH.ThermalConfig().as_row(), device=dev)
        fns = {cap: (lambda c=cap: ops.adaptive_blocks(
            *cells, tabs, scn, bins, tcfg, validated=True, block_lanes=c))
            for cap in BLOCK_CAPS}
        outs = {cap: fn()[:6] for cap, fn in fns.items()}
        times = paired_ms(fns, LANES_ROUNDS)
        plan = ops.adaptive_plan(lanes, len(edges), len(edges) + 1, 8, 8,
                                 False, False, False)
        _print_caps(f"adaptive_blocks (a) G=70 N=4096 L={lanes}", times, outs,
                    lambda c: ops.adaptive_plan(
                        lanes, len(edges), len(edges) + 1, 8, 8, False,
                        False, False, block_lanes=c))
        chain_bound("3a", 4096, times[None]["ms"], n_edges=len(edges),
                    table="smem" if plan["tables_staged"] else "l1")


def _campaign_specs_scenarios():
    from repro_torch.core.aldram import default_scenarios
    scns = default_scenarios()
    return scns + tuple(x.oracle() for x in scns)


def cross_device_engine() -> None:
    """Phase 8f: the campaign engine at --fast scale on the card and on
    the CPU, static and adaptive over a declarative axis of the pool's
    first 13 traces (`synth_spec(n=1024)`):
    on each device the 3-entry mesh (cuda:0 or cpu, repeated), the
    bracket on it and every tuner candidate of the platform bitwise the
    device's unsharded materialized default run; across the devices
    the static runs and the bracket's static half bitwise and its worst
    bins equal (the closed loop senses through `sin` / `exp`, whose
    last bits differ between the card and the CPU: phase 8b holds its
    bins; here the adaptive means' largest relative difference is
    printed)."""
    import numpy as np
    from repro_torch.core import perf_model
    from repro_torch.core import thermal as TH
    from repro_torch.core import timing as T
    from repro_torch.core.autotune import ReplayTuner
    from repro_torch.core.dram_sim import Policy
    from repro_torch.core.sim_engine import SimEngine, SimSpec
    from repro_torch.launch.mesh import make_campaign_mesh

    pool = perf_model.synth_spec(1024, SEED)
    synth = dataclasses.replace(pool, **{       # 13 traces: pads to 15
        f: getattr(pool, f)[:13] for f in ("offsets", "row_hits",
                                            "write_fracs", "inter_arrivals")})
    rows = T.stack_timing([T.DDR3_1600, T.ALDRAM_55C_EVAL])
    tab = np.stack([T.ALDRAM_55C_EVAL.as_row(), T.DDR3_1600.as_row()])[None]
    tspec = TH.ThermalSpec(_campaign_specs_scenarios(), (55.0,),
                           TH.ThermalConfig())
    pols = (Policy(), Policy(reorder_window=8))
    kw = {"static": dict(timings=rows, policies=pols),
          "adaptive": dict(timings=tab, thermal=tspec, policies=pols)}
    out, within = {}, {}
    for dev in ("cuda", "cpu"):
        mesh = make_campaign_mesh(
            devices=["cuda:0" if dev == "cuda" else "cpu"] * 3)
        t0 = time.perf_counter()
        res = {}
        for kind, k in kw.items():
            names = STATIC_FIELDS if kind == "static" else ADAPTIVE_FIELDS
            base = _fields(SimEngine(device=dev).run(SimSpec(
                traces=synth.materialize(dev), **k)), names)
            res[kind] = base
            spec = SimSpec(traces=synth, **k)
            runs = {"mesh": SimEngine(device=dev, mesh=mesh).run(spec)}
            for i, cfg in enumerate(ReplayTuner(platform=dev,
                                                path="").candidates):
                runs[f"candidate {i}"] = SimEngine(device=dev).run(
                    spec, config=cfg)
            for name, r in runs.items():
                within[f"{dev} {kind} {name}"] = _differing(
                    _fields(r, names), base)[0]
        br = {m: _bracket_fields(SimEngine(device=dev, mesh=m).run_bracket(
            SimSpec(traces=synth, **kw["adaptive"]), T.DDR3_1600.as_row()))
            for m in (None, mesh)}
        within[f"{dev} bracket mesh"] = _differing(br[mesh], br[None])[0]
        res["bracket"] = br[None]
        out[dev] = (res, time.perf_counter() - t0)
    g, c = out["cuda"][0], out["cpu"][0]
    static_bad = _differing(g["static"], c["static"])[0]
    br_static = {k: v for k, v in g["bracket"].items()
                 if k.startswith("static.") or k == "worst_bin"}
    bracket_bad = _differing(br_static, c["bracket"])[0]
    rel = float(np.abs(g["adaptive"]["mean_latency_ns"]
                       / c["adaptive"]["mean_latency_ns"] - 1.0).max())
    print(f"cross-device engine --fast (3-entry mesh, 13 traces of "
          f"synth_spec n=1024, "
          f"every candidate): differing elements on each device "
          f"{json.dumps(within)}; card vs CPU: static {static_bad}, "
          f"bracket static half and worst bins {bracket_bad}, adaptive "
          f"means max rel diff {rel:.3e}; card {out['cuda'][1]:.2f} s, CPU "
          f"{out['cpu'][1]:.2f} s")
    check(all(v == 0 for v in within.values()),
          "a sharded, declarative or tuned run differs from its device's "
          "default")
    check(static_bad == 0 and bracket_bad == 0,
          "card and CPU campaign engines differ")


# ------------------------------------------------------------ fleet path

FLEET_POLICIES = ("static", "error", "periodic")


def _fleet_spec():
    """`examples/aldram_fleet.py`'s fleet-month at full width: 30 daily
    epochs at 48C, the chiller failing (+9C) at epoch 15, module 3 dead
    at epoch 10, workload rows (0, 17, 19) x 1,024 requests."""
    from repro_torch.core.thermal import cooling_failure
    from repro_torch.fleet.recal import FleetSpec
    return FleetSpec(n_epochs=30,
                     ambient=cooling_failure(48.0, 9.0, at_ns=15 * 1.0e4),
                     ambient_step_ns=1.0e4, workload_rows=(0, 17, 19),
                     n_requests=1024, module_failures=((10, 3),), seed=SEED)


def fleet_path(env) -> None:
    """Phase 6e: the fleet recalibration service at full width on the
    main path's population (115 modules, 176,640 cells, the 1.25 ns
    grid, five bins), launch counts reset just before and read just
    after: `autotune_epoch` records the epoch campaign's CUDA candidate
    first (not counted), then one fleet-month per policy through a
    `backend="auto"` engine — the profile, 30 epochs of drift, scrub
    (`ErrorMonitor.probe`: margin_grid), policy reaction and ONE replay
    (replay_blocks (b)) each; then the error policy's first 10 epochs
    once more under `torch.profiler` for the busy share."""
    from repro_torch.core.autotune import ReplayTuner
    from repro_torch.core.calibration import (CALIBRATED_CONSTANTS,
                                              CALIBRATED_VARIATION)
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.sim_engine import SimEngine
    from repro_torch.fleet.recal import FleetEngine, frontier
    from repro_torch.kernels.replay import ops as replay_ops

    pop, spec = env["pop"], _fleet_spec()
    prof = Profiler(CALIBRATED_CONSTANTS, grid_step=1.25, device="cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tuner = ReplayTuner(platform="cuda",
                        path=str(out_dir / "fleet_tune_cuda.json"))
    sim = SimEngine(device="cuda", backend="auto", tuner=tuner)

    def engine(policy, **kw):
        return FleetEngine(pop, dataclasses.replace(spec, policy=policy, **kw),
                           var_cfg=CALIBRATED_VARIATION, profiler=prof,
                           sim=sim, device="cuda")

    winner, t_tune = wall(lambda: engine("static").autotune_epoch(reps=3))
    print(f"fleet autotune_epoch: winner {winner} ({t_tune:.3f} s; table "
          f"{json.dumps({f'{u},{b}': int(v) for (u, b), v in tuner.table._table.items()})})")
    reset_counts()
    res, secs, mlog, replay = {}, {}, [], {}
    with margin_log(mlog), first_call(replay_ops, "replay_grid", replay):
        for p in FLEET_POLICIES:
            res[p], secs[p] = wall(engine(p).run)
    launches = read_counts()
    shapes = margin_shapes(mlog)
    fr = frontier(res)
    for p, r in res.items():
        s = r.summary()
        print(f"fleet {p}: {secs[p]:.3f} s = {secs[p] / spec.n_epochs:.4f} "
              f"s/epoch; " + json.dumps(
                  {k: v for k, v in s.items() if k != "policy"}))
        print(f"  recal epochs {r.recal_epochs} relax {r.relax_epochs} "
              f"rejected {r.relax_rejected}; frontier "
              f"{json.dumps(fr['policies'][p])}")
    print("fleet path kernels: " + json.dumps(launches))
    print(f"fleet margin_grid calls by shape (margin_sweep calls, CUDA "
          f"events): {json.dumps(shapes)}; first replay: timings "
          f"{list(replay['timings'].shape)}, streams "
          f"{list(replay['arrival'].shape)}, block_lanes "
          f"{replay['block_lanes']}")
    n_margin = sum(r.margin_dispatches for r in res.values())
    check(all(r.replay_dispatches == spec.n_epochs for r in res.values()),
          f"replays per epoch: "
          f"{[r.replay_dispatches for r in res.values()]}")
    check(res["error"].summary()["total_unc"] == 0.0,
          f"error policy served {res['error'].summary()['total_unc']} "
          "uncorrectable events")
    check(launches["replay_blocks (b)"] == spec.n_epochs * len(res)
          and all(v == 0 for k, v in launches.items()
                  if k not in ("margin_grid", "replay_blocks (b)")),
          f"replay launches {launches}")
    # `margin_dispatches` counts from after each month's first profile
    # (one refresh and one timing launch)
    check(launches["margin_grid"] == n_margin + 2 * len(res) > 2 * len(res),
          f"margin_grid launches {launches['margin_grid']} vs "
          f"{n_margin} dispatches + {2 * len(res)} first profiles")
    check(shapes["campaign"]["launches"] + shapes["other"]["launches"]
          == launches["margin_grid"],
          f"margin shapes {shapes}, launches {launches['margin_grid']}")
    env.update(launches_fleet=launches, fleet_seconds=secs,
               margin_shapes_fleet=shapes,
               margin_small_fleet=small_grid_inputs(mlog),
               fleet_replay=replay)

    short = engine("error", n_epochs=10)
    busy_share("fleet path (error policy, 10 epochs)", short.run)


def cross_device_fleet(env) -> None:
    """Phase 6f: `fleet_bench`'s --fast configuration (8 modules x 4
    cells, the 2.5 ns grid, rows (0, 19) x 512, 30 epochs, three
    policies), a 10-epoch regions=4 fleet and a 10-epoch faulted fleet,
    on the card (launch counts reset just before and read just after)
    and on the CPU from the same cells, trace pool and error uniforms:
    equal telemetry, or a divergence that only cells within 2e-4 of
    zero explain (`port_fleet_bench.compare`, printed with both
    margins); the bench's bracket on the card."""
    from benchmarks import port_fleet_bench as PFB
    from benchmarks.port_common import profiler
    from repro_torch.core import faults as F
    from repro_torch.core import perf_model
    from repro_torch.fleet.recal import frontier

    var_cfg, spec = PFB.config(True)
    base = dict(pop=PFB.population(var_cfg, device="cpu"), var_cfg=var_cfg,
                profiler=profiler(True, "cpu"),
                traces=perf_model.trace_batch(spec.n_requests, spec.seed,
                                              device="cpu"))
    fa = F.FaultSpec(scenarios=(F.FaultScenario(
        name="err", err_scale=1.0, err_free_red=0.0, detect_frac=0.9,
        retry_ns=60.0),), seed=5)
    short = dataclasses.replace(spec, n_epochs=10)
    cases = {"--fast": dict(base, spec=spec),
             "regions=4": dict(base, spec=dataclasses.replace(short,
                                                              regions=4)),
             "faulted": dict(base, spec=dataclasses.replace(short, faults=fa),
                             fault_uniforms=F.fault_uniforms(
                                 5, len(spec.workload_rows),
                                 spec.n_requests, device="cpu"))}
    reset_counts()
    card = PFB.fleet_runs(cases, "cuda")
    launches = read_counts()
    out = PFB.cross_device(cases, card=card)
    bad = []
    for name, o in out.items():
        for p, rep in o["reports"].items():
            g, c = o["card"][p].summary(), o["cpu"][p].summary()
            dv = rep["divergence"]
            print(f"cross-device fleet {name} {p}: "
                  + ("no differing scrub or profile" if dv is None else
                     f"first differing {dv['kind']} at epoch {dv['epoch']} "
                     f"(call {dv['call']}): {dv['why']}")
                  + f"; {rep['compared_epochs']} epochs compared, differing "
                  f"fields {rep['differing_fields']}; unc {g['total_unc']} / "
                  f"{c['total_unc']}, detected {g['total_served_detected']}"
                  f" / {c['total_served_detected']}")
            for cell in (dv or {}).get("cells", []):
                print(f"  sign differs: {json.dumps(cell)}")
            if not rep["ok"]:
                bad.append((name, p))
        print(f"cross-device fleet {name}: card {o['seconds']['cuda']:.2f} "
              f"s, CPU {o['seconds']['cpu']:.2f} s")
    fr = frontier(out["--fast"]["card"])["policies"]
    print("cross-device fleet path kernels (card): " + json.dumps(launches))
    print("fleet_bench bracket on the card: " + json.dumps(
        {p: {k: fr[p][k] for k in ("eff_reduction", "total_unc")}
         for p in fr}))
    check(not bad, f"card and CPU fleets differ beyond the near-zero rule: "
          f"{bad}")
    check(all(r.replay_dispatches == r.spec.n_epochs
              for o in out.values() for r in o["card"].values()),
          "a card fleet served more or less than one replay an epoch")
    check(fr["error"]["total_unc"] == 0.0 and fr["static"]["total_unc"] > 0.0
          and fr["error"]["eff_reduction"] > fr["static"]["eff_reduction"],
          f"fleet_bench bracket on the card: {fr}")
    # one launch of the case's variant per epoch and policy; one
    # margin_grid launch per dispatch after each month's first profile,
    # two for that profile (a refresh and a timing launch)
    months = [r for o in out.values() for r in o["card"].values()]
    want = {f"replay_blocks ({v})": sum(r.spec.n_epochs
                                        for r in out[c]["card"].values())
            for v, c in (("b", "--fast"), ("c", "regions=4"),
                         ("e", "faulted"))}
    want["margin_grid"] = sum(r.margin_dispatches + 2 for r in months)
    check(all(v > 0 for v in want.values())
          and all(launches[k] == want.get(k, 0) for k in launches),
          f"fleet launches {launches}, expected {want} and 0 elsewhere")
    env.update(launches_fleet_fast=launches)


# --------------------------------------------------------- figure drivers

# margin_grid launches of phase 6g's drivers: fig2_refresh 1 (refresh),
# fig2_timing 2 and multi_timing 2 (refresh + one campaign), repeatability
# 1, calibration.evaluate 2
FIGURES_MARGIN_LAUNCHES = 8


def figures_path(env) -> None:
    """Phase 6g: the paper-figure drivers at full width on the main
    path's population (nothing sampled or profiled again), launch counts
    reset just before and read just after; the totals add the drivers
    phases 4 and 5 ran on their campaigns (thermal_bench per-module and
    per-bank, fig_bank, fig_region), which are not run twice."""
    from benchmarks import (port_fig2_refresh, port_fig2_timing,
                            port_multi_timing, port_power_bench,
                            port_repeatability, port_sim_bench)
    from repro_torch.core import calibration as C
    from repro_torch.kernels.charge_sim import ops as margin_ops
    from repro_torch.kernels.replay import ops as replay_ops

    pop = env["pop"]
    earlier = dict(env.get("figure_drivers", {}))
    reset_counts()
    runs, mlog, replay = {}, [], {}
    # multi_timing makes the path's first replay_grid call
    with margin_log(mlog), first_call(replay_ops, "replay_grid", replay):
        for name, fn in (
                ("fig2_refresh", lambda: port_fig2_refresh.run(pop=pop)),
                ("fig2_timing", lambda: port_fig2_timing.run(pop=pop)),
                ("multi_timing", lambda: port_multi_timing.run(pop=pop)),
                ("repeatability", lambda: port_repeatability.run(pop=pop)),
                ("power", port_power_bench.run),
                # its reference pipeline is a pure-Python FR-FCFS loop over
                # 70 x N requests: the full 8,192 is a port_run.py run
                ("sim_bench --fast", lambda: port_sim_bench.run(True)),
                ("calibration", lambda: C.evaluate(
                    C.CALIBRATED_CONSTANTS, C.CALIBRATED_VARIATION, fast=False,
                    pop=pop))):
            runs[name], _, _ = driver_run(env, name, fn)
    launches = read_counts()
    shapes = margin_shapes(mlog)
    grids = small_grid_inputs(mlog, skip=())
    small = {k: v for k, v in grids.items()
             if k[0] * k[1] < margin_ops.SEARCH_MIN_ELEMS}
    drivers = env["figure_drivers"]
    total: dict = {}
    for d in drivers.values():
        for k, v in d["launches"].items():
            total[k] = total.get(k, 0) + v

    stats = runs["calibration"]
    print("calibration.evaluate (115 modules, 1.25 ns grid): " + json.dumps(
        {"stats": stats, "residuals": C.residuals(stats),
         "loss": C.loss(stats)}))
    for name, d in drivers.items():
        where = "phase 4/5" if name in earlier else "6g"
        print(f"figures {name} ({where}): {d['seconds']:.3f} s, launches "
              f"{json.dumps(d['launches'])}")
    print("figures path kernels (6g): " + json.dumps(launches))
    by_shape = {f"{n} x {m}": c for (n, m), (*_, c) in grids.items()}
    print(f"figures margin_grid calls by shape: {json.dumps(by_shape)}; "
          f"first replay: timings {list(replay['timings'].shape)}, streams "
          f"{list(replay['arrival'].shape)}")
    print("figures path kernels (6g + the drivers of phases 4-5): "
          + json.dumps(total))

    check(all(math.isfinite(v) for v in stats.values()), str(stats))
    check(math.isfinite(C.loss(stats)), "calibration loss not finite")
    check(runs["multi_timing"]["dispatches"] == {"replay": 1},
          str(runs["multi_timing"]["dispatches"]))
    check(runs["repeatability"]["dispatches"] == {"margin": 1},
          str(runs["repeatability"]["dispatches"]))
    check(launches["margin_grid"] == FIGURES_MARGIN_LAUNCHES,
          f"margin_grid launches {launches['margin_grid']}")
    check(set(earlier) == {"thermal_bench", "thermal_bench per-bank",
                           "fig_bank", "fig_region"},
          f"phases 4-5 drivers {sorted(earlier)}")
    check(all(total.get(k, 0) > 0 for k in (
        "margin_grid", "replay_blocks (a)", "replay_blocks (b)",
        "replay_blocks (c)", "adaptive_blocks (a)", "adaptive_blocks (b)")),
          f"a kernel of the figure drivers never launched: {total}")
    check(sum(c for *_, c in grids.values()) == launches["margin_grid"],
          f"margin shapes {shapes}, launches {launches['margin_grid']}")
    env.update(launches_figures=launches, margin_shapes_figures=shapes,
               margin_small_figures=small,
               margin_keyed_figures={k: v for k, v in grids.items()
                                     if k not in small},
               figures_replay=replay)


# ------------------------------------------------------------ serve path

SERVE_ARCH = "glm4-9b"
SERVE_PROMPTS = (4096, 2000, 1300, 700)   # tokens; two slots admit mid-run
SERVE_NEW_TOKENS = 16
SERVE_MAX_LEN = 8192
TIE_GAP = 1e-3        # a top-2 logit gap below this may flip a token
LOGIT_TOL = 1e-3      # kernels vs plain last-token logits, max abs
# jamba-1.5-large at full width, cut to one period of its 7 : 1 Mamba :
# attention pattern, without its experts: a full-width period holds four
# MoE layers of 38.6 GB each (16 experts of 3 x 8192 x 24576 float32
# weights), which the card's 80 GB cannot hold
JAMBA_CUT = {"n_layers": 8, "n_experts": 0, "top_k": 0}
# (b, s, hq, hkv, d, window): glm4-9b's prefill, an unaligned prompt,
# gemma3-12b's local and global layers, musicgen's MHA, a batched GQA
FLASH_SHAPES = {"glm4 4096": (1, 4096, 32, 2, 128, None),
                "glm4 2000": (1, 2000, 32, 2, 128, None),
                "gemma3 local 4096": (1, 4096, 16, 8, 256, 1024),
                "gemma3 global 4096": (1, 4096, 16, 8, 256, None),
                "musicgen 2048": (1, 2048, 32, 32, 64, None),
                "batched 2x1024": (2, 1024, 8, 2, 128, None)}
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # tests/test_kernels.py
# (atol, rtol) held within the reference's bounds, against the plain
# version in the kernel's own math (float32 on the same inputs, the
# result rounded to the input dtype): the float32 bound of
# tests/test_torch_serve.py against the oracle, and about 2 bfloat16 ulps
# (the bf16 plain version rounds scores and probabilities to bf16, so it
# sits up to ~1e-2 off the float32 math: only the reference's bound holds
# against it)
FLASH_TIGHT = {"float32": (1e-5, 0.0), "bfloat16": (1e-3, 1.6e-2)}


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


@contextlib.contextmanager
def plain_serve():
    """The three serve kernel wrappers (flash attention, WKV, selective
    scan) swapped for their plain versions while the block runs.  Here
    only: the port has no such switch."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref

    swaps = ((flash_ops, "flash_attention", flash_ref.flash_attention),
             (wkv_ops, "wkv", wkv_ref.wkv),
             (scan_ops, "mamba_scan", scan_ref.mamba_scan))
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _serve(params, cfg, prompts, plain: bool, replay: dict | None = None
           ) -> dict:
    """Serve `prompts` through `ServeEngine` (2 slots): per request its
    tokens and each token's top-2 logit gap, each prefill's last-token
    logits, wall seconds and launches per serve kernel, and each decode
    tick's; for a config with experts, each prefill's routing
    (`moe_routing`), which `replay` (another run's) forces.  `plain=True`
    serves through the plain versions of the three serve kernels
    (`plain_serve`)."""
    import torch
    from repro_torch.serve.engine import Request, ServeEngine

    rec = {"prefill": [], "decode": [], "logits": {}, "gaps": {},
           "routes": {}}
    cur = {"rid": None}
    fns = _serve_fns()

    def counts():
        return {name: fn.launches for name, fn in fns.items()}

    def delta(c0):
        return {name: n - c0[name] for name, n in counts().items()}

    class Timed(ServeEngine):
        def _prefill_into(self, slot, req):
            self.current = req
            cur["rid"] = req.rid
            c0 = counts()
            _, t = wall(lambda: ServeEngine._prefill_into(self, slot, req))
            cur["rid"] = None
            rec["prefill"].append((req.rid, len(req.prompt), t, delta(c0)))

        def _decode(self, tokens, pos):
            c0 = counts()
            out, t = wall(lambda: ServeEngine._decode(self, tokens, pos))
            rec["decode"].append((t, delta(c0)))
            return out

    eng = Timed(params, cfg, batch_slots=2, max_len=SERVE_MAX_LEN,
                dtype=torch.float32, device="cuda")

    def sampler(logits, _k):
        top = logits.topk(2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).cpu().numpy()
        if logits.shape[0] == 1:                      # a prefill
            rid = eng.current.rid
            rec["logits"][rid] = logits[0].cpu()
            rec["gaps"][rid] = [float(gaps[0])]
        else:
            for s, req in enumerate(eng.active):
                if req is not None:
                    rec["gaps"][req.rid].append(float(gaps[s]))
        return logits.argmax(-1)

    eng.sampler = sampler
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, max_new_tokens=SERVE_NEW_TOKENS))
    with (plain_serve() if plain else contextlib.nullcontext(),
          moe_routing(cur, rec["routes"], replay) if cfg.n_experts
          else contextlib.nullcontext()):
        done, secs = wall(eng.run_until_drained)
    rec["out"] = {r.rid: list(r.out) for r in done}
    rec["seconds"] = secs
    del eng
    torch.cuda.empty_cache()
    return rec


def _mixer_layers(cfg) -> dict:
    """Layers per mixer kind: attention (local or global), rwkv6, mamba."""
    group = cfg.group_spec()
    reps = cfg.n_layers // len(group)
    kinds = [{"attn_local": "attn"}.get(s.mixer, s.mixer) for s in group]
    return {k: reps * kinds.count(k) for k in ("attn", "rwkv6", "mamba")}


def _serve_model(cfg) -> dict:
    """One serve phase at full width (float32, random seeded weights,
    TF32 off): `cfg` served through `ServeEngine` (its prefill through
    the kernels), launch counts reset just before and read just after;
    then the same requests through the plain path, compared token for
    token, and last-token logits within LOGIT_TOL where every prefill
    token was routed alike; for a config with experts, the routing
    choices that differ are counted per request and the plain path
    serves once more with the kernel path's prefill routes forced, its
    logits within LOGIT_TOL on every request (a flipped top-k choice
    moves logits by a step, not by rounding); then one short run under
    `torch.profiler`.  Every serve kernel
    must have been launched exactly as the config's layers say: flash
    once per attention layer and prefill, wkv once per RWKV6 layer and
    prefill, mamba_scan once per Mamba layer and prefill or decode tick,
    and nothing else."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TF

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matrix products are on: float32 would not mean float32")
    params, init_s = wall(lambda: TF.init_params(
        torch.Generator("cuda").manual_seed(SEED), cfg, device="cuda"))
    n_params = sum(t.numel() for t in _tree_leaves(params))
    n_tree = sum(t.numel() for t in _tree_leaves(TF.init_params(
        torch.Generator(), cfg, device="meta")))
    print(f"serve {cfg.name}: {n_params / 1e9:.3f} B parameters (the "
          f"init_params tree {n_tree / 1e9:.3f} B; the config's "
          f"param_count() {cfg.param_count() / 1e9:.3f} B), float32 "
          f"{n_params * 4 / 1e9:.1f} GB, drawn on the card in {init_s:.2f} s")
    check(n_params == n_tree, f"{n_params} parameters, the tree {n_tree}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS]

    _serve_short(params, cfg, prompts[-1])      # warm-up: cuBLAS, caches
    reset_counts()
    fast = _serve(params, cfg, prompts, plain=False)
    launches = read_counts()
    plain = _serve(params, cfg, prompts, plain=True)
    after_plain = read_counts()

    for name, r in (("kernels", fast), ("plain", plain)):
        n_tok = sum(len(o) for o in r["out"].values())
        n_prompt = sum(x[1] for x in r["prefill"])
        pre_s = sum(x[2] for x in r["prefill"])
        dec = [x[0] for x in r["decode"]]
        print(f"serve {cfg.name} {name}: {len(r['out'])} requests, "
              f"{r['seconds']:.3f} s wall, {n_tok} tokens out = "
              f"{n_tok / r['seconds']:.2f} tok/s; prefill {pre_s:.3f} s for "
              f"{n_prompt} prompt tokens = {n_prompt / pre_s:.1f} tok/s; "
              f"{len(dec)} decode ticks, {statistics.mean(dec) * 1e3:.2f} ms "
              f"mean ({min(dec) * 1e3:.2f}-{max(dec) * 1e3:.2f})")
        print(f"  prefill seconds: " + json.dumps(
            {f"req {rid} ({n})": round(t, 4)
             for rid, n, t, _ in r["prefill"]}))
    # served tokens equal, unless the plain path's top-2 gap is a near tie;
    # last-token logits within LOGIT_TOL where both paths routed every
    # prefill token alike (a flipped top-k choice moves them by a step)
    flips = _route_flips(fast["routes"], plain["routes"], len(prompts))
    near_ties, worst_logit, gaps_by_rid, alike = 0, 0.0, [], 0
    for rid in range(len(prompts)):
        a, b = fast["out"][rid], plain["out"][rid]
        gaps = plain["gaps"][rid]
        check(len(a) == len(b) == SERVE_NEW_TOKENS == len(gaps),
              f"req {rid}: {len(a)} / {len(b)} tokens, {len(gaps)} gaps")
        for t in range(len(b)):
            if gaps[t] < TIE_GAP:
                near_ties += 1
                break
            check(a[t] == b[t], f"{cfg.name} req {rid} token {t}: kernels "
                  f"{a[t]} != plain {b[t]} (plain top-2 gap {gaps[t]:.3e})")
        gaps_by_rid.append(float(
            (fast["logits"][rid] - plain["logits"][rid]).abs().max()))
        if not any(flips[rid]):
            alike += 1
            worst_logit = max(worst_logit, gaps_by_rid[-1])
    min_gap = min(min(g) for g in plain["gaps"].values())
    print(f"serve {cfg.name} kernels vs plain: tokens equal on "
          f"{len(prompts) - near_ties} of {len(prompts)} requests "
          f"({near_ties} not compared past a plain top-2 gap < {TIE_GAP:g}; "
          f"smallest gap {min_gap:.3e}); last-token logits within "
          f"{worst_logit:.3e} (max abs) on the {alike} prefills whose "
          "routes agree")
    if cfg.n_experts:
        # the plain path again, with the kernel path's prefill routes
        # forced: what is left between the two is the kernels' rounding
        forced = _serve(params, cfg, prompts, plain=True,
                        replay=fast["routes"])
        same = _route_flips(fast["routes"], forced["routes"], len(prompts))
        check(not any(n for pair in same for n in pair), "the forced routes "
              f"were not followed: {same}")
        forced_gaps = [float((fast["logits"][rid] - forced["logits"][rid])
                             .abs().max()) for rid in range(len(prompts))]
        for rid, ((n_exp, n_adm), gap, fgap) in enumerate(zip(
                flips, gaps_by_rid, forced_gaps)):
            print(f"serve {cfg.name} req {rid} ({len(prompts[rid])} tokens, "
                  f"{cfg.n_layers} MoE layers, top-{cfg.top_k}): kernels vs "
                  f"plain differ in {n_exp} expert choices and {n_adm} "
                  f"admitted (token, slot, expert, position) choices; "
                  f"last-token logits {gap:.3e} apart, {fgap:.3e} with the "
                  f"kernel path's routes forced on the plain path")
        worst_logit = max(worst_logit, *forced_gaps)
    check(worst_logit <= LOGIT_TOL, f"prefill logits differ by {worst_logit}")

    layers = _mixer_layers(cfg)
    n_pre, n_dec = len(fast["prefill"]), len(fast["decode"])
    want = {"flash_attention": (layers["attn"] * n_pre, 0),
            "wkv": (layers["rwkv6"] * n_pre, 0),
            "mamba_scan": (layers["mamba"] * n_pre, layers["mamba"] * n_dec)}
    by_phase = {}
    for kernel, (w_pre, w_dec) in want.items():
        pre_l = sum(x[3][kernel] for x in fast["prefill"])
        dec_l = sum(x[1][kernel] for x in fast["decode"])
        by_phase[kernel] = (pre_l, dec_l)
        print(f"serve {cfg.name} kernels: {kernel} {launches[kernel]} "
              f"launches ({pre_l} in {n_pre} prefills, {dec_l} in {n_dec} "
              f"decode ticks; expected {w_pre} + {w_dec}); plain run "
              f"{after_plain[kernel] - launches[kernel]}")
        check(launches[kernel] == pre_l + dec_l and (pre_l, dec_l)
              == (w_pre, w_dec), f"{kernel} launches {launches[kernel]} "
              f"(prefill {pre_l}, decode {dec_l}), expected {w_pre} + "
              f"{w_dec}")
        check(after_plain[kernel] == launches[kernel],
              f"the plain path launched {kernel}")
    check(all(v == 0 for k, v in launches.items() if k not in want),
          f"the serve path launched another kernel: {launches}")

    busy_share(f"serve path {cfg.name} (one 700-token request, 5 tokens "
               "out)", lambda: _serve_short(params, cfg, prompts[-1]))
    del params
    torch.cuda.empty_cache()
    return {"launches_serve": launches, "launches_by_phase": by_phase}


def serve_path() -> dict:
    """Phase 9: glm4-9b at full width through the flash prefill."""
    from repro_torch.configs import get_config
    return _serve_model(get_config(SERVE_ARCH))


def serve_rwkv6() -> dict:
    """Phase 13: rwkv6-3b at full width (32 RWKV6 layers: the WKV kernel
    in every prefill layer, the one-step recurrence in decode)."""
    from repro_torch.configs import get_config
    return _serve_model(get_config("rwkv6-3b"))


def serve_jamba() -> dict:
    """Phase 14: jamba-1.5-large at full width, without its experts and
    cut to one period of 8 layers (7 Mamba: the selective-scan kernel in
    prefill and decode; 1 attention: the flash kernel in prefill)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                              **JAMBA_CUT)
    return _serve_model(cfg)


def _serve_short(params, cfg, prompt) -> None:
    import torch
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=SERVE_MAX_LEN,
                      dtype=torch.float32, device="cuda")
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    eng.run_until_drained()


def _flash_inputs(shape, dtype, seed):
    import torch
    b, s, hq, hkv, d, _ = shape
    g = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(shp, generator=g, device="cuda").to(dtype)
                 for shp in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def _library_attention(q, k, v, window) -> dict:
    """One PyTorch call for the same function, where there is one:
    `scaled_dot_product_attention(is_causal=True)` on [B, H, S, D] under
    each SDPA backend that takes the inputs, with `enable_gqa=True` where
    the backend takes it, else with K/V repeated to Hq heads outside the
    timed call.  Returns {backend: (ms, "enable_gqa" | "repeat_kv")};
    the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if window is not None:
        return {}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    kr, vr = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
    calls = {"enable_gqa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True),
             "repeat_kv": lambda: F.scaled_dot_product_attention(
                 qt, kr, vr, is_causal=True)}
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for how, fn in calls.items():
            try:
                with sdpa_kernel(backend):
                    fn()
                    out[backend.name] = (cuda_ms(fn), how)
                break
            except (RuntimeError, TypeError):
                continue
    return out


def flash_ptxas() -> list:
    """Registers, spills and stack of each flash_attention instantiation
    from the build's ptxas report, with its dynamic shared memory."""
    import re
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    rows, serialized = {}, set()
    name = None
    for line in build.log_path("flash_attention").read_text().splitlines():
        m = re.search(r"'(_Z\S*kernelILi(\d+)E\S*)'", line)
        if m and "C7512" in line:           # wgmma serialized for want of
            serialized.add(m.group(1))      # registers
        elif m and "Compiling entry function" in line:
            name = m.group(1)
            dtype = "float32" if "3f32" in name else "bfloat16"
            rows[name] = {"dtype": dtype, "d": int(m.group(2))}
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            rows[name].update(stack=nums[0], spill_stores=nums[1],
                              spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            rows[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    out = []
    for name, r in rows.items():
        dt = torch.float32 if r["dtype"] == "float32" else torch.bfloat16
        r["smem_bytes"] = ops.smem_bytes(dt, r["d"])
        r["wgmma_serialized"] = name in serialized
        out.append(r)
    return sorted(out, key=lambda r: (r["dtype"], r["d"]))


def kernel_flash(serve) -> dict:
    """Phase 11: flash_attention against its plain version on the card at
    every listed shape, in float32 and bfloat16 (the reference's bounds),
    and its times at glm4-9b's 4096-token prefill shape beside its bound,
    the plain version's and the library call's."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    ptxas = flash_ptxas()
    for r in ptxas:
        print(f"flash_attention ptxas {r['dtype']} D={r['d']}: "
              f"{r['registers']} registers, {r['spill_stores']} B spill "
              f"stores, {r['spill_loads']} B spill loads, {r['stack']} B "
              f"stack; {r['smem_bytes']} B dynamic shared memory"
              + ("; wgmma serialized for want of registers"
                 if r["wgmma_serialized"] else ""))
    errs = {"float32": 0.0, "bfloat16": 0.0}
    times = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        tol = FLASH_TOL[dt_name]
        t_abs, t_rel = FLASH_TIGHT[dt_name]
        for i, (name, shape) in enumerate(FLASH_SHAPES.items()):
            b, s, hq, hkv, d, window = shape
            q, k, v = _flash_inputs(shape, dt, SEED + i)
            out = ops.flash_attention(q, k, v, window=window)
            ref.flash_attention(q, k, v, window=window)   # warm-up: memory
            plain, plain_s = wall(lambda: ref.flash_attention(
                q, k, v, window=window))
            diff = (out.float() - plain.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= tol + tol * plain.float().abs()).all())
            if dt != torch.float32:
                del plain, diff
                plain = ref.flash_attention(q.float(), k.float(), v.float(),
                                            window=window).to(dt)
                diff = (out.float() - plain.float()).abs()
            err_f32_math = diff.max().item()
            tight = bool((diff <= t_abs + t_rel * plain.float().abs()).all())
            del plain, diff
            call = cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                       window=window))
            n_flop = ops.attention_flops(b, s, s, hq, d)
            if window is not None:     # keys a query sees: min(q+1, window)
                n_flop = 4 * b * hq * d * sum(
                    min(p + 1, window) for p in range(s))
            print(f"flash_attention {name} {dt_name} (b {b}, s {s}, heads "
                  f"{hq}/{hkv}, d {d}, window {window}): max abs {err:.3e} "
                  f"(bound {tol:g}); vs float32 math {err_f32_math:.3e} "
                  f"(bound atol {t_abs:g} + rtol {t_rel:g}), "
                  f"wrapper call {call:.3f} ms = "
                  f"{n_flop / call / 1e9:.2f} TFLOP/s, plain "
                  f"{plain_s * 1e3:.1f} ms")
            check(ok, f"flash_attention {name} {dt_name}: beyond rtol = atol "
                  f"= {tol:g} (max abs {err:.3e})")
            check(tight, f"flash_attention {name} {dt_name}: beyond atol "
                  f"{t_abs:g} + rtol {t_rel:g} of the float32 math (max abs "
                  f"{err_f32_math:.3e})")
            errs[dt_name] = max(errs[dt_name], err)
            if name == "glm4 4096":
                # CUDA events around each call: the wrapper waits on
                # nothing, and after the AL-DRAM phases' profiler sessions
                # the profiler has kept no record of this kernel
                ms = cuda_ms(lambda: ops.flash_attention(q, k, v), reps=10)
                peak = PEAK_FP32_PER_S if dt == torch.float32 \
                    else PEAK_BF16_PER_S
                # q, k, v read once and the output written once
                n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                    * q.element_size()
                b_ms, b_by = bound_ms(n_bytes, n_flop, peak)
                lib = _library_attention(q, k, v, window)
                lib_ms = min((x[0] for x in lib.values()), default=None)
                check(lib_ms is not None, "no SDPA backend took the inputs")
                print(f"  kernel {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
                      f"{n_flop:.4e} flop at {peak / 1e12:g} TFLOP/s, "
                      f"{n_bytes / 1e6:.1f} MB), {ms / b_ms:.2f}x the bound "
                      f"= {100 * b_ms / ms:.1f} % of it; {ms / lib_ms:.2f}x "
                      f"the fastest library call ({lib_ms:.4f} ms); plain "
                      f"{plain_s * 1e3:.1f} ms; library "
                      + json.dumps({k2: {"ms": round(x[0], 4), "call": x[1]}
                                    for k2, x in lib.items()}))
                times[dt_name] = {"ms": ms, "plain_ms": plain_s * 1e3,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "library_ms": lib_ms,
                                  "library": {k2: list(x)
                                              for k2, x in lib.items()}}
            del q, k, v, out
            torch.cuda.empty_cache()
    f32, bf16 = times["float32"], times["bfloat16"]
    n = serve["launches_serve"]["flash_attention"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:98",
            "launches": n, "launches_by_path": {"serve": n},
            "max_abs_err": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"],
            "shape": "b 1, s 4096, heads 32/2, d 128, causal",
            **{k2: f32[k2] for k2 in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
            "ms_source": "cuda_events_call",
            "library": f32["library"],
            "bf16": bf16, "ptxas": ptxas}


SSM_TOL = 3e-4        # rtol = atol, the reference's Pallas-vs-oracle bound
# (b, t, h, d, initial state): rwkv6-3b's prefill, the ragged 1300-token
# prompt, a reduced D = 32 with B = 2, a nonzero initial state, and a
# state scan over 64 chunks from a nonzero state with few heads
WKV_SHAPES = {"rwkv6-3b 4096": (1, 4096, 40, 64, False),
              "ragged 1300": (1, 1300, 40, 64, False),
              "reduced d32 b2": (2, 700, 4, 32, False),
              "from a state": (2, 1300, 40, 64, True),
              "64 chunks, 2 heads, from a state": (1, 4096, 2, 64, True)}
# (b, t, di, ds, initial state): jamba's prefill, a ragged 1300 with
# B = 2, ds = 8 (ragged di), a decode step from a nonzero state
SCAN_SHAPES = {"jamba 4096": (1, 4096, 16384, 16, False),
               "ragged 1300 b2": (2, 1300, 16384, 16, False),
               "ds 8": (2, 700, 1000, 8, False),
               "decode t1": (2, 1, 16384, 16, True)}


def _within(got, want) -> tuple[bool, float]:
    diff = (got - want).abs()
    return (bool((diff <= SSM_TOL + SSM_TOL * want.abs()).all()),
            diff.max().item())


def _ssm_kernel(name, shapes, make, kernel, plain, n_bytes, n_ops, serve,
                extra, timed=(), device_kernel=None) -> dict:
    """`kernel` against `plain` on the card at every listed shape, outputs
    and final states within rtol = atol = 3e-4; the kernel's time at the
    first (full) shape and at the shapes labelled in `timed` (CUDA
    events, median of 10 calls; with `device_kernel`, the CUDA kernels
    of that name's device time from torch.profiler, which leaves out the
    wrapper's host work, or the call's CUDA-event time where the
    profiler keeps no record: `ms_source` says which) beside its bound,
    the plain version's time (one run, warmed) and no library call (no
    single PyTorch call computes it).  The entry's numbers are the first
    shape's; the others go under `ms_by_shape` with their bounds."""
    import torch
    worst = 0.0
    by_shape = {}
    for i, (label, shape) in enumerate(shapes.items()):
        ins = make(shape, SEED + i)
        out, state = kernel(*ins)
        plain(*ins)                               # warm-up: memory
        (p_out, p_state), plain_s = wall(lambda: plain(*ins))
        ok_o, err_o = _within(out, p_out)
        ok_s, err_s = _within(state, p_state)
        print(f"{name} {label} {shape}: max abs {err_o:.3e} (output), "
              f"{err_s:.3e} (final state), bound rtol = atol = {SSM_TOL:g}; "
              f"plain {plain_s * 1e3:.1f} ms")
        check(ok_o and ok_s, f"{name} {label}: beyond rtol = atol = "
              f"{SSM_TOL:g} (output {err_o:.3e}, state {err_s:.3e})")
        worst = max(worst, err_o, err_s)
        if i == 0 or label in timed:
            call = cuda_ms(lambda: kernel(*ins), reps=10)
            ms, src = call, "cuda_events_call"
            if device_kernel is not None:
                try:
                    ms = kernel_ms(lambda: kernel(*ins), device_kernel,
                                   reps=10)
                    src = "torch_profiler"
                except NoProfilerRecord as e:
                    print(f"  ({e}: its time is the call's from CUDA "
                          "events)")
            b_ms, b_by = bound_ms(n_bytes(shape), n_ops(shape))
            how = (" device" if src == "torch_profiler" else
                   " (the wrapper call's CUDA-event time)") + (
                f" (wrapper call {call:.4f} ms)"
                if device_kernel is not None else "")
            print(f"  kernel {ms:.4f} ms{how}, bound {b_ms:.4f} ms ({b_by}: "
                  f"{n_ops(shape):.4e} operations at 67 TFLOP/s, "
                  f"{n_bytes(shape) / 1e6:.1f} MB at 3.35 TB/s), "
                  f"{ms / b_ms:.2f}x the bound; plain {plain_s * 1e3:.1f} ms;"
                  " library none")
            by_shape[label] = {"ms": ms, "ms_source": src, "call_ms": call,
                               "plain_ms": plain_s * 1e3,
                               "bound_ms": b_ms, "bound_by": b_by}
            if i == 0:
                times = {**by_shape[label], "library_ms": None}
        del ins, out, state, p_out, p_state
        torch.cuda.empty_cache()
    n = serve["launches_serve"][name]
    extra = dict(extra, ms_by_shape=by_shape) if timed else extra
    return {"name": name, "route": "cuda", **extra, "launches": n,
            "launches_by_path": {"serve": n}, "max_abs_err": worst, **times}


def kernel_wkv(serve) -> dict:
    """Phase 15: wkv against its plain version (chunk 16) on the card."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref

    def make(shape, seed):
        b, t, h, d, with_state = shape
        g = torch.Generator("cuda").manual_seed(seed)

        def n(*shp):
            return torch.randn(shp, generator=g, device="cuda")
        r, k, v = (0.5 * n(b, t, h, d) for _ in range(3))
        w = -torch.exp(n(b, t, h, d) - 2.0)
        return (r, k, v, w, 0.3 * n(h, d),
                0.5 * n(b, h, d, d) if with_state else None)

    return _ssm_kernel(
        "wkv", WKV_SHAPES, make,
        lambda r, k, v, w, u, s: ops.wkv(r, k, v, w, u, state=s),
        lambda r, k, v, w, u, s: ref.wkv(r, k, v, w, u, state=s),
        lambda sh: ops.wkv_hbm_bytes(*sh[:4]),
        lambda sh: ops.wkv_flops(*sh[:4]), serve,
        {"source": "src/repro_torch/kernels/rwkv6/wkv.cu",
         "replaces": "src/repro/kernels/rwkv6/rwkv6.py:79",
         "shape": "b 1, t 4096, h 40, d 64"})


def kernel_mamba(serve) -> dict:
    """Phase 16: mamba_scan against its plain step loop on the card."""
    import torch
    from repro_torch.kernels.mamba_scan import ops, ref

    def make(shape, seed):
        b, t, di, ds, with_state = shape
        g = torch.Generator("cuda").manual_seed(seed)

        def n(*shp):
            return torch.randn(shp, generator=g, device="cuda")
        return (0.5 * n(b, t, di),
                torch.nn.functional.softplus(n(b, t, di) - 1.0),
                0.5 * n(b, t, ds), 0.5 * n(b, t, ds),
                -torch.exp(0.3 * n(di, ds)),
                0.5 * n(b, di, ds) if with_state else None)

    def n_bytes(sh):
        b, t, di, ds, with_state = sh
        return ops.mamba_scan_hbm_bytes(b, t, di, ds) + 4 * di * ds \
            + (ops.mamba_scan_state_bytes(b, di, ds) if with_state
               else 4 * b * di * ds)

    entry = _ssm_kernel(
        "mamba_scan", SCAN_SHAPES, make,
        lambda x, dt, bm, cm, a, h0: ops.mamba_scan(x, dt, bm, cm, a,
                                                    h0=h0),
        lambda x, dt, bm, cm, a, h0: ref.mamba_scan(x, dt, bm, cm, a, h0=h0),
        n_bytes, lambda sh: ops.mamba_scan_flops(*sh[:4]), serve,
        {"source": "src/repro_torch/kernels/mamba_scan/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:57",
         "shape": "b 1, t 4096, di 16384, ds 16",
         "plans": {lb: dataclasses.asdict(ops.scan_plan(sh[1], sh[3]))
                   for lb, sh in SCAN_SHAPES.items()}},
        timed=("decode t1",), device_kernel="mamba_scan_kernel")
    pre, dec = serve["launches_by_phase"]["mamba_scan"]
    entry["launches_by_shape"] = {"prefill": pre, "decode t1": dec}
    print(f"mamba_scan launches on the serve path by shape: {pre} prefill "
          f"(one per Mamba layer and prompt), {dec} decode steps at T = 1 "
          f"(one per Mamba layer and tick)")
    return entry


# --------------------------------------------------------- training path

TRAIN_ARCH = "rwkv6-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_ACCUM = 2, 4096, 3, 2
TRAIN_LOSS_TOL = 1e-3        # kernels vs plain, relative, per step
TRAIN_GNORM_TOL = 1e-2       # the same for grad_norm (bf16 compute)
WKV_BWD_TOL = 1e-3           # rtol = atol: the backward vs its plain version
# (b, t, h, d, initial state and final-state gradient): rwkv6-3b's
# training shape, the ragged 1300-token prompt, D = 32 with B = 2, and a
# nonzero initial state with a nonzero final-state gradient
WKV_BWD_SHAPES = {"rwkv6-3b 4096": (1, 4096, 40, 64, False),
                  "ragged 1300": (1, 1300, 40, 64, False),
                  "reduced d32 b2": (2, 700, 4, 32, False),
                  "from a state": (2, 1300, 40, 64, True)}


def _train_config():
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import TrainerConfig
    return TrainerConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, seed=SEED,
                         train=TrainConfig(accum_steps=TRAIN_ACCUM))


def _train_run(cfg, plain: bool) -> dict:
    """`Trainer.run` at full width: per step the seconds of its
    gradients and of its optimizer (`train_step`'s `times`, each half
    between two synchronizations), the metrics, the peak memory; with
    `plain`, the WKV wrapper swapped for its plain version (chunk 16,
    which autograd differentiates: `plain_serve`)."""
    import gc

    import torch
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, init_s = wall(lambda: Trainer(cfg, _train_config(),
                                           device="cuda"))
    times = []
    reset_counts()
    with plain_serve() if plain else contextlib.nullcontext():
        trainer.run(times=times)
    launches = read_counts()
    return {"trainer": trainer, "init_s": init_s,
            "step_s": [t["grads_s"] + t["update_s"] for t in times],
            "opt_s": [t["update_s"] for t in times],
            "metrics": trainer.metrics, "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _train_report(cfg, run: dict, n_tree: int) -> None:
    """The training phases' lines: parameters (held to the `init_params`
    tree), peak memory, and per step the metrics, its seconds split into
    forward + backward and the optimizer, and tokens per second."""
    n_params = sum(t.numel() for t in _tree_leaves(run["trainer"].params))
    check(n_params == n_tree, f"{n_params} parameters, the tree {n_tree}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train {cfg.name}: {n_params / 1e9:.3f} B parameters, float32 "
          f"parameters + gradients + AdamW moments "
          f"{16 * n_params / 1e9:.1f} GB, drawn on the card in "
          f"{run['init_s']:.2f} s; bf16 compute, remat, accum "
          f"{TRAIN_ACCUM}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; peak "
          f"memory allocated {run['peak_gb']:.2f} GB")
    for m, st, ot in zip(run["metrics"], run["step_s"], run["opt_s"]):
        print(f"train {cfg.name} kernels step {m['step']}: loss "
              f"{m['loss']:.6f} grad_norm {m['grad_norm']:.6f} lr "
              f"{m['lr']:.3e}; {st:.3f} s = forward + backward "
              f"{st - ot:.3f} s + optimizer {ot:.3f} s; {tokens / st:.0f} "
              "tokens/s")


def train_path() -> dict:
    """Phase 17: rwkv6-3b trained at full width and depth on the card
    (`Trainer`, bf16 compute, float32 parameters and moments, remat,
    accum 2, 2 x 4096 tokens of `SyntheticLM(seed=0)` a step, 3 steps):
    exactly 2 x 32 x 2 = 128 WKV forward and 32 x 2 = 64 backward
    launches a step and nothing else; seconds per step split into forward
    + backward and the optimizer, tokens per second, peak memory; one more
    step under `torch.profiler`; then the same steps with the WKV wrapper
    swapped for its plain version: losses within 1e-3 relative, and the
    grad norms' gaps printed.  At this initialisation the model's
    gradient at full depth is not resolved by float32, let alone bf16
    (`_train_grad_check` measures how far from a float64 witness each
    path lies), so the grad norms are held in float32 at two layers and
    at 32 (`_train_grad_check`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matrix products are on: float32 would not mean float32")
    cfg = get_config(TRAIN_ARCH)
    n_tree = sum(t.numel() for t in _tree_leaves(TF.init_params(
        torch.Generator(), cfg, device="meta")))
    fast = _train_run(cfg, plain=False)
    tr = fast["trainer"]
    _train_report(cfg, fast, n_tree)
    n = fast["launches"]
    layers = _mixer_layers(cfg)["rwkv6"]
    want = {"wkv": 2 * layers * TRAIN_ACCUM * TRAIN_STEPS,
            "wkv_bwd": layers * TRAIN_ACCUM * TRAIN_STEPS}
    print(f"train path kernels ({TRAIN_STEPS} steps): wkv {n['wkv']} "
          f"(expected {want['wkv']}: forward and remat recompute, per layer "
          f"and microbatch), wkv_bwd {n['wkv_bwd']} (expected "
          f"{want['wkv_bwd']}), others "
          f"{ {k: v for k, v in n.items() if k not in want and v} }")
    for k, w in want.items():
        check(n[k] == w, f"train path: {k} launched {n[k]} times, "
              f"expected {w}")
    check(all(v == 0 for k, v in n.items() if k not in want),
          f"the training path launched another kernel: {n}")

    def one_more():
        tr.tcfg.steps = TRAIN_STEPS + 1
        tr.run(start_step=TRAIN_STEPS)
    busy_share(f"train path {cfg.name} (one step)", one_more,
               watch=("wkv_",))
    del tr, fast["trainer"], one_more

    plain = _train_run(cfg, plain=True)
    del plain["trainer"]
    check(not any(plain["launches"].values()),
          f"the plain training run launched a kernel: {plain['launches']}")
    gaps = {"loss": [], "grad_norm": []}
    for a, b in zip(fast["metrics"], plain["metrics"]):
        for key in gaps:
            gaps[key].append(abs(a[key] - b[key]) / abs(b[key]))
    for m, st in zip(plain["metrics"], plain["step_s"]):
        print(f"train {cfg.name} plain step {m['step']}: loss "
              f"{m['loss']:.6f} grad_norm {m['grad_norm']:.6f}; {st:.3f} s")
    print(f"train {cfg.name} kernels vs plain (bf16): loss gaps "
          f"{[f'{g:.3e}' for g in gaps['loss']]} (bound {TRAIN_LOSS_TOL:g}),"
          f" grad_norm gaps {[f'{g:.3e}' for g in gaps['grad_norm']]} "
          "(not bounded in bf16: rounding rules its gradients), relative")
    check(max(gaps["loss"]) <= TRAIN_LOSS_TOL, f"losses differ: {gaps}")
    _train_grad_check(cfg)
    torch.cuda.empty_cache()
    return {"launches_train": n, "step_s": fast["step_s"],
            "opt_s": fast["opt_s"], "metrics": fast["metrics"][:TRAIN_STEPS],
            "peak_gb": fast["peak_gb"]}


# the checkpoint check's reduced rwkv6-3b run: steps, batch rows, tokens
MESH_CKPT_STEPS, MESH_CKPT_BATCH, MESH_CKPT_SEQ = 2, 2, 256
COMPRESS_RATIO = 0.01        # top-k's kept share (the reference's default)


def _bits_equal(a, b) -> bool:
    """Same shape and the same bits (float32 as int32: signed zeros and
    NaN payloads count)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def train_mesh(train: dict) -> dict:
    """Phase 17c (after phase 17): rwkv6-3b at full width and depth
    trained with phase 17's recipe by `Trainer(mesh=make_smoke_mesh())`:
    its parameters, gradients and moments `DTensor`s on a (1, 1)
    ("data", "model") mesh in an NCCL world of one.  Launch counts reset
    just before the run and read just after: exactly phase 17's 128 wkv
    and 64 wkv_bwd launches a step and nothing else; losses, lr and grad
    norms held to phase 17's kernel run as it ran (a world of one sums
    over one rank: bitwise expected; the largest gap printed); seconds
    per step and peak memory beside phase 17's.  Then, at reduced width,
    a checkpoint of a mesh trainer restored with `shardings=` onto
    `make_mesh_for(1, model_parallel=1)`, bitwise; and the gradient
    compressors (top-k with error feedback, int8) on the card and on the
    CPU on the largest leaf of one full-width gradient, bitwise."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime import compression as C
    from repro_torch.runtime.elastic import make_mesh_for
    from repro_torch.train.step import accumulate_grads
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_smoke_mesh()
    print(f"train mesh: {mesh} in a world of {dist.get_world_size()} "
          f"({dist.get_backend()})")
    tr, init_s = wall(lambda: Trainer(cfg, _train_config(), mesh=mesh))
    check(all(isinstance(x, DTensor) for x in _tree_leaves(tr.params)),
          "the mesh trainer holds a parameter that is not a DTensor")
    times = []
    reset_counts()
    tr.run(times=times)
    n = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    layers = _mixer_layers(cfg)["rwkv6"]
    want = {"wkv": 2 * layers * TRAIN_ACCUM * TRAIN_STEPS,
            "wkv_bwd": layers * TRAIN_ACCUM * TRAIN_STEPS}
    print(f"train mesh kernels ({TRAIN_STEPS} steps): wkv {n['wkv']} "
          f"(expected {want['wkv']}), wkv_bwd {n['wkv_bwd']} (expected "
          f"{want['wkv_bwd']}), others "
          f"{ {k: v for k, v in n.items() if k not in want and v} }")
    for k, w in want.items():
        check(n[k] == w, f"train mesh: {k} launched {n[k]} times, "
              f"expected {w}")
    check(all(v == 0 for k, v in n.items() if k not in want),
          f"the mesh training path launched another kernel: {n}")
    gaps = {k: max(abs(a[k] - b[k]) for a, b in zip(tr.metrics,
                                                     train["metrics"]))
            for k in ("loss", "lr", "grad_norm")}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    card = card_line()
    for m, b, t, bt, bo in zip(tr.metrics, train["metrics"], times,
                               train["step_s"], train["opt_s"]):
        st = t["grads_s"] + t["update_s"]
        print(f"train mesh {cfg.name} step {m['step']}: loss {m['loss']:.6f} "
              f"grad_norm {m['grad_norm']:.6f} lr {m['lr']:.3e} (phase 17: "
              f"{b['loss']:.6f} {b['grad_norm']:.6f} {b['lr']:.3e}); "
              f"{st:.3f} s = forward + backward {t['grads_s']:.3f} s + "
              f"optimizer {t['update_s']:.3f} s, {tokens / st:.0f} tokens/s "
              f"(phase 17: {bt:.3f} s, optimizer {bo:.3f} s) on {card}")
    print(f"train mesh {cfg.name}: drawn and placed in {init_s:.2f} s; peak "
          f"memory allocated {peak:.2f} GB (phase 17: "
          f"{train['peak_gb']:.2f} GB); largest gaps to phase 17: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(all(v == 0 for v in gaps.values()),
          f"the mesh trainer's metrics differ from phase 17's: {gaps}")

    # one more full-width gradient; its largest leaf through both
    # compressors on the card and on the CPU
    grads, _ = accumulate_grads(
        tr.params, shard_batch(tr.data.batch_at(TRAIN_STEPS),
                               SH.batch_sharding(mesh)), cfg, tr.tcfg.train)
    path, leaf = max(_named(grads), key=lambda t: t[1].numel())
    name = SH.path_str(path)
    g = SH.local(leaf).detach().clone()
    p0 = SH.local(SH.at(tr.params, path)).detach().clone()
    del grads, leaf
    cost = train_cost(tr, train)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    outs = {}
    for dev, x in (("cuda", {"g": g}), ("cpu", {"g": g.cpu()})):
        (sent, state), sec = _timed(dev, lambda x=x: C.topk_compress(
            x, C.topk_init(x), COMPRESS_RATIO))
        (q, scale, _, _), sec8 = _timed(dev, lambda x=x: C.int8_compress(
            x)["g"])
        outs[dev] = {"sent": sent["g"], "residual": state.residual["g"],
                     "q": q, "scale": scale, "s": (sec, sec8)}
        del sent, state, q, scale
    same = {k: _bits_equal(outs["cuda"][k], outs["cpu"][k])
            for k in ("sent", "residual", "q", "scale")}
    err = float((C.int8_decompress({"g": (outs["cuda"]["q"],
                                          outs["cuda"]["scale"],
                                          tuple(g.shape), 0)})["g"]
                 - g).abs().max())
    bound = C.int8_error_bound(g)
    print(f"train mesh compressors on {name} {tuple(g.shape)} "
          f"({g.numel()} elements): top-k at {COMPRESS_RATIO:g} "
          f"{C.topk_wire_bytes({'g': g}, COMPRESS_RATIO)} wire bytes, "
          f"{outs['cuda']['s'][0]:.3f} s on the card, "
          f"{outs['cpu']['s'][0]:.3f} s on the CPU; int8 "
          f"{outs['cuda']['s'][1]:.3f} / {outs['cpu']['s'][1]:.3f} s, round "
          f"trip max error {err:.3e} (bound {bound:.3e}); bitwise card = "
          f"CPU: {same}")
    check(all(same.values()), f"the compressors differ card vs CPU: {same}")
    check(err <= bound, f"int8 round trip {err} above its bound {bound}")
    del outs
    adamw8_card_cpu(name, g, p0)
    del g, p0
    torch.cuda.empty_cache()

    # a reduced mesh trainer's checkpoint, restored with shardings= onto
    # make_mesh_for(1, model_parallel=1)
    small = reduced(cfg)
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        tc = dataclasses.replace(
            _train_config(), steps=MESH_CKPT_STEPS,
            global_batch=MESH_CKPT_BATCH, seq_len=MESH_CKPT_SEQ, ckpt_dir=d,
            ckpt_every=1)
        st = Trainer(small, tc, mesh=make_smoke_mesh())
        st.run()
        new = make_mesh_for(1, model_parallel=1)
        like = {"params": st.params, "opt": st.opt}
        p_sh = SH.param_shardings(small, new, st.params)
        tree, step = load_checkpoint(d, like, shardings={
            "params": p_sh, "opt": SH.opt_shardings(p_sh, st.opt)})
    pairs = list(zip(_named(tree), _named(like)))
    same_ck = sum(_bits_equal(SH.gather(a), SH.gather(b))
                  for (_, a), (_, b) in pairs)
    placed = all(isinstance(a, DTensor) and a.device_mesh == new
                 for (p, a), _ in pairs if p[0] == "params")
    print(f"train mesh checkpoint ({small.name}, step {step}): {same_ck} of "
          f"{len(pairs)} leaves bitwise after the restore onto "
          f"make_mesh_for(1, model_parallel=1); parameters placed on it: "
          f"{placed}")
    check(step == MESH_CKPT_STEPS and same_ck == len(pairs) and placed,
          "the mesh checkpoint did not restore bitwise")
    del st, tree, like
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"train mesh phase: {time.perf_counter() - t0:.1f} s")
    return {"launches_train_mesh": n, "launches_cost": cost}


def adamw8_card_cpu(name: str, g, p) -> None:
    """Phase 17c's 8-bit AdamW check: one update of the parameter leaf
    `p` by its gradient `g` (rwkv6-3b's largest leaf, from a zero state,
    lr 3e-4, no clipping: the global norm is a reduction whose order is
    the device's own) on the card and on the CPU: the moment codes, the
    row scales and the parameters bit for bit."""
    import torch
    from repro_torch.optim.adamw8bit import adamw8_init, adamw8_update

    outs = {}
    for dev, x, w in (("cuda", g, p), ("cpu", g.cpu(), p.cpu())):
        def one(x=x, w=w, dev=dev):
            st = adamw8_init({"w": w})
            new, st = adamw8_update({"w": x}, st, {"w": w},
                                    torch.full((), 3e-4, device=dev),
                                    grad_clip=None)
            return {"param": new["w"], "m codes": st.m["w"].q,
                    "m scales": st.m["w"].scale, "v codes": st.v["w"].q,
                    "v scales": st.v["w"].scale}
        outs[dev], sec = _timed(dev, one)
        outs[dev]["s"] = sec
    same = {k: _bits_equal(outs["cuda"][k], outs["cpu"][k])
            for k in outs["cpu"] if k != "s"}
    flips = {k: int((outs["cuda"][k].cpu() != outs["cpu"][k]).sum())
             for k in same if not same[k]}
    print(f"train mesh 8-bit AdamW on {name} {tuple(g.shape)}: one update "
          f"{outs['cuda']['s']:.3f} s on the card, {outs['cpu']['s']:.3f} s "
          f"on the CPU; bitwise card = CPU: {same}"
          + (f"; elements that differ: {flips}" if flips else ""))
    check(all(same.values()), f"8-bit AdamW differs card vs CPU: {flips}")


COST_TOL_OPS = 20            # differing ops printed by phase 17d


def train_cost(tr, train: dict) -> dict:
    """Phase 17d (inside phase 17c, on its trainer, before it is freed;
    no new model): one warm training step of rwkv6-3b at full width
    (phase 17's recipe, the (1, 1) mesh) counted on the card by
    `launch.hlo_cost`, launch counts reset just before and read just
    after (exactly 128 wkv and 64 wkv_bwd launches and nothing else),
    and the same step counted on fake CPU tensors by `launch.dryrun`
    (no mesh: on a mesh of one rank the step runs the same ops): equal
    flops and collectives; the HBM bytes equal, or each differing op
    printed.  Then one line: flops, HBM bytes, model flops (3 x
    `flops_per_token` x tokens), the useful ratio, the H100 roofline's
    compute and memory seconds (989 TFLOP/s, 3.35 TB/s), phase 17's warm
    step and the model-flops share of 989 TFLOP/s in it, with the card's
    name and power limit.  Returns the launches."""
    import torch
    from repro_torch.launch import dryrun, hlo_cost

    t0 = time.perf_counter()
    cfg = tr.cfg
    batch = tr._place(tr.data.batch_at(TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (out, card_mode, card_mem), step_s = _timed("cuda", lambda: hlo_cost.count(
        tr._step, tr.params, tr.opt, batch))
    n = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss = float(out[2]["loss"])
    del out
    layers = _mixer_layers(cfg)["rwkv6"]
    want = {"wkv": 2 * layers * TRAIN_ACCUM, "wkv_bwd": layers * TRAIN_ACCUM}
    print(f"cost step kernels: wkv {n['wkv']} (expected {want['wkv']}), "
          f"wkv_bwd {n['wkv_bwd']} (expected {want['wkv_bwd']}), others "
          f"{ {k: v for k, v in n.items() if k not in want and v} }")
    for k, w in want.items():
        check(n[k] == w, f"cost step: {k} launched {n[k]} times, expected "
              f"{w}")
    check(all(v == 0 for k, v in n.items() if k not in want),
          f"the counted step launched another kernel: {n}")

    t1 = time.perf_counter()
    specs = dryrun.fake_inputs(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    fake_mode, fake_mem = dryrun.count_step("train", cfg, specs,
                                            tr.tcfg.train)
    fake_s = time.perf_counter() - t1
    c, f = card_mode.costs, fake_mode.costs
    print(f"cost step counted: card {c.flops:.6e} flops, {c.hbm_bytes:.6e} "
          f"HBM bytes, collectives {c.collectives}, peak tracked "
          f"{card_mem['peak_bytes'] / 1e9:.3f} GB (allocator peak "
          f"{peak:.3f} GB), loss {loss:.6f}, {step_s:.3f} s under the "
          f"counter; fake CPU tensors {f.flops:.6e} flops, "
          f"{f.hbm_bytes:.6e} HBM bytes, collectives {f.collectives}, peak "
          f"{fake_mem['peak_bytes'] / 1e9:.3f} GB, {fake_s:.1f} s")
    diff = sorted((k, card_mode.ops.get(k), fake_mode.ops.get(k))
                  for k in set(card_mode.ops) | set(fake_mode.ops)
                  if card_mode.ops.get(k) != fake_mode.ops.get(k))
    for k, a, b in diff[:COST_TOL_OPS]:
        print(f"  cost step op {k}: card [calls, flops, bytes] {a}, fake {b}")
    check(c.flops == f.flops and c.collectives == f.collectives,
          "the card's counted step and its fake-tensor count differ in "
          "flops or collectives")
    mf = 3.0 * cfg.flops_per_token(TRAIN_SEQ) * TRAIN_BATCH * TRAIN_SEQ
    warm = statistics.median(train["step_s"][1:])
    print(f"cost rwkv6-3b step ({TRAIN_BATCH} x {TRAIN_SEQ} tokens, accum "
          f"{TRAIN_ACCUM}, remat, bf16 compute): {c.flops:.6e} flops, "
          f"{c.hbm_bytes:.6e} HBM bytes (hbm equal to the fake count: "
          f"{c.hbm_bytes == f.hbm_bytes}), model flops {mf:.6e}, useful "
          f"ratio {mf / c.flops:.4f}; H100 roofline compute "
          f"{c.flops / PEAK_BF16_PER_S:.4f} s, memory "
          f"{c.hbm_bytes / PEAK_BYTES_PER_S:.4f} s; phase 17 warm step "
          f"{warm:.4f} s (median of {len(train['step_s']) - 1}); model-flops "
          f"share of 989 TFLOP/s {mf / PEAK_BF16_PER_S / warm:.4%} on "
          f"{card_line()}")
    print(f"cost phase (17d): {time.perf_counter() - t0:.1f} s")
    return n



def _named(tree, path=()):
    """(path, leaf) of nested dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    else:
        yield path, tree
        return
    for k, v in items:
        yield from _named(v, path + (k,))


def _timed(dev: str, fn):
    """fn() and its seconds, the card synchronized on both sides."""
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# layers of the float32 gradient checks at full width: two, where
# float32 resolves the gradient (kernels and plain within 2.2e-6 of each
# other), and the full 32, where it does not: at this initialisation
# both float32 paths lie 3-10x their own norm from the float64 witness,
# and one ulp of parameter noise moves either path's grad norm by 0.1-0.7
TRAIN_CHECK_LAYERS = (2, 32)
NOISE_SEEDS = (100, 101, 102)    # the 1-ulp parameter-noise draws


def grad_norm_noise(params, batch, cfg, tcfg, seeds=NOISE_SEEDS,
                    base: float | None = None) -> list:
    """How far one float32 ulp of noise on the parameters moves the
    gradient norm: for each seed, the relative move of the norm with
    every parameter times 1 + 2^-23 * {-1, 0, 1} (drawn on the
    parameters' device).  Two implementations whose norms differ by
    less cannot be told apart on these inputs."""
    import torch
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import accumulate_grads, global_grad_norm

    def norm(p):
        return float(global_grad_norm(accumulate_grads(p, batch, cfg,
                                                       tcfg)[0]))
    base = norm(params) if base is None else base
    moves = []
    for seed in seeds:
        gen = torch.Generator(batch["tokens"].device).manual_seed(seed)
        noisy = tree_map(lambda p: p * (1 + 2.0 ** -23 * torch.randint(
            -1, 2, p.shape, generator=gen, device=p.device)), params)
        moves.append(norm(noisy) / base - 1)
        del noisy
    return moves


def _train_grad_check(cfg) -> None:
    """Phase 17b: rwkv6-3b's float32 gradients at full width, one
    4096-token microbatch (`accumulate_grads`, remat) from seeded
    weights, at each depth of `TRAIN_CHECK_LAYERS`: through the WKV
    kernels, through the plain version, and through the plain version in
    float64 (the witness: the model and the plain WKV computed in
    float64).  Gates: the loss within 1e-3 relative; the grad norms of
    the two float32 paths within max(1e-2, twice the spread), the spread
    being the largest move of either path's norm under one float32 ulp
    of parameter noise (three draws each).  Printed: each path's
    distance to the witness."""
    import gc

    import torch
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                        global_grad_norm)

    batch = shard_batch(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, 1,
                                    SEED).batch_at(0), "cuda")
    tcfg = TrainConfig(dtype=torch.float32)
    tcfg64 = TrainConfig(dtype=torch.float64, grad_dtype=torch.float64)

    def init(cfg_l):
        gc.collect()
        torch.cuda.empty_cache()
        return TF.init_params(torch.Generator("cuda").manual_seed(SEED),
                              cfg_l, device="cuda")

    def dist(g, ref) -> float:
        return float(torch.sqrt(sum(torch.sum(torch.square(
            a.double() - b.double())) for a, b in zip(tree_leaves(g),
                                                      tree_leaves(ref)))))

    for n_layers in TRAIN_CHECK_LAYERS:
        cfg_l = dataclasses.replace(cfg, n_layers=n_layers)
        # the witness first, alone on the card (float64 weights and
        # gradients: 16 bytes a parameter); kept as float32
        p64 = tree_map(lambda p: p.double(), init(cfg_l))
        torch.cuda.reset_peak_memory_stats()
        with plain_serve():
            (g64, l64), s64 = wall(lambda: accumulate_grads(
                p64, batch, cfg_l, tcfg64))
        peak64 = torch.cuda.max_memory_allocated() / 1e9
        n64, l64 = float(global_grad_norm(g64)), float(l64)
        witness = tree_map(lambda g: g.float(), g64)
        del p64, g64
        params = init(cfg_l)
        out = {}
        for plain in (False, True):
            reset_counts()
            with plain_serve() if plain else contextlib.nullcontext():
                (grads, loss), secs = wall(lambda: accumulate_grads(
                    params, batch, cfg_l, tcfg))
            n = read_counts()
            out[plain] = {"loss": float(loss), "s": secs,
                          "norm": float(global_grad_norm(grads)),
                          "launches": (n["wkv"], n["wkv_bwd"]),
                          "dist": dist(grads, witness) / n64}
            del grads
        del witness
        for plain in (False, True):
            with plain_serve() if plain else contextlib.nullcontext():
                out[plain]["moves"] = grad_norm_noise(
                    params, batch, cfg_l, tcfg, base=out[plain]["norm"])
        del params
        k, p = out[False], out[True]
        check((*k["launches"], *p["launches"]) == (2 * n_layers, n_layers,
                                                   0, 0),
              f"float32 check launches: kernels {k['launches']}, plain "
              f"{p['launches']}")
        gaps = (abs(k["loss"] - p["loss"]) / abs(p["loss"]),
                abs(k["norm"] - p["norm"]) / p["norm"])
        spread = max(abs(x) for x in k["moves"] + p["moves"])
        bound = max(TRAIN_GNORM_TOL, 2 * spread)
        print(f"train {cfg.name} float32 gradients at {n_layers} layers "
              f"(1 x {TRAIN_SEQ} tokens), kernels vs plain: loss "
              f"{k['loss']:.6f} / {p['loss']:.6f} (gap {gaps[0]:.3e}), "
              f"grad_norm {k['norm']:.6f} / {p['norm']:.6f} (gap "
              f"{gaps[1]:.3e}, bound {bound:.3e} = max({TRAIN_GNORM_TOL:g},"
              f" 2 x the spread {spread:.3e})); {k['s']:.2f} s / "
              f"{p['s']:.2f} s")
        print(f"  1-ulp parameter noise moves the grad norm by "
              f"{[f'{x:+.3e}' for x in k['moves']]} (kernels), "
              f"{[f'{x:+.3e}' for x in p['moves']]} (plain)")
        print(f"  float64 witness (plain): loss {l64:.9f}, grad_norm "
              f"{n64:.6f}, {s64:.2f} s, peak {peak64:.2f} GB; grad_norm "
              f"gap to it {k['norm'] / n64 - 1:+.3e} (kernels), "
              f"{p['norm'] / n64 - 1:+.3e} (plain); gradient distance "
              f"|g - g64| / |g64| {k['dist']:.3e} (kernels), "
              f"{p['dist']:.3e} (plain)")
        check(gaps[0] <= TRAIN_LOSS_TOL, f"float32 losses differ: {gaps}")
        check(gaps[1] <= bound, f"float32 grad norms differ at {n_layers} "
              f"layers: {gaps[1]:.3e} > {bound:.3e}")


# max abs of each gradient of the first backward kernel (a block per
# head and batch row walking the steps) against the plain version on
# phase 18's inputs (NVIDIA H100 80GB HBM3, 700 W), printed beside the
# current kernel's
WALK_KERNEL_ERR = {
    "rwkv6-3b 4096": {"r": 2.861e-05, "k": 1.335e-05, "v": 9.537e-06,
                      "w_log": 2.098e-05, "u": 4.425e-04},
    "ragged 1300": {"r": 2.289e-05, "k": 1.526e-05, "v": 8.583e-06,
                    "w_log": 1.907e-05, "u": 1.717e-04},
    "reduced d32 b2": {"r": 1.335e-05, "k": 4.768e-06, "v": 3.815e-06,
                       "w_log": 9.537e-06, "u": 4.196e-05},
    "from a state": {"r": 2.098e-05, "k": 1.431e-05, "v": 9.537e-06,
                     "w_log": 2.098e-05, "u": 1.678e-04,
                     "state": 1.907e-06}}
# the backward's CUDA kernels, in launch order
WKV_BWD_PASSES = ("wkv_bwd_chunk_kernel", "wkv_bwd_scan_kernel",
                  "wkv_bwd_out_kernel", "wkv_bwd_du_kernel")


def kernel_wkv_bwd(train) -> dict:
    """Phase 18: the WKV backward kernel against its plain version
    (`torch.autograd.grad` through the chunk-16 plain forward) on the
    card at every `WKV_BWD_SHAPES` shape, every gradient within rtol =
    atol = 1e-3, each max abs beside `WALK_KERNEL_ERR`; its time at the
    training shape (CUDA events, median of 10 calls of `wkv_backward` on
    the forward's saved chunk states) beside its bound and the plain
    version's time, and the device time of each of its CUDA kernels."""
    import torch
    from repro_torch.kernels.rwkv6 import ops, ref

    def make(shape, seed):
        b, t, h, d, with_state = shape
        g = torch.Generator("cuda").manual_seed(seed)

        def n(*shp):
            return torch.randn(shp, generator=g, device="cuda")
        r, k, v = (0.5 * n(b, t, h, d) for _ in range(3))
        w = -torch.exp(n(b, t, h, d) - 2.0)
        return (r, k, v, w, 0.3 * n(h, d),
                0.5 * n(b, h, d, d) if with_state else None, n(b, t, h, d),
                n(b, h, d, d) if with_state else None)

    worst, times = 0.0, None
    for i, (label, shape) in enumerate(WKV_BWD_SHAPES.items()):
        r, k, v, w, u, s0, d_o, d_s = make(shape, SEED + 40 + i)
        _, s_out, chunks = ops._forward(r, k, v, w, u, s0)
        got = ops.wkv_backward(r, k, v, w, u, chunks, d_o, d_s,
                               need_state=s0 is not None, s_out=s_out)
        ref.wkv_backward(r, k, v, w, u, d_o, state=s0, d_state=d_s)
        want, plain_s = wall(lambda: ref.wkv_backward(
            r, k, v, w, u, d_o, state=s0, d_state=d_s))
        errs = {}
        for name, a, b in zip(("r", "k", "v", "w_log", "u", "state"), got,
                              want):
            if b is None:
                continue
            diff = (a - b).abs()
            errs[name] = diff.max().item()
            check(bool((diff <= WKV_BWD_TOL + WKV_BWD_TOL * b.abs()).all()),
                  f"wkv_bwd {label}: d{name} beyond rtol = atol = "
                  f"{WKV_BWD_TOL:g} (max abs {errs[name]:.3e})")
        worst = max(worst, *errs.values())
        print(f"wkv_bwd {label} {shape}: max abs "
              + ", ".join(f"d{k} {e:.3e} (walk "
                          f"{WALK_KERNEL_ERR[label][k]:.3e})"
                          for k, e in errs.items())
              + f"; bound rtol = atol = {WKV_BWD_TOL:g}; plain "
              f"{plain_s * 1e3:.1f} ms")
        if i == 0:
            b_, t_, h_, dd, _ = shape

            def call():
                return ops.wkv_backward(r, k, v, w, u, chunks, d_o)
            ms = cuda_ms(call, reps=10)
            passes = {}
            for p in WKV_BWD_PASSES:
                try:
                    passes[p] = kernel_ms(call, p)
                except NoProfilerRecord:    # a measurement only
                    passes[p] = None
            n_bytes = ops.wkv_bwd_hbm_bytes(b_, t_, h_, dd)
            n_ops = ops.wkv_bwd_flops(b_, t_, h_, dd)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            print(f"  kernel {ms:.4f} ms (the wrapper call's CUDA-event "
                  f"time), bound {b_ms:.4f} ms ({b_by}: {n_ops:.4e} "
                  f"operations at 67 TFLOP/s, {n_bytes / 1e6:.1f} MB at "
                  f"3.35 TB/s), {ms / b_ms:.2f}x the bound; plain "
                  f"{plain_s * 1e3:.1f} ms; library none")
            print("  device time a call by CUDA kernel (torch.profiler, "
                  "mean of 5 launches): " + ", ".join(
                      f"{p} " + ("not recorded" if m is None
                                 else f"{m:.4f} ms")
                      for p, m in passes.items()))
            times = {"ms": ms, "ms_source": "cuda_events_call",
                     "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "pass_ms": passes}
        del r, k, v, w, u, s0, d_o, d_s, chunks, s_out, got, want
        torch.cuda.empty_cache()
    n = train["launches_train"]["wkv_bwd"]
    return {"name": "wkv_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/wkv_bwd.cu",
            "replaces": "src/repro/models/ssm.py:56",
            "shape": "b 1, t 4096, h 40, d 64", "launches": n,
            "launches_by_path": {"train": n}, "max_abs_err": worst, **times}


# ------------------------------------------------------------ MoE path

MOE_ARCH = "granite-moe-1b-a400m"
# the MoE FFN's contractions by einsum spec: the one-hot dispatch and
# combine, and the three expert products
MOE_SPECS = {"gsec,gsd->gecd": "dispatch", "gsec,gecd->gsd": "combine",
             "gecd,edf->gecf": "experts (gate, up)",
             "gecf,efd->gecd": "experts (down)"}


@contextlib.contextmanager
def _moe_einsum(wrap):
    """While the block runs, `models/moe.py` calls `wrap(spec, *ops)` in
    place of `torch.einsum` (the module's `torch` is swapped for a proxy
    here only)."""
    import torch
    from repro_torch.models import moe as MoE

    class Proxy:
        einsum = staticmethod(wrap)

        def __getattr__(self, name):
            return getattr(torch, name)

    MoE.torch = Proxy()
    try:
        yield
    finally:
        MoE.torch = torch


@contextlib.contextmanager
def moe_einsum_times(out: dict):
    """While the block runs, each einsum of `models/moe.py` is bracketed
    by a pair of CUDA events (no synchronize); on exit `out` holds the
    milliseconds per `MOE_SPECS` label, summed over the calls, and the
    call counts."""
    import torch

    pairs = []

    def timed(spec, *ops):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = torch.einsum(spec, *ops)
        e1.record()
        pairs.append((MOE_SPECS[spec], e0, e1))
        return res

    try:
        with _moe_einsum(timed):
            yield
    finally:
        torch.cuda.synchronize()
        for label, e0, e1 in pairs:
            out[label] = out.get(label, 0.0) + e0.elapsed_time(e1)
            out[f"{label} calls"] = out.get(f"{label} calls", 0) + 1


@contextlib.contextmanager
def moe_routing(cur: dict, log: dict, replay: dict | None = None):
    """While the block runs, every `moe_apply` call made while
    `cur["rid"]` names a request appends to `log[rid]` its routing, on
    the device: the top-k expert indices [G, S, K] and per choice its
    admitted place, expert * C + position, or -1 where capacity dropped
    it.  With `replay` (another run's `log`), such a call takes its
    top-k indices from `replay[rid]`, in order, with their probabilities
    gathered from its own: the other run's routes, forced.  The module's
    `top_k` is swapped here only."""
    import torch
    from repro_torch.models import moe as MoE

    top_k, pending = MoE.top_k, {}

    def spy_top_k(probs, k):
        rid = cur["rid"]
        if rid is None:
            return top_k(probs, k)
        calls = log.setdefault(rid, [])
        if replay is None:
            vals, idx = top_k(probs, k)
        else:
            idx = replay[rid][len(calls)][0]
            vals = probs.gather(-1, idx)
        pending["idx"] = idx
        return vals, idx

    def spy_einsum(spec, *ops):
        if MOE_SPECS[spec] == "dispatch" and cur["rid"] is not None:
            idx, disp = pending.pop("idx"), ops[0]
            c = disp.shape[-1]
            d = disp.gather(2, idx[..., None].expand(*idx.shape, c))
            place = torch.where(d.amax(-1) > 0, idx * c + d.argmax(-1), -1)
            log[cur["rid"]].append((idx, place))
        return torch.einsum(spec, *ops)

    MoE.top_k = spy_top_k
    try:
        with _moe_einsum(spy_einsum):
            yield
    finally:
        MoE.top_k = top_k


def _route_flips(a: dict, b: dict, n: int) -> list:
    """Per request of two runs' `moe_routing` logs: (top-k expert choices
    that differ, admitted (token, slot, expert, position) choices that
    differ); (0, 0) for a request with no MoE call."""
    out = []
    for rid in range(n):
        ra, rb = a.get(rid, []), b.get(rid, [])
        check(len(ra) == len(rb), f"req {rid}: {len(ra)} / {len(rb)} MoE "
              "calls")
        out.append((sum(int((x[0] != y[0]).sum()) for x, y in zip(ra, rb)),
                    sum(int((x[1] != y[1]).sum()) for x, y in zip(ra, rb))))
    return out


def serve_moe() -> dict:
    """Phase 22: granite-moe-1b-a400m at full width and depth (24 layers
    of 32 experts, top-8) through `_serve_model` (flash prefill, MoE FFNs
    in plain torch, the plain path compared token for token, the routing
    choices that differ counted and the logits held with the kernel
    path's routes forced, its busy share); then one 4096-token prefill with each MoE contraction timed
    (`moe_einsum_times`): the one-hot dispatch and combine beside the
    expert products."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as TF

    cfg = get_config(MOE_ARCH)
    out = _serve_model(cfg)
    s = MoE.group_size(cfg)
    print(f"serve {cfg.name} routing: groups of {s} tokens, capacity "
          f"{MoE.capacity(s, cfg.n_experts, cfg.top_k)} a (group, expert), "
          f"{cfg.n_experts} experts, top-{cfg.top_k}")
    params = TF.init_params(torch.Generator("cuda").manual_seed(SEED), cfg,
                            device="cuda")
    toks = torch.tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, SERVE_PROMPTS[0])), device="cuda")
    with torch.no_grad():
        times = {}
        with moe_einsum_times(times):
            _, t = wall(lambda: TF.prefill(params, toks, cfg,
                                           max_len=SERVE_MAX_LEN,
                                           use_flash=True,
                                           dtype=torch.float32))
    del params
    torch.cuda.empty_cache()
    route = times["dispatch"] + times["combine"]
    experts = times["experts (gate, up)"] + times["experts (down)"]
    print(f"serve {cfg.name} MoE contractions in one {SERVE_PROMPTS[0]}-"
          f"token prefill ({t:.3f} s wall; CUDA events around each einsum, "
          f"{cfg.n_layers} layers): dispatch {times['dispatch']:.2f} ms + "
          f"combine {times['combine']:.2f} ms = {route:.2f} ms, expert "
          f"products {experts:.2f} ms (gate and up "
          f"{times['experts (gate, up)']:.2f} ms, down "
          f"{times['experts (down)']:.2f} ms): one-hot routing "
          f"{route / experts:.2f}x the expert products")
    check(times["dispatch calls"] == cfg.n_layers,
          f"{times['dispatch calls']} dispatch contractions, expected "
          f"{cfg.n_layers}")
    out["moe_ms"] = {"dispatch": times["dispatch"],
                     "combine": times["combine"], "experts": experts}
    return out


def train_moe() -> dict:
    """Phase 23: granite-moe-1b-a400m trained at full width and depth with
    phase 17's recipe (`Trainer`, bf16 compute, float32 parameters and
    AdamW moments, remat, accum 2, 2 x 4096 tokens of
    `SyntheticLM(seed=0)` a step, 3 steps): no hand-written kernel
    launched (attention trains through the plain path, MoE is plain
    torch); losses finite, every MoE layer's auxiliary loss finite and in
    (0, E] in every step; seconds per step, tokens per second, peak
    memory; one more step under `torch.profiler`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as TF

    cfg = get_config(MOE_ARCH)
    n_tree = sum(t.numel() for t in _tree_leaves(TF.init_params(
        torch.Generator(), cfg, device="meta")))
    auxes = []
    apply = MoE.moe_apply

    def recorded(p, x, c):
        out, aux = apply(p, x, c)
        auxes.append(aux.detach())
        return out, aux

    MoE.moe_apply = recorded
    try:
        run = _train_run(cfg, plain=False)
    finally:
        MoE.moe_apply = apply
    _train_report(cfg, run, n_tree)
    n = run["launches"]
    print(f"train path kernels {cfg.name} ({TRAIN_STEPS} steps): "
          f"{json.dumps(n)}")
    check(not any(n.values()), f"the MoE training path launched a "
          f"hand-written kernel: {n}")
    check(all(math.isfinite(m["loss"]) for m in run["metrics"]),
          "a loss is not finite")
    # the forward's calls: remat's recompute stops once it has rebuilt
    # what the backward needs, before the wrapper records its aux
    per_step = len(auxes) // TRAIN_STEPS
    n_moe = sum(s.ffn != "dense" for s in cfg.group_spec()) * (
        cfg.n_layers // len(cfg.group_spec()))
    check(per_step * TRAIN_STEPS == len(auxes)
          and per_step in (n_moe * TRAIN_ACCUM, 2 * n_moe * TRAIN_ACCUM),
          f"{len(auxes)} MoE calls recorded in {TRAIN_STEPS} steps, "
          f"expected {n_moe} layers x {TRAIN_ACCUM} microbatches a step "
          "(twice that with remat's recompute)")
    vals = torch.stack(auxes).float().cpu().reshape(TRAIN_STEPS, per_step)
    for i, row in enumerate(vals):
        print(f"train {cfg.name} step {i} aux: {per_step} MoE calls, per "
              f"layer {row.min():.6f}-{row.max():.6f} (bound (0, "
              f"{cfg.n_experts}])")
        check(bool(torch.isfinite(row).all() and (row > 0).all()
                   and (row <= cfg.n_experts).all()),
              f"step {i}: an aux loss outside (0, {cfg.n_experts}]")
    tr = run["trainer"]

    def one_more():
        tr.tcfg.steps = TRAIN_STEPS + 1
        tr.run(start_step=TRAIN_STEPS)
    busy_share(f"train path {cfg.name} (one step)", one_more,
               watch=("gemm", "bmm"))
    del tr, run["trainer"], one_more
    torch.cuda.empty_cache()
    return {"launches_train": n, "step_s": run["step_s"]}


MAMBA_BWD_TOL = 1e-3         # rtol = atol: the backward vs its plain version
# (b, t, di, ds, initial state and final state's gradient): jamba's
# training shape, a ragged 1300 with B = 2 and ds = 8, and a nonzero
# initial state with a nonzero final-state gradient
SCAN_BWD_SHAPES = {"jamba 4096": (1, 4096, 16384, 16, False),
                   "ragged 1300 b2 ds8": (2, 1300, 16384, 8, False),
                   "from a state": (2, 300, 16384, 16, True)}
MIXER_TOL = 1e-3             # relative norm gap of each parameter gradient


def kernel_mamba_bwd(launches: int) -> dict:
    """Phase 24: the selective-scan backward kernel against its plain
    version (`torch.autograd.grad` through the plain step loop) on the
    card at every `SCAN_BWD_SHAPES` shape, every gradient within rtol =
    atol = 1e-3 (each max abs printed); its time at jamba's shape (CUDA
    events, median of 10 calls of `mamba_scan_backward` on the forward's
    saved chunk states; each of its two CUDA kernels' device time; the
    bytes and rows of its dB / dC partials) beside its bound and the
    plain version's time; then one full-width Jamba
    Mamba mixer (d_model 8192, d_inner 16384) at T = 4096 in float32:
    every parameter gradient through the kernels and through the plain
    scan (its forward step loop with the plain reverse recurrence
    `ref.mamba_scan_backward` as its gradient), relative norm gap
    <= 1e-3.  `launches`: the backward's launches on the training path
    (phase 21's Jamba)."""
    import torch
    from repro_torch.kernels.mamba_scan import ops, ref

    def make(shape, seed):
        b, t, di, ds, with_state = shape
        g = torch.Generator("cuda").manual_seed(seed)

        def n(*shp):
            return torch.randn(shp, generator=g, device="cuda")
        return (0.5 * n(b, t, di),
                torch.nn.functional.softplus(n(b, t, di) - 1.0),
                0.5 * n(b, t, ds), 0.5 * n(b, t, ds),
                -torch.exp(0.3 * n(di, ds)),
                0.5 * n(b, di, ds) if with_state else None, n(b, t, di),
                n(b, di, ds) if with_state else None)

    def plain_grads(x, dt, bm, cm, a, h0, dy, dh):
        ins = [z.clone().requires_grad_() for z in (x, dt, bm, cm, a)]
        if h0 is not None:
            ins.append(h0.clone().requires_grad_())
        y, h = ref.mamba_scan(*ins[:5], h0=None if h0 is None else ins[5])
        outs, cts = [y], [dy]
        if dh is not None:
            outs.append(h)
            cts.append(dh)
        return torch.autograd.grad(outs, ins, cts)

    worst, times = 0.0, None
    for i, (label, shape) in enumerate(SCAN_BWD_SHAPES.items()):
        x, dt, bm, cm, a, h0, dy, dh = make(shape, SEED + 60 + i)
        _, _, chunks = ops._forward(x, dt, bm, cm, a, h0, None,
                                    save_chunks=True)
        got = ops.mamba_scan_backward(x, dt, bm, cm, a, chunks, dy, dh,
                                      need_h0=h0 is not None)
        want, plain_s = wall(lambda: plain_grads(x, dt, bm, cm, a, h0, dy,
                                                 dh))
        errs = {}
        for name, g_, w_ in zip(("x", "dt", "B", "C", "A", "h0"), got,
                                want):
            diff = (g_ - w_).abs()
            errs[name] = diff.max().item()
            check(bool((diff <= MAMBA_BWD_TOL
                        + MAMBA_BWD_TOL * w_.abs()).all()),
                  f"mamba_scan_bwd {label}: d{name} beyond rtol = atol = "
                  f"{MAMBA_BWD_TOL:g} (max abs {errs[name]:.3e})")
        worst = max(worst, *errs.values())
        print(f"mamba_scan_bwd {label} {shape}: max abs "
              + ", ".join(f"d{k} {e:.3e}" for k, e in errs.items())
              + f"; bound rtol = atol = {MAMBA_BWD_TOL:g}; plain (autograd "
              f"through the step loop) {plain_s * 1e3:.1f} ms")
        if i == 0:
            b_, t_, di_, ds_, _ = shape

            def call():
                return ops.mamba_scan_backward(x, dt, bm, cm, a, chunks, dy)
            ms = cuda_ms(call, reps=10)
            passes = {}
            for p in ("mamba_scan_bwd_kernel", "mamba_scan_bwd_reduce"):
                try:
                    passes[p] = kernel_ms(call, p)
                except NoProfilerRecord:    # a measurement only
                    passes[p] = None
            n_bytes = ops.mamba_scan_bwd_hbm_bytes(b_, t_, di_, ds_)
            n_ops = ops.mamba_scan_bwd_flops(b_, t_, di_, ds_)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            print(f"  kernel {ms:.4f} ms (the wrapper call's CUDA-event "
                  f"time), bound {b_ms:.4f} ms ({b_by}: {n_ops:.4e} "
                  f"operations at 67 TFLOP/s, {n_bytes / 1e6:.1f} MB at "
                  f"3.35 TB/s), {ms / b_ms:.2f}x the bound; plain "
                  f"{plain_s * 1e3:.1f} ms; library none")
            rows = ops._bwd_lib().mamba_scan_bwd_rows(di_)
            part_bytes = 4 * rows * b_ * t_ * 2 * ds_
            print("  device time a call by CUDA kernel (torch.profiler, "
                  "mean of 5 launches): " + ", ".join(
                      f"{p} " + ("not recorded" if m is None
                                 else f"{m:.4f} ms")
                      for p, m in passes.items())
                  + f"; dB / dC partials {part_bytes / 1e6:.1f} MB "
                  f"({rows} rows)")
            times = {"ms": ms, "ms_source": "cuda_events_call",
                     "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "pass_ms": passes, "partial_bytes": part_bytes}
        del x, dt, bm, cm, a, h0, dy, dh, chunks, got, want
        torch.cuda.empty_cache()
    mixer = _mamba_mixer_check()
    return {"name": "mamba_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/mamba_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:184",
            "shape": "b 1, t 4096, di 16384, ds 16", "launches": launches,
            "launches_by_path": {"train jamba (phase 21)": launches},
            "max_abs_err": worst, "mixer_grad_gap": mixer, **times}


def _mamba_mixer_check() -> float:
    """Phase 24b: one Mamba mixer of jamba-1.5-large at full width
    (d_model 8192, d_inner 16384, d_state 16), seeded float32 weights, one
    4096-token input: every parameter's gradient of sum(out * w) through
    the scan kernel and its backward, and through the plain scan; the
    largest relative norm gap |g - g_plain| / |g_plain| must be <= 1e-3.
    Returns it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.models import ssm as SSM

    cfg = get_config("jamba-1.5-large-398b")
    gen = torch.Generator("cuda").manual_seed(SEED)
    p = SSM.mamba_init(gen, cfg, device="cuda")
    x = torch.randn((1, SERVE_PROMPTS[0], cfg.d_model), generator=gen,
                    device="cuda")
    w = torch.randn(x.shape, generator=gen, device="cuda")
    grads = {}
    for plain in (False, True):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        saved = scan_ops.mamba_scan
        reset_counts()
        if plain:
            scan_ops.mamba_scan = scan_ref.mamba_scan_with_grad
        try:
            out, _ = SSM.mamba_apply(leaves, x, cfg)
            _, secs = wall(lambda: (out * w).sum().backward())
        finally:
            scan_ops.mamba_scan = saved
        n = read_counts()
        grads[plain] = {k: v.grad for k, v in leaves.items()}
        print(f"mamba mixer {cfg.d_model} x {SERVE_PROMPTS[0]} "
              f"{'plain' if plain else 'kernels'}: backward {secs:.3f} s, "
              f"mamba_scan {n['mamba_scan']} mamba_scan_bwd "
              f"{n['mamba_scan_bwd']} launches")
        check((n["mamba_scan"], n["mamba_scan_bwd"])
              == ((0, 0) if plain else (1, 1)),
              f"mixer launches {n['mamba_scan']}, {n['mamba_scan_bwd']}")
        del leaves, out
    gaps = {k: float((grads[False][k] - g).norm() / g.norm())
            for k, g in grads[True].items()}
    print("mamba mixer gradients, kernels vs plain, relative norm gap: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (bound {MIXER_TOL:g})")
    check(max(gaps.values()) <= MIXER_TOL, f"mixer gradients differ: {gaps}")
    del grads, p, x, w
    torch.cuda.empty_cache()
    return max(gaps.values())


def train_guards() -> None:
    """Phase 19: flash_attention, which has no backward, refuses
    grad-requiring inputs on the card; mamba_scan, which has its backward
    kernel, returns outputs with a grad_fn; both launch as before under
    no_grad."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops

    q = torch.randn((1, 128, 4, 64), device="cuda", requires_grad=True)
    kv = torch.randn((1, 128, 2, 64), device="cuda")
    x = torch.randn((1, 16, 64), device="cuda", requires_grad=True)
    dt = torch.rand((1, 16, 64), device="cuda")
    bm = torch.randn((1, 16, 16), device="cuda")
    a = -torch.rand((64, 16), device="cuda")
    try:
        flash_ops.flash_attention(q, kv, kv)
    except NotImplementedError as e:
        print(f"train guard flash_attention: NotImplementedError ({e})")
    else:
        raise SmokeFailure("flash_attention took grad-requiring inputs")
    y, h = scan_ops.mamba_scan(x, dt, bm, bm, a)
    check(y.grad_fn is not None and h.grad_fn is not None,
          "mamba_scan's outputs carry no gradient")
    print(f"train guard mamba_scan: outputs with grad_fn "
          f"{type(y.grad_fn).__name__} (the backward kernel)")
    with torch.no_grad():
        flash_ops.flash_attention(q, kv, kv)
        scan_ops.mamba_scan(x, dt, bm, bm, a)


# the launchers phase 20 runs, with what each must print: the serving
# launcher its 4 requests, the training launcher its loss line
LAUNCHERS = (("serve", SERVE_ARCH), ("serve", "rwkv6-3b"),
             ("serve", "granite-moe-1b-a400m"), ("train", TRAIN_ARCH),
             ("train", SERVE_ARCH), ("train", "granite-moe-1b-a400m"))


def launchers_start() -> list:
    """Phase 20, started: the port's launchers on the card, as a user
    runs them, all at once in the background while the cross-device
    phases run: `python -m repro_torch.launch.serve --arch
    glm4-9b|rwkv6-3b|granite-moe-1b-a400m --device cuda` (reduced,
    float32, kernel prefill) and `python -m repro_torch.launch.train
    --arch rwkv6-3b|glm4-9b|granite-moe-1b-a400m --device cuda --steps 3`
    (reduced, float32)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for kind, arch in LAUNCHERS:
        cmd = [sys.executable, "-m", f"repro_torch.launch.{kind}", "--arch",
               arch, "--device", "cuda"] + (
                   ["--steps", "3"] if kind == "train" else [])
        procs.append((kind, arch, cmd, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def launchers_finish(procs) -> None:
    """Phase 20, collected: each launcher exits 0; a serving launcher
    prints its 4 requests, a training launcher its loss line."""
    import re
    for kind, arch, cmd, proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.splitlines()
        print(f"launcher `{' '.join(cmd[1:])}`: rc {proc.returncode}")
        for line in lines:
            print(f"  {line}")
        check(proc.returncode == 0, f"the launcher failed:\n{err[-3000:]}")
        if kind == "serve":
            check(sum(line.startswith("req ") for line in lines) == 4,
                  "the serving launcher did not print its 4 requests")
        else:
            check(any(re.match(rf"^{re.escape(arch)}: loss \d+\.\d{{3}} "
                               r"-> \d+\.\d{3} in \d+s on 1 device\(s\)$",
                               line) for line in lines),
                  f"the {arch} training launcher printed no loss line")


# phase 21's models with their batches (rows, tokens): reduced rwkv6-3b
# (D = 32), reduced granite with its 32 experts (top-8, capacity below
# the routing group) and one period of reduced Jamba with its experts (7
# Mamba layers: the scan kernel and its backward; MoE on every second
# layer), the last two on 2 x 32 tokens (their CPU side is the phase's
# cost)
CROSS_TRAIN = {"rwkv6-3b": ((4, 64), {}),
               "granite-moe-1b-a400m": ((2, 32), {"n_experts": 32}),
               "jamba-1.5-large-398b": ((2, 32), {"n_layers": 8})}


def cross_device_train() -> dict:
    """Phase 21: each `CROSS_TRAIN` model trained 3 steps in float32 on
    the card (the WKV and selective-scan kernels and their backward
    kernels) and on the CPU (plain versions) from the same weights and
    batches: losses within 1e-5 relative, grad norms within 1e-5 relative
    or twice what one float32 ulp of parameter noise moves the CPU's own
    (`grad_norm_noise`, from the initial weights, measured only where a
    gap exceeds 1e-5), every parameter within atol 1e-6 + rtol 1e-4.
    The card's launches are counted per model (reset just before, read
    just after its 3 steps); returned by model."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.step import TrainConfig, train_step

    launches = {}
    for arch, ((rows, seq), kw) in CROSS_TRAIN.items():
        cfg = reduced(get_config(arch), **kw)
        tcfg = TrainConfig(accum_steps=2, dtype=torch.float32)
        cpu = TF.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
        params = {"cpu": cpu, "cuda": _tree_to(cpu, "cuda")}
        opts = {d: adamw_init(p) for d, p in params.items()}
        rng = np.random.default_rng(SEED)
        batches = [rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(
            np.int32) for _ in range(3)]

        def batch(toks, dev):
            return {"tokens": torch.tensor(toks[:, :-1], device=dev),
                    "targets": torch.tensor(toks[:, 1:], device=dev)}

        init = tree_map(torch.clone, cpu)  # for the spread, if needed
        gaps = {"loss": [], "grad_norm": []}
        card = {}
        for toks in batches:
            m = {}
            for dev in ("cuda", "cpu"):
                if dev == "cuda":
                    reset_counts()
                params[dev], opts[dev], m[dev] = train_step(
                    params[dev], opts[dev], batch(toks, dev), cfg, tcfg,
                    inplace=True)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    for k, v in read_counts().items():
                        card[k] = card.get(k, 0) + v
            for key in gaps:
                a, b = float(m["cuda"][key]), float(m["cpu"][key])
                gaps[key].append(abs(a - b) / abs(b))
        worst = max(((a.cpu() - b).abs() / (1e-6 + 1e-4 * b.abs())).max()
                    .item() for a, b in zip(_tree_leaves(params["cuda"]),
                                            _tree_leaves(params["cpu"])))
        used = {k: v for k, v in card.items() if v}
        # the spread widens the bound only past 1e-5: measured only then
        if max(gaps["grad_norm"]) > 1e-5:
            noise = max(abs(x) for x in grad_norm_noise(
                init, batch(batches[0], "cpu"), cfg, tcfg))
            spread = f"the CPU's own 1-ulp spread {noise:.2e}"
        else:
            noise, spread = 0.0, "every gap within 1e-5: the spread unmeasured"
        gn_bound = max(1e-5, 2 * noise)
        print(f"cross-device train {cfg.name}: loss gaps "
              f"{[f'{g:.2e}' for g in gaps['loss']]} (bound 1e-5), grad_norm"
              f" gaps {[f'{g:.2e}' for g in gaps['grad_norm']]} (bound "
              f"{gn_bound:.2e}: {spread}), parameters at {worst:.3f} of atol "
              f"1e-6 + rtol 1e-4; card kernels {used}")
        check(max(gaps["loss"]) <= 1e-5, f"{arch}: card and CPU losses "
              f"differ: {gaps}")
        check(max(gaps["grad_norm"]) <= gn_bound,
              f"{arch}: card and CPU grad norms differ: {gaps}")
        check(worst <= 1.0, f"{arch}: card and CPU parameters differ")
        layers = _mixer_layers(cfg)
        want = {"wkv": 2 * 3 * 2 * layers["rwkv6"],
                "wkv_bwd": 3 * 2 * layers["rwkv6"],
                "mamba_scan": 2 * 3 * 2 * layers["mamba"],
                "mamba_scan_bwd": 3 * 2 * layers["mamba"]}
        check(used == {k: v for k, v in want.items() if v},
              f"{arch}: the card's training launched {used}, expected "
              f"{want} (forward and remat recompute, backward, per layer, "
              "microbatch and step)")
        launches[arch] = card
    return launches


# phase 12's models, with their experts: reduced granite keeps 32 (its
# capacity below the routing group), arctic and Jamba `reduced`'s 8
CROSS_SERVE = {"glm4-9b": {}, "gemma3-12b": {}, "rwkv6-3b": {},
               "jamba-1.5-large-398b": {},
               "granite-moe-1b-a400m": {"n_experts": 32},
               "arctic-480b": {}}


def cross_device_serve() -> None:
    """Phase 12: each `CROSS_SERVE` model served on the card (kernel
    prefill, the selective scan in decode, MoE FFNs in plain torch) and
    on the CPU (plain versions) from the same seeded weights:
    `examples/port_serve_batch.py`'s 6 requests, float32, max_len 128;
    the served tokens must be equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import Request, ServeEngine

    for arch, kw in CROSS_SERVE.items():
        cfg = reduced(get_config(arch), **kw)
        cpu = TF.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
        outs = {}
        for dev in ("cuda", "cpu"):
            params = cpu if dev == "cpu" else _tree_to(cpu, dev)
            eng = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                              dtype=torch.float32, device=dev)
            rng = np.random.default_rng(0)
            for i in range(6):
                eng.submit(Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, 8 + 4 * i).astype(np.int32),
                    max_new_tokens=12))
            outs[dev] = {r.rid: r.out for r in eng.run_until_drained()}
        same = sum(outs["cuda"][i] == outs["cpu"][i] for i in range(6))
        print(f"cross-device serve {cfg.name} ({cfg.n_experts} experts, "
              f"top-{cfg.top_k}): {same} of 6 requests served the same "
              "tokens on the card (kernels) and the CPU")
        check(same == 6, f"{arch}: card and CPU tokens differ")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    try:
        card = card_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
              f"{torch.cuda.get_device_name(0)} ({card})")
        print(host_probe())
        t0 = time.perf_counter()
        build.build_all()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        for name in build.SOURCES:
            for line in build.log_path(name).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        env = phase(main_path, {})
        phase(time_breakdown, env)
        k1 = phase(kernel_margin_grid, env)
        for fn in (thermal_path, thermal_breakdown, region_path,
                   region_breakdown, fault_path, fault_breakdown,
                   traffic_path, campaign_engine, fleet_path,
                   cross_device_fleet, figures_path):
            phase(fn, env)
        k1.update(path_launches(env, "margin_grid"))
        k1.update(phase(kernel_margin_small, env))
        k1.update(phase(kernel_margin_keyed, env))
        k1["max_abs_err"] = max(k1["max_abs_err"], k1["max_abs_err_small"],
                                k1["max_abs_err_keyed"])
        k1["launches_by_shape"] = {p: env[f"margin_shapes_{p}"]
                                   for p in ("main", "region", "fleet",
                                             "figures")}
        k2, k3, k4, k5, k6, k7, k8, k9 = (phase(fn, env) for fn in (
            kernel_replay, kernel_replay_banked, kernel_adaptive,
            kernel_replay_regioned, kernel_adaptive_regioned,
            kernel_replay_faulted, kernel_adaptive_faulted,
            kernel_replay_multi))
        # the serve path needs the AL-DRAM phases' memory back; the
        # traffic profile (~131k kernel records) runs after every kernel
        # timing, since a trace that size has left the next profiler
        # session with no record
        traffic = {"traffic_traces": env["traffic_traces"]}
        del env
        torch.cuda.empty_cache()
        serve = phase(serve_path)
        k10 = phase(kernel_flash, serve)
        k11 = phase(kernel_wkv, phase(serve_rwkv6))
        serve_h = phase(serve_jamba)
        k12 = phase(kernel_mamba, serve_h)
        serve_m = phase(serve_moe)
        for path, run in (("serve jamba", serve_h), ("serve granite",
                                                     serve_m)):
            k10["launches_by_path"][path] = \
                run["launches_serve"]["flash_attention"]
            k10["launches"] += k10["launches_by_path"][path]
        train = phase(train_path)
        k11["launches_by_path"]["train"] = train["launches_train"]["wkv"]
        k11["launches"] += k11["launches_by_path"]["train"]
        meshed = phase(train_mesh, train)
        counted = meshed["launches_cost"]
        meshed = meshed["launches_train_mesh"]
        k11["launches_by_path"]["train mesh"] = meshed["wkv"]
        k11["launches_by_path"]["cost (17d)"] = counted["wkv"]
        k11["launches"] += meshed["wkv"] + counted["wkv"]
        k13 = phase(kernel_wkv_bwd, train)
        k13["launches_by_path"]["train mesh"] = meshed["wkv_bwd"]
        k13["launches_by_path"]["cost (17d)"] = counted["wkv_bwd"]
        k13["launches"] += meshed["wkv_bwd"] + counted["wkv_bwd"]
        phase(train_moe)
        phase(train_guards)
        phase(traffic_breakdown, traffic)
        del traffic
        launchers = phase(launchers_start)
        phase(cross_device_thermal, phase(cross_device))
        for fn in (cross_device_region, cross_device_fault,
                   cross_device_traffic, cross_device_engine,
                   cross_device_serve):
            phase(fn)
        trained = phase(cross_device_train)["jamba-1.5-large-398b"]
        k12["launches_by_path"]["train jamba (phase 21)"] = \
            trained["mamba_scan"]
        k12["launches"] += trained["mamba_scan"]
        phase(launchers_finish, launchers)
        k14 = phase(kernel_mamba_bwd, trained["mamba_scan_bwd"])
        print("phase seconds: " + json.dumps(PHASE_SECONDS))
        print(f"chip_smoke seconds: {time.perf_counter() - t0:.1f}")
        print(host_probe())
    except Exception:                       # report and fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(card)
    kernels = [k1, k2, k3, *k4, k5, k6, k7, k8, k9, k10, k11, k12, k13,
               k14]
    for k in kernels:
        # `ms`: torch.profiler device time, unless the entry says that
        # it is a wrapper call's CUDA-event time
        k.setdefault("ms_source", "torch_profiler")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

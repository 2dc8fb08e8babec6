// Closed-loop (adaptive) DRAM trace replay for Hopper: every (cell g,
// lane l) pair replays cell g's request stream under lane l's timing-table
// stack and thermal scenario, re-selecting its temperature bin per request.
//
// Replaces the Pallas TPU kernel `adaptive_blocks` of
// src/repro/kernels/replay/replay.py (`_adaptive_kernel`, launched at
// :626): module tables [S+1, 6, L] (variant a), per-bank tables
// [n_banks, S+1, 6, L] (variant b) and mask-compressed subarray-region
// tables [U, S+1, 6, L] gathered through an index map (variant c, the
// regioned branch at replay.py:392), one channel, no faults.
// Plain version: repro_torch/core/dram_sim.py (`replay_adaptive_cells`,
// `service_math`, `thermal.ambient_at`, `power.access_energy_from_terms`).
//
// Inputs (row-major, float32 unless noted): closed [G] (1 = closed page);
// arrival [G, N]; bank, row, is_write, valid [G, N] int32; tables
// [(n_banks | U,) R, 6, L] with R = S + 1 rows per stack, the JEDEC row
// last; for (c) region_map int32 [n_banks * NR] shared by every lane, or
// [n_banks * NR, L] per lane, with values in [0, U) (NR regions per bank);
// scn [9, L] scenario rows (base, amp_sin, period_sin, amp_step, t_step,
// amp_burst, period_burst, duty, hyst_scale); edges [E] ascending bin
// edges (E = S, or one +inf edge when S = 0); tcfg [6] (tau, c_heat,
// hyst_c, e_burst, e_act_pre, p_act_standby).
// Outputs: lat [G, N, L] (0 at padding); total, temp_max, temp_mean [G, L];
// switches [G, L] int32; heat [G, n_banks, L]; and, when emit_raw, the
// sensed temperatures [G, N, L] (0 at padding) and selected bins [G, N, L]
// int32 (-1 at padding).
//
// Design.  One block per cell g (x blocks of lanes), one thread per lane.
// Every lane of a block reads the same stream, so the block stages it
// through shared memory in chunks of kChunk requests, as replay.cu does.
// The bank FSM (open_row, act_time, wr_done, ready per bank) and the
// mlp_window done-ring sit in shared memory indexed [slot][lane] (a
// request's bank is data).  The per-bank RC heat lives in registers
// (kMaxBanks-wide array, loops fully unrolled with a runtime guard, so
// every index is a constant), and so do the current bin, the last arrival
// and the diagnostics: temp_max, the running temp sum and the switch
// count are reduced here and only [G, L] values are written.  The table
// row of the selected (bin[, bank]) is read from global memory (read-only
// and L1-resident: L * R * 6 * 4 bytes, x n_banks for variant b).
// Variant (c) resolves the request's (bank, region) slot bank * NR +
// region_of(row, NR) — int32 arithmetic, (row mod 512) * NR / 512 with a
// floored modulo — to a unique column u through the map and reads column
// u at the selected bin (a template instantiation of its own,
// kRegioned); the heat registers stay per bank.
//
// Numerics.  Each step follows the plain version operation for operation:
// decay heat * expf((-dt) / tau) with a true division; the sensed
// temperature ((base + a_sin * sinf((2pi_f32 * t) / p_sin)) + step) +
// burst plus the decayed heats summed bank 0 first, left to right; the
// floored remainder for the burst phase (fmodf, sign-corrected); bins as
// counts of edges below the reading; the energy e_burst + miss * (e_act_pre
// + p_as * tras).  The build turns off FMA contraction and fast math, so
// the kernel rounds like PyTorch's own CUDA float32 operations: a
// last-bit difference in the reading would flip a bin at an edge and
// change the lane's timing row from then on.
//
// Bound.  The N requests of a lane form one dependent chain (each step
// needs the previous heat, bin and bank state), so the kernel is bound by
// N sequential steps of latency (an expf, a sinf and a few dozen
// dependent float operations each), not by its bytes (20 B read per
// request per cell, 4 B written per request per lane, 12 B more with
// emit_raw) or operations.  At the thermal campaign's shape (G = 70 cells,
// L = 8 lanes) only 560 lanes are live on the whole card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 1024;    // requests staged per shared-memory chunk
constexpr int kMaxLanes = 128;  // lanes per block
constexpr int kMaxBanks = 16;   // heat registers per lane
constexpr float kTwoPi = 6.2831854820251465f;  // float32(2 * pi)
constexpr int kSubarrayRows = 512;              // dram_sim.SUBARRAY_ROWS

__device__ __forceinline__ float floored_rem(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

template <bool kRegioned>
__global__ void adaptive_kernel(
    const float* __restrict__ closed, const float* __restrict__ arrival,
    const int* __restrict__ bank, const int* __restrict__ row,
    const int* __restrict__ is_write, const int* __restrict__ valid,
    const float* __restrict__ tables, const int* __restrict__ region_map,
    const float* __restrict__ scn,
    const float* __restrict__ edges, const float* __restrict__ tcfg,
    float* __restrict__ lat, float* __restrict__ total,
    float* __restrict__ tmax_out, float* __restrict__ tmean_out,
    int* __restrict__ sw_out, float* __restrict__ heat_out,
    float* __restrict__ temps_out, int* __restrict__ bins_out, int n,
    int lanes, int n_edges, int n_rows, int n_banks, int mlp_window,
    int banked, int n_regions, int map_per_lane, int emit_raw) {
  extern __shared__ float smem[];
  const int bs = blockDim.x;
  const int lane = threadIdx.x;
  const int g = blockIdx.x;
  const int l = blockIdx.y * bs + lane;
  const bool live = l < lanes;

  // shared layout: [chunk arrival][chunk bank][chunk row][chunk flags]
  //                [open][act][wrd][rdy] (each n_banks x bs) [ring W x bs]
  float* s_arr = smem;
  int* s_bank = reinterpret_cast<int*>(s_arr + kChunk);
  int* s_row = s_bank + kChunk;
  int* s_flag = s_row + kChunk;
  float* st_open = reinterpret_cast<float*>(s_flag + kChunk);
  float* st_act = st_open + n_banks * bs;
  float* st_wrd = st_act + n_banks * bs;
  float* st_rdy = st_wrd + n_banks * bs;
  float* st_ring = st_rdy + n_banks * bs;

  for (int b = 0; b < n_banks; ++b) {
    st_open[b * bs + lane] = -1.0f;
    st_act[b * bs + lane] = 0.0f;
    st_wrd[b * bs + lane] = 0.0f;
    st_rdy[b * bs + lane] = 0.0f;
  }
  for (int w = 0; w < mlp_window; ++w) st_ring[w * bs + lane] = 0.0f;

  const bool is_closed = closed[g] > 0.5f;
  const float tau = tcfg[0], c_heat = tcfg[1], hyst_c = tcfg[2];
  const float e_burst = tcfg[3], e_act_pre = tcfg[4], p_as = tcfg[5];
  float base = 0.f, a_sin = 0.f, p_sin = 1.f, a_step = 0.f, t_step = 0.f;
  float a_b = 0.f, p_b = 1.f, duty = 0.f, hyst = 0.f;
  if (live) {
    base = scn[0 * lanes + l];
    a_sin = scn[1 * lanes + l];
    p_sin = scn[2 * lanes + l];
    a_step = scn[3 * lanes + l];
    t_step = scn[4 * lanes + l];
    a_b = scn[5 * lanes + l];
    p_b = scn[6 * lanes + l];
    duty = scn[7 * lanes + l];
    hyst = hyst_c * scn[8 * lanes + l];
  }
  float heat[kMaxBanks];
#pragma unroll
  for (int b = 0; b < kMaxBanks; ++b) heat[b] = 0.0f;
  int cur = 0, switches = 0, n_valid = 0;
  float t_prev = 0.0f, tmax = -INFINITY, tsum = 0.0f;
  const long long cell = (long long)g * n;
  const long long stack = (long long)n_rows * 6 * lanes;   // one column

  for (int base_k = 0; base_k < n; base_k += kChunk) {
    const int len = min(kChunk, n - base_k);
    __syncthreads();   // previous chunk fully consumed
    for (int k = lane; k < len; k += bs) {
      const long long q = cell + base_k + k;
      s_arr[k] = arrival[q];
      s_bank[k] = bank[q];
      s_row[k] = row[q];
      s_flag[k] = (is_write[q] != 0 ? 1 : 0) | (valid[q] != 0 ? 2 : 0);
    }
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < len; ++kk) {
      const int k = base_k + kk;
      const long long out = (cell + k) * lanes + l;
      if ((s_flag[kk] & 2) == 0) {     // padding: state untouched
        lat[out] = 0.0f;
        if (emit_raw) {
          temps_out[out] = 0.0f;
          bins_out[out] = -1;
        }
        continue;
      }
      const float t = s_arr[kk];
      const int bk = s_bank[kk];
      const int bi = bk * bs + lane;
      const float rf = (float)s_row[kk];
      const bool w = (s_flag[kk] & 1) != 0;
      const int ri = (k % mlp_window) * bs + lane;

      // thermal loop: decay, sense, re-select the bin
      const float dt = fmaxf(t - t_prev, 0.0f);
      const float decay = expf(-dt / tau);
      float hsum = 0.0f;
#pragma unroll
      for (int b = 0; b < kMaxBanks; ++b) {
        if (b < n_banks) {
          heat[b] = heat[b] * decay;
          hsum = b == 0 ? heat[0] : hsum + heat[b];
        }
      }
      const float ambient =
          ((base + a_sin * sinf((kTwoPi * t) / p_sin)) +
           a_step * (t >= t_step ? 1.0f : 0.0f)) +
          a_b * (floored_rem(t, p_b) < duty * p_b ? 1.0f : 0.0f);
      const float reading = ambient + hsum;
      const float reading_h = reading + hyst;
      int up = 0, down = 0;
      for (int j = 0; j < n_edges; ++j) {
        const float e = edges[j];
        up += e < reading ? 1 : 0;
        down += e < reading_h ? 1 : 0;
      }
      const int new_bin = max(up, min(cur, down));
      int col = banked ? bk : 0;
      if constexpr (kRegioned) {
        int off = s_row[kk] % kSubarrayRows;
        if (off < 0) off += kSubarrayRows;
        const int slot = bk * n_regions + off * n_regions / kSubarrayRows;
        col = region_map[map_per_lane ? slot * lanes + l : slot];
      }
      const float* tp = tables + col * stack +
                        (long long)new_bin * 6 * lanes + l;
      const float trcd = tp[0 * lanes], tras = tp[1 * lanes];
      const float twr = tp[2 * lanes], trp = tp[3 * lanes];
      const float tcl = tp[5 * lanes];

      // service_math (dram_sim.py), operation for operation
      const float gate = st_ring[ri];
      const float open_b = st_open[bi], act_b = st_act[bi];
      const float wrd_b = st_wrd[bi], rdy_b = st_rdy[bi];
      const float start = fmaxf(fmaxf(t, rdy_b), gate);
      const bool is_hit = open_b == rf;
      const bool is_empty = open_b == -1.0f;
      const float pre_ok = fmaxf(act_b + tras, wrd_b);
      const float conflict_start = fmaxf(start, pre_ok);
      const float act_new =
          is_hit ? act_b : (is_empty ? start + 0.0f : conflict_start + trp);
      const float data_start =
          is_hit ? start
                 : (is_empty ? start + trcd : (conflict_start + trp) + trcd);
      const float done = data_start + tcl;
      const float wrd_new = w ? done + twr : wrd_b;
      const float pre_start = fmaxf(fmaxf(done, act_new + tras), wrd_new);
      st_open[bi] = is_closed ? -1.0f : rf;
      st_act[bi] = act_new;
      st_wrd[bi] = wrd_new;
      st_rdy[bi] = is_closed ? pre_start + trp : done;
      st_ring[ri] = done;

      // closed loop: the access energy of the row just selected
      const float miss = is_hit ? 0.0f : 1.0f;
      const float energy = e_burst + miss * (e_act_pre + p_as * tras);
      const float deposit = c_heat * energy;
#pragma unroll
      for (int b = 0; b < kMaxBanks; ++b)
        if (b == bk) heat[b] = heat[b] + deposit;

      if (k > 0 && new_bin != cur) ++switches;
      cur = new_bin;
      t_prev = t;
      tmax = fmaxf(tmax, reading);
      tsum = tsum + reading;
      ++n_valid;
      lat[out] = done - fmaxf(t, gate);
      if (emit_raw) {
        temps_out[out] = reading;
        bins_out[out] = new_bin;
      }
    }
  }

  if (live) {
    float rdy_max = st_rdy[lane], wrd_max = st_wrd[lane];
    for (int b = 1; b < n_banks; ++b) {
      rdy_max = fmaxf(rdy_max, st_rdy[b * bs + lane]);
      wrd_max = fmaxf(wrd_max, st_wrd[b * bs + lane]);
    }
    const long long o = (long long)g * lanes + l;
    total[o] = fmaxf(rdy_max, wrd_max);
    tmax_out[o] = tmax;
    tmean_out[o] = tsum / (float)n_valid;
    sw_out[o] = switches;
#pragma unroll
    for (int b = 0; b < kMaxBanks; ++b)
      if (b < n_banks) heat_out[((long long)g * n_banks + b) * lanes + l] =
          heat[b];
  }
}

int block_lanes(int lanes) {
  return lanes < kMaxLanes ? ((lanes + 31) / 32) * 32 : kMaxLanes;
}

}  // namespace

extern "C" int adaptive_smem_bytes(int lanes, int n_banks, int mlp_window) {
  return (4 * kChunk) * 4 + (4 * n_banks + mlp_window) * block_lanes(lanes) * 4;
}

// C interface (ctypes).  Returns the cudaError_t of the launch (0 =
// success); the kernel runs asynchronously on `stream` (a cudaStream_t).
// temps_out and bins_out may be NULL when emit_raw is 0, region_map when
// n_regions is 0 (variants a and b).
extern "C" int adaptive_launch(
    const float* closed, const float* arrival, const int* bank,
    const int* row, const int* is_write, const int* valid,
    const float* tables, const int* region_map, const float* scn,
    const float* edges,
    const float* tcfg, float* lat, float* total, float* tmax_out,
    float* tmean_out, int* sw_out, float* heat_out, float* temps_out,
    int* bins_out, int g, int n, int lanes, int n_edges, int n_rows,
    int n_banks, int mlp_window, int banked, int n_regions,
    int map_per_lane, int emit_raw, void* stream) {
  if (g <= 0 || n <= 0 || lanes <= 0 || n_edges <= 0 || n_rows <= 0 ||
      n_banks <= 0 || n_banks > kMaxBanks || mlp_window <= 0 ||
      n_regions < 0 || (n_regions > 0 && (!banked || region_map == nullptr)) ||
      (emit_raw && (temps_out == nullptr || bins_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int bs = block_lanes(lanes);
  const int smem = adaptive_smem_bytes(lanes, n_banks, mlp_window);
  // the region gather is compiled into the (c) instantiation only, so
  // (a) and (b) pay nothing for it
  auto kern = n_regions > 0 ? adaptive_kernel<true> : adaptive_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int gy = (lanes + bs - 1) / bs;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)g, (unsigned)gy);
  kern<<<grid, bs, smem, (cudaStream_t)stream>>>(
      closed, arrival, bank, row, is_write, valid, tables, region_map, scn,
      edges, tcfg, lat, total, tmax_out, tmean_out, sw_out, heat_out,
      temps_out, bins_out, n, lanes, n_edges, n_rows, n_banks, mlp_window,
      banked, n_regions, map_per_lane, emit_raw);
  return (int)cudaGetLastError();
}

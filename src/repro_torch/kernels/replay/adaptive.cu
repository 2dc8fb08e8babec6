// Closed-loop (adaptive) DRAM trace replay for Hopper: every (cell g,
// lane l) pair replays cell g's request stream under lane l's timing-table
// stack and thermal scenario, re-selecting its temperature bin per request.
//
// Replaces the Pallas TPU kernel `adaptive_blocks` of
// src/repro/kernels/replay/replay.py (`_adaptive_kernel`, launched at
// :626): module tables [S+1, 6, L] (variant a), per-bank tables
// [n_banks, S+1, 6, L] (variant b) and mask-compressed subarray-region
// tables [U, S+1, 6, L] gathered through an index map (variant c, the
// regioned branch at replay.py:392), each also under a fault axis
// (variant d, the faulted branch at replay.py:286-301, :335-350,
// :367-390, :412-444, :462-502), one channel.
// Plain version: repro_torch/core/dram_sim.py (`replay_adaptive_cells`,
// `service_math`, `thermal.ambient_at`, `power.access_energy_from_terms`,
// `faults`); the stream terms alone: repro_torch/kernels/replay/ref.py
// (`adaptive_stream_terms`).
//
// Inputs (row-major, float32 unless noted): closed [G] (1 = closed page);
// arrival [G, N]; bank, row, is_write, valid [G, N] int32; tables
// [(n_banks | U,) R, 6, L] with R = S + 1 rows per stack, the JEDEC row
// last; for (c) region_map int32 [n_banks * NR] shared by every lane, or
// [n_banks * NR, L] per lane, with values in [0, U) (NR regions per bank);
// scn [9, L] scenario rows (base, amp_sin, period_sin, amp_step, t_step,
// amp_burst, period_burst, duty, hyst_scale); edges [E] ascending bin
// edges (E = S, or one +inf edge when S = 0); tcfg [6] (tau, c_heat,
// hyst_c, e_burst, e_act_pre, p_act_standby); for (d) the lane-tiled fault
// rows [F_COLS, L] and the issue-order error uniforms [G, N].
// Outputs: lat [G, N, L] (0 at padding); total, temp_max, temp_mean [G, L];
// switches [G, L] int32; heat [G, n_banks, L]; when emit_raw, the
// sensed temperatures [G, N, L] (0 at padding) and selected bins [G, N, L]
// int32 (-1 at padding); for (d) the counters [5, G, L] int32 (detected,
// silent, trips, degraded, probes).
//
// Bound.  The N requests of a lane form one dependent chain: each step
// needs the previous step's bank heats, bin, bank state and (d) watchdog.
// What truly carries from step to step is the heat loop — decay the bank
// heats, sum them bank 0 first, add the ambient, (d) read through the
// faulted sensor, count the edges below the reading (and the reading plus
// hysteresis), the table row of the new bin, the access energy and its
// deposit on the request's bank: 23 dependent integer and float
// operations and one table-row read a step at n_banks = 8 and up to 8
// edges (ops.replay_chain_ops counts them), ~122 cycles, 0.25 ms at N =
// 4096 and 1.98 GHz; (d) adds the faulted sensor's 13 and its
// quantization's true division, ~210 cycles.  The bytes (20 B read per
// request per cell, 4 B written per request per lane, 12 B more with
// emit_raw) and operations bound far below that: the chain is the bound.
//
// Design.  Each step splits into the stream terms and the chain.
//
// The stream terms depend only on the request stream and the lane's
// scenario or fault row: the gap dt = max(t - t_prev, 0) to the previous
// VALID request's arrival (0 before the first), the heat decay
// expf((-dt) / tau), the ambient ((base + a_sin * sinf((2pi_f32 * t) /
// p_sin)) + step) + burst with its floored remainder (fmodf), and in (d)
// the sensor's lag factor, noise term and stuck-at and dropout flags
// (faults::sensor_terms, two hash01 sinf draws).  A block of chain warps
// (one thread per lane, at most kMaxLanes lanes) has kProducerWarps more
// warps that compute them per (request, lane) for a chunk of requests
// ahead of the chain, into the second of two shared-memory buffers, while
// the chain warps walk the first: one __syncthreads a chunk, one launch,
// no global round trip.  The first producer warp stages the chunk's
// request fields and runs the gap scan (a ballot finds each request's
// previous valid one inside the warp's 32, a register carries it across
// groups and chunks) before the producers' own barrier; then every
// producer takes (request, lane) items.  In (c) the producers also
// resolve the region column bank * NR + region_of(row, NR) through the map.
//
// The chain warps keep only the loop-carried work, in the plain version's
// order of operations: the decayed heats and their sum, the reading (the
// faulted sensor's lag, drift, noise, stuck-at, dropout and quantization
// in d, faults::sensor_chain), the bin from edges held in registers (up
// to kEdgeRegs, padded with +inf; the edges below the reading counted as
// floats in a pairwise tree, which the compiler may not reassociate into
// a serial chain as it did an int sum), the table row, `service_math`,
// the energy and deposit, and in (d) the error draw, the watchdog and the
// counters; each step's terms are read into registers a step ahead (the
// buffer is never written by the chain, so those loads need not queue
// behind the bank state's stores).  The bank FSM (open_row, act_time,
// wr_done, ready per bank) and the mlp_window done-ring sit in shared
// memory indexed [slot][lane] (a request's bank is data); the per-bank RC
// heat lives in registers (exactly 8 banks, or up to kMaxBanks with a
// runtime guard, each its own instantiation; loops fully unrolled, so
// every index is a constant), and so do the current bin, the diagnostics
// and in (d) the fault row, the sensor state, the watchdog and the
// counters.  The lane's table stack is staged in shared memory when it
// fits beside double buffers of at least kMinStagedChunk requests ((a)
// and (b) at the thermal campaign's 8 lanes: a few KB); the region tiles
// of (c) and (d) are read through the read-only path (L1-resident), as
// are (a)/(b) stacks too large to stage.  The host plan (`plan`) picks
// the chunk length and the staging from the shared memory each needs.
//
// Numerics.  Each step follows the plain version operation for operation;
// which thread evaluates a stream term does not change its bits, so the
// outputs are those of a lane that computed everything itself.  The build turns off FMA contraction and
// fast math, so the kernel rounds like PyTorch's own CUDA float32
// operations: a last-bit difference in the reading would flip a bin at an
// edge and change the lane's timing row from then on.  The ring slot is k
// % mlp_window with k the request's position, which equals the plain
// version's served-request counter because padding is a suffix (the
// wrapper checks it).

#include <cuda_runtime.h>
#include <math.h>

#include "faults.cuh"

namespace {

constexpr int kMaxLanes = 128;       // chain lanes per block (4 warps)
constexpr int kProducerWarps = 8;    // stream-term warps per block
constexpr int kProducers = kProducerWarps * 32;
constexpr int kMaxBanks = 16;        // heat registers per lane, at most
constexpr int kFewBanks = 8;         // the exact-width instantiation
constexpr int kEdgeRegs = 8;         // bin edges held in registers
constexpr int kMaxChunk = 256;       // requests per buffer, at most
constexpr int kMinStagedChunk = 32;  // least chunk worth staging tables for
constexpr int kSmemBudget = 232448;  // shared memory of one Hopper block
constexpr float kTwoPi = 6.2831854820251465f;  // float32(2 * pi)
constexpr int kSubarrayRows = 512;              // dram_sim.SUBARRAY_ROWS
constexpr int kScnRows = 9;          // scenario rows staged per lane
constexpr int kFaultRows = 5;        // lag_tau, noise, seed, drop_p, stuck_from

// per-request words of a chunk buffer: arrival, bank, row, flags (is_write
// | valid << 1 | ring slot << 2), gap, decay, (d) uniform
enum { kReqT, kReqBank, kReqRow, kReqFlag, kReqDt, kReqDecay, kReqU,
       kReqWords };

__device__ __forceinline__ float floored_rem(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// thermal.ambient_at for lane j of the staged scenario rows [9][lb]
__device__ __forceinline__ float ambient_at(const float* scn, int lb, int j,
                                            float t) {
  const float base = scn[0 * lb + j], a_sin = scn[1 * lb + j];
  const float p_sin = scn[2 * lb + j], a_step = scn[3 * lb + j];
  const float t_step = scn[4 * lb + j], a_b = scn[5 * lb + j];
  const float p_b = scn[6 * lb + j], duty = scn[7 * lb + j];
  return ((base + a_sin * sinf((kTwoPi * t) / p_sin)) +
          a_step * (t >= t_step ? 1.0f : 0.0f)) +
         a_b * (floored_rem(t, p_b) < duty * p_b ? 1.0f : 0.0f);
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kProducers) : "memory");
}

// One chunk buffer: kReqWords per-request rows of `chunk` words, then the
// per-(request, lane) terms [n_terms][chunk][lb]: ambient, (d) alpha,
// noise term, sensor flags, (c) region column.
struct Buf {
  float* t;
  int* bank;
  int* row;
  int* flag;
  float* dt;
  float* decay;
  float* u;
  float* amb;
  float* alpha;
  float* noise;
  int* sflag;
  int* col;
};

template <bool kRegioned, bool kFaulted>
__device__ __forceinline__ Buf buf_at(float* base, int chunk, int lb) {
  Buf b;
  b.t = base + kReqT * chunk;
  b.bank = reinterpret_cast<int*>(base + kReqBank * chunk);
  b.row = reinterpret_cast<int*>(base + kReqRow * chunk);
  b.flag = reinterpret_cast<int*>(base + kReqFlag * chunk);
  b.dt = base + kReqDt * chunk;
  b.decay = base + kReqDecay * chunk;
  b.u = base + kReqU * chunk;
  float* lt = base + kReqWords * chunk;
  const int plane = chunk * lb;
  b.amb = lt;
  lt += plane;
  b.alpha = lt;
  b.noise = lt + (kFaulted ? plane : 0);
  b.sflag = reinterpret_cast<int*>(lt + (kFaulted ? 2 * plane : 0));
  lt += kFaulted ? 3 * plane : 0;
  b.col = reinterpret_cast<int*>(lt);
  return b;
}

__host__ __device__ __forceinline__ int n_terms(bool regioned, bool faulted) {
  return 1 + (faulted ? 3 : 0) + (regioned ? 1 : 0);
}

// The stream terms of requests [k0, k0 + len) of cell g for the block's
// live lanes [l0, l0 + cl), by producer p of kProducers.  `carry_t` (the
// first producer warp's) is the arrival of the last valid request before
// k0, 0 if none.
template <bool kRegioned, bool kFaulted>
__device__ __forceinline__ void produce(
    int p, const Buf& b, int lb, int cl, int l0, int lanes, long long cell,
    int k0, int len, const float* __restrict__ arrival,
    const int* __restrict__ bank, const int* __restrict__ row,
    const int* __restrict__ is_write, const int* __restrict__ valid,
    const float* __restrict__ uniforms, const int* __restrict__ region_map,
    int n_regions, int map_per_lane, const float* s_scn, const float* s_fp,
    float tau, int mlp_window, float& carry_t) {
  if (p < 32) {          // request fields and the gap scan, 32 at a time
    for (int i0 = 0; i0 < len; i0 += 32) {
      const int i = i0 + p;
      const bool in = i < len;
      const long long q = cell + k0 + i;
      const float t = in ? arrival[q] : 0.0f;
      const bool v = in && valid[q] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      const unsigned below = mask & ((1u << p) - 1u);
      const float t_src =
          __shfl_sync(0xffffffffu, t, below ? 31 - __clz(below) : 0);
      const float dt = fmaxf(t - (below ? t_src : carry_t), 0.0f);
      if (mask) carry_t = __shfl_sync(0xffffffffu, t, 31 - __clz(mask));
      if (in) {
        b.t[i] = t;
        b.bank[i] = bank[q];
        b.row[i] = row[q];
        b.flag[i] = (is_write[q] != 0 ? 1 : 0) | (v ? 2 : 0) |
                    (((k0 + i) % mlp_window) << 2);
        b.dt[i] = dt;
        b.decay[i] = expf(-dt / tau);
        if constexpr (kFaulted) b.u[i] = uniforms ? uniforms[q] : 0.0f;
      }
    }
  }
  producer_sync();
  const int items = len * cl;
  for (int idx = p; idx < items; idx += kProducers) {
    const int i = idx / cl;
    const int j = idx - i * cl;
    const int o = i * lb + j;
    const float t = b.t[i];
    b.amb[o] = ambient_at(s_scn, lb, j, t);
    if constexpr (kFaulted) {
      const faults::SensorTerms s = faults::sensor_terms(
          s_fp[0 * lb + j], s_fp[1 * lb + j], s_fp[2 * lb + j],
          s_fp[3 * lb + j], s_fp[4 * lb + j], t, b.dt[i], k0 + i);
      b.alpha[o] = s.alpha;
      b.noise[o] = s.noise;
      b.sflag[o] = s.flags;
    }
    if constexpr (kRegioned) {
      int off = b.row[i] % kSubarrayRows;
      if (off < 0) off += kSubarrayRows;
      const int slot = b.bank[i] * n_regions + off * n_regions / kSubarrayRows;
      b.col[o] = region_map[map_per_lane ? slot * lanes + l0 + j : slot];
    }
  }
}

// One step's stream terms as the chain reads them, loaded a step ahead.
struct Step {
  int flag, bank, row, sflag, col;
  float t, decay, amb, alpha, noise, u;
};

template <bool kRegioned, bool kFaulted>
__device__ __forceinline__ Step load_step(const Buf& b, int kk, int o) {
  Step s;
  s.flag = b.flag[kk];
  s.t = b.t[kk];
  s.bank = b.bank[kk];
  s.row = b.row[kk];
  s.decay = b.decay[kk];
  s.amb = b.amb[o];
  s.alpha = s.noise = s.u = 0.0f;
  s.sflag = s.col = 0;
  if constexpr (kFaulted) {
    s.alpha = b.alpha[o];
    s.noise = b.noise[o];
    s.sflag = b.sflag[o];
    s.u = b.u[kk];
  }
  if constexpr (kRegioned) s.col = b.col[o];
  return s;
}

// The five timings a step reads of one table row (trcd, tras, twr, trp,
// tcl; column 4, trefi, is unused) for one lane, `stride` apart: shared
// loads, or read-only global loads.
struct Row5 {
  float trcd, tras, twr, trp, tcl;
};

template <bool kShared>
__device__ __forceinline__ Row5 row_at(const float* p, int stride) {
  if constexpr (kShared)
    return {p[0], p[stride], p[2 * stride], p[3 * stride], p[5 * stride]};
  else
    return {__ldg(p), __ldg(p + stride), __ldg(p + 2 * stride),
            __ldg(p + 3 * stride), __ldg(p + 5 * stride)};
}

// Stage the lanes' scenario rows [9][lb] and (d) sensor fault columns
// [5][lb] in shared memory, by threads [tid, ...) step nt.
__device__ __forceinline__ void stage_rows(float* s_scn, float* s_fp,
                                           const float* __restrict__ scn,
                                           const float* __restrict__ fault,
                                           int lb, int cl, int l0, int lanes,
                                           int tid, int nt) {
  for (int i = tid; i < kScnRows * cl; i += nt) {
    const int r = i / cl, j = i - r * cl;
    s_scn[r * lb + j] = scn[r * lanes + l0 + j];
  }
  if (fault == nullptr) return;
  for (int i = tid; i < kFaultRows * cl; i += nt) {
    const int r = i / cl, j = i - r * cl;
    const int c = r == 0   ? faults::kLagTau
                  : r == 1 ? faults::kNoise
                  : r == 2 ? faults::kSeed
                  : r == 3 ? faults::kDropP
                           : faults::kStuckFrom;
    s_fp[r * lb + j] = fault[c * lanes + l0 + j];
  }
}

template <bool kRegioned, bool kFaulted, int NB>
__global__ void __launch_bounds__(kMaxLanes + kProducers, 1) adaptive_kernel(
    const float* __restrict__ closed, const float* __restrict__ arrival,
    const int* __restrict__ bank, const int* __restrict__ row,
    const int* __restrict__ is_write, const int* __restrict__ valid,
    const float* __restrict__ tables, const int* __restrict__ region_map,
    const float* __restrict__ scn,
    const float* __restrict__ edges, const float* __restrict__ tcfg,
    const float* __restrict__ fault, const float* __restrict__ uniforms,
    float* __restrict__ lat, float* __restrict__ total,
    float* __restrict__ tmax_out, float* __restrict__ tmean_out,
    int* __restrict__ sw_out, float* __restrict__ heat_out,
    float* __restrict__ temps_out, int* __restrict__ bins_out,
    int* __restrict__ counters, int n,
    int lanes, int n_edges, int n_rows, int n_banks, int mlp_window,
    int banked, int n_regions, int map_per_lane, int emit_raw, int chunk,
    int stage_tab) {
  extern __shared__ float smem[];
  const int lb = blockDim.x - kProducers;   // chain lanes of a block
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int l0 = blockIdx.y * lb;
  const int cl = min(lb, lanes - l0);       // live lanes of this block
  const bool is_chain = tid < lb;
  const int lane = tid;                     // chain lane within the block
  const int l = l0 + lane;
  const bool live = is_chain && lane < cl;

  // shared layout: [scn 9 x lb][fault 5 x lb (d)][edges E][tables (staged)]
  //                [open][act][wrd][rdy] (each n_banks x lb) [ring W x lb]
  //                [chunk buffer 0][chunk buffer 1]
  float* s_scn = smem;
  float* s_fp = s_scn + kScnRows * lb;
  float* s_edge = s_fp + (kFaulted ? kFaultRows * lb : 0);
  float* s_tab = s_edge + n_edges;
  const int n_cols = banked ? n_banks : 1;
  const long long tab_words =
      stage_tab ? (long long)n_cols * n_rows * 6 * lb : 0;
  float* st_open = s_tab + tab_words;
  float* st_act = st_open + n_banks * lb;
  float* st_wrd = st_act + n_banks * lb;
  float* st_rdy = st_wrd + n_banks * lb;
  float* st_ring = st_rdy + n_banks * lb;
  float* s_buf = st_ring + mlp_window * lb;
  const int buf_words =
      kReqWords * chunk + n_terms(kRegioned, kFaulted) * chunk * lb;

  const int nt = blockDim.x;
  stage_rows(s_scn, s_fp, scn, kFaulted ? fault : nullptr, lb, cl, l0, lanes,
             tid, nt);
  for (int j = tid; j < n_edges; j += nt) s_edge[j] = edges[j];
  if (stage_tab) {      // [col][R][6][lb] <- [col][R][6][lanes], lanes l0..
    const long long words = (long long)n_cols * n_rows * 6 * cl;
    for (long long i = tid; i < words; i += nt) {
      const long long r = i / cl;
      const int j = (int)(i - r * cl);
      s_tab[r * lb + j] = tables[r * lanes + l0 + j];
    }
  }
  if (is_chain) {
    for (int b = 0; b < n_banks; ++b) {
      st_open[b * lb + lane] = -1.0f;
      st_act[b * lb + lane] = 0.0f;
      st_wrd[b * lb + lane] = 0.0f;
      st_rdy[b * lb + lane] = 0.0f;
    }
    for (int w = 0; w < mlp_window; ++w) st_ring[w * lb + lane] = 0.0f;
  }

  const bool is_closed = closed[g] > 0.5f;
  const float tau = tcfg[0], c_heat = tcfg[1], hyst_c = tcfg[2];
  const float e_burst = tcfg[3], e_act_pre = tcfg[4], p_as = tcfg[5];
  const long long cell = (long long)g * n;
  float carry_t = 0.0f;                      // producers: last valid arrival
  __syncthreads();                           // staged rows, edges, tables

  if (!is_chain)                             // the first chunk's terms
    produce<kRegioned, kFaulted>(tid - lb,
                                 buf_at<kRegioned, kFaulted>(s_buf, chunk, lb),
                                 lb, cl, l0, lanes, cell,
                                 0, min(chunk, n), arrival, bank, row,
                                 is_write, valid, uniforms, region_map,
                                 n_regions, map_per_lane, s_scn, s_fp, tau,
                                 mlp_window, carry_t);

  // the chain's registers
  float hyst = 0.0f;
  float er[kEdgeRegs];
  if (live) hyst = hyst_c * scn[8 * lanes + l];
#pragma unroll
  for (int j = 0; j < kEdgeRegs; ++j)
    er[j] = j < n_edges ? edges[j] : INFINITY;
  // NB == kFewBanks is instantiated for exactly that many banks (no
  // guard in the unrolled loops); the wide one guards against n_banks
  constexpr bool kExactBanks = NB == kFewBanks;
  float heat[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) heat[b] = 0.0f;
  int cur = 0, switches = 0, n_valid = 0;
  float tmax = -INFINITY, tsum = 0.0f;
  const int s_col_stride = n_rows * 6 * lb;          // staged stack
  const long long g_col_stride = (long long)n_rows * 6 * lanes;
  const int jedec = n_rows - 1;                             // JEDEC row
  faults::Row fr{};
  faults::Watchdog wd;
  faults::Counters cnt;
  float lag = faults::kNoReading, held = lag, psen = lag;
  int pbin = 0;
  if constexpr (kFaulted) {
    if (live) fr = faults::load_row(fault, lanes, l);
  }
  __syncthreads();                           // chunk 0's terms are in

  for (int c = 0, k0 = 0; k0 < n; ++c, k0 += chunk) {
    const int len = min(chunk, n - k0);
    const Buf B = buf_at<kRegioned, kFaulted>(s_buf + (c & 1) * buf_words,
                                              chunk, lb);
    if (!is_chain) {
      if (k0 + chunk < n)                    // the next chunk's terms
        produce<kRegioned, kFaulted>(
            tid - lb,
            buf_at<kRegioned, kFaulted>(s_buf + ((c + 1) & 1) * buf_words,
                                        chunk, lb),
            lb, cl, l0, lanes, cell, k0 + chunk,
            min(chunk, n - k0 - chunk), arrival, bank, row, is_write, valid,
            uniforms, region_map, n_regions, map_per_lane, s_scn, s_fp, tau,
            mlp_window, carry_t);
    } else if (live) {
      // the step's terms come from registers loaded a step ahead: the
      // buffer is never written by the chain, so those loads need not
      // wait behind the bank state's stores
      Step nx = load_step<kRegioned, kFaulted>(B, 0, lane);
      for (int kk = 0; kk < len; ++kk) {
        const Step st = nx;
        if (kk + 1 < len)
          nx = load_step<kRegioned, kFaulted>(B, kk + 1, (kk + 1) * lb + lane);
        const int k = k0 + kk;
        const long long out = (cell + k) * lanes + l;
        const int fl = st.flag;
        if ((fl & 2) == 0) {           // padding: state untouched
          lat[out] = 0.0f;
          if (emit_raw) {
            temps_out[out] = 0.0f;
            bins_out[out] = -1;
          }
          continue;
        }
        const float t = st.t;
        const int bk = st.bank;
        const int bi = bk * lb + lane;
        const float rf = (float)st.row;
        const bool w = (fl & 1) != 0;
        const int ri = (fl >> 2) * lb + lane;
        const float decay = st.decay;
        const float ambient = st.amb;
        int col = banked ? bk : 0;
        if constexpr (kRegioned) col = st.col;

        // thermal loop: decay, sense, re-select the bin
        float hsum = 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (kExactBanks || b < n_banks) {
            heat[b] = heat[b] * decay;
            hsum = b == 0 ? heat[0] : hsum + heat[b];
          }
        }
        const float sensed = ambient + hsum;
        float reading = sensed;
        if constexpr (kFaulted)
          reading = faults::sensor_chain(fr, t, sensed, lag, held, st.alpha,
                                         st.noise, st.sflag);
        const float reading_h = reading + hyst;
        int new_bin;
        if (n_edges <= kEdgeRegs) {    // +inf pads: never below a reading
          // counted in float: the compiler may not reassociate float adds,
          // so the pairwise tree stays three adds deep (an int sum became
          // a serial chain of predicated increments); counts are exact
          float cu[kEdgeRegs], cd[kEdgeRegs];
#pragma unroll
          for (int j = 0; j < kEdgeRegs; ++j) {
            cu[j] = er[j] < reading ? 1.0f : 0.0f;
            cd[j] = er[j] < reading_h ? 1.0f : 0.0f;
          }
          const float up = ((cu[0] + cu[1]) + (cu[2] + cu[3])) +
                           ((cu[4] + cu[5]) + (cu[6] + cu[7]));
          const float down = ((cd[0] + cd[1]) + (cd[2] + cd[3])) +
                             ((cd[4] + cd[5]) + (cd[6] + cd[7]));
          new_bin = (int)fmaxf(up, fminf((float)cur, down));
        } else {
          int up = 0, down = 0;
          for (int j = 0; j < n_edges; ++j) {
            const float e = s_edge[j];
            up += e < reading ? 1 : 0;
            down += e < reading_h ? 1 : 0;
          }
          new_bin = max(up, min(cur, down));
        }
        int use_bin = new_bin;
        bool is_probe = false;
        if constexpr (kFaulted) {
          is_probe = faults::wd_probe(wd, fr);
          if (!(wd.tripped == 0 || is_probe)) use_bin = jedec;
        }
        // the row of the served bin (and in d the JEDEC row), from the
        // staged stack (shared loads) or the tile (read-only loads)
        Row5 r, jr;
        if (stage_tab) {
          const float* tc = s_tab + lane + col * s_col_stride;
          r = row_at<true>(tc + use_bin * 6 * lb, lb);
          if constexpr (kFaulted) jr = row_at<true>(tc + jedec * 6 * lb, lb);
        } else {
          const float* tc = tables + l + col * g_col_stride;
          r = row_at<false>(tc + use_bin * 6 * lanes, lanes);
          if constexpr (kFaulted)
            jr = row_at<false>(tc + jedec * 6 * lanes, lanes);
        }
        const float trcd = r.trcd, tras = r.tras, twr = r.twr, trp = r.trp;
        const float tcl = r.tcl;
        bool det = false, sil = false;
        float sur = 0.0f;
        if constexpr (kFaulted) {
          const float jsum = ((jr.trcd + jr.tras) + jr.twr) + jr.trp;
          const float edge = use_bin >= jedec ? INFINITY : s_edge[use_bin];
          faults::error_outcome(fr, faults::reduction(trcd, tras, twr, trp,
                                                      jsum),
                                fmaxf(sensed - edge, 0.0f), st.u, det,
                                sil);
          sur = det ? jr.tcl + fr.retry_ns : 0.0f;
        }

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
        float done = data_start + tcl;
        float wrd_new = w ? done + twr : wrd_b;
        const float pre_start = fmaxf(fmaxf(done, act_new + tras), wrd_new);
        float ready_new = is_closed ? pre_start + trp : done;
        float lat_v = done - fmaxf(t, gate);
        if constexpr (kFaulted) {     // the retry surcharge
          done = done + sur;
          lat_v = lat_v + sur;
          wrd_new = w ? wrd_new + sur : wrd_new;
          ready_new = ready_new + sur;
        }
        st_open[bi] = is_closed ? -1.0f : rf;
        st_act[bi] = act_new;
        st_wrd[bi] = wrd_new;
        st_rdy[bi] = ready_new;
        st_ring[ri] = done;

        // closed loop: the access energy of the row just selected
        const float miss = is_hit ? 0.0f : 1.0f;
        const float energy = e_burst + miss * (e_act_pre + p_as * tras);
        const float deposit = c_heat * energy;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b == bk) heat[b] = heat[b] + deposit;

        if constexpr (kFaulted) {
          const bool implaus = fr.jump_c > 0.0f &&
                               psen > faults::kNoReadingHalf &&
                               fabsf(reading - psen) > fr.jump_c;
          const bool degraded = wd.tripped > 0;
          const bool new_trip =
              faults::wd_update(wd, fr, det, implaus, is_probe);
          faults::count(cnt, det, sil, new_trip, degraded, is_probe);
          held = reading;
          psen = reading;
          if (k > 0 && use_bin != pbin) ++switches;
          pbin = use_bin;
        } else {
          if (k > 0 && new_bin != cur) ++switches;
        }
        cur = new_bin;
        tmax = fmaxf(tmax, reading);
        tsum = tsum + reading;
        ++n_valid;
        lat[out] = lat_v;
        if (emit_raw) {
          temps_out[out] = reading;
          bins_out[out] = use_bin;
        }
      }
    }
    __syncthreads();     // chunk c walked, chunk c + 1's terms are in
  }

  if (live) {
    float rdy_max = st_rdy[lane], wrd_max = st_wrd[lane];
    for (int b = 1; b < n_banks; ++b) {
      rdy_max = fmaxf(rdy_max, st_rdy[b * lb + lane]);
      wrd_max = fmaxf(wrd_max, st_wrd[b * lb + lane]);
    }
    const long long o = (long long)g * lanes + l;
    total[o] = fmaxf(rdy_max, wrd_max);
    tmax_out[o] = tmax;
    tmean_out[o] = tsum / (float)n_valid;
    sw_out[o] = switches;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (kExactBanks || b < n_banks) heat_out[((long long)g * n_banks + b) * lanes + l] =
          heat[b];
    if constexpr (kFaulted)
      faults::store(cnt, counters, (long long)gridDim.x * lanes, o);
  }
}

// The producers' stage alone (a test entry): the stream terms of every
// (cell, request, lane) into global memory, by the same `produce` code,
// one block of kProducers threads per (cell, block of lanes).
template <bool kFaulted>
__global__ void __launch_bounds__(kProducers) adaptive_terms_kernel(
    const float* __restrict__ arrival, const int* __restrict__ valid,
    const float* __restrict__ scn, const float* __restrict__ tcfg,
    const float* __restrict__ fault, float* __restrict__ dt_out,
    float* __restrict__ decay_out, float* __restrict__ amb_out,
    float* __restrict__ alpha_out, float* __restrict__ noise_out,
    int* __restrict__ flags_out, int n, int lanes, int lb, int chunk) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int l0 = blockIdx.y * lb;
  const int cl = min(lb, lanes - l0);
  float* s_scn = smem;
  float* s_fp = s_scn + kScnRows * lb;
  const Buf b = buf_at<false, kFaulted>(
      s_fp + (kFaulted ? kFaultRows * lb : 0), chunk, lb);
  stage_rows(s_scn, s_fp, scn, kFaulted ? fault : nullptr, lb, cl, l0, lanes,
             tid, kProducers);
  const float tau = tcfg[0];
  const long long cell = (long long)g * n;
  float carry_t = 0.0f;
  // valid stands in for bank, row and is_write: their fields are unused
  for (int k0 = 0; k0 < n; k0 += chunk) {
    const int len = min(chunk, n - k0);
    __syncthreads();     // staged rows; the previous chunk copied out
    produce<false, kFaulted>(tid, b, lb, cl, l0, lanes, cell, k0, len,
                             arrival, valid, valid, valid, valid, nullptr,
                             nullptr, 0, 0, s_scn, s_fp, tau, 1, carry_t);
    __syncthreads();
    for (int i = tid; i < len; i += kProducers)
      if (blockIdx.y == 0) {
        dt_out[cell + k0 + i] = b.dt[i];
        decay_out[cell + k0 + i] = b.decay[i];
      }
    for (int idx = tid; idx < len * cl; idx += kProducers) {
      const int i = idx / cl, j = idx - i * cl;
      const long long q = (cell + k0 + i) * lanes + l0 + j;
      amb_out[q] = b.amb[i * lb + j];
      if constexpr (kFaulted) {
        alpha_out[q] = b.alpha[i * lb + j];
        noise_out[q] = b.noise[i * lb + j];
        flags_out[q] = b.sflag[i * lb + j];
      }
    }
  }
}

// the instantiation for a variant: the region gather, the fault loop and
// the heat registers' width (exactly 8 banks, or up to 16 with a guard)
// are compiled in, so (a) and (b) pay nothing for (c) and (d), nor 8
// banks for 16
template <int NB>
auto pick(bool regioned, bool faulted) {
  return regioned ? (faulted ? adaptive_kernel<true, true, NB>
                             : adaptive_kernel<true, false, NB>)
                  : (faulted ? adaptive_kernel<false, true, NB>
                             : adaptive_kernel<false, false, NB>);
}

// Chain lanes of a block: the lanes rounded up to a warp, at most
// kMaxLanes or the caller's cap (32, 64 or 128; 0 keeps kMaxLanes).  Lanes
// are independent, so the block size changes no output.
int block_lanes(int lanes, int cap) {
  const int top = cap > 0 ? cap : kMaxLanes;
  return lanes < top ? ((lanes + 31) / 32) * 32 : top;
}

bool valid_cap(int cap) {
  return cap == 0 || cap == 32 || cap == 64 || cap == kMaxLanes;
}

// The launch plan: chunk length and table staging, from shared memory.
struct Plan {
  int chunk, stage_tab;
  long long smem;
};

Plan plan(int lanes, int n_edges, int n_rows, int n_banks, int mlp_window,
          bool banked, bool regioned, bool faulted, int cap) {
  const long long lb = block_lanes(lanes, cap);
  const long long fixed = (kScnRows + (faulted ? kFaultRows : 0)) * lb +
                          n_edges + (4LL * n_banks + mlp_window) * lb;
  const long long tab =
      regioned ? -1 : (long long)(banked ? n_banks : 1) * n_rows * 6 * lb;
  const long long terms = n_terms(regioned, faulted);
  for (int stage = 1; stage >= 0; --stage) {
    if (stage && tab < 0) continue;
    for (int k = kMaxChunk; k >= (stage ? kMinStagedChunk : 1); k /= 2) {
      const long long words = fixed + (stage ? tab : 0) +
                              2 * (kReqWords * (long long)k + terms * k * lb);
      if (words * 4 <= kSmemBudget) return {k, stage, words * 4};
    }
  }
  return {0, 0, 0};
}

int set_smem(const void* kern, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// C interface (ctypes).  Returns the cudaError_t of the launch (0 =
// success); the kernel runs asynchronously on `stream` (a cudaStream_t).
// temps_out and bins_out may be NULL when emit_raw is 0, region_map when
// n_regions is 0 (variants a and b); fault, uniforms and counters are all
// NULL (variants a-c) or all given (variant d).  max_lanes caps the chain
// lanes of a block (32, 64 or 128; 0 keeps the default, block_lanes).
extern "C" int adaptive_launch(
    const float* closed, const float* arrival, const int* bank,
    const int* row, const int* is_write, const int* valid,
    const float* tables, const int* region_map, const float* scn,
    const float* edges, const float* tcfg, const float* fault,
    const float* uniforms, float* lat, float* total, float* tmax_out,
    float* tmean_out, int* sw_out, float* heat_out, float* temps_out,
    int* bins_out, int* counters, int g, int n, int lanes, int n_edges,
    int n_rows, int n_banks, int mlp_window, int banked, int n_regions,
    int map_per_lane, int emit_raw, int max_lanes, void* stream) {
  const bool faulted = fault != nullptr;
  const bool regioned = n_regions > 0;
  if (g <= 0 || n <= 0 || lanes <= 0 || n_edges <= 0 || n_rows <= 0 ||
      n_banks <= 0 || n_banks > kMaxBanks || mlp_window <= 0 ||
      n_regions < 0 || (regioned && (!banked || region_map == nullptr)) ||
      (emit_raw && (temps_out == nullptr || bins_out == nullptr)) ||
      (faulted && (uniforms == nullptr || counters == nullptr)) ||
      !valid_cap(max_lanes))
    return (int)cudaErrorInvalidValue;
  const int lb = block_lanes(lanes, max_lanes);
  const Plan pl = plan(lanes, n_edges, n_rows, n_banks, mlp_window,
                       banked != 0, regioned, faulted, max_lanes);
  if (pl.chunk == 0) return (int)cudaErrorInvalidValue;
  auto kern = n_banks == kFewBanks ? pick<kFewBanks>(regioned, faulted)
                                   : pick<kMaxBanks>(regioned, faulted);
  const int e = set_smem((const void*)kern, pl.smem);
  if (e != 0) return e;
  const int gy = (lanes + lb - 1) / lb;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)g, (unsigned)gy);
  kern<<<grid, lb + kProducers, pl.smem, (cudaStream_t)stream>>>(
      closed, arrival, bank, row, is_write, valid, tables, region_map, scn,
      edges, tcfg, fault, uniforms, lat, total, tmax_out, tmean_out, sw_out,
      heat_out, temps_out, bins_out, counters, n, lanes, n_edges, n_rows,
      n_banks, mlp_window, banked, n_regions, map_per_lane, emit_raw,
      pl.chunk, pl.stage_tab);
  return (int)cudaGetLastError();
}

// The launch plan of `adaptive_launch` for these sizes: out[0] chunk
// length (0: no plan fits), out[1] tables staged, out[2] shared bytes,
// out[3] threads per block, out[4] chain lanes per block.
extern "C" void adaptive_plan(int lanes, int n_edges, int n_rows,
                              int n_banks, int mlp_window, int banked,
                              int regioned, int faulted, int max_lanes,
                              int* out) {
  const Plan pl = plan(lanes, n_edges, n_rows, n_banks, mlp_window,
                       banked != 0, regioned != 0, faulted != 0, max_lanes);
  out[0] = pl.chunk;
  out[1] = pl.stage_tab;
  out[2] = (int)pl.smem;
  out[3] = block_lanes(lanes, max_lanes) + kProducers;
  out[4] = block_lanes(lanes, max_lanes);
}

// The stream terms alone (the producers' stage, for tests): dt and decay
// [G, N], ambient [G, N, L] and, with `fault` ([F_COLS, L]), alpha, the
// noise term and the sensor flags (stuck-at 1, dropout 2) [G, N, L].
extern "C" int adaptive_terms_launch(
    const float* arrival, const int* valid, const float* scn,
    const float* tcfg, const float* fault, float* dt_out, float* decay_out,
    float* amb_out, float* alpha_out, float* noise_out, int* flags_out,
    int g, int n, int lanes, void* stream) {
  const bool faulted = fault != nullptr;
  if (g <= 0 || n <= 0 || lanes <= 0 ||
      (faulted && (alpha_out == nullptr || noise_out == nullptr ||
                   flags_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int lb = block_lanes(lanes, 0);
  const int chunk = 64;
  const long long smem =
      4LL * ((kScnRows + (faulted ? kFaultRows : 0)) * lb + kReqWords * chunk +
             n_terms(false, faulted) * chunk * lb);
  auto kern = faulted ? adaptive_terms_kernel<true>
                      : adaptive_terms_kernel<false>;
  const int e = set_smem((const void*)kern, smem);
  if (e != 0) return e;
  dim3 grid((unsigned)g, (unsigned)((lanes + lb - 1) / lb));
  kern<<<grid, kProducers, smem, (cudaStream_t)stream>>>(
      arrival, valid, scn, tcfg, fault, dt_out, decay_out, amb_out, alpha_out,
      noise_out, flags_out, n, lanes, lb, chunk);
  return (int)cudaGetLastError();
}

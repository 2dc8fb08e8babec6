// Batched DRAM trace replay for Hopper: every (cell g, timing row s) lane
// replays cell g's request stream under timing row s.
//
// Replaces variants (a)-(e) of the Pallas TPU kernel `replay_blocks` of
// src/repro/kernels/replay/replay.py (`_kernel`): module-level timing rows
// [6, S] (a), the per-bank tile [n_banks, 6, S] (b, the banked branch at
// replay.py:99/:172), the mask-compressed subarray-region store [U, 6, S]
// gathered through an index map (c, the regioned branch at replay.py:162),
// the multi-channel, multi-rank module (d, the `multi` branches at
// replay.py:95-120, :143-160, :216-219) and module rows under a fault axis
// (e, the faulted branch at replay.py:82-90, :125-134, :181-193,
// :201-237).  Plain version: repro_torch/core/dram_sim.py (`replay_cells`,
// `service_math`).
//
// Inputs (row-major): closed [G] float32 (1 = closed page); arrival [G, N]
// float32; bank, row, is_write, valid [G, N] int32 (flags 0/1); timings
// [6, S], [n_banks, 6, S] or [U, 6, S] float32 (rows = trcd, tras, twr,
// trp, trefi, tcl); for (c) region_map int32 [n_banks * R] shared by every
// lane, or [n_banks * R, S] per lane, with values in [0, U); for (e) the
// lane-tiled fault rows [F_COLS, S], the JEDEC column [6] and the
// issue-order error uniforms [G, N], all float32; for (d) the per-cell
// interleave codes [G] int32 (dram_sim.ILEAVE_CODES), n_channels, n_ranks
// and t_burst.
// Outputs: lat [G, N, S] float32 (0 at padding), total [G, S] float32;
// for (e) the counters [5, G, S] int32 (detected, silent, trips, degraded,
// probes).
//
// Design.  One block per cell g (x blocks of timing rows), one thread per
// timing-row lane.  Every lane of a block reads the same stream, so the
// block stages it through shared memory in chunks of kChunk requests.
// The per-lane bank state (open_row, act_time, wr_done, ready for each of
// n_banks banks) and the mlp_window done-ring sit in shared memory indexed
// by [slot][lane]: a request's bank index is data, and a dynamically
// indexed per-thread array would spill to local memory.
//
// Variant (b) reads the request's bank's five timing values from the
// [n_banks, 6, S] tile in global memory (read-only, L1-resident: 1.5 KB
// per 8 lanes at S = 6), neighbouring lanes on neighbouring addresses;
// variant (a) keeps its row in registers.  Variant (c) first resolves the
// request's (bank, region) slot bank * R + region_of(row, R) to a unique
// column u through the map (one more L1-resident load; a per-lane map
// gives each lane its own u, so the tile loads of a warp may diverge) and
// reads column u of the [U, 6, S] store (U x 6 x S x 4 B: 40 KB at U = 64,
// S = 26).  region_of is int32 arithmetic, (row mod 512) * R / 512 with a
// floored modulo, as the reference's.  (b) is (c) with the bank as the
// column.  The branches are uniform; the gather of (c) is a template
// instantiation of its own (kRegioned).
//
// Variant (e), its own instantiation (kFaulted): one thread per (timing
// row x fault row) lane as in (a).  The lane reads its fault row into
// registers once (faults.cuh) and carries its watchdog and five counters
// in registers; the request's uniform u[g, k] is shared by every lane of
// the cell, so it is staged with the request chunk.  Per request the
// watchdog gate serves the JEDEC column while tripped (except on probes),
// the served row's reduction against JEDEC sets the error probability
// (a true division), and a detected error adds JEDEC tCL + RETRY_NS to the
// completion, the latency, a write's recovery and the bank's readiness,
// as `dram_sim._service(surcharge=...)` does.
//
// Variant (d), its own instantiation (kMulti) composable with the other
// three: the bank state grows to C*R*n_banks slots, still [slot][lane] in
// shared memory, plus a [C][lane] bus-free row.  The staging threads map
// each request of the chunk to its channel and global slot (ch*R + rank) *
// n_banks + bank once, from the cell's interleave code read once per block
// (int32 floored modulo and division, as dram_sim.chan_rank), so the
// integer work stays off the lanes' dependent chain.  The gate is
// fmaxf(ring, bus[ch]); after `service_math` (and a retry surcharge) a
// valid request leaves the bus busy until (done - tCL) + t_burst.  The
// timing gather of (b) and (c) stays on the rank-level bank.  At 128
// lanes, C = 4, R = 1 the block state is ~72 KB; the wrapper refuses a
// geometry over the card's 227 KB.
//
// Each request runs `service_math` (src/repro/core/dram_sim.py:652)
// operation for operation.  It is float32 add, max and select only (no
// multiply, so nothing can contract into an FMA), which makes `lat` and
// `total` bitwise equal to the plain version.  `open_row` is kept in
// float32 as in the Pallas kernel (row ids stay far below 2^24).  An
// invalid request leaves the state untouched and writes latency 0; the
// ring slot is k % mlp_window with k the loop counter, which equals the
// reference's served-request counter because padding is a suffix (the
// wrapper checks it).
//
// Bound.  The N requests of a lane form one dependent chain, so the
// kernel is bound by N sequential steps of latency, not by its bytes
// (20 B read per request per cell, 4 B written per request per lane) or
// its ~20 operations per request per lane; at the Fig. 4 shapes only
// 140-420 lanes are live on the whole card.

#include <cuda_runtime.h>

#include "faults.cuh"

namespace {

constexpr int kChunk = 1024;   // requests staged per shared-memory chunk
constexpr int kMaxLanes = 128; // timing rows per block
constexpr int kSubarrayRows = 512;  // dram_sim.SUBARRAY_ROWS
constexpr int kSmemLimit = 232448;  // shared memory of one Hopper block

// int32 floored modulo and division by a positive m (Python's % and //)
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
__device__ __forceinline__ int floor_div(int a, int m) {
  return (a - floor_mod(a, m)) / m;
}

template <bool kRegioned, bool kFaulted, bool kMulti>
__global__ void replay_kernel(const float* __restrict__ closed,
                              const float* __restrict__ arrival,
                              const int* __restrict__ bank,
                              const int* __restrict__ row,
                              const int* __restrict__ is_write,
                              const int* __restrict__ valid,
                              const float* __restrict__ timings,
                              const int* __restrict__ region_map,
                              const float* __restrict__ fault,
                              const float* __restrict__ jedec,
                              const float* __restrict__ uniforms,
                              const int* __restrict__ ileave,
                              float* __restrict__ lat,
                              float* __restrict__ total,
                              int* __restrict__ counters, int n, int s_rows,
                              int n_banks, int mlp_window, int banked,
                              int n_regions, int map_per_lane,
                              int n_channels, int n_ranks, float t_burst) {
  extern __shared__ float smem[];
  const int bs = blockDim.x;
  const int lane = threadIdx.x;
  const int g = blockIdx.x;
  const int s = blockIdx.y * bs + lane;
  const bool live = s < s_rows;

  // shared layout: [chunk arrival][chunk bank][chunk row][chunk flags]
  //                [open][act][wrd][rdy] (each n_slots x bs) [ring W x bs]
  //                [bus free C x bs] (multi) [chunk uniforms] (faulted)
  //                [chunk slot | channel << 16] (multi)
  const int n_slots = kMulti ? n_channels * n_ranks * n_banks : n_banks;
  float* s_arr = smem;
  int* s_bank = reinterpret_cast<int*>(s_arr + kChunk);
  int* s_row = s_bank + kChunk;
  int* s_flag = s_row + kChunk;
  float* st_open = reinterpret_cast<float*>(s_flag + kChunk);
  float* st_act = st_open + n_slots * bs;
  float* st_wrd = st_act + n_slots * bs;
  float* st_rdy = st_wrd + n_slots * bs;
  float* st_ring = st_rdy + n_slots * bs;
  float* st_bus = st_ring + mlp_window * bs;
  float* s_u = st_bus + (kMulti ? n_channels * bs : 0);
  int* s_slot = reinterpret_cast<int*>(s_u + (kFaulted ? kChunk : 0));

  for (int b = 0; b < n_slots; ++b) {
    st_open[b * bs + lane] = -1.0f;
    st_act[b * bs + lane] = 0.0f;
    st_wrd[b * bs + lane] = 0.0f;
    st_rdy[b * bs + lane] = 0.0f;
  }
  for (int w = 0; w < mlp_window; ++w) st_ring[w * bs + lane] = 0.0f;
  if constexpr (kMulti)
    for (int c = 0; c < n_channels; ++c) st_bus[c * bs + lane] = 0.0f;
  const int il = kMulti ? ileave[g] : 0;

  const bool is_closed = closed[g] > 0.5f;
  float trcd = 0.f, tras = 0.f, twr = 0.f, trp = 0.f, tcl = 0.f;
  if (live && !banked) {
    trcd = timings[0 * s_rows + s];
    tras = timings[1 * s_rows + s];
    twr = timings[2 * s_rows + s];
    trp = timings[3 * s_rows + s];
    tcl = timings[5 * s_rows + s];
  }
  const long long cell = (long long)g * n;
  faults::Row fr{};
  faults::Watchdog wd;
  faults::Counters cnt;
  float j_trcd = 0.f, j_tras = 0.f, j_twr = 0.f, j_trp = 0.f, j_tcl = 0.f;
  float jsum = 1.f;
  if constexpr (kFaulted) {
    if (live) fr = faults::load_row(fault, s_rows, s);
    j_trcd = jedec[0];
    j_tras = jedec[1];
    j_twr = jedec[2];
    j_trp = jedec[3];
    j_tcl = jedec[5];
    jsum = ((j_trcd + j_tras) + j_twr) + j_trp;
  }

  for (int base = 0; base < n; base += kChunk) {
    const int len = min(kChunk, n - base);
    __syncthreads();   // previous chunk fully consumed
    for (int k = lane; k < len; k += bs) {
      const long long q = cell + base + k;
      s_arr[k] = arrival[q];
      s_bank[k] = bank[q];
      s_row[k] = row[q];
      s_flag[k] = (is_write[q] != 0 ? 1 : 0) | (valid[q] != 0 ? 2 : 0);
      if constexpr (kFaulted) s_u[k] = uniforms[q];
      if constexpr (kMulti) {       // dram_sim.chan_rank
        const int b = bank[q], r = row[q];
        const int c = il == 0   ? floor_mod(r, n_channels)
                      : il == 1 ? floor_mod(r * n_banks + b, n_channels)
                                : floor_mod(b ^ r, n_channels);
        const int rank = floor_mod(floor_div(r, n_channels), n_ranks);
        s_slot[k] = ((c * n_ranks + rank) * n_banks + b) | (c << 16);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < len; ++kk) {
      const int k = base + kk;
      const float t = s_arr[kk];
      const int bk = s_bank[kk];
      int slot = bk, ch = 0;
      if constexpr (kMulti) {
        slot = s_slot[kk] & 0xffff;
        ch = s_slot[kk] >> 16;
      }
      const int bi = slot * bs + lane;
      const float rf = (float)s_row[kk];
      const bool w = (s_flag[kk] & 1) != 0;
      const bool v = (s_flag[kk] & 2) != 0;
      const int ri = (k % mlp_window) * bs + lane;
      if (banked) {
        int col = bk;
        if constexpr (kRegioned) {
          int off = s_row[kk] % kSubarrayRows;
          if (off < 0) off += kSubarrayRows;
          const int slot = bk * n_regions + off * n_regions / kSubarrayRows;
          col = region_map[map_per_lane ? slot * s_rows + s : slot];
        }
        const float* tb = timings + (long long)col * 6 * s_rows + s;
        trcd = tb[0 * s_rows];
        tras = tb[1 * s_rows];
        twr = tb[2 * s_rows];
        trp = tb[3 * s_rows];
        tcl = tb[5 * s_rows];
      }

      // the served row: the lane's own, or JEDEC while the watchdog is
      // tripped (except on a probe); then the error draw and its price
      float c_rcd = trcd, c_ras = tras, c_wr = twr, c_rp = trp, c_cl = tcl;
      bool is_probe = false, det = false, sil = false;
      float sur = 0.0f;
      if constexpr (kFaulted) {
        is_probe = faults::wd_probe(wd, fr);
        if (!(wd.tripped == 0 || is_probe)) {
          c_rcd = j_trcd;
          c_ras = j_tras;
          c_wr = j_twr;
          c_rp = j_trp;
          c_cl = j_tcl;
        }
        faults::error_outcome(
            fr, faults::reduction(c_rcd, c_ras, c_wr, c_rp, jsum), 0.0f,
            s_u[kk], det, sil);
        sur = det ? j_tcl + fr.retry_ns : 0.0f;
      }

      // service_math (dram_sim.py:652), operation for operation; the
      // channel's bus joins the ring gate (d)
      float gate = st_ring[ri];
      if constexpr (kMulti) gate = fmaxf(gate, st_bus[ch * bs + lane]);
      const float open_b = st_open[bi], act_b = st_act[bi];
      const float wrd_b = st_wrd[bi], rdy_b = st_rdy[bi];
      const float start = fmaxf(fmaxf(t, rdy_b), gate);
      const bool is_hit = open_b == rf;
      const bool is_empty = open_b == -1.0f;
      const float pre_ok = fmaxf(act_b + c_ras, wrd_b);
      const float conflict_start = fmaxf(start, pre_ok);
      const float act_new =
          is_hit ? act_b : (is_empty ? start + 0.0f : conflict_start + c_rp);
      const float data_start =
          is_hit ? start
                 : (is_empty ? start + c_rcd
                             : (conflict_start + c_rp) + c_rcd);
      float done = data_start + c_cl;
      float wrd_new = w ? done + c_wr : wrd_b;
      const float pre_start = fmaxf(fmaxf(done, act_new + c_ras), wrd_new);
      float ready_new = is_closed ? pre_start + c_rp : done;
      const float latched = is_closed ? -1.0f : rf;
      float lat_v = done - fmaxf(t, gate);
      if constexpr (kFaulted) {     // the retry surcharge
        done = done + sur;
        lat_v = lat_v + sur;
        wrd_new = w ? wrd_new + sur : wrd_new;
        ready_new = ready_new + sur;
      }

      if (v) {
        st_open[bi] = latched;
        st_act[bi] = act_new;
        st_wrd[bi] = wrd_new;
        st_rdy[bi] = ready_new;
        st_ring[ri] = done;
        // the bus stays busy for t_burst from the burst start (done - tCL)
        if constexpr (kMulti) st_bus[ch * bs + lane] = (done - c_cl) + t_burst;
        if constexpr (kFaulted) {
          const bool degraded = wd.tripped > 0;
          const bool new_trip =
              faults::wd_update(wd, fr, det, false, is_probe);
          faults::count(cnt, det, sil, new_trip, degraded, is_probe);
        }
      }
      lat[(cell + k) * s_rows + s] = v ? lat_v : 0.0f;
    }
  }

  if (live) {
    float rdy_max = st_rdy[lane], wrd_max = st_wrd[lane];
    for (int b = 1; b < n_slots; ++b) {
      rdy_max = fmaxf(rdy_max, st_rdy[b * bs + lane]);
      wrd_max = fmaxf(wrd_max, st_wrd[b * bs + lane]);
    }
    total[(long long)g * s_rows + s] = fmaxf(rdy_max, wrd_max);
    if constexpr (kFaulted)
      faults::store(cnt, counters, (long long)gridDim.x * s_rows,
                    (long long)g * s_rows + s);
  }
}

int block_lanes(int s_rows) {
  return s_rows < kMaxLanes ? ((s_rows + 31) / 32) * 32 : kMaxLanes;
}

}  // namespace

extern "C" int replay_smem_bytes(int s_rows, int n_banks, int mlp_window,
                                 int faulted, int n_channels, int n_ranks) {
  const bool multi = n_channels * n_ranks > 1;
  const int slots = multi ? n_channels * n_ranks * n_banks : n_banks;
  return (4 * kChunk) * 4 +
         (4 * slots + mlp_window + (multi ? n_channels : 0)) *
             block_lanes(s_rows) * 4 +
         (faulted ? kChunk * 4 : 0) + (multi ? kChunk * 4 : 0);
}

// C interface (ctypes).  Returns the cudaError_t of the launch (0 =
// success); the kernel runs asynchronously on `stream` (a cudaStream_t).
// region_map may be NULL when n_regions is 0 (variants a, b and e); fault,
// jedec, uniforms and counters are all NULL or all given (module rows
// only); ileave is read only when n_channels * n_ranks > 1 (variant d).
extern "C" int replay_launch(const float* closed, const float* arrival,
                             const int* bank, const int* row,
                             const int* is_write, const int* valid,
                             const float* timings, const int* region_map,
                             const float* fault, const float* jedec,
                             const float* uniforms, const int* ileave,
                             float* lat, float* total, int* counters, int g,
                             int n, int s_rows, int n_banks, int mlp_window,
                             int banked, int n_regions, int map_per_lane,
                             int n_channels, int n_ranks, float t_burst,
                             void* stream) {
  const bool faulted = fault != nullptr;
  const bool multi = n_channels * n_ranks > 1;
  if (g <= 0 || n <= 0 || s_rows <= 0 || n_banks <= 0 || mlp_window <= 0 ||
      n_regions < 0 || (n_regions > 0 && (!banked || region_map == nullptr)) ||
      (faulted && (banked || jedec == nullptr || uniforms == nullptr ||
                   counters == nullptr)) ||
      n_channels <= 0 || n_ranks <= 0 || (multi && ileave == nullptr) ||
      (multi && n_channels * n_ranks * n_banks > 0xffff) ||
      (multi && n_channels > 0x7fff))
    return (int)cudaErrorInvalidValue;
  const int bs = block_lanes(s_rows);
  const int smem = replay_smem_bytes(s_rows, n_banks, mlp_window, faulted,
                                     n_channels, n_ranks);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  // the region gather, the fault loop and the channel state are compiled
  // into their own instantiations (c, e, d), so (a) and (b) pay nothing
  // for them and C*R == 1 launches (a)-(c), (e) unchanged
  auto kern = multi ? (faulted ? replay_kernel<false, true, true>
                       : n_regions > 0 ? replay_kernel<true, false, true>
                                       : replay_kernel<false, false, true>)
              : faulted     ? replay_kernel<false, true, false>
              : n_regions > 0 ? replay_kernel<true, false, false>
                              : replay_kernel<false, false, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int gy = (s_rows + bs - 1) / bs;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)g, (unsigned)gy);
  kern<<<grid, bs, smem, (cudaStream_t)stream>>>(
      closed, arrival, bank, row, is_write, valid, timings, region_map, fault,
      jedec, uniforms, ileave, lat, total, counters, n, s_rows, n_banks,
      mlp_window, banked, n_regions, map_per_lane, n_channels, n_ranks,
      t_burst);
  return (int)cudaGetLastError();
}

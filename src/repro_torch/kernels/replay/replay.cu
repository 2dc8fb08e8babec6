// Batched DRAM trace replay for Hopper: every (cell g, timing row s) lane
// replays cell g's request stream under timing row s.
//
// Replaces variants (a), (b) and (c) of the Pallas TPU kernel
// `replay_blocks` of src/repro/kernels/replay/replay.py (`_kernel`):
// module-level timing rows [6, S] (a), the per-bank tile [n_banks, 6, S]
// (b, the banked branch at replay.py:99/:172) or the mask-compressed
// subarray-region store [U, 6, S] gathered through an index map (c, the
// regioned branch at replay.py:162), one channel, no faults.  Plain
// version: repro_torch/core/dram_sim.py (`replay_cells`, `service_math`).
//
// Inputs (row-major): closed [G] float32 (1 = closed page); arrival [G, N]
// float32; bank, row, is_write, valid [G, N] int32 (flags 0/1); timings
// [6, S], [n_banks, 6, S] or [U, 6, S] float32 (rows = trcd, tras, twr,
// trp, trefi, tcl); for (c) region_map int32 [n_banks * R] shared by every
// lane, or [n_banks * R, S] per lane, with values in [0, U).
// Outputs: lat [G, N, S] float32 (0 at padding), total [G, S] float32.
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

namespace {

constexpr int kChunk = 1024;   // requests staged per shared-memory chunk
constexpr int kMaxLanes = 128; // timing rows per block
constexpr int kSubarrayRows = 512;  // dram_sim.SUBARRAY_ROWS

template <bool kRegioned>
__global__ void replay_kernel(const float* __restrict__ closed,
                              const float* __restrict__ arrival,
                              const int* __restrict__ bank,
                              const int* __restrict__ row,
                              const int* __restrict__ is_write,
                              const int* __restrict__ valid,
                              const float* __restrict__ timings,
                              const int* __restrict__ region_map,
                              float* __restrict__ lat,
                              float* __restrict__ total, int n, int s_rows,
                              int n_banks, int mlp_window, int banked,
                              int n_regions, int map_per_lane) {
  extern __shared__ float smem[];
  const int bs = blockDim.x;
  const int lane = threadIdx.x;
  const int g = blockIdx.x;
  const int s = blockIdx.y * bs + lane;
  const bool live = s < s_rows;

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
  float trcd = 0.f, tras = 0.f, twr = 0.f, trp = 0.f, tcl = 0.f;
  if (live && !banked) {
    trcd = timings[0 * s_rows + s];
    tras = timings[1 * s_rows + s];
    twr = timings[2 * s_rows + s];
    trp = timings[3 * s_rows + s];
    tcl = timings[5 * s_rows + s];
  }
  const long long cell = (long long)g * n;

  for (int base = 0; base < n; base += kChunk) {
    const int len = min(kChunk, n - base);
    __syncthreads();   // previous chunk fully consumed
    for (int k = lane; k < len; k += bs) {
      const long long q = cell + base + k;
      s_arr[k] = arrival[q];
      s_bank[k] = bank[q];
      s_row[k] = row[q];
      s_flag[k] = (is_write[q] != 0 ? 1 : 0) | (valid[q] != 0 ? 2 : 0);
    }
    __syncthreads();
    if (!live) continue;
    for (int kk = 0; kk < len; ++kk) {
      const int k = base + kk;
      const float t = s_arr[kk];
      const int bk = s_bank[kk];
      const int bi = bk * bs + lane;
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

      // service_math (dram_sim.py:652), operation for operation
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
      const float ready_new = is_closed ? pre_start + trp : done;
      const float latched = is_closed ? -1.0f : rf;
      const float lat_v = done - fmaxf(t, gate);

      if (v) {
        st_open[bi] = latched;
        st_act[bi] = act_new;
        st_wrd[bi] = wrd_new;
        st_rdy[bi] = ready_new;
        st_ring[ri] = done;
      }
      lat[(cell + k) * s_rows + s] = v ? lat_v : 0.0f;
    }
  }

  if (live) {
    float rdy_max = st_rdy[lane], wrd_max = st_wrd[lane];
    for (int b = 1; b < n_banks; ++b) {
      rdy_max = fmaxf(rdy_max, st_rdy[b * bs + lane]);
      wrd_max = fmaxf(wrd_max, st_wrd[b * bs + lane]);
    }
    total[(long long)g * s_rows + s] = fmaxf(rdy_max, wrd_max);
  }
}

}  // namespace

extern "C" int replay_smem_bytes(int s_rows, int n_banks, int mlp_window) {
  const int bs = s_rows < kMaxLanes ? ((s_rows + 31) / 32) * 32 : kMaxLanes;
  return (4 * kChunk) * 4 + (4 * n_banks + mlp_window) * bs * 4;
}

// C interface (ctypes).  Returns the cudaError_t of the launch (0 =
// success); the kernel runs asynchronously on `stream` (a cudaStream_t).
// region_map may be NULL when n_regions is 0 (variants a and b).
extern "C" int replay_launch(const float* closed, const float* arrival,
                             const int* bank, const int* row,
                             const int* is_write, const int* valid,
                             const float* timings, const int* region_map,
                             float* lat, float* total, int g, int n,
                             int s_rows, int n_banks, int mlp_window,
                             int banked, int n_regions, int map_per_lane,
                             void* stream) {
  if (g <= 0 || n <= 0 || s_rows <= 0 || n_banks <= 0 || mlp_window <= 0 ||
      n_regions < 0 || (n_regions > 0 && (!banked || region_map == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int bs = s_rows < kMaxLanes ? ((s_rows + 31) / 32) * 32 : kMaxLanes;
  const int smem = replay_smem_bytes(s_rows, n_banks, mlp_window);
  // the region gather is compiled into the (c) instantiation only, so
  // (a) and (b) pay nothing for it
  auto kern = n_regions > 0 ? replay_kernel<true> : replay_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int gy = (s_rows + bs - 1) / bs;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)g, (unsigned)gy);
  kern<<<grid, bs, smem, (cudaStream_t)stream>>>(
      closed, arrival, bank, row, is_write, valid, timings, region_map, lat,
      total, n, s_rows, n_banks, mlp_window, banked, n_regions, map_per_lane);
  return (int)cudaGetLastError();
}

// Dense (cells x combos) steady-state read/write margin grid for Hopper.
//
// Replaces the Pallas TPU kernel `margin_grid` of
// src/repro/kernels/charge_sim/charge_sim.py (`_kernel`, `_margin_block`).
// Plain version: repro_torch/kernels/charge_sim/ref.py (`margin_grid`),
// i.e. repro_torch/core/charge.py evaluated densely.
//
// Inputs (float32 unless said, row-major):
//   cells_t  [7, n]: tau_r, xfer, tau_ret85, tau_p, tau_w, and the per-cell
//                    read / write tREFI overrides (<= 0: use the combo's)
//   rkeys    [4, KR]: the distinct read keys (tras, trp, trefi, temp_c)
//   wkeys    [4, KW]: the distinct write keys (twr, trp, trefi, temp_c)
//   col_keys int32 [m]: column j's read key | its write key << 16, both
//                    indices local to the column's group
//   trcd     [m]: column j's tRCD
//   groups   int32 [G, 6]: per column group its columns [col0, col1) and
//                    its keys: first read key, count, first write key,
//                    count (ops.py builds all of these from combos_t)
//   (the per-element kernel takes combos_t [6, m] itself: trcd, tras, twr,
//   trp, trefi, temp_c)
// Outputs: read [n, m], write [n, m] (float32, row-major).
//
// Why keys.  The read margin of (cell, combo) is min(m_sense, tRCD - ts)
// where m_sense and ts come out of an 8-step fixed point that reads only
// the cell and four combo values (tras, trp, trefi, temp_c); the write
// margin is min(m_sense_w, tRCD - t_open, m_floor) where the three come
// from (twr, trp, trefi, temp_c).  tRCD enters each margin only in its
// last min.  The profiling campaign's 8,505 columns hold 450 read and
// 495 write keys, so a per-element kernel repeats each fixed point 18.9
// times.  A per-cell tREFI override replaces the key's tREFI inside the
// kernel; it can only merge keys, never split one.
//
// Design.  The work is items: (column group, tile of cells), a tile as
// many cells as the group's key tables fit in 96 KB (10 for the
// campaign; at most 16).  One persistent block of 1024 threads an SM
// takes items in turn and holds two shared-memory buffers.
//   Phase A, by 20 key warps: for each (cell of the tile, read key) the
//   pair (ts, m_sense), and for each (cell, write key) (m_sense_w,
//   t_open) and m_floor, into a buffer.  The code is the earlier
//   per-element kernel's, moved, not rewritten: the same expressions in
//   the same order (read_key, write_key).
//   Phase B, by 12 store warps: stream the group's columns from the
//   other buffer: a thread takes a column, loads its keys and tRCD once
//   (the next column's ahead), and for every cell of the tile gathers
//   the keys' values and stores both margins.  A warp stores 32
//   consecutive floats of one output row, with streaming stores
//   (__stcs): the 12 GB of a campaign never fit the 50 MB L2.
// At each step the key warps fill item s while the store warps drain
// item s - 1, so the fixed points hide under the stores.  Every output
// is the same operations on the same operands as in the per-element
// kernel, so the result is bitwise that kernel's (chip_smoke.py holds
// the two kernels against each other on the whole campaign grid).
// Columns are cut into groups only when one cell's keys would not fit a
// buffer (many distinct keys, e.g. random combos); the campaign is one
// group.
//
// Small grids (below 2^25 elements, `ops.SEARCH_MIN_ELEMS`) skip the key
// search, whose host time would exceed what it saves, and go to a second
// kernel, `margin_grid_elem_kernel`: a thread per element runs the same
// read_key and write_key code and both mins in full.  That is the
// per-element design of the earlier kernel, at its occupancy: the
// persistent kernel with every column its own key ran the fixed points
// on 20 warps an SM and took 1.4x the time on the main and region paths'
// small grids (H100).
//
// Bound.  At the campaign shape (176,640 x 8,505) the 12.0 GB of output
// take 3.59 ms at 3.35 TB/s.  The work these inputs need is per (cell,
// read key) 240 operations (20 of them expf/logf), per (cell, write key)
// 54 (5) and per element 5 (`ops.margin_grid_key_flops`): 3.1e10, 0.47
// ms at 67 TFLOP/s.  So the kernel is bound by its stores; the fixed points
// it saves are what kept the per-element kernel at 52 ms.
//
// Rounding.  IEEE expf/logf (no --use_fast_math), no FMA contraction
// (-fmad=false, see build.py), a tensor divided by a constant as a
// product with the constant's float reciprocal and a constant divided by
// a tensor as the tensor's reciprocal times the constant: the plain
// version's order of operations as PyTorch evaluates it on the card.
// The kernel still differs from the plain version in the last bits at
// 82,182,004 of the 209,018,880 elements of the 12,288-cell campaign
// slice (max abs 1.907e-6, none beyond 2e-4); the cause is not
// isolated.  Where restore collapses (tRAS at the 12.5 ns end of the
// grid) the fixed point amplifies last-bit differences up to ~1e-2 on
// margins <= -1.8, never near the pass/fail boundary.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct ChargeConsts {
  float t_wl, alpha_share, tau_s, dv_full, dv_min, t_p0, t_wr_base,
      t_wr_floor, kappa_w, beta_w, dv_full_w, k_ret, k_rc, v_precharge;
};

// A block of 1024 threads: 20 key warps (phase A) and 12 store warps
// (phase B).  More store warps starve phase A, fewer starve the stores;
// fixed points interleaved two a thread were slower on the H100.
constexpr int kThreads = 1024;
constexpr int kStoreThreads = 32 * 12;                    // phase B
constexpr int kKeyThreads = kThreads - kStoreThreads;     // phase A
constexpr int kMaxTileCells = 16;
constexpr int kFixedPointIters = 8;
constexpr int kTileBytes = 96 * 1024;   // one buffer's key tables

// the per-element kernel's block: 32 columns x 8 cells
constexpr int kElemCols = 32;
constexpr int kElemCells = 8;

struct Cell {
  float tau_r, xfer, tau_ret85, tau_p, tau_w_c, trefi_r_cell, trefi_w_cell;
};

// Cell `p` points to in cells_t [7, n].
__device__ __forceinline__ Cell load_cell(const float* __restrict__ p,
                                          int n) {
  return {__ldg(p), __ldg(p + n), __ldg(p + 2LL * n), __ldg(p + 3LL * n),
          __ldg(p + 4LL * n), __ldg(p + 5LL * n), __ldg(p + 6LL * n)};
}

__device__ __forceinline__ float sense_t(float q, float xfer, float residual,
                                         float tau_r_t,
                                         const ChargeConsts& c) {
  float dv_eff = fmaxf((q - 0.5f) * xfer - residual, 1e-6f);
  return c.t_wl + c.alpha_share * tau_r_t +
         c.tau_s * logf((1.0f / dv_eff) * c.dv_full);
}

// Read steady state of one (cell, read key): (ts, m_sense).
__device__ __forceinline__ float2 read_key(const Cell& cl, float tras,
                                           float trp, float trefi,
                                           float temp_c,
                                           const ChargeConsts& c) {
  const float tau_r = cl.tau_r, xfer = cl.xfer;
  const float tau_ret85 = cl.tau_ret85, tau_p = cl.tau_p;
  const float tau_w_c = cl.tau_w_c;
  const float trefi_r = cl.trefi_r_cell > 0.0f ? cl.trefi_r_cell : trefi;

  const float hot = 1.0f + c.k_rc * fmaxf(temp_c - 55.0f, 0.0f);
  const float tau_r_t = tau_r * hot;
  const float tau_w_t = tau_w_c * hot;
  const float tau_ret = tau_ret85 * expf(c.k_ret * (85.0f - temp_c));
  const float leak = expf(-trefi_r / tau_ret);
  const float residual =
      c.v_precharge * expf(-fmaxf(trp - c.t_p0, 0.0f) / tau_p);

  // read steady state: affine fixed point of the refresh/restore loop
  float q_r = 0.95f;
#pragma unroll
  for (int it = 0; it < kFixedPointIters; ++it) {
    const float q_acc = 0.5f + (q_r - 0.5f) * leak;
    const float ts = sense_t(q_acc, xfer, residual, tau_r_t, c);
    const float t_rest = fmaxf(tras - ts, 0.0f);
    // restore starts from the charge-shared level (paper Fig. 1)
    const float q_shared = 0.5f + (q_acc - 0.5f) * xfer;
    q_r = 1.0f - (1.0f - q_shared) * expf(-t_rest / tau_w_t);
  }
  const float q_acc = 0.5f + (q_r - 0.5f) * leak;
  const float ts = sense_t(q_acc, xfer, residual, tau_r_t, c);
  const float m_sense =
      ((q_acc - 0.5f) * xfer - residual - c.dv_min) * (1.0f / c.dv_min);
  return make_float2(ts, m_sense);
}

// Write steady state of one (cell, write key) (worst case: flip of a
// freshly written value; write tests exercise worst-case coupling ->
// derated retention): (m_sense_w, t_open) and m_floor.
__device__ __forceinline__ float2 write_key(const Cell& cl, float twr,
                                            float trp, float trefi,
                                            float temp_c,
                                            const ChargeConsts& c,
                                            float* m_floor_out) {
  const float tau_r = cl.tau_r, xfer = cl.xfer;
  const float tau_ret85 = cl.tau_ret85, tau_p = cl.tau_p;
  const float tau_w_c = cl.tau_w_c;
  const float trefi_w = cl.trefi_w_cell > 0.0f ? cl.trefi_w_cell : trefi;

  const float hot = 1.0f + c.k_rc * fmaxf(temp_c - 55.0f, 0.0f);
  const float tau_r_t = tau_r * hot;
  const float tau_w_t = tau_w_c * hot;
  const float tau_ret = tau_ret85 * expf(c.k_ret * (85.0f - temp_c));
  const float residual =
      c.v_precharge * expf(-fmaxf(trp - c.t_p0, 0.0f) / tau_p);

  const float tau_w = tau_w_t * c.beta_w;
  const float leak_w = expf(-trefi_w / (tau_ret * c.kappa_w));
  const float q_low = 0.05f;
  const float q_written =
      1.0f - (1.0f - q_low) * expf(-fmaxf(twr + c.t_wr_base, 0.0f) / tau_w);
  const float q_s = 0.5f + (q_written - 0.5f) * leak_w;
  const float dv_eff_w = fmaxf((q_s - 0.5f) * xfer - residual, 1e-6f);
  const float t_open = c.t_wl + c.alpha_share * tau_r_t +
                       c.tau_s * logf(fmaxf((1.0f / dv_eff_w) * c.dv_full_w,
                                            1e-6f));
  const float m_sense_w =
      ((q_s - 0.5f) * xfer - residual - c.dv_min) * (1.0f / c.dv_min);
  *m_floor_out = twr - c.t_wr_floor * (tau_r_t * (1.0f / 4.5f));
  return make_float2(m_sense_w, t_open);
}

// A column group: its columns [col0, col1) and its keys (first read key,
// count, first write key, count).
struct Group {
  int col0, col1, kr0, nkr, kw0, nkw;
};

// Group g of `groups` [G, 6].
__device__ __forceinline__ Group group_of(const int* __restrict__ groups,
                                          int g) {
  const int* p = groups + 6 * g;
  return {p[0], p[1], p[2], p[3], p[4], p[5]};
}

// Phase A of one work item (a cell tile of one column group) into `buf`,
// by the key threads.
__device__ __forceinline__ void fill_keys(
    const float* __restrict__ cells_t, const float* __restrict__ rkeys,
    const float* __restrict__ wkeys, const Group gr, float* buf,
    long long i0, int cells, int tile, int n, int n_rkeys, int n_wkeys,
    int ktid, const ChargeConsts& c) {
  const int kr0 = gr.kr0, nkr = gr.nkr, kw0 = gr.kw0, nkw = gr.nkw;
  float2* s_rd = reinterpret_cast<float2*>(buf);      // [tile][nkr]
  float2* s_wr = s_rd + tile * nkr;                    // [tile][nkw]
  float* s_wf = reinterpret_cast<float*>(s_wr + tile * nkw);
  const float* cl0 = cells_t + i0;
  for (int p = ktid; p < cells * nkr; p += kKeyThreads) {
    const int row = p / nkr, key = kr0 + p % nkr;
    const Cell cl = load_cell(cl0 + row, n);
    s_rd[p] = read_key(cl, __ldg(rkeys + key), __ldg(rkeys + n_rkeys + key),
                       __ldg(rkeys + 2 * n_rkeys + key),
                       __ldg(rkeys + 3 * n_rkeys + key), c);
  }
  for (int p = ktid; p < cells * nkw; p += kKeyThreads) {
    const int row = p / nkw, key = kw0 + p % nkw;
    const Cell cl = load_cell(cl0 + row, n);
    s_wr[p] = write_key(cl, __ldg(wkeys + key), __ldg(wkeys + n_wkeys + key),
                        __ldg(wkeys + 2 * n_wkeys + key),
                        __ldg(wkeys + 3 * n_wkeys + key), c, s_wf + p);
  }
}

// Phase B of one work item from `buf`, by the store threads: a thread
// takes a column, loads its keys and tRCD once (the next column's ahead),
// and stores both margins for every cell of the tile.
__device__ __forceinline__ void drain_columns(
    const int* __restrict__ col_keys, const float* __restrict__ trcd_col,
    const Group gr, const float* buf, float* __restrict__ read_out,
    float* __restrict__ write_out, long long i0, int cells, int tile, int m,
    int stid) {
  const int col0 = gr.col0, col1 = gr.col1, nkr = gr.nkr, nkw = gr.nkw;
  const float2* s_rd = reinterpret_cast<const float2*>(buf);
  const float2* s_wr = s_rd + tile * nkr;
  const float* s_wf = reinterpret_cast<const float*>(s_wr + tile * nkw);
  int j = col0 + stid;
  int ck = j < col1 ? __ldg(col_keys + j) : 0;
  float trcd = j < col1 ? __ldg(trcd_col + j) : 0.f;
  for (; j < col1; j += kStoreThreads) {
    const int jn = j + kStoreThreads;
    const int ck_next = jn < col1 ? __ldg(col_keys + jn) : 0;
    const float trcd_next = jn < col1 ? __ldg(trcd_col + jn) : 0.f;
    const int kr = ck & 0xffff, kw = (ck >> 16) & 0xffff;
    float* rp = read_out + i0 * m + j;
    float* wp = write_out + i0 * m + j;
#pragma unroll 1   // unrolled rows were slower on the H100
    for (int row = 0; row < cells; ++row) {
      const float2 a = s_rd[row * nkr + kr];
      const float2 b = s_wr[row * nkw + kw];
      const float m_floor = s_wf[row * nkw + kw];
      __stcs(rp, fminf(a.y, trcd - a.x));
      __stcs(wp, fminf(fminf(b.x, trcd - b.y), m_floor));
      rp += m;
      wp += m;
    }
    ck = ck_next;
    trcd = trcd_next;
  }
}

// Persistent: block b takes work items b, b + gridDim.x, ... (item = group
// * n_tiles + cell tile).  At step s the key warps fill item s into one
// buffer while the store warps drain item s - 1 from the other.
__global__ void __launch_bounds__(kThreads, 1)
margin_grid_kernel(const float* __restrict__ cells_t,
                   const float* __restrict__ rkeys,
                   const float* __restrict__ wkeys,
                   const int* __restrict__ col_keys,
                   const float* __restrict__ trcd_col,
                   const int* __restrict__ groups,
                   float* __restrict__ read_out,
                   float* __restrict__ write_out, int n, int m, int n_rkeys,
                   int n_wkeys, int n_groups, int n_tiles, int tile,
                   int buf_floats, ChargeConsts c) {
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int n_items = n_groups * n_tiles;
  const int count = (n_items - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  for (int s = 0; s <= count; ++s) {
    const bool keys = tid < kKeyThreads;         // warp-uniform role
    const int step = keys ? s : s - 1;
    if (step >= 0 && step < count) {
      const int item = (int)blockIdx.x + step * (int)gridDim.x;
      const Group gr = group_of(groups, item / n_tiles);
      const long long i0 = (long long)(item % n_tiles) * tile;
      const int cells = (int)min((long long)tile, n - i0);
      float* buf = bufs + (step & 1) * buf_floats;
      if (keys)
        fill_keys(cells_t, rkeys, wkeys, gr, buf, i0, cells, tile, n,
                  n_rkeys, n_wkeys, tid, c);
      else
        drain_columns(col_keys, trcd_col, gr, buf, read_out,
                               write_out, i0, cells, tile, m,
                               tid - kKeyThreads);
    }
    __syncthreads();
  }
}

// Per-element (small grids): thread (x, y) of a 32 x 8 block computes
// element (cell i0 + y, column j0 + x) in full with read_key and
// write_key, so each output is the key path's operations on its operands.
// combos_t [6, m]: trcd, tras, twr, trp, trefi, temp_c.
__global__ void __launch_bounds__(kElemCols * kElemCells)
margin_grid_elem_kernel(const float* __restrict__ cells_t,
                        const float* __restrict__ combos_t,
                        float* __restrict__ read_out,
                        float* __restrict__ write_out, int n, int m,
                        ChargeConsts c) {
  const long long i = (long long)blockIdx.x * kElemCells + threadIdx.y;
  const int j = blockIdx.y * kElemCols + threadIdx.x;
  if (i >= n || j >= m) return;
  const Cell cl = load_cell(cells_t + i, n);
  const float* cb = combos_t + j;
  const float trcd = __ldg(cb), tras = __ldg(cb + m);
  const float twr = __ldg(cb + 2LL * m), trp = __ldg(cb + 3LL * m);
  const float trefi = __ldg(cb + 4LL * m), temp_c = __ldg(cb + 5LL * m);
  const float2 rd = read_key(cl, tras, trp, trefi, temp_c, c);
  float m_floor;
  const float2 wr = write_key(cl, twr, trp, trefi, temp_c, c, &m_floor);
  const long long o = i * m + j;
  read_out[o] = fminf(rd.y, trcd - rd.x);
  write_out[o] = fminf(fminf(wr.x, trcd - wr.y), m_floor);
}

ChargeConsts unpack(const float* consts) {
  ChargeConsts c;
  c.t_wl = consts[0];
  c.alpha_share = consts[1];
  c.tau_s = consts[2];
  c.dv_full = consts[3];
  c.dv_min = consts[4];
  c.t_p0 = consts[5];
  c.t_wr_base = consts[6];
  c.t_wr_floor = consts[7];
  c.kappa_w = consts[8];
  c.beta_w = consts[9];
  c.dv_full_w = consts[10];
  c.k_ret = consts[11];
  c.k_rc = consts[12];
  c.v_precharge = consts[13];
  return c;
}

}  // namespace

// Bytes of one cell's key tables: what the column groups must keep under
// `margin_grid_group_bytes()` for a tile of at least one cell.
extern "C" int margin_grid_group_bytes() { return kTileBytes; }

// C interface (ctypes).  `consts` points to the 14 ChargeConsts floats in
// host memory; `rkeys`, `wkeys`, `col_keys`, `trcd` and `groups` lie on the
// device beside the other inputs (ops.key_groups).  `max_keys` is the
// largest 2 * (read keys) + 3 * (write keys) of a group; `stream` is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 = success); the
// kernel runs asynchronously on `stream`.
extern "C" int margin_grid_launch(const float* cells_t, const float* rkeys,
                                  const float* wkeys, const int* col_keys,
                                  const float* trcd, const int* groups,
                                  float* read_out, float* write_out, int n,
                                  int m, int n_rkeys, int n_wkeys,
                                  int n_groups, int max_keys,
                                  const float* consts, void* stream) {
  if (n <= 0 || m <= 0 || n_groups <= 0 || n_groups > 65535 ||
      max_keys <= 0 || 4LL * max_keys > kTileBytes || groups == nullptr ||
      col_keys == nullptr)
    return (int)cudaErrorInvalidValue;
  const ChargeConsts c = unpack(consts);
  int tile = kTileBytes / (4 * max_keys);
  if (tile > kMaxTileCells) tile = kMaxTileCells;
  if ((long long)tile > n) tile = n;
  const int buf_floats = (tile * max_keys + 3) / 4 * 4;
  const int smem = 2 * 4 * buf_floats;
  const long long n_tiles = ((long long)n + tile - 1) / tile;
  if (n_tiles * n_groups > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int n_items = (int)(n_tiles * n_groups);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        margin_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = n_items < sms ? n_items : sms;
  margin_grid_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      cells_t, rkeys, wkeys, col_keys, trcd, groups, read_out, write_out, n,
      m, n_rkeys, n_wkeys, n_groups, (int)n_tiles, tile, buf_floats, c);
  return (int)cudaGetLastError();
}

// The per-element kernel on combos_t [6, m] itself, no keys.
extern "C" int margin_grid_elem_launch(const float* cells_t,
                                       const float* combos_t,
                                       float* read_out, float* write_out,
                                       int n, int m, const float* consts,
                                       void* stream) {
  const long long gx = ((long long)n + kElemCells - 1) / kElemCells;
  const long long gy = ((long long)m + kElemCols - 1) / kElemCols;
  if (n <= 0 || m <= 0 || gx > 2147483647LL || gy > 65535LL)
    return (int)cudaErrorInvalidValue;
  margin_grid_elem_kernel<<<dim3((unsigned)gx, (unsigned)gy),
                            dim3(kElemCols, kElemCells), 0,
                            (cudaStream_t)stream>>>(
      cells_t, combos_t, read_out, write_out, n, m, unpack(consts));
  return (int)cudaGetLastError();
}

// Chunked RWKV6 ("Finch") WKV recurrence, for Hopper.
//
// Replaces the Pallas TPU kernel `wkv_bhtd` of
// src/repro/kernels/rwkv6/rwkv6.py (`_kernel`).  Plain version:
// repro_torch/kernels/rwkv6/ref.py (the reference's `wkv_chunked`).
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + u k_t^T v_t)
//
// Inputs r, k, v, w_log [B, T, H, D] (the model layout, read through
// their batch, time and head strides, the D axis contiguous), u [H, D]
// contiguous, an optional initial state [B, H, D, D] (zeros when null);
// outputs o [B, T, H, D] contiguous and the final state [B, H, D, D] (the
// decode cache's).  From a zero state o is what the TPU kernel computes.
// float32; D 32 (the reduced configs) or 64.
//
// Design.  T is cut into chunks of L = 64 steps (the TPU kernel's chunk;
// the plain version's is 16: the two agree to rounding).  Only the state
// S [D, D] carries from one chunk to the next; everything else of a
// chunk can be formed by itself.  So one call launches three kernels:
//   1. `wkv_chunk_kernel`, a block per (chunk, head, batch row): the
//      chunk's inclusive cumulative logs lcum, its decay exp(ltot) [D]
//      and its state increment kv = (k * exp(ltot - lcum))^T v [D, D],
//      summed over the chunk's steps in order, into scratch.
//   2. `wkv_scan_kernel`, a thread per (batch row, head, d, e): the state
//      scan S_{c+1} = exp(ltot_c) * S_c + kv_c in that order, writing S_c
//      over kv_c (the state at the start of every chunk) and the final S.
//   3. `wkv_out_kernel`, a block per (chunk, head, batch row):
//      o = (r * exp(lprev)) @ S_c + A v + (r . (u * k)) v, with
//      A[i, j] = sum_d r_id k_jd exp(lprev_id - lcum_jd) for j < i.
//      A is factored over sub-chunks of 16 steps.  The four diagonal
//      16 x 16 sub-blocks are summed pairwise in log space.  An
//      off-diagonal sub-block (I > J) is the product of two scaled tiles,
//      (r_I * exp(lprev_I - lam_J)) @ (k_J * exp(lam_J - lcum_J))^T, with
//      lam_J the inclusive log at J's last step.  That takes 3 x 16 x D +
//      6 x 16 x D expf for the off-diagonal blocks instead of 6 x 256 x D.
// Exponent safety: the log decays are <= 0, so the cumulative logs never
// grow (adding a non-positive float never increases a float).  lprev_i
// is taken as lcum_{i-1} (0 at i = 0), so every exponent above is <= 0:
// lprev_i <= lam_J for i in I > J and lam_J <= lcum_j for j in J.  Both
// factors are <= 1 and nothing overflows at any decay; where a factor
// underflows, the pairwise term, whose exponent is the sum of the two,
// underflows as well.  A ragged last chunk is masked, not padded by a
// copy: its missing steps are staged as k = v = r = 0 and log-decay 0,
// which leave the state untouched, and are not stored.  Dot products and
// products are fmaf sums on the CUDA cores in float32 (no TF32: the
// bound against the plain version is 3e-4).
//
// The cumulative logs are summed in four (D = 32: eight) parts of a
// column at once, each in order, then offset by the parts above.  Every
// block issues all its global loads before its first shared-memory store
// (a block waiting on one load at a time was the first version's pace).
//
// Bound.  wkv_flops counts per chunk 4 L D^2 (r S and the state update)
// and 5 D per entry of the j < i triangle (A and A v): at rwkv6-3b's
// prefill shape (1, 4096, 40, 64) 4.39e9 flop, 0.065 ms at 67 TFLOP/s
// float32, against 210.4 MB of r, k, v, w, u, o and the state (0.063 ms
// at 3.35 TB/s).  The three passes also move the scratch (kv and S per
// chunk: 2 x 42 MB written, 2 x 42 MB read at that shape) and read k, v
// and w twice, ~0.55 GB in all, ~0.16 ms at 3.35 TB/s.  Pass 3 takes
// most of the time: two blocks an SM (97 KB of shared memory each at
// D = 64), ~30 k expf a block for the diagonal sub-blocks, and six
// block-wide barriers between its steps.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;       // L: time steps per chunk
constexpr int kSub = 16;         // steps per sub-chunk of A
constexpr int kNSub = kChunk / kSub;
constexpr int kThreads = 256;
constexpr int kGroups = 16;      // row groups (and column groups) of tiles
constexpr int kScanThreads = 256;
constexpr int kScanUnroll = 8;

struct Strides {                 // element strides of the B, T, H axes
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
};

// A chunk's tiles of N inputs [B, T, H, D] into shared [L][pitch] tiles,
// zero past t_len.  Every load of all N tiles is issued before the first
// store to shared memory, so a thread keeps 16 N loads in flight instead
// of waiting on each.
template <int D, int N>
struct Tiles {
  const float* x[N];
  long long sb[N], st[N], sh[N];
  float* s[N];
  int pitch[N];
};

template <int D, int N>
__device__ __forceinline__ void stage(const Tiles<D, N>& tl, int b, int h,
                                      int t0, int t_len) {
  constexpr int kPer = kChunk * D / kThreads;
  float val[N][kPer];
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const float* xb = tl.x[a] + b * tl.sb[a] + h * tl.sh[a];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const long long t = t0 + i / D;
      val[a][u] = t < t_len ? __ldg(xb + t * tl.st[a] + i % D) : 0.f;
    }
  }
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      tl.s[a][(i / D) * tl.pitch[a] + i % D] = val[a][u];
    }
}

// Inclusive cumulative logs down each column d, in place, by all threads:
// kThreads / D parts of a column each sum their rows in order, then add
// the totals of the parts above them (summed in order).  The result never
// grows down a column (every log decay is <= 0, and a part's offset is
// computed exactly as the last entry of the part above).  `part` is
// kThreads floats of scratch.  Ends with every thread synchronised.
template <int D>
__device__ __forceinline__ void cumsum_cols(float* lc, int pitch,
                                            float* part) {
  constexpr int kParts = kThreads / D;
  constexpr int kRowsPer = kChunk / kParts;
  const int d = threadIdx.x % D, q = threadIdx.x / D;
  float* col = lc + q * kRowsPer * pitch + d;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    acc += col[i * pitch];
    col[i * pitch] = acc;
  }
  part[q * D + d] = acc;
  __syncthreads();
  if (q > 0) {
    float off = 0.f;
    for (int p = 0; p < q; ++p) off += part[p * D + d];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) col[i * pitch] = off + col[i * pitch];
  }
  __syncthreads();
}

// Pass 1: a chunk's decay exp(ltot) and increment (k * exp(ltot -
// lcum))^T v.  kv [NC, B, H, D, D], dec [NC, B, H, D].
template <int D>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ w, float* __restrict__ kv,
                 float* __restrict__ dec, int t_len, int heads, int batch,
                 Strides st) {
  constexpr int kCols = D / kGroups;
  extern __shared__ float smem[];
  float* ks = smem;                      // [L][D] k, then k exp(ltot - lcum)
  float* vs = ks + kChunk * D;           // [L][D] v
  float* lc = vs + kChunk * D;           // [L][D] log decay, then lcum
  float* part = lc + kChunk * D;         // [kThreads] cumsum scratch
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk;
  const long long bh = (long long)b * heads + h;
  const long long cbh = (long long)c * batch * heads + bh;
  const int rg = tid / kGroups, cg = tid % kGroups;

  stage<D, 3>({{k, v, w}, {st.kb, st.vb, st.wb}, {st.kt, st.vt, st.wt},
               {st.kh, st.vh, st.wh}, {ks, vs, lc}, {D, D, D}},
              b, h, t0, t_len);
  __syncthreads();
  cumsum_cols<D>(lc, D, part);
  for (int i = tid; i < kChunk * D; i += kThreads) {
    const float ltot = lc[(kChunk - 1) * D + i % D];
    ks[i] = ks[i] * expf(ltot - lc[i]);
  }
  if (tid < D) dec[cbh * D + tid] = expf(lc[(kChunk - 1) * D + tid]);
  __syncthreads();

  // rows d = rg + 16 a, columns e = cg + 16 c2
  float upd[kCols][kCols];
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) upd[a][c2] = 0.f;
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    float x[kCols];
    float y[kCols];
#pragma unroll
    for (int a = 0; a < kCols; ++a) x[a] = ks[j * D + rg + kGroups * a];
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) y[c2] = vs[j * D + cg + kGroups * c2];
#pragma unroll
    for (int a = 0; a < kCols; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2)
        upd[a][c2] = fmaf(x[a], y[c2], upd[a][c2]);
  }
  float* out = kv + cbh * D * D;
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2)
      out[(rg + kGroups * a) * D + cg + kGroups * c2] = upd[a][c2];
}

// Pass 2: the state scan, one thread per (batch row, head, d, e).  On
// return kv[c] holds S at the start of chunk c, s_out the final state.
template <int D>
__global__ void __launch_bounds__(kScanThreads)
wkv_scan_kernel(float* __restrict__ kv, const float* __restrict__ dec,
                const float* __restrict__ s_in, float* __restrict__ s_out,
                int n_chunks, long long n_bh) {
  const long long idx = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (idx >= n_bh * D * D) return;
  const long long bh = idx / (D * D);
  const int de = (int)(idx % (D * D));
  const int d = de / D;
  float s = s_in != nullptr ? s_in[idx] : 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += kScanUnroll) {
    float inc[kScanUnroll];
    float dc[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (c0 + u < n_chunks) {
        const long long cbh = (long long)(c0 + u) * n_bh + bh;
        inc[u] = kv[cbh * D * D + de];
        dc[u] = dec[cbh * D + d];
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (c0 + u < n_chunks) {
        kv[((long long)(c0 + u) * n_bh + bh) * D * D + de] = s;
        s = dc[u] * s + inc[u];
      }
    }
  }
  s_out[idx] = s;
}

template <int D>
constexpr int out_smem_floats() {
  // rs, ks (then S), lc [L][D + 1]; vs [L][D]; A [L][L + 1];
  // kf [3 x 16][D + 1]; dg [L]; u [D]; the cumulative sums' scratch
  return 3 * kChunk * (D + 1) + kChunk * D + kChunk * (kChunk + 1) +
         (kNSub - 1) * kSub * (D + 1) + kChunk + D + kThreads;
}

// Pass 3: one chunk's outputs from the state at its start (S_c in kv).
template <int D>
__global__ void __launch_bounds__(kThreads)
wkv_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s_c,
               float* __restrict__ o, int t_len, int heads, int batch,
               Strides st) {
  constexpr int P = D + 1;               // padded row of an [L][D] tile
  constexpr int PA = kChunk + 1;         // padded row of A
  constexpr int kRows = kChunk / kGroups;
  constexpr int kCols = D / kGroups;
  constexpr int kPairs = kSub * (kSub - 1) / 2;
  static_assert(kThreads % kChunk == 0 && kThreads % D == 0, "lanes");
  static_assert(D * D <= kChunk * P, "S fits where k was");

  extern __shared__ float smem[];
  float* rs = smem;                      // [L][P] r, then r * exp(lprev)
  float* ks = rs + kChunk * P;           // [L][P] k, then S [D][D]
  float* lc = ks + kChunk * P;           // [L][P] log decay, then lcum
  float* vs = lc + kChunk * P;           // [L][D] v
  float* am = vs + kChunk * D;           // [L][PA] A, strict lower triangle
  float* kf = am + kChunk * PA;          // [48][P] k_J * exp(lam_J - lcum)
  float* dg = kf + (kNSub - 1) * kSub * P;   // [L] r_i . (u * k_i)
  float* us = dg + kChunk;               // [D] u
  float* part = us + D;                  // [kThreads] cumsum scratch

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk;
  const long long bh = (long long)b * heads + h;
  const long long cbh = (long long)c * batch * heads + bh;

  stage<D, 4>({{r, k, v, w}, {st.rb, st.kb, st.vb, st.wb},
               {st.rt, st.kt, st.vt, st.wt}, {st.rh, st.kh, st.vh, st.wh},
               {rs, ks, vs, lc}, {P, P, D, P}},
              b, h, t0, t_len);
  for (int i = tid; i < kChunk * kChunk; i += kThreads)
    if (i % kChunk >= i / kChunk) am[(i / kChunk) * PA + i % kChunk] = 0.f;
  for (int i = tid; i < D; i += kThreads) us[i] = u[(long long)h * D + i];
  __syncthreads();

  {                                      // diagonal bonus of row i
    constexpr int kLanes = kThreads / kChunk;  // lanes per row
    const int i = tid / kLanes, l = tid % kLanes;
    float acc = 0.f;
#pragma unroll 8
    for (int d = l; d < D; d += kLanes)
      acc = fmaf(rs[i * P + d], us[d] * ks[i * P + d], acc);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (l == 0) dg[i] = acc;
  }
  cumsum_cols<D>(lc, P, part);

  // the scaled k tiles of sub-chunks 0..2, and the diagonal sub-blocks
  // of A pairwise (j < i inside one sub-chunk)
  for (int i = tid; i < (kNSub - 1) * kSub * D; i += kThreads) {
    const int j = i / D, d = i % D;
    const float lam = lc[((j / kSub) * kSub + kSub - 1) * P + d];
    kf[j * P + d] = ks[j * P + d] * expf(lam - lc[j * P + d]);
  }
  // two pairs a thread, interleaved (480 pairs for 256 threads)
  static_assert(kNSub * kPairs <= 2 * kThreads, "two pairs a thread");
  {
    int pi_[2], pj_[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int p = tid + h2 * kThreads;
      const int pp = p < kNSub * kPairs ? p : tid;
      const int blk = pp / kPairs;
      const int q = pp % kPairs;         // q = ii (ii - 1) / 2 + jj, jj < ii
      int ii = (int)((1.f + sqrtf(1.f + 8.f * (float)q)) * 0.5f);
      while (ii * (ii - 1) / 2 > q) --ii;
      while ((ii + 1) * ii / 2 <= q) ++ii;
      pi_[h2] = blk * kSub + ii;
      pj_[h2] = blk * kSub + q - ii * (ii - 1) / 2;
    }
    const float* r0 = rs + pi_[0] * P;
    const float* p0 = lc + (pi_[0] - 1) * P;   // lprev_i = lcum_{i-1}
    const float* k0 = ks + pj_[0] * P;
    const float* c0 = lc + pj_[0] * P;
    const float* r1 = rs + pi_[1] * P;
    const float* p1 = lc + (pi_[1] - 1) * P;
    const float* k1 = ks + pj_[1] * P;
    const float* c1 = lc + pj_[1] * P;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      acc0 = fmaf(r0[d] * k0[d], expf(p0[d] - c0[d]), acc0);
      acc1 = fmaf(r1[d] * k1[d], expf(p1[d] - c1[d]), acc1);
    }
    am[pi_[0] * PA + pj_[0]] = acc0;
    if (tid + kThreads < kNSub * kPairs) am[pi_[1] * PA + pj_[1]] = acc1;
  }
  __syncthreads();

  // off-diagonal sub-blocks I > J: row i, 8 of J's columns per task
  for (int t = tid; t < 6 * 2 * kSub; t += kThreads) {
    const int pair = t / (2 * kSub);
    const int rem = t % (2 * kSub);
    const int bi = pair < 1 ? 1 : pair < 3 ? 2 : 3;          // I
    const int bj = pair - (bi * (bi - 1)) / 2;               // J < I
    const int i = bi * kSub + rem % kSub;
    const int j0 = bj * kSub + (rem / kSub) * (kSub / 2);
    const float* lam = lc + (bj * kSub + kSub - 1) * P;
    const float* pi = lc + (i - 1) * P;
    float acc[kSub / 2];
#pragma unroll
    for (int jj = 0; jj < kSub / 2; ++jj) acc[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float rf = rs[i * P + d] * expf(pi[d] - lam[d]);
#pragma unroll
      for (int jj = 0; jj < kSub / 2; ++jj)
        acc[jj] = fmaf(rf, kf[(j0 + jj) * P + d], acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kSub / 2; ++jj) am[i * PA + j0 + jj] = acc[jj];
  }
  // S at the chunk's start, where k was (k is no longer read)
  {
    const float* sc = s_c + cbh * D * D;
    float val[D * D / kThreads];
#pragma unroll
    for (int u = 0; u < D * D / kThreads; ++u)
      val[u] = __ldg(sc + tid + u * kThreads);
#pragma unroll
    for (int u = 0; u < D * D / kThreads; ++u) ks[tid + u * kThreads] = val[u];
  }
  __syncthreads();

  for (int i = tid; i < kChunk * D; i += kThreads) {
    const int row = i / D, col = i % D;
    const float lp = row > 0 ? lc[(row - 1) * P + col] : 0.f;
    rs[row * P + col] = rs[row * P + col] * expf(lp);
  }
  __syncthreads();

  // outputs: rows rg + 16 a, columns cg + 16 c2
  const int rg = tid / kGroups, cg = tid % kGroups;
  float inter[kRows][kCols];
  float intra[kRows][kCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) inter[a][c2] = intra[a][c2] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[kRows];
    float y[kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) x[a] = rs[(rg + kGroups * a) * P + d];
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) y[c2] = ks[d * D + cg + kGroups * c2];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2)
        inter[a][c2] = fmaf(x[a], y[c2], inter[a][c2]);
  }
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    float x[kRows];
    float y[kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) x[a] = am[(rg + kGroups * a) * PA + j];
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) y[c2] = vs[j * D + cg + kGroups * c2];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2)
        intra[a][c2] = fmaf(x[a], y[c2], intra[a][c2]);
  }
  float* ob = o + ((long long)b * t_len * heads + h) * D;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = rg + kGroups * a;
    if (t0 + i >= t_len) continue;
    float* orow = ob + (long long)(t0 + i) * heads * D;
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) {
      const int e = cg + kGroups * c2;
      orow[e] = (inter[a][c2] + intra[a][c2]) + dg[i] * vs[i * D + e];
    }
  }
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s_in, float* o, float* s_out,
           float* kv, float* dec, int batch, int t_len, int heads,
           const Strides& st, cudaStream_t stream) {
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  const long long n_bh = (long long)batch * heads;
  const dim3 grid(n_chunks, heads, batch);
  const int smem1 = (3 * kChunk * D + kThreads) * (int)sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem1 > 48 * 1024) {
    err = cudaFuncSetAttribute(wkv_chunk_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem1);
    if (err != cudaSuccess) return (int)err;
  }
  wkv_chunk_kernel<D><<<grid, kThreads, smem1, stream>>>(
      k, v, w, kv, dec, t_len, heads, batch, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_scan = n_bh * D * D;
  wkv_scan_kernel<D><<<(unsigned)((n_scan + kScanThreads - 1) /
                                  kScanThreads),
                       kScanThreads, 0, stream>>>(kv, dec, s_in, s_out,
                                                  n_chunks, n_bh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = out_smem_floats<D>() * (int)sizeof(float);
  auto kernel = wkv_out_kernel<D>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(r, k, v, w, u, kv, o, t_len,
                                           heads, batch, st);
  return (int)cudaGetLastError();
}

}  // namespace

// o is contiguous [B, T, H, D]; s_out and s_in (or null: zeros)
// contiguous [B, H, D, D]; kv (ceil(T / 64) * B * H * D * D floats) and
// dec (ceil(T / 64) * B * H * D floats) are scratch.  Launches three
// kernels on `stream`; returns the CUDA error of the launches (0 on
// success).
extern "C" int wkv_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s_in, void* o, void* s_out, void* kv,
    void* dec, int batch, int t_len, int heads, int d, long long rb,
    long long rt, long long rh, long long kb, long long kt, long long kh,
    long long vb, long long vt, long long vh, long long wb, long long wt,
    long long wh, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || heads < 1 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s_in);
  auto* of = static_cast<float*>(o);
  auto* so = static_cast<float*>(s_out);
  auto* kvf = static_cast<float*>(kv);
  auto* df = static_cast<float*>(dec);
  switch (d) {
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, sf, of, so, kvf, df, batch,
                        t_len, heads, st, s);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, sf, of, so, kvf, df, batch,
                        t_len, heads, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward pass of the RWKV6 ("Finch") WKV recurrence, for Hopper.
//
// Replaces no TPU kernel: the reference differentiates its plain chunked
// scan (`repro.models.ssm.wkv_chunked`, through `jax.grad`), and its
// Pallas kernel `wkv_bhtd` has no backward.  The port trains every RWKV6
// layer through the forward kernel (wkv.cu), so its gradient needs a
// kernel too.  Plain version: `torch.autograd.grad` through
// repro_torch/kernels/rwkv6/ref.py's `wkv` (chunk 16).
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// With G_t the gradient flowing into S_t (the final state's gradient at
// the end, zeros when null) and w_t = exp(w_log_t):
//   G_{t-1} = diag(w_t) G_t + r_t^T do_t,   d state = G before step 0,
//   dr_t = (S_{t-1} + diag(u) k_t^T v_t) do_t,  dk_t = G_t v_t + u r_t (do_t . v_t),
//   dv_t = G_t^T k_t + (r_t . (u k_t)) do_t,    dw_log_t = w_t rowsum(G_t * S_{t-1}),
//   du = the sum over b, t of r_t k_t (do_t . v_t).
//
// Inputs r, k, v, w_log and do [B, T, H, D] (read through their batch,
// time and head strides, the D axis contiguous), u [H, D], the states at
// the start of every 64-step chunk that the forward's pass 2 leaves in
// its `kv` scratch ([ceil(T / 64), B, H, D, D]), the final state's
// gradient [B, H, D, D] or null and, when it is given, the final state
// [B, H, D, D].  Outputs dr, dk, dv, dw_log contiguous [B, T, H, D], du
// [H, D] and, when asked, the initial state's gradient [B, H, D, D].
// float32, D 32 or 64.
//
// Design: chunk-parallel, mirroring the forward's three passes on its
// chunks of L = 64 steps (lcum the inclusive cumulative log decay inside
// a chunk, lprev the exclusive one, ltot the chunk's total; S_c the
// state at chunk c's start, G_c the gradient flowing into its end state):
//   1. `wkv_bwd_chunk_kernel`, a block per (chunk, head, batch row): the
//      chunk's gradient increment dG_c = (r * exp(lprev))^T do [D, D] and
//      its decay exp(ltot) [D], into scratch.
//   2. `wkv_bwd_scan_kernel`, a thread per (batch row, head, d, e): the
//      reverse scan G_{c-1} = exp(ltot_c) * G_c + dG_c from the final
//      state's gradient, writing G_c over dG_c; the initial state's
//      gradient is G at chunk 0's start.
//   3. `wkv_bwd_out_kernel`, a block per (chunk, head, batch row), from
//      S_c and G_c:
//        dr = exp(lprev) * (do S_c^T) + the j < i triangle + u k (v . do)
//        dk = exp(ltot - lcum) * (v G_c^T) + the i > j triangle + u r (do . v)
//        dv = (k * exp(ltot - lcum)) G_c + A^T do + (r . (u k)) do
//      with B[i, j] = do_i . v_j and the forward's A[i, j] = sum_d r_id
//      k_jd exp(lprev_id - lcum_jd), j < i.  dw_log has no per-step
//      G * S: with a_t = r_t * (S_{t-1} do_t) and b_t = k_t * (G_t v_t),
//      the state parts of dr_t and dk_t,
//        dw_log_t = rowsum(G_c * S_{c+1}) + sum_{s > t} a_s - sum_{s >= t} b_s
//      over the chunk's steps (S_{c+1} the next chunk's saved state, the
//      final state for the last chunk, whose term is 0 when the final
//      state's gradient is null): rowsum(G_t * S_t) steps back by
//      a_t - b_t.  The sums over s are a 64-step suffix scan in shared
//      memory.  The triangles are factored over sub-chunks of 16 steps
//      as the forward's: an off-diagonal sub-block (I > J) is a product
//      of tiles scaled from one anchor, lam_J (the inclusive log at J's
//      last step) for A and dr, mu_I (the inclusive log at the step
//      before I) for dk; a diagonal sub-block is summed pairwise in log
//      space.  du is summed per chunk and then over chunks and batch rows
//      by `wkv_bwd_du_kernel`.
// Exponent safety: every log decay is <= 0, so the cumulative logs never
// grow down a chunk and every exponent above is <= 0 (lprev_i <= lam_J <=
// lcum_j and lprev_i <= mu_I <= lcum_j for i in I > J, j in J); where a
// factor underflows, the pairwise term underflows as well.  A ragged
// last chunk is staged with r = k = v = do = 0 and log decay 0 past T,
// which leave S and G untouched, and is not stored there.  Sums are fmaf
// on the CUDA cores in float32 (no TF32; the bound against the plain
// version is rtol = atol = 1e-3).
//
// Bound.  `wkv_bwd_flops` counts the sequential algorithm, 14 D^2 + 16
// D per step and (batch row, head): at rwkv6-3b's (1, 4096, 40, 64)
// 9.6e9 flop, 0.14 ms at 67 TFLOP/s float32, above its ~0.42 GB of
// inputs and outputs (0.13 ms at 3.35 TB/s).  The chunk design does
// about as much (pass 3: four L x D x D products, B and A^T do over
// the triangle, the sub-chunk tiles) on n_chunks x B x H blocks (2,560
// there), and moves G per chunk through scratch (42 MB written, 42 MB
// read at that shape).  Pass 3 takes one block an SM (189 KB of shared
// memory at D = 64); on an H100 it is ~0.80 of the call's ~0.95 ms of
// device time there, pass 1 ~0.09, the scan ~0.06.  Two changes to pass
// 3 were not faster and are not kept: leaving out the B and A^T do
// tiles above the diagonal (0.793 against 0.801 ms), and summing A's
// diagonal sub-blocks with dr's over half-warp shuffles (1.013 against
// 0.798 ms).  The first design, a block per (head, batch row) walking
// 2 T dependent steps with a barrier in each, took ~7 ms there; three
// changes to it moved nothing and are not retried: a cp.async ring
// bringing S_{t-1} back 8 steps ahead, float4 broadcasts of v_t and
// do_t, and checkpoints every 8 steps rebuilt in shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;       // L: the forward's chunk, its saved states
constexpr int kSub = 16;         // steps per sub-chunk of the triangles
constexpr int kNSub = kChunk / kSub;
constexpr int kThreads = 256;
constexpr int kGroups = 16;      // row groups (and column groups) of tiles
constexpr int kScanThreads = 256;
constexpr int kScanUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroups == kSub, "a tile row's offset in its sub-chunk");

struct Strides {                 // element strides of the B, T, H axes
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh, gb, gt, gh;
};

// A chunk's tiles of N inputs [B, T, H, D] into shared [L][pitch] tiles,
// zero past t_len.  Every load of all N tiles is issued before the first
// store to shared memory (wkv.cu's staging).
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

// Inclusive cumulative logs down each column d, in place (wkv.cu's):
// kThreads / D parts of a column each sum their rows in order, then add
// the totals of the parts above them.  `part` is kThreads floats of
// scratch.  Ends with every thread synchronised.
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

// Exclusive suffix sums down each column d, in place: row i becomes the
// sum of rows i + 1 .. L - 1, in the same parts as `cumsum_cols`.  Ends
// with every thread synchronised.
template <int D>
__device__ __forceinline__ void suffix_cols(float* xc, int pitch,
                                            float* part) {
  constexpr int kParts = kThreads / D;
  constexpr int kRowsPer = kChunk / kParts;
  const int d = threadIdx.x % D, q = threadIdx.x / D;
  float* col = xc + q * kRowsPer * pitch + d;
  float acc = 0.f;
#pragma unroll
  for (int i = kRowsPer - 1; i >= 0; --i) {
    const float x = col[i * pitch];
    col[i * pitch] = acc;
    acc += x;
  }
  part[q * D + d] = acc;
  __syncthreads();
  if (q < kParts - 1) {
    float off = 0.f;
    for (int p = kParts - 1; p > q; --p) off += part[p * D + d];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) col[i * pitch] = off + col[i * pitch];
  }
  __syncthreads();
}

// Pass 1: a chunk's decay exp(ltot) and gradient increment
// (r * exp(lprev))^T do.  dg [NC, B, H, D, D], dec [NC, B, H, D].
template <int D>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_chunk_kernel(const float* __restrict__ r,
                     const float* __restrict__ w,
                     const float* __restrict__ go, float* __restrict__ dg,
                     float* __restrict__ dec, int t_len, int heads,
                     int batch, Strides st) {
  constexpr int kCols = D / kGroups;
  extern __shared__ float smem[];
  float* rs = smem;                      // [L][D] r, then r exp(lprev)
  float* gs = rs + kChunk * D;           // [L][D] do
  float* lc = gs + kChunk * D;           // [L][D] log decay, then lcum
  float* part = lc + kChunk * D;         // [kThreads] cumsum scratch
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk;
  const long long bh = (long long)b * heads + h;
  const long long cbh = (long long)c * batch * heads + bh;
  const int rg = tid / kGroups, cg = tid % kGroups;

  stage<D, 3>({{r, go, w}, {st.rb, st.gb, st.wb}, {st.rt, st.gt, st.wt},
               {st.rh, st.gh, st.wh}, {rs, gs, lc}, {D, D, D}},
              b, h, t0, t_len);
  __syncthreads();
  cumsum_cols<D>(lc, D, part);
  for (int i = tid; i < kChunk * D; i += kThreads) {
    const float lp = i >= D ? lc[i - D] : 0.f;    // lprev_t = lcum_{t-1}
    rs[i] = rs[i] * expf(lp);
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
    for (int a = 0; a < kCols; ++a) x[a] = rs[j * D + rg + kGroups * a];
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) y[c2] = gs[j * D + cg + kGroups * c2];
#pragma unroll
    for (int a = 0; a < kCols; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2)
        upd[a][c2] = fmaf(x[a], y[c2], upd[a][c2]);
  }
  float* out = dg + cbh * D * D;
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2)
      out[(rg + kGroups * a) * D + cg + kGroups * c2] = upd[a][c2];
}

// Pass 2: the reverse scan over the chunks, one thread per (batch row,
// head, d, e).  On return dg[c] holds G at chunk c's end; gs_in (when
// not null) the gradient at chunk 0's start.
template <int D>
__global__ void __launch_bounds__(kScanThreads)
wkv_bwd_scan_kernel(float* __restrict__ dg, const float* __restrict__ dec,
                    const float* __restrict__ gs_out,
                    float* __restrict__ gs_in, int n_chunks,
                    long long n_bh) {
  const long long idx = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (idx >= n_bh * D * D) return;
  const long long bh = idx / (D * D);
  const int de = (int)(idx % (D * D));
  const int d = de / D;
  float g = gs_out != nullptr ? gs_out[idx] : 0.f;
  for (int c1 = n_chunks - 1; c1 >= 0; c1 -= kScanUnroll) {
    float inc[kScanUnroll];
    float dc[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (c1 - u >= 0) {
        const long long cbh = (long long)(c1 - u) * n_bh + bh;
        inc[u] = dg[cbh * D * D + de];
        dc[u] = dec[cbh * D + d];
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (c1 - u >= 0) {
        dg[((long long)(c1 - u) * n_bh + bh) * D * D + de] = g;
        g = dc[u] * g + inc[u];
      }
    }
  }
  if (gs_in != nullptr) gs_in[idx] = g;
}

template <int D>
constexpr int out_smem_floats() {
  // r, k, v, do, lcum, k exp(ltot - lcum), a - b [L][D + 1]; S_c, G_c
  // [D][D + 1]; A and B [L][L + 1]; the k and r tiles of the
  // off-diagonal sub-blocks [2][48][D + 1]; r . (u k) [L]; u, the
  // end-of-chunk row sums [D]; the column scans' scratch
  return 7 * kChunk * (D + 1) + 2 * D * (D + 1) + kChunk * (kChunk + 1) +
         2 * (kNSub - 1) * kSub * (D + 1) + kChunk + 2 * D + kThreads;
}

// Pass 3: one chunk's gradients from S at its start (s_c) and G at its
// end (g_end, pass 2's).  s_out: the final state, or null when the final
// state's gradient is (then the last chunk's end term is 0).  du_part
// [NC, B, H, D] gets the chunk's r k (do . v) summed over its steps.
template <int D>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ go, const float* __restrict__ u,
                   const float* __restrict__ s_c,
                   const float* __restrict__ g_end,
                   const float* __restrict__ s_out, float* __restrict__ dr,
                   float* __restrict__ dk, float* __restrict__ dv,
                   float* __restrict__ dw, float* __restrict__ du_part,
                   int t_len, int heads, int batch, Strides st) {
  constexpr int P = D + 1;               // padded row of an [L][D] tile
  constexpr int PA = kChunk + 1;         // padded row of A and B
  constexpr int kRows = kChunk / kGroups;
  constexpr int kCols = D / kGroups;
  constexpr int kPairs = kSub * (kSub - 1) / 2;
  static_assert(kRows == kNSub, "tile row a lies in sub-chunk a");
  static_assert(kThreads % kChunk == 0 && kThreads % D == 0, "lanes");

  extern __shared__ float smem[];
  float* rs = smem;                      // [L][P] r
  float* ks = rs + kChunk * P;           // [L][P] k
  float* vs = ks + kChunk * P;           // [L][P] v
  float* gs = vs + kChunk * P;           // [L][P] do
  float* lc = gs + kChunk * P;           // [L][P] log decay, then lcum
  float* kt = lc + kChunk * P;           // [L][P] k exp(ltot - lcum)
  float* xs = kt + kChunk * P;           // [L][P] a - b, then its suffix sums
  float* ss = xs + kChunk * P;           // [D][P] S_c
  float* gg = ss + D * P;                // [D][P] G_c
  float* ab = gg + D * P;                // [L][PA] A below, B^T above
  float* kq = ab + kChunk * PA;          // [48][P] k_J exp(lam_J - lcum)
  float* rp = kq + (kNSub - 1) * kSub * P;   // [48][P] r_I exp(lprev - mu_I)
  float* ruk = rp + (kNSub - 1) * kSub * P;  // [L] r_i . (u * k_i)
  float* us = ruk + kChunk;              // [D] u
  float* zs = us + D;                    // [D] rowsum(G_c * S_{c+1})
  float* part = zs + D;                  // [kThreads] column scans' scratch

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = c * kChunk;
  const long long bh = (long long)b * heads + h;
  const long long cbh = (long long)c * batch * heads + bh;
  const int rg = tid / kGroups, cg = tid % kGroups;

  stage<D, 5>({{r, k, v, go, w}, {st.rb, st.kb, st.vb, st.gb, st.wb},
               {st.rt, st.kt, st.vt, st.gt, st.wt},
               {st.rh, st.kh, st.vh, st.gh, st.wh}, {rs, ks, vs, gs, lc},
               {P, P, P, P, P}},
              b, h, t0, t_len);
  {                                      // S_c and G_c, padded
    constexpr int kPer = D * D / kThreads;
    const float* sc = s_c + cbh * D * D;
    const float* ge = g_end + cbh * D * D;
    float sv[kPer];
    float gv[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      sv[q] = __ldg(sc + tid + q * kThreads);
      gv[q] = __ldg(ge + tid + q * kThreads);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kThreads;
      ss[(i / D) * P + i % D] = sv[q];
      gg[(i / D) * P + i % D] = gv[q];
    }
  }
  {                                      // zs = rowsum(G_c * S_{c+1})
    constexpr int kTpr = kThreads / D;   // threads a row, adjacent lanes
    constexpr int kPerRow = D / kTpr;
    const int row = tid / kTpr, q = tid % kTpr;
    const float* se = c + 1 < n_chunks
                          ? s_c + (cbh + (long long)batch * heads) * D * D
                          : (s_out != nullptr ? s_out + bh * D * D : nullptr);
    float acc = 0.f;
    if (se != nullptr) {
      const float* gp = g_end + cbh * D * D + row * D + q * kPerRow;
      const float* sp = se + row * D + q * kPerRow;
#pragma unroll
      for (int j = 0; j < kPerRow; ++j)
        acc = fmaf(__ldg(gp + j), __ldg(sp + j), acc);
    }
#pragma unroll
    for (int off = kTpr / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (q == 0) zs[row] = acc;
  }
  for (int i = tid; i < D; i += kThreads) us[i] = u[(long long)h * D + i];
  __syncthreads();

  {                                      // B[i, j] = do_i . v_j, j <= i
    float acc[kRows][kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kRows; ++c2) acc[a][c2] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float x[kRows];
      float y[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) x[a] = gs[(rg + kGroups * a) * P + e];
#pragma unroll
      for (int c2 = 0; c2 < kRows; ++c2)
        y[c2] = vs[(cg + kGroups * c2) * P + e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kRows; ++c2)
          acc[a][c2] = fmaf(x[a], y[c2], acc[a][c2]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kRows; ++c2) {
        const int i = rg + kGroups * a, j = cg + kGroups * c2;
        if (j <= i) ab[j * PA + i] = acc[a][c2];
      }
  }
  {                                      // ruk[i] = r_i . (u * k_i)
    constexpr int kLanes = kThreads / kChunk;
    const int i = tid / kLanes, l = tid % kLanes;
    float acc = 0.f;
#pragma unroll 8
    for (int d = l; d < D; d += kLanes)
      acc = fmaf(rs[i * P + d], us[d] * ks[i * P + d], acc);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (l == 0) ruk[i] = acc;
  }
  cumsum_cols<D>(lc, P, part);

  // the scaled tiles: k of sub-chunks 0..2 from their last step, r of
  // sub-chunks 1..3 from the step before them, k from the chunk's end
  for (int i = tid; i < (kNSub - 1) * kSub * D; i += kThreads) {
    const int j = i / D, d = i % D;
    const float lam = lc[((j / kSub) * kSub + kSub - 1) * P + d];
    kq[j * P + d] = ks[j * P + d] * expf(lam - lc[j * P + d]);
    const int ir = j + kSub;
    const float mu = lc[((ir / kSub) * kSub - 1) * P + d];
    rp[j * P + d] = rs[ir * P + d] * expf(lc[(ir - 1) * P + d] - mu);
  }
  for (int i = tid; i < kChunk * D; i += kThreads) {
    const int j = i / D, d = i % D;
    kt[j * P + d] =
        ks[j * P + d] * expf(lc[(kChunk - 1) * P + d] - lc[j * P + d]);
  }
  // the diagonal sub-blocks of A pairwise (j < i inside one sub-chunk),
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
    ab[pi_[0] * PA + pj_[0]] = acc0;
    if (tid + kThreads < kNSub * kPairs) ab[pi_[1] * PA + pj_[1]] = acc1;
  }
  if (tid < D) {                         // the chunk's part of du
    float acc = 0.f;
    for (int i = 0; i < kChunk; ++i)
      acc = fmaf(rs[i * P + tid] * ks[i * P + tid], ab[i * PA + i], acc);
    du_part[cbh * D + tid] = acc;
  }
  __syncthreads();

  // the off-diagonal sub-blocks of A (I > J): row i, 8 of J's columns
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
        acc[jj] = fmaf(rf, kq[(j0 + jj) * P + d], acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kSub / 2; ++jj) ab[i * PA + j0 + jj] = acc[jj];
  }
  __syncthreads();

  // outputs: rows i = rg + 16 a (sub-chunk a, offset rg), columns
  // d = cg + 16 c2
  const long long obase = ((long long)b * t_len + t0) * heads * D +
                          (long long)h * D;
  float xa[kRows][kCols];                // a - b
  float bt[kRows][kCols];                // b
  {                                      // dr
    float acc[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) acc[a][c2] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float x[kRows];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) x[a] = gs[(rg + kGroups * a) * P + e];
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2)
        y[c2] = ss[(cg + kGroups * c2) * P + e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          acc[a][c2] = fmaf(x[a], y[c2], acc[a][c2]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = rg + kGroups * a;
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) {
        const float lp = i > 0 ? lc[(i - 1) * P + cg + kGroups * c2] : 0.f;
        acc[a][c2] *= expf(lp);
      }
    }
    // off-diagonal: sub-chunk J's columns for the rows of every I > J
#pragma unroll
    for (int bj = 0; bj < kNSub - 1; ++bj) {
      float tt[kRows][kCols];
#pragma unroll
      for (int a = bj + 1; a < kRows; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2) tt[a][c2] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = bj * kSub + jj;
        float y[kCols];
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          y[c2] = kq[j * P + cg + kGroups * c2];
#pragma unroll
        for (int a = bj + 1; a < kRows; ++a) {
          const float bij = ab[j * PA + rg + kGroups * a];
#pragma unroll
          for (int c2 = 0; c2 < kCols; ++c2)
            tt[a][c2] = fmaf(bij, y[c2], tt[a][c2]);
        }
      }
      const float* lam = lc + (bj * kSub + kSub - 1) * P;
#pragma unroll
      for (int a = bj + 1; a < kRows; ++a) {
        const float* lp = lc + (rg + kGroups * a - 1) * P;
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2) {
          const int d = cg + kGroups * c2;
          acc[a][c2] = fmaf(expf(lp[d] - lam[d]), tt[a][c2], acc[a][c2]);
        }
      }
    }
    // diagonal sub-block: j < i in sub-chunk a, pairwise
    if (rg > 0) {
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = rg + kGroups * a;
        float lp[kCols];
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          lp[c2] = lc[(i - 1) * P + cg + kGroups * c2];
        for (int jj = 0; jj < rg; ++jj) {
          const int j = a * kSub + jj;
          const float bij = ab[j * PA + i];
#pragma unroll
          for (int c2 = 0; c2 < kCols; ++c2) {
            const int d = cg + kGroups * c2;
            acc[a][c2] = fmaf(expf(lp[c2] - lc[j * P + d]) * ks[j * P + d],
                              bij, acc[a][c2]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = rg + kGroups * a;
      const float vdo = ab[i * PA + i];
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) {
        const int d = cg + kGroups * c2;
        xa[a][c2] = rs[i * P + d] * acc[a][c2];
        if (t0 + i < t_len)
          dr[obase + (long long)i * heads * D + d] =
              fmaf(us[d] * ks[i * P + d], vdo, acc[a][c2]);
      }
    }
  }
  {                                      // dk
    float acc[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) acc[a][c2] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float x[kRows];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) x[a] = vs[(rg + kGroups * a) * P + e];
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2)
        y[c2] = gg[(cg + kGroups * c2) * P + e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          acc[a][c2] = fmaf(x[a], y[c2], acc[a][c2]);
    }
    float lcj[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) {
        const int d = cg + kGroups * c2;
        lcj[a][c2] = lc[(rg + kGroups * a) * P + d];
        acc[a][c2] *= expf(lc[(kChunk - 1) * P + d] - lcj[a][c2]);
      }
    // off-diagonal: sub-chunk I's rows for the columns of every J < I
#pragma unroll
    for (int bi = 1; bi < kNSub; ++bi) {
      float tt[kRows][kCols];
#pragma unroll
      for (int a = 0; a < bi; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2) tt[a][c2] = 0.f;
#pragma unroll 4
      for (int ii = 0; ii < kSub; ++ii) {
        const int i = bi * kSub + ii;
        float y[kCols];
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          y[c2] = rp[(i - kSub) * P + cg + kGroups * c2];
#pragma unroll
        for (int a = 0; a < bi; ++a) {
          const float bij = ab[(rg + kGroups * a) * PA + i];
#pragma unroll
          for (int c2 = 0; c2 < kCols; ++c2)
            tt[a][c2] = fmaf(bij, y[c2], tt[a][c2]);
        }
      }
      const float* mu = lc + (bi * kSub - 1) * P;
#pragma unroll
      for (int a = 0; a < bi; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2) {
          const int d = cg + kGroups * c2;
          acc[a][c2] = fmaf(expf(mu[d] - lcj[a][c2]), tt[a][c2],
                            acc[a][c2]);
        }
    }
    // diagonal sub-block: i > j in sub-chunk a, pairwise
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int j = rg + kGroups * a;
      for (int ii = rg + 1; ii < kSub; ++ii) {
        const int i = a * kSub + ii;
        const float bij = ab[j * PA + i];
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2) {
          const int d = cg + kGroups * c2;
          acc[a][c2] = fmaf(expf(lc[(i - 1) * P + d] - lcj[a][c2]) *
                                rs[i * P + d],
                            bij, acc[a][c2]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int j = rg + kGroups * a;
      const float vdo = ab[j * PA + j];
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) {
        const int d = cg + kGroups * c2;
        bt[a][c2] = ks[j * P + d] * acc[a][c2];
        xa[a][c2] -= bt[a][c2];
        xs[j * P + d] = xa[a][c2];
        if (t0 + j < t_len)
          dk[obase + (long long)j * heads * D + d] =
              fmaf(us[d] * rs[j * P + d], vdo, acc[a][c2]);
      }
    }
  }
  {                                      // dv: columns e = cg + 16 c2
    float acc[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) acc[a][c2] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x[kRows];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) x[a] = kt[(rg + kGroups * a) * P + d];
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) y[c2] = gg[d * P + cg + kGroups * c2];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          acc[a][c2] = fmaf(x[a], y[c2], acc[a][c2]);
    }
    // A^T do over i > j
#pragma unroll 4
    for (int i = rg + 1; i < kChunk; ++i) {
      float x[kRows];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int j = rg + kGroups * a;
        x[a] = i > j ? ab[i * PA + j] : 0.f;
      }
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) y[c2] = gs[i * P + cg + kGroups * c2];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c2 = 0; c2 < kCols; ++c2)
          acc[a][c2] = fmaf(x[a], y[c2], acc[a][c2]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int j = rg + kGroups * a;
      if (t0 + j >= t_len) continue;
#pragma unroll
      for (int c2 = 0; c2 < kCols; ++c2) {
        const int e = cg + kGroups * c2;
        dv[obase + (long long)j * heads * D + e] =
            fmaf(ruk[j], gs[j * P + e], acc[a][c2]);
      }
    }
  }
  __syncthreads();
  suffix_cols<D>(xs, P, part);
  // dw_log_t = rowsum(G_c * S_{c+1}) + sum_{s > t} (a_s - b_s) - b_t
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int j = rg + kGroups * a;
    if (t0 + j >= t_len) continue;
#pragma unroll
    for (int c2 = 0; c2 < kCols; ++c2) {
      const int d = cg + kGroups * c2;
      dw[obase + (long long)j * heads * D + d] =
          (zs[d] + xs[j * P + d]) - bt[a][c2];
    }
  }
}

// du [H, D] = the sum over the chunks and batch rows of du_part
// [NC x B, H, D].
__global__ void wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                  float* __restrict__ du, int n_rows,
                                  int n_hd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_hd) return;
  float acc = 0.f;
  for (int q = 0; q < n_rows; ++q) acc += du_part[(long long)q * n_hd + i];
  du[i] = acc;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* go, const float* u, const float* s_c,
           const float* s_out, const float* gs_out, float* dr, float* dk,
           float* dv, float* dw, float* du_part, float* du, float* gs_in,
           float* dg, float* dec, int batch, int t_len, int heads,
           const Strides& st, cudaStream_t stream) {
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  const long long n_bh = (long long)batch * heads;
  const dim3 grid(n_chunks, heads, batch);
  const int smem1 = (3 * kChunk * D + kThreads) * (int)sizeof(float);
  cudaError_t err = allow_smem(wkv_bwd_chunk_kernel<D>, smem1);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_chunk_kernel<D><<<grid, kThreads, smem1, stream>>>(
      r, w, go, dg, dec, t_len, heads, batch, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_scan = n_bh * D * D;
  wkv_bwd_scan_kernel<D><<<(unsigned)((n_scan + kScanThreads - 1) /
                                      kScanThreads),
                           kScanThreads, 0, stream>>>(dg, dec, gs_out, gs_in,
                                                      n_chunks, n_bh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem3 = out_smem_floats<D>() * (int)sizeof(float);
  err = allow_smem(wkv_bwd_out_kernel<D>, smem3);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_out_kernel<D><<<grid, kThreads, smem3, stream>>>(
      r, k, v, w, go, u, s_c, dg, gs_out != nullptr ? s_out : nullptr, dr,
      dk, dv, dw, du_part, t_len, heads, batch, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_hd = heads * D;
  wkv_bwd_du_kernel<<<(n_hd + 255) / 256, 256, 0, stream>>>(
      du_part, du, n_chunks * batch, n_hd);
  return (int)cudaGetLastError();
}

}  // namespace

// dr, dk, dv, dw contiguous [B, T, H, D]; du [H, D]; gs_out (or null:
// zeros) and gs_in (or null: not written) contiguous [B, H, D, D]; s_c
// the forward's chunk-start states [ceil(T / 64), B, H, D, D]; s_out the
// final state [B, H, D, D], needed when gs_out is given (null otherwise);
// dg (ceil(T / 64) * B * H * D * D floats), dec and du_part (ceil(T / 64)
// * B * H * D floats each) are scratch.  Launches four kernels on
// `stream`; returns the CUDA error of the launches (0 on success).
extern "C" int wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* go, const void* u, const void* s_c, const void* s_out,
    const void* gs_out, void* dr, void* dk, void* dv, void* dw,
    void* du_part, void* du, void* gs_in, void* dg, void* dec, int batch,
    int t_len, int heads, int d, long long rb, long long rt, long long rh,
    long long kb, long long kt, long long kh, long long vb, long long vt,
    long long vh, long long wb, long long wt, long long wh, long long gb,
    long long gt, long long gh, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || heads < 1 ||
      heads > 65535 || (gs_out != nullptr && s_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides st{rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh,
                   gb, gt, gh};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  switch (d) {
    case 32:
      return launch<32>(f(r), f(k), f(v), f(w), f(go), f(u), f(s_c),
                        f(s_out), f(gs_out), m(dr), m(dk), m(dv), m(dw),
                        m(du_part), m(du), m(gs_in), m(dg), m(dec), batch,
                        t_len, heads, st, s);
    case 64:
      return launch<64>(f(r), f(k), f(v), f(w), f(go), f(u), f(s_c),
                        f(s_out), f(gs_out), m(dr), m(dk), m(dv), m(dw),
                        m(du_part), m(du), m(gs_in), m(dg), m(dec), batch,
                        t_len, heads, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

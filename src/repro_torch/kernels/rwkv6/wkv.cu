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
// Design.  One block per (head, batch row) walks T in chunks of L = 64
// steps (the TPU kernel's chunk; the plain version's is 16: the two agree
// to rounding).  Per chunk, in shared memory (rows padded to D + 1
// floats): the r, k, v and log-decay tiles, the inclusive and exclusive
// cumulative logs, r * exp(lprev), k * exp(ltot - lcum), the pairwise
// matrix A and the state S [D, D].  A[i, j] = sum_d r_id k_jd
// exp(lprev_id - lcum_jd) is formed for j < i only, one triangle entry
// per thread in turn (every exponent <= 0, so any decay is safe); the
// [L, L, D] tensor of the TPU kernel is never formed and the masked
// triangle is never exponentiated (it stays 0).  Outputs and the state
// update are 4 x D/16 register tiles per thread.  A ragged last chunk is
// masked, not padded by a copy: its missing steps are staged as k = v = r
// = 0 and log-decay 0, which leave the state untouched, and are not
// stored.  The output sums inter + intra + diagonal in the plain
// version's order; dot products are sequential fmaf sums.
//
// Bound.  wkv_flops counts per chunk 4 L D^2 (r S and the state update)
// and 5 D per entry of the j < i triangle (A and A v): at rwkv6-3b's
// prefill shape (1, 4096, 40, 64) 4.39e9 flop, 0.065 ms at 67 TFLOP/s
// float32, against 210.4 MB of r, k, v, w, u, o and the state (0.063 ms
// at 3.35 TB/s): bound by operations.  This first kernel runs B x H blocks (40 for 132 SMs at one
// request), takes one expf per triangle element and per d (L^2 D / 2 a
// chunk) and reads A's operands from shared memory: splitting the state's
// columns across blocks, a sub-chunk factorisation of A onto tensor cores
// and more blocks per SM are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;       // L: time steps per chunk
constexpr int kThreads = 256;
constexpr int kGroups = 16;      // row groups (and column groups) of tiles
constexpr int kTri = kChunk * (kChunk - 1) / 2;

struct Strides {                 // element strides of the B, T, H axes
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
};

template <int D>
constexpr int smem_floats() {
  return 7 * kChunk * (D + 1) + kChunk * (kChunk + 1) + D * D + kChunk + D;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* s_in,
           float* __restrict__ o, float* __restrict__ s_out, int t_len,
           int heads, Strides st) {
  constexpr int P = D + 1;               // padded row of an [L][D] tile
  constexpr int PA = kChunk + 1;         // padded row of A
  constexpr int kRows = kChunk / kGroups;
  constexpr int kCols = D / kGroups;
  static_assert(D + kChunk <= kThreads, "cumsum and diagonal threads");

  extern __shared__ float smem[];
  float* rs = smem;                      // [L][P] r
  float* ks = rs + kChunk * P;           // [L][P] k
  float* vs = ks + kChunk * P;           // [L][P] v
  float* lc = vs + kChunk * P;           // [L][P] log decay, then lcum
  float* lp = lc + kChunk * P;           // [L][P] lprev = lcum - w
  float* rd = lp + kChunk * P;           // [L][P] r * exp(lprev)
  float* kd = rd + kChunk * P;           // [L][P] k * exp(ltot - lcum)
  float* am = kd + kChunk * P;           // [L][PA] A, strict lower triangle
  float* ss = am + kChunk * PA;          // [D][D] state S
  float* dg = ss + D * D;                // [L] r_i . (u * k_i)
  float* us = dg + kChunk;               // [D] u

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int rg = tid / kGroups;
  const int cg = tid % kGroups;
  const long long bh = (long long)b * heads + h;

  for (int i = tid; i < kChunk * kChunk; i += kThreads)
    if (i % kChunk >= i / kChunk) am[(i / kChunk) * PA + i % kChunk] = 0.f;
  for (int i = tid; i < D * D; i += kThreads)
    ss[i] = s_in != nullptr ? s_in[bh * D * D + i] : 0.f;
  for (int i = tid; i < D; i += kThreads) us[i] = u[(long long)h * D + i];

  const float* rb = r + b * st.rb + h * st.rh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* wb = w + b * st.wb + h * st.wh;
  float* ob = o + ((long long)b * t_len * heads + h) * D;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    __syncthreads();                     // the previous chunk is consumed
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int row = i / D;
      const int col = i % D;
      const long long t = t0 + row;
      const bool ok = t < t_len;
      rs[row * P + col] = ok ? rb[t * st.rt + col] : 0.f;
      ks[row * P + col] = ok ? kb[t * st.kt + col] : 0.f;
      vs[row * P + col] = ok ? vb[t * st.vt + col] : 0.f;
      lc[row * P + col] = ok ? wb[t * st.wt + col] : 0.f;
    }
    __syncthreads();

    if (tid < D) {                       // cumulative logs down column d
      float acc = 0.f;
      for (int i = 0; i < kChunk; ++i) {
        const float wl = lc[i * P + tid];
        acc += wl;
        lc[i * P + tid] = acc;
        lp[i * P + tid] = acc - wl;
      }
    } else if (tid < D + kChunk) {       // diagonal bonus of row i
      const int i = tid - D;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        acc = fmaf(rs[i * P + d], us[d] * ks[i * P + d], acc);
      dg[i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int row = i / D;
      const int col = i % D;
      const float ltot = lc[(kChunk - 1) * P + col];
      rd[row * P + col] = rs[row * P + col] * expf(lp[row * P + col]);
      kd[row * P + col] = ks[row * P + col] * expf(ltot - lc[row * P + col]);
    }
    for (int p = tid; p < kTri; p += kThreads) {
      // p = i (i - 1) / 2 + j with 0 <= j < i
      int i = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
      while (i * (i - 1) / 2 > p) --i;
      while ((i + 1) * i / 2 <= p) ++i;
      const int j = p - i * (i - 1) / 2;
      const float* ri = rs + i * P;
      const float* pi = lp + i * P;
      const float* kj = ks + j * P;
      const float* cj = lc + j * P;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        acc = fmaf(ri[d] * kj[d], expf(pi[d] - cj[d]), acc);
      am[i * PA + j] = acc;
    }
    __syncthreads();

    // outputs: rows rg + 16 a, columns cg + 16 c
    float inter[kRows][kCols];
    float intra[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) inter[a][c] = intra[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x[kRows];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) x[a] = rd[(rg + kGroups * a) * P + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) y[c] = ss[d * D + cg + kGroups * c];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          inter[a][c] = fmaf(x[a], y[c], inter[a][c]);
    }
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      float x[kRows];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) x[a] = am[(rg + kGroups * a) * PA + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) y[c] = vs[j * P + cg + kGroups * c];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          intra[a][c] = fmaf(x[a], y[c], intra[a][c]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = rg + kGroups * a;
      if (t0 + i >= t_len) continue;
      float* orow = ob + (long long)(t0 + i) * heads * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int e = cg + kGroups * c;
        orow[e] = (inter[a][c] + intra[a][c]) + dg[i] * vs[i * P + e];
      }
    }
    __syncthreads();                     // every read of S is done

    // state: rows rg + 16 a, columns cg + 16 c
    float upd[kCols][kCols];
#pragma unroll
    for (int a = 0; a < kCols; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) upd[a][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      float x[kCols];
      float y[kCols];
#pragma unroll
      for (int a = 0; a < kCols; ++a) x[a] = kd[j * P + rg + kGroups * a];
#pragma unroll
      for (int c = 0; c < kCols; ++c) y[c] = vs[j * P + cg + kGroups * c];
#pragma unroll
      for (int a = 0; a < kCols; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          upd[a][c] = fmaf(x[a], y[c], upd[a][c]);
    }
#pragma unroll
    for (int a = 0; a < kCols; ++a) {
      const int d = rg + kGroups * a;
      const float decay = expf(lc[(kChunk - 1) * P + d]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float* sp = ss + d * D + cg + kGroups * c;
        *sp = decay * *sp + upd[a][c];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < D * D; i += kThreads) s_out[bh * D * D + i] = ss[i];
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s_in, float* o, float* s_out,
           int batch, int t_len, int heads, const Strides& st,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  auto kernel = wkv_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(r, k, v, w, u, s_in, o, s_out,
                                           t_len, heads, st);
  return (int)cudaGetLastError();
}

}  // namespace

// o is contiguous [B, T, H, D]; s_out and s_in (or null: zeros)
// contiguous [B, H, D, D].  Returns the CUDA error of the launch (0 on success).
extern "C" int wkv_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s_in, void* o, void* s_out, int batch,
    int t_len, int heads, int d, long long rb, long long rt, long long rh,
    long long kb, long long kt, long long kh, long long vb, long long vt,
    long long vh, long long wb, long long wt, long long wh, void* stream) {
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
  switch (d) {
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, sf, of, so, batch, t_len, heads,
                        st, s);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, sf, of, so, batch, t_len, heads,
                        st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

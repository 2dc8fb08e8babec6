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
// With G_t the gradient flowing into S_t (G_T = the final state's
// gradient, zeros when null) and w_t = exp(w_log_t):
//   dr_t     = do_t (S_{t-1} + diag(u) k_t^T v_t)^T
//   dk_t     = G_t v_t + u * r_t (do_t . v_t)
//   dv_t     = G_t^T k_t + (r_t . (u * k_t)) do_t
//   dw_log_t = w_t * rowsum(G_t * S_{t-1})
//   du       = sum over b, t of r_t * k_t (do_t . v_t)
//   G_{t-1}  = diag(w_t) G_t + r_t^T do_t,   d state = G_0.
//
// Inputs r, k, v, w_log and do [B, T, H, D] (read through their batch,
// time and head strides, the D axis contiguous), u [H, D], the states at
// the start of every 64-step chunk that the forward's pass 2 leaves in
// its `kv` scratch ([ceil(T / 64), B, H, D, D]) and the final state's
// gradient [B, H, D, D] or null.  Outputs dr, dk, dv, dw_log contiguous
// [B, T, H, D], du [H, D] and, when asked, the initial state's gradient
// [B, H, D, D].  float32, D 32 or 64.
//
// Design: the simple one.  A block per (head, batch row) holds S and G
// [D, D] in registers, 4 threads a row and D / 4 columns a thread, and
// walks the chunks from the last to the first.  For each chunk it stages
// the chunk's r, k, v, exp(w_log) and do in shared memory with the
// per-step dot products do . v and r . (u * k); then
//   1. walks the chunk forward from the saved chunk-start state,
//      storing each S_{t-1} in a per-thread global scratch (each thread
//      writes and later reads only its own elements, so no barrier) and
//      forming dr_t, whose only state term S_{t-1} do_t is known there;
//   2. walks the chunk's steps in reverse with G: dk_t and dw_log_t are
//      row sums (two shuffles across the row's 4 threads), dv_t a column
//      sum (a reduce-scatter across the warp's 8 rows, then the warps'
//      partial sums through shared memory, one barrier a step).
// Every factor w_t = exp(w_log_t) is <= 1, so neither S nor G grows and
// nothing overflows.  A ragged last chunk walks only its own steps.
// Sums are fmaf on the CUDA cores in float32, no TF32: the bound against
// the plain version is rtol = atol = 1e-3.
//
// Bound.  `wkv_bwd_flops` counts 14 D^2 per step and (batch row, head)
// (the state rebuilt, S do, G v, G * S, G^T k and the G update) and 16 D
// for the u terms: at rwkv6-3b's (1, 4096, 40, 64) 9.6e9 flop, 0.14 ms
// at 67 TFLOP/s float32, above its ~0.42 GB of inputs and outputs (0.13
// ms at 3.35 TB/s).  Only B x H blocks run (40 of the 132 SMs at that
// shape), each a chain of 2 T dependent steps with a block-wide barrier
// in every backward step.  It takes ~7 ms there, ~49x the bound
// (chip_smoke.py, H100).  Three changes that kept every output bitwise
// made it no faster: a cp.async ring bringing S_{t-1} back 8 steps
// ahead, float4 broadcast loads of v_t and do_t, and checkpoints every 8
// steps with the history rebuilt in shared memory (no scratch round
// trip).  What bounds it is not isolated; a chunk-parallel design that
// mirrors the forward's three passes is the lever (ROADMAP queue B).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;       // the forward's chunk: its saved states
constexpr unsigned kFull = 0xffffffffu;

struct Strides {                 // element strides of the B, T, H axes
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh, gb, gt, gh;
};

template <int D>
struct Cfg {
  static constexpr int kThreads = 4 * D;      // 4 threads a row of S
  static constexpr int kCols = D / 4;         // columns of S a thread
  static constexpr int kWarps = kThreads / 32;
};

template <int D>
constexpr int bwd_smem_floats() {
  // r, k, v, exp(w_log), do [L][D]; do . v and r . (u k) [L]; the
  // column sums of dv, two buffers [2][warps][D]
  return 5 * kChunk * D + 2 * kChunk + 2 * Cfg<D>::kWarps * D;
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ go, const float* __restrict__ u,
               const float* __restrict__ s_c, const float* __restrict__ gs_out,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_part, float* __restrict__ gs_in,
               float4* __restrict__ hist, int t_len, int heads, int batch,
               Strides st) {
  constexpr int NT = Cfg<D>::kThreads, CPT = Cfg<D>::kCols;
  constexpr int NW = Cfg<D>::kWarps, C4 = CPT / 4;
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + kChunk * D;
  float* vs = ks + kChunk * D;
  float* ws = vs + kChunk * D;           // exp(w_log)
  float* gs = ws + kChunk * D;           // do
  float* vdo = gs + kChunk * D;          // do . v
  float* ruk = vdo + kChunk;             // r . (u * k)
  float* colsum = ruk + kChunk;          // [2][NW][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid >> 2, col0 = (tid & 3) * CPT;
  const bool row_lead = (tid & 3) == 0;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = (long long)b * heads + h;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  const float u_row = __ldg(u + h * D + row);
  float4* my_hist = hist + bh * kChunk * C4 * NT + tid;

  float g[CPT];                          // G, then G_{t-1} after each step
  if (gs_out != nullptr) {
    const float4* src = reinterpret_cast<const float4*>(
        gs_out + bh * D * D + row * D + col0);
#pragma unroll
    for (int j = 0; j < C4; ++j) {
      const float4 x = __ldg(src + j);
      g[4 * j] = x.x; g[4 * j + 1] = x.y; g[4 * j + 2] = x.z;
      g[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) g[j] = 0.f;
  }
  float du_acc = 0.f;
  int buf = 0;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int len = min(kChunk, t_len - t0);
    __syncthreads();                     // the last chunk's reads are done
    // stage the chunk (zero past T; exp(0) = 1 there)
#pragma unroll 4
    for (int i = tid; i < kChunk * D; i += NT) {
      const int t = i / D, d = i % D;
      float xr = 0.f, xk = 0.f, xv = 0.f, xw = 0.f, xg = 0.f;
      if (t < len) {
        const long long tt = t0 + t;
        xr = __ldg(r + b * st.rb + tt * st.rt + h * st.rh + d);
        xk = __ldg(k + b * st.kb + tt * st.kt + h * st.kh + d);
        xv = __ldg(v + b * st.vb + tt * st.vt + h * st.vh + d);
        xw = __ldg(w + b * st.wb + tt * st.wt + h * st.wh + d);
        xg = __ldg(go + b * st.gb + tt * st.gt + h * st.gh + d);
      }
      rs[i] = xr; ks[i] = xk; vs[i] = xv; ws[i] = expf(xw); gs[i] = xg;
    }
    __syncthreads();
    for (int t = warp; t < kChunk; t += NW) {
      float a = 0.f, e = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) {
        a = fmaf(vs[t * D + d], gs[t * D + d], a);
        e = fmaf(rs[t * D + d], __ldg(u + h * D + d) * ks[t * D + d], e);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        a += __shfl_xor_sync(kFull, a, m);
        e += __shfl_xor_sync(kFull, e, m);
      }
      if (lane == 0) {
        vdo[t] = a;
        ruk[t] = e;
      }
    }
    float s[CPT];                        // S at the chunk's start
    {
      const float4* src = reinterpret_cast<const float4*>(
          s_c + (((long long)c * batch + b) * heads + h) * D * D + row * D +
          col0);
#pragma unroll
      for (int j = 0; j < C4; ++j) {
        const float4 x = __ldg(src + j);
        s[4 * j] = x.x; s[4 * j + 1] = x.y; s[4 * j + 2] = x.z;
        s[4 * j + 3] = x.w;
      }
    }
    __syncthreads();

    // 1. forward: keep S_{t-1}, form dr_t, step S
    for (int t = 0; t < len; ++t) {
      float4* hp = my_hist + (long long)t * C4 * NT;
#pragma unroll
      for (int j = 0; j < C4; ++j)
        hp[j * NT] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                 s[4 * j + 3]);
      const float* gt = gs + t * D + col0;
      const float* vt = vs + t * D + col0;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc = fmaf(s[j], gt[j], acc);
      acc = row_sum(acc);
      const float kr = ks[t * D + row], wr = ws[t * D + row];
      if (row_lead)
        dr[(((long long)b * t_len + t0 + t) * heads + h) * D + row] =
            fmaf(u_row * kr, vdo[t], acc);
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] = fmaf(wr, s[j], kr * vt[j]);
    }

    // 2. backward: dk_t, dw_log_t, dv_t from G_t, then G_{t-1}
    float sn[CPT];                       // S_{t-1}, loaded a step ahead
    if (len > 0) {
      const float4* hp = my_hist + (long long)(len - 1) * C4 * NT;
#pragma unroll
      for (int j = 0; j < C4; ++j) {
        const float4 x = hp[j * NT];
        sn[4 * j] = x.x; sn[4 * j + 1] = x.y; sn[4 * j + 2] = x.z;
        sn[4 * j + 3] = x.w;
      }
    }
    for (int t = len - 1; t >= 0; --t) {
      float sp[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) sp[j] = sn[j];
      if (t > 0) {
        const float4* hp = my_hist + (long long)(t - 1) * C4 * NT;
#pragma unroll
        for (int j = 0; j < C4; ++j) {
          const float4 x = hp[j * NT];
          sn[4 * j] = x.x; sn[4 * j + 1] = x.y; sn[4 * j + 2] = x.z;
          sn[4 * j + 3] = x.w;
        }
      }
      const float* gt = gs + t * D + col0;
      const float* vt = vs + t * D + col0;
      const float kr = ks[t * D + row], wr = ws[t * D + row];
      const float rr = rs[t * D + row];
      float a_k = 0.f, a_w = 0.f;
      float cp[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        a_k = fmaf(g[j], vt[j], a_k);
        a_w = fmaf(g[j], sp[j], a_w);
        cp[j] = g[j] * kr;
      }
      a_k = row_sum(a_k);
      a_w = row_sum(a_w);
      if (row_lead) {
        const long long o = (((long long)b * t_len + t0 + t) * heads + h) *
                                D + row;
        dk[o] = fmaf(u_row * rr, vdo[t], a_k);
        dw[o] = wr * a_w;
        du_acc = fmaf(rr * kr, vdo[t], du_acc);
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) g[j] = fmaf(wr, g[j], rr * gt[j]);
      // the column sums of G_t^T k_t over the warp's 8 rows: halve the
      // columns at each of the lane bits 4, 3, 2 (the row bits)
      int off = 0;
#pragma unroll
      for (int lvl = 0; lvl < 3; ++lvl) {
        const int m = 16 >> lvl;
        const int half = CPT >> (lvl + 1);
        const bool upper = (lane & m) != 0;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = upper ? cp[j] : cp[j + half];
          const float keep = upper ? cp[j + half] : cp[j];
          cp[j] = keep + __shfl_xor_sync(kFull, send, m);
        }
        off += upper ? half : 0;
      }
      float* cs = colsum + (buf * NW + warp) * D + col0 + off;
#pragma unroll
      for (int j = 0; j < CPT / 8; ++j) cs[j] = cp[j];
      __syncthreads();
      if (tid < D) {
        const float* cb = colsum + buf * NW * D + tid;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < NW; ++q) acc += cb[q * D];
        dv[(((long long)b * t_len + t0 + t) * heads + h) * D + tid] =
            fmaf(ruk[t], gs[t * D + tid], acc);
      }
      buf ^= 1;
    }
  }
  if (gs_in != nullptr) {
    float4* dst = reinterpret_cast<float4*>(gs_in + bh * D * D + row * D +
                                            col0);
#pragma unroll
    for (int j = 0; j < C4; ++j)
      dst[j] = make_float4(g[4 * j], g[4 * j + 1], g[4 * j + 2],
                           g[4 * j + 3]);
  }
  if (row_lead) du_part[bh * D + row] = du_acc;
}

// du [H, D] = the sum over the batch rows of du_part [B, H, D].
__global__ void wkv_bwd_du_kernel(const float* __restrict__ du_part,
                                  float* __restrict__ du, int batch,
                                  int n_hd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_hd) return;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) acc += du_part[(long long)b * n_hd + i];
  du[i] = acc;
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* go, const float* u, const float* s_c,
           const float* gs_out, float* dr, float* dk, float* dv, float* dw,
           float* du_part, float* du, float* gs_in, float4* hist, int batch,
           int t_len, int heads, const Strides& st, cudaStream_t stream) {
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_kernel<D><<<dim3(heads, batch), Cfg<D>::kThreads, smem, stream>>>(
      r, k, v, w, go, u, s_c, gs_out, dr, dk, dv, dw, du_part, gs_in, hist,
      t_len, heads, batch, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_hd = heads * D;
  wkv_bwd_du_kernel<<<(n_hd + 255) / 256, 256, 0, stream>>>(du_part, du,
                                                            batch, n_hd);
  return (int)cudaGetLastError();
}

}  // namespace

// dr, dk, dv, dw contiguous [B, T, H, D]; du [H, D]; gs_out (or null:
// zeros) and gs_in (or null: not written) contiguous [B, H, D, D]; s_c
// the forward's chunk-start states [ceil(T / 64), B, H, D, D]; du_part
// (B * H * D floats) and hist (B * H * 64 * D * D floats, 16-byte
// aligned) are scratch.  Launches two kernels on `stream`; returns the
// CUDA error of the launches (0 on success).
extern "C" int wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* go, const void* u, const void* s_c, const void* gs_out,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* du,
    void* gs_in, void* hist, int batch, int t_len, int heads, int d,
    long long rb, long long rt, long long rh, long long kb, long long kt,
    long long kh, long long vb, long long vt, long long vh, long long wb,
    long long wt, long long wh, long long gb, long long gt, long long gh,
    void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || heads < 1 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh,
                   gb, gt, gh};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  switch (d) {
    case 32:
      return launch<32>(f(r), f(k), f(v), f(w), f(go), f(u), f(s_c),
                        f(gs_out), m(dr), m(dk), m(dv), m(dw), m(du_part),
                        m(du), m(gs_in), static_cast<float4*>(hist), batch,
                        t_len, heads, st, s);
    case 64:
      return launch<64>(f(r), f(k), f(v), f(w), f(go), f(u), f(s_c),
                        f(gs_out), m(dr), m(dk), m(dv), m(dw), m(du_part),
                        m(du), m(gs_in), static_cast<float4*>(hist), batch,
                        t_len, heads, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

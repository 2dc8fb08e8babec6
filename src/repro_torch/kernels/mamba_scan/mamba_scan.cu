// Mamba selective scan, for Hopper.
//
// Replaces the Pallas TPU kernel `mamba_scan_bdt` of
// src/repro/kernels/mamba_scan/mamba_scan.py (`_kernel`).  Plain
// version: repro_torch/kernels/mamba_scan/ref.py (the reference's step
// loop).
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = h_t . C_t
//
// Inputs x, dt [B, T, di] and B, C [B, T, ds] read through their batch
// and time strides (the last axis contiguous: B and C are column slices
// of the model's x_proj output, read in place), A [di, ds] contiguous,
// an optional initial state h0 [B, di, ds] (zeros when null); outputs
// y [B, T, di] and the final state [B, di, ds] (the decode cache's; h0
// and the final state may be one buffer: each thread reads its own
// states before it writes them); optionally the state before every
// `save`-th step, h_chunks [ceil(T / save), B, di, ds] (null: not
// written), which the backward (mamba_scan_bwd.cu) rebuilds each span's
// states from.  No D-skip and no gate, as the TPU kernel.  float32; ds 8
// (the reduced configs) or 16.
//
// Bound.  mamba_scan_hbm_bytes = 4 B T (3 di + 2 ds) bytes: at jamba's
// prefill shape (1, 4096, 16384, 16) 805.8 MB, 0.241 ms at 3.35 TB/s,
// against ~7.6e9 operations (0.113 ms at 67 TFLOP/s float32).  Each of
// the 1.07e9 exponentials is one MUFU.EX2 (and 8 float32 instructions
// of the IEEE expf): 0.26 ms of MUFU work at 16 an SM a clock, above the
// bytes bound.  A decode step (T = 1) reads and writes the state: 5.4 MB
// at (2, 1, 16384, 16), 1.6 us.
//
// Design.  Each (batch row, channel) has a team of P adjacent threads (P
// in {2, 4, 8, 16}, dividing ds), each holding ds / P consecutive states
// and the matching slice of A's row in registers for the whole sequence,
// so B x di x P threads fill the card where one thread per channel (the
// first version) left 4 warps an SM.  Per step a thread computes its
// states' expf(dt * a) and updates them (the exp of the product, then
// multiply and add, no contraction: the build passes -fmad=false, so the
// state rounds as the plain version and as the first version, bit for
// bit), sums its states' h * C with a sequential fmaf and the team adds
// its partial sums with __shfl_xor_sync in a fixed butterfly (every team
// lane ends with the same sum: float addition commutes).  A block holds
// `channels` channels; time is walked in tiles of `steps` steps: the block
// stages the tile's x and dt [steps][channels] (coalesced over the
// channels) and B and C [steps][ds] (shared by every channel) in shared
// memory with cp.async into the second of two buffers while the teams
// walk the first, in groups of kGroup steps (all loads, then the group's
// independent exponentials, then the state updates in step order, then
// the group's team sums), the teams write y into a [steps][channels]
// tile, and the block stores it coalesced.  Ragged T and di are masked, not padded: a
// channel past di computes on zeros and stores nothing, a step past T is
// not staged.  At T = 1 a team's states are adjacent in h0 and the final
// state, so a warp's state loads and stores cover one contiguous span.
// The host plan (ops.scan_plan: P, channels per block, steps per tile)
// was chosen by measurement on the card.  The grad path's launch (kSave)
// also stores each thread's states before every `save`-th step, at the
// start of a group: every 16 steps, 268 MB at jamba's prefill shape,
// 1.06x the serve launch's time on an H100 (700 W; PR 28's
// benchmarks/port_kernel_redesign.py run).

#include <cuda_runtime.h>
#include <math.h>

namespace {

// steps a thread walks as one group: 8 with 4 states a thread, else 4
// (measured on an H100: 8 is ~4 % faster at P = 4, ds = 16, and slower
// at 1 state a thread)
template <int NS>
constexpr int kGroup = NS == 4 ? 8 : 4;
constexpr int kMaxThreads = 512; // threads per block, at most

struct Strides {                 // element strides of the B and T axes
  long long xb, xt, db, dt, bb, bt, cb, ct, yb, yt;
};

// cp.async of one float into shared memory; `ok` false fills a zero and
// reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior_1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// NS consecutive floats of shared memory, in vector loads where aligned
template <int NS>
__device__ __forceinline__ void load_ns(const float* p, float (&v)[NS]) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (NS == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// NS consecutive floats to global memory, in vector stores where aligned
template <int NS>
__device__ __forceinline__ void store_ns(float* p, const float (&v)[NS]) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NS / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (NS == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// U consecutive steps i, ..., i + U - 1 of one thread's NS states: every
// load first, then the U x NS exponentials (independent of the state),
// then the state updates in step order, then the U partial sums' team
// butterflies (independent of each other), then y: the latency of each
// stage overlaps U times over.
template <int DS, int P, int U>
__device__ __forceinline__ void scan_steps(int i, const float* bs,
                                           const float* cs, const float* xs,
                                           const float* dts, float* ys,
                                           int cpb, int cl, int j,
                                           const float (&av)[DS / P],
                                           float (&h)[DS / P]) {
  constexpr int NS = DS / P;
  float d[U], dx[U], bv[U][NS], cv[U][NS], da[U][NS], acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    d[u] = dts[(i + u) * cpb + cl];
    dx[u] = d[u] * xs[(i + u) * cpb + cl];
    load_ns<NS>(bs + (i + u) * DS + j * NS, bv[u]);
    load_ns<NS>(cs + (i + u) * DS + j * NS, cv[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int s = 0; s < NS; ++s) da[u][s] = expf(d[u] * av[s]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    acc[u] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float dbx = dx[u] * bv[u][s];
      h[s] = da[u][s] * h[s] + dbx;
      acc[u] = fmaf(h[s], cv[u][s], acc[u]);
    }
  }
#pragma unroll
  for (int m = P / 2; m >= 1; m /= 2)
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc[u] = acc[u] + __shfl_xor_sync(0xffffffffu, acc[u], m);
  if (j == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) ys[(i + u) * cpb + cl] = acc[u];
  }
}

// kSave: the launch writes h_chunks every `save` steps (an
// instantiation of its own, so that the serve path's launches run the
// code they ran before it)
template <int DS, int P, bool kSave>
__global__ void __launch_bounds__(kMaxThreads) mamba_scan_kernel(const float* __restrict__ x,
                                  const float* __restrict__ dt,
                                  const float* __restrict__ bm,
                                  const float* __restrict__ cm,
                                  const float* __restrict__ a,
                                  const float* h0, float* __restrict__ y,
                                  float* h_out, float* __restrict__ h_chunks,
                                  int t_len, int di, int steps, int save,
                                  Strides st) {
  constexpr int NS = DS / P;     // states per thread
  extern __shared__ __align__(16) float sm[];
  const int cpb = blockDim.x / P;              // channels per block
  // two tile buffers of [B steps x DS][C steps x DS][x steps x cpb]
  // [dt steps x cpb] (16-byte aligned: DS and 2 cpb are multiples of 4),
  // then the y tile [steps x cpb]
  const int buf = steps * (2 * DS + 2 * cpb);
  float* ys = sm + 2 * buf;

  const int tid = threadIdx.x;
  const int cl = tid / P;                      // channel within the block
  const int j = tid % P;                       // team lane
  const int ch0 = blockIdx.x * cpb;
  const int ch = ch0 + cl;
  const int nch = min(cpb, di - ch0);          // live channels of the block
  const int b = blockIdx.y;
  const bool ok = ch < di;

  float av[NS];
  float h[NS];
  const long long hrow = ((long long)b * di + ch) * DS + j * NS;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    av[s] = ok ? a[(long long)ch * DS + j * NS + s] : 0.f;
    h[s] = (ok && h0 != nullptr) ? h0[hrow + s] : 0.f;
  }

  const float* xb = x + b * st.xb + ch0;
  const float* db = dt + b * st.db + ch0;
  const float* bb = bm + b * st.bb;
  const float* cb = cm + b * st.cb;
  float* yb = y + b * st.yb + ch0;

  // a [steps][cpb] tile is walked P rows at a time: thread tid always
  // takes column tc of rows tr, tr + P, ... (no division per element)
  const int tc = tid % cpb, tr = tid / cpb;
  const bool tc_live = tc < nch;

  // the tile of steps [t0, t0 + n) into buffer `base`, asynchronously
  auto stage = [&](int t0, float* base) {
    const int n = min(steps, t_len - t0);
    float* bs = base;
    float* cs = bs + steps * DS;
    float* xs = cs + steps * DS;
    float* dts = xs + steps * cpb;
    for (int r = tr; r < n; r += P) {
      const long long t = t0 + r;
      cp_async4(xs + r * cpb + tc, tc_live ? xb + t * st.xt + tc : xb,
                tc_live);
      cp_async4(dts + r * cpb + tc, tc_live ? db + t * st.dt + tc : db,
                tc_live);
    }
    for (int i = tid; i < n * DS; i += blockDim.x) {
      const long long t = t0 + i / DS;
      cp_async4(bs + i, bb + t * st.bt + i % DS, true);
      cp_async4(cs + i, cb + t * st.ct + i % DS, true);
    }
  };

  // kSave: the state before every `save`-th step, each a group's first
  // (the launch checks that the save points fall on group starts)
  float* hc = h_chunks + hrow;
  const long long hstride = (long long)gridDim.y * di * DS;
  int next_save = 0;
  auto save_state = [&](int t) {
    if (t == next_save) {
      if (ok) store_ns<NS>(hc, h);
      hc += hstride;
      next_save += save;
    }
  };

  stage(0, sm);
  cp_async_commit();
  for (int t0 = 0, it = 0; t0 < t_len; t0 += steps, ++it) {
    const int n = min(steps, t_len - t0);
    if (t0 + steps < t_len) stage(t0 + steps, sm + ((it + 1) & 1) * buf);
    cp_async_commit();                // (an empty group on the last tile)
    cp_async_wait_prior_1();          // this tile's copies have landed
    __syncthreads();
    const float* bs = sm + (it & 1) * buf;
    const float* cs = bs + steps * DS;
    const float* xs = cs + steps * DS;
    const float* dts = xs + steps * cpb;
    // every team lane runs the steps: the shuffles need the whole warp (a
    // channel past di computes on zeros)
    int i = 0;
    for (; i + kGroup<NS> <= n; i += kGroup<NS>) {
      if constexpr (kSave) save_state(t0 + i);
      scan_steps<DS, P, kGroup<NS>>(i, bs, cs, xs, dts, ys, cpb, cl, j, av,
                                    h);
    }
    for (; i < n; ++i) {
      if constexpr (kSave) save_state(t0 + i);
      scan_steps<DS, P, 1>(i, bs, cs, xs, dts, ys, cpb, cl, j, av, h);
    }
    __syncthreads();                  // the y tile is complete
    if (tc_live)
      for (int r = tr; r < n; r += P)
        yb[(long long)(t0 + r) * st.yt + tc] = ys[r * cpb + tc];
  }

  if (ok) {
#pragma unroll
    for (int s = 0; s < NS; ++s) h_out[hrow + s] = h[s];
  }
}

template <int DS, int P>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, const float* h0, float* y, float* h_out,
           float* h_chunks, int batch, int t_len, int di, int channels,
           int steps, int save, const Strides& st, cudaStream_t stream) {
  const int threads = channels * P;
  const long long smem = 4LL * steps * (2 * (2LL * DS + 2 * channels)
                                        + channels);
  if (threads > kMaxThreads || threads % 32 != 0 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  // saves on group starts: every tile starts on a save point and the
  // groups of steps divide the spacing
  if (h_chunks != nullptr &&
      ((steps < t_len && steps % save != 0) || save % kGroup<DS / P> != 0))
    return (int)cudaErrorInvalidValue;
  auto kern = h_chunks != nullptr ? mamba_scan_kernel<DS, P, true>
                                   : mamba_scan_kernel<DS, P, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((di + channels - 1) / channels, batch);
  kern<<<grid, threads, smem, stream>>>(x, dt, bm, cm, a, h0, y, h_out,
                                        h_chunks, t_len, di, steps, save, st);
  return (int)cudaGetLastError();
}

}  // namespace

// h0 may be null (zeros), h_chunks null (not written; else the state
// before every `save`-th step, [ceil(t_len / save), batch, di, ds]).
// team = P threads per channel (2, 4, 8 or 16, dividing ds), `channels`
// per block (channels x team a multiple of 32, at most kMaxThreads),
// `steps` per staged tile, `save` >= 1 with h_chunks.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mamba_scan_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* a, const void* h0, void* y, void* h_out, void* h_chunks,
    int batch,
    int t_len, int di, int ds, int team, int channels, int steps, int save,
    long long xb, long long xt, long long db, long long dtt, long long bb,
    long long bt, long long cb, long long ct, long long yb, long long yt,
    void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1 || channels < 1 ||
      steps < 1 || (h_chunks != nullptr && save < 1))
    return (int)cudaErrorInvalidValue;
  const Strides st{xb, xt, db, dtt, bb, bt, cb, ct, yb, yt};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cmf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(h_out);
  auto* cf = static_cast<float*>(h_chunks);
#define MAMBA_SCAN_CASE(DS_, P_)                                             \
  if (ds == DS_ && team == P_)                                               \
    return launch<DS_, P_>(xf, df, bf, cmf, af, hf, yf, of, cf, batch,       \
                           t_len, di, channels, steps, save, st, s);
  MAMBA_SCAN_CASE(8, 2)
  MAMBA_SCAN_CASE(8, 4)
  MAMBA_SCAN_CASE(8, 8)
  MAMBA_SCAN_CASE(16, 2)
  MAMBA_SCAN_CASE(16, 4)
  MAMBA_SCAN_CASE(16, 8)
  MAMBA_SCAN_CASE(16, 16)
#undef MAMBA_SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

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
// and the final state may be one buffer: each thread reads its own rows
// before it writes them).  No D-skip and no gate, as the TPU kernel.
// float32; ds 8 (the reduced configs) or 16.
//
// Design.  One thread per (batch row, channel) keeps its h[ds] and A row
// in registers for the whole sequence; blocks of 64 channels.  Time is
// walked in tiles of 32 steps: each thread stages its channel's x and dt
// of the tile in shared memory (32 independent loads in flight, coalesced
// across the block's channels), and the block stages the tile's B and C
// rows (shared by every channel) once.  Ragged T and di are masked, not
// padded: a channel past di computes nothing, a step past T is not
// staged.  The state update rounds as the plain version (exp of the
// product, then multiply and add, no contraction: the build passes
// -fmad=false); y is a sequential fmaf sum over ds where the plain
// version's einsum sums in its own order.
//
// Bound.  mamba_scan_hbm_bytes = 4 B T (3 di + 2 ds) bytes: at jamba's
// prefill shape (1, 4096, 16384, 16) 805.8 MB, 0.241 ms at 3.35 TB/s,
// against ~7.5e9 operations (0.11 ms at 67 TFLOP/s float32): bound by
// bytes.  This first kernel has B x di threads (16,384 at B = 1: 4
// warps an SM), so it is bound by the latency of each thread's chain of
// T steps of ds expf; splitting ds across threads is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChannels = 64;    // channels per block, one thread each
constexpr int kSteps = 32;       // time steps staged per tile

struct Strides {                 // element strides of the B and T axes
  long long xb, xt, db, dt, bb, bt, cb, ct, yb, yt;
};

template <int DS>
__global__ void __launch_bounds__(kChannels)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ a, const float* h0,
                  float* __restrict__ y, float* h_out, int t_len, int di,
                  Strides st) {
  __shared__ float xs[kSteps][kChannels];
  __shared__ float dts[kSteps][kChannels];
  __shared__ float bs[kSteps][DS];
  __shared__ float cs[kSteps][DS];

  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kChannels + tid;
  const int b = blockIdx.y;
  const bool ok = ch < di;

  float av[DS];
  float h[DS];
  const long long hrow = ((long long)b * di + ch) * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    av[s] = ok ? a[(long long)ch * DS + s] : 0.f;
    h[s] = (ok && h0 != nullptr) ? h0[hrow + s] : 0.f;
  }

  const float* xb = x + b * st.xb + ch;
  const float* db = dt + b * st.db + ch;
  const float* bb = bm + b * st.bb;
  const float* cb = cm + b * st.cb;
  float* yb = y + b * st.yb + ch;

  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    const int n = min(kSteps, t_len - t0);
    __syncthreads();                  // the previous tile is consumed
    if (ok) {
      for (int i = 0; i < n; ++i) {
        xs[i][tid] = xb[(long long)(t0 + i) * st.xt];
        dts[i][tid] = db[(long long)(t0 + i) * st.dt];
      }
    }
    for (int i = tid; i < n * DS; i += kChannels) {
      const long long t = t0 + i / DS;
      bs[i / DS][i % DS] = bb[t * st.bt + i % DS];
      cs[i / DS][i % DS] = cb[t * st.ct + i % DS];
    }
    __syncthreads();
    if (!ok) continue;
    for (int i = 0; i < n; ++i) {
      const float d = dts[i][tid];
      const float dx = d * xs[i][tid];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float da = expf(d * av[s]);
        const float dbx = dx * bs[i][s];
        h[s] = da * h[s] + dbx;
        acc = fmaf(h[s], cs[i][s], acc);
      }
      yb[(long long)(t0 + i) * st.yt] = acc;
    }
  }

  if (ok) {
#pragma unroll
    for (int s = 0; s < DS; ++s) h_out[hrow + s] = h[s];
  }
}

template <int DS>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, const float* h0, float* y, float* h_out,
           int batch, int t_len, int di, const Strides& st,
           cudaStream_t stream) {
  dim3 grid((di + kChannels - 1) / kChannels, batch);
  mamba_scan_kernel<DS><<<grid, kChannels, 0, stream>>>(
      x, dt, bm, cm, a, h0, y, h_out, t_len, di, st);
  return (int)cudaGetLastError();
}

}  // namespace

// h0 may be null (zeros).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int mamba_scan_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* a, const void* h0, void* y, void* h_out, int batch,
    int t_len, int di, int ds, long long xb, long long xt, long long db,
    long long dtt, long long bb, long long bt, long long cb, long long ct,
    long long yb, long long yt, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1)
    return (int)cudaErrorInvalidValue;
  const Strides st{xb, xt, db, dtt, bb, bt, cb, ct, yb, yt};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(h_out);
  switch (ds) {
    case 8:
      return launch<8>(xf, df, bf, cf, af, hf, yf, of, batch, t_len, di, st,
                       s);
    case 16:
      return launch<16>(xf, df, bf, cf, af, hf, yf, of, batch, t_len, di,
                        st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

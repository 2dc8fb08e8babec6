// Backward of the Mamba selective scan, for Hopper.
//
// The reference has no kernel for it: it differentiates its plain scan
// (src/repro/models/ssm.py, `mamba_apply`'s lax.scan).  Plain version:
// repro_torch/kernels/mamba_scan/ref.py `mamba_scan_backward` (the
// explicit reverse recurrence), and autograd through `ref.mamba_scan`.
//
// Forward (mamba_scan.cu), per (batch row b, channel d, state s):
//
//   a_t = exp(dt_t A),  h_t = a_t h_{t-1} + (dt_t x_t) B_t,  y_t = h_t . C_t
//
// Backward, with G_t the gradient of the loss with respect to h_t:
//
//   G_t = dy_t C_t + a_{t+1} G_{t+1}        (G_T also takes dh_T)
//   dC_t[s] = sum_d dy_t[d] h_t[d, s]
//   dB_t[s] = sum_d G_t[d, s] dt_t[d] x_t[d]
//   dx_t[d] = dt_t[d] sum_s G_t[d, s] B_t[s]
//   ddt_t[d] = x_t[d] sum_s G_t B_t + sum_s G_t a_t A h_{t-1}
//   dA[d, s] = sum_{b, t} G_t a_t dt_t h_{t-1}
//   dh0 = a_1 G_1
//
// Inputs x, dt, dy [B, T, di], B, C [B, T, ds], A [di, ds] and the
// forward's state at the start of every chunk of kChunk steps,
// h_chunks [ceil(T / kChunk), B, di, ds] (mamba_scan.cu's optional
// output, written with a tile of kChunk steps), all contiguous; dh_T
// [B, di, ds] or null (zeros).  Outputs dx, ddt [B, T, di], dB, dC
// [B, T, ds], dA [di, ds] and dh0 [B, di, ds] (null: not written).
// float32; ds 8 or 16.
//
// Design.  The chains (b, d, s) are independent, as in the forward: a
// team of kTeam = 8 adjacent threads holds one (b, d), each thread
// ds / 8 states, A's row slice and the running G in registers.  The
// chunks are walked from the last to the first; the block stages a
// chunk's x, dt, dy [kChunk][channels] (coalesced over the channels) and
// B, C [kChunk][ds] in shared memory.  A chunk's states are rebuilt
// forward from its saved start (never stepped back by dividing by a_t,
// which underflows where dt A is very negative), keeping the state at
// every kSub-th step in registers; then each sub-chunk of kSub steps,
// from the last, is rebuilt once more, keeping h_{t-1} and a_t of each
// step, and walked back.  A step's exponentials and states are computed
// exactly as the forward computes them (the build passes -fmad=false),
// so the rebuilt states are the forward's, bit for bit.  The walk writes
// each step's per-thread terms to shared memory and reduces nothing
// itself: the dC and dB terms [kSub][2 ds][channels] and the team's G B
// and G a A h_{t-1} partial sums [kSub][2][channels][kTeam].  After each
// sub-chunk the block sums them: dC and dB over its channels, in channel
// order, into per-block partials [blocks, B, T, 2 ds]; dx and ddt over
// the team, in lane order, stored as coalesced rows.  dA accumulates per
// thread over the steps.  A second kernel sums the partials over the
// blocks, and dA's over the batch rows, each in a fixed order: no
// atomics, so a rerun is bitwise the same.  Ragged T and di are masked: a
// channel past di computes on zeros, a step past T is skipped by the
// whole block.
//
// Measured on an H100 at jamba's training shape (1, 4096, 16384, 16):
// teams of 8 beat teams of 4 (3.29 against 6.28 ms), and one staged tile
// with two blocks an SM beat a double-buffered tile with one (3.29
// against 5.07 ms); sub-chunks of 4 steps were slower (4.11 ms).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;    // steps between the forward's saved states
constexpr int kSub = 8;       // steps rebuilt and walked back at once
constexpr int kThreads = 256; // threads per block
constexpr int kTeam = 8;      // threads per (batch row, channel)

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// shared memory of a block, in floats
template <int DS, int P>
struct Smem {
  static constexpr int kCpb = kThreads / P;   // channels per block
  // one chunk's x, dt, dy [kChunk][kCpb] and B, C [kChunk][DS]
  static constexpr int kTile = 3 * kChunk * kCpb + 2 * kChunk * DS;
  // a (step, dC or dB entry) row of the terms, padded so that a warp's
  // stores of one state fall in distinct banks
  static constexpr int kRow = kCpb + 32 / DS;
  static constexpr int kTerms = kSub * 2 * DS * kRow;
  static constexpr int kTeamSums = kSub * 2 * kCpb * P;
  static constexpr int kTotal = kTile + kTerms + kTeamSums;
};

template <int DS, int P>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* __restrict__ h_chunks,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_t,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ part,
                          float* __restrict__ da_part,
                          float* __restrict__ dh0, int t_len, int di) {
  using S = Smem<DS, P>;
  constexpr int NS = DS / P;           // states per thread
  constexpr int CPB = S::kCpb;
  constexpr int kCkpt = kChunk / kSub; // saved states per chunk
  extern __shared__ __align__(16) float sm[];
  float* terms = sm + S::kTile;        // [kSub][2 DS][kRow]
  float* team = terms + S::kTerms;     // [kSub][2][CPB][P]

  const int tid = threadIdx.x;
  const int cl = tid / P, j = tid % P;
  const int ch0 = blockIdx.x * CPB;
  const int ch = ch0 + cl;
  const int nch = min(CPB, di - ch0);  // live channels of the block
  const bool ok = ch < di;
  const int b = blockIdx.y, nb = gridDim.y;
  const long long row = (long long)b * t_len;  // row of step 0 of batch b
  const long long hrow = ((long long)b * di + ch) * DS + j * NS;
  const long long cstride = (long long)nb * di * DS;

  float av[NS], g[NS], dacc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    av[s] = ok ? a[(long long)ch * DS + j * NS + s] : 0.f;
    g[s] = (ok && dh_t != nullptr) ? dh_t[hrow + s] : 0.f;
    dacc[s] = 0.f;
  }

  // a [kChunk][CPB] tile is staged P rows at a time: thread tid always
  // takes column tc of rows tr, tr + P, ...
  const int tc = tid % CPB, tr = tid / CPB;
  const bool tc_live = tc < nch;
  const float* xb = x + row * di + ch0;
  const float* db = dt + row * di + ch0;
  const float* yb = dy + row * di + ch0;

  // chunk c's inputs into the tile
  auto stage = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, t_len - t0);
    float* xs = sm;
    float* dts = xs + kChunk * CPB;
    float* dys = dts + kChunk * CPB;
    float* bs = dys + kChunk * CPB;
    float* cs = bs + kChunk * DS;
    for (int r = tr; r < n; r += P) {
      const long long off = (long long)(t0 + r) * di + tc;
      cp_async4(xs + r * CPB + tc, tc_live ? xb + off : xb, tc_live);
      cp_async4(dts + r * CPB + tc, tc_live ? db + off : db, tc_live);
      cp_async4(dys + r * CPB + tc, tc_live ? yb + off : yb, tc_live);
    }
    for (int i = tid; i < n * DS; i += kThreads) {
      const long long off = (row + t0) * DS + i;
      cp_async4(bs + i, bm + off, true);
      cp_async4(cs + i, cm + off, true);
    }
  };

  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, t_len - t0);
    stage(c);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float* xs = sm;
    const float* dts = xs + kChunk * CPB;
    const float* dys = dts + kChunk * CPB;
    const float* bs = dys + kChunk * CPB;
    const float* cs = bs + kChunk * DS;

    float h[NS], ckpt[kCkpt][NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      h[s] = ok ? h_chunks[c * cstride + hrow + s] : 0.f;
    // the chunk forward: the state before every kSub-th step
#pragma unroll
    for (int k = 0; k < kCkpt; ++k) {
#pragma unroll
      for (int s = 0; s < NS; ++s) ckpt[k][s] = h[s];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int i = k * kSub + u;
        if (i < n) {
          const float d = dts[i * CPB + cl];
          const float dxv = d * xs[i * CPB + cl];
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float da = expf(d * av[s]);
            const float dbx = dxv * bs[i * DS + j * NS + s];
            h[s] = da * h[s] + dbx;
          }
        }
      }
    }
    // the sub-chunks from the last: rebuild, walk back, then reduce
#pragma unroll
    for (int k = kCkpt - 1; k >= 0; --k) {
      if (k * kSub >= n) continue;      // uniform over the block
      float hp[kSub][NS], ea[kSub][NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) h[s] = ckpt[k][s];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int i = k * kSub + u;
        if (i < n) {
          const float d = dts[i * CPB + cl];
          const float dxv = d * xs[i * CPB + cl];
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            hp[u][s] = h[s];
            ea[u][s] = expf(d * av[s]);
            const float dbx = dxv * bs[i * DS + j * NS + s];
            h[s] = ea[u][s] * h[s] + dbx;
          }
        }
      }
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int i = k * kSub + u;
        if (i >= n) continue;           // uniform over the block
        const float d = dts[i * CPB + cl];
        const float dyv = dys[i * CPB + cl];
        const float dxv = d * xs[i * CPB + cl];
        float gb = 0.f, gq = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int e = j * NS + s;
          const float bv = bs[i * DS + e];
          const float cv = cs[i * DS + e];
          g[s] = dyv * cv + g[s];                    // G_t
          const float ht = ea[u][s] * hp[u][s] + dxv * bv;
          terms[(u * 2 * DS + e) * S::kRow + cl] = dyv * ht;
          terms[(u * 2 * DS + DS + e) * S::kRow + cl] = g[s] * dxv;
          gb = gb + g[s] * bv;
          const float q = g[s] * ea[u][s] * hp[u][s];
          gq = gq + q * av[s];
          dacc[s] = dacc[s] + q * d;
          g[s] = ea[u][s] * g[s];                    // a_t G_t
        }
        team[((u * 2) * CPB + cl) * P + j] = gb;
        team[((u * 2 + 1) * CPB + cl) * P + j] = gq;
      }
      __syncthreads();
      // dC and dB: the block's sums over its channels, in channel order
      for (int q = tid; q < kSub * 2 * DS; q += kThreads) {
        const int u = q / (2 * DS), v = q % (2 * DS);
        const int i = k * kSub + u;
        if (i < n) {
          const float* tq = terms + q * S::kRow;
          float acc = 0.f;
          for (int cc = 0; cc < CPB; ++cc) acc = acc + tq[cc];
          part[((long long)blockIdx.x * nb * t_len + row + t0 + i) * 2 * DS +
               v] = acc;
        }
      }
      // dx and ddt: the team's sums, in lane order, stored row by row
      for (int q = tid; q < kSub * CPB; q += kThreads) {
        const int u = q / CPB, cc = q % CPB;
        const int i = k * kSub + u;
        if (i < n && cc < nch) {
          const float* tb = team + ((u * 2) * CPB + cc) * P;
          const float* tg = tb + CPB * P;
          float gb = 0.f, gq = 0.f;
#pragma unroll
          for (int l = 0; l < P; ++l) {
            gb = gb + tb[l];
            gq = gq + tg[l];
          }
          const long long o = (row + t0 + i) * di + ch0 + cc;
          dx[o] = dts[i * CPB + cc] * gb;
          ddt[o] = xs[i * CPB + cc] * gb + gq;
        }
      }
      __syncthreads();
    }
  }
  if (ok) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      da_part[hrow + s] = dacc[s];
      if (dh0 != nullptr) dh0[hrow + s] = g[s];
    }
  }
}

// dC, dB [B, T, ds]: the partials summed over the blocks; dA [di, ds]:
// the per-row sums summed over the batch rows; both in index order
__global__ void mamba_scan_bwd_reduce_kernel(const float* __restrict__ part,
                                             const float* __restrict__ da_part,
                                             float* __restrict__ dbm,
                                             float* __restrict__ dcm,
                                             float* __restrict__ da, int blocks,
                                             int nb, int t_len, int di,
                                             int ds) {
  const long long n_part = (long long)nb * t_len * 2 * ds;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_part) {
    float acc = 0.f;
    for (int k = 0; k < blocks; ++k) acc = acc + part[k * n_part + idx];
    const long long bt = idx / (2 * ds);
    const int v = (int)(idx % (2 * ds));
    if (v < ds)
      dcm[bt * ds + v] = acc;
    else
      dbm[bt * ds + v - ds] = acc;
    return;
  }
  const long long e = idx - n_part;
  if (e >= (long long)di * ds) return;
  float acc = 0.f;
  for (int r = 0; r < nb; ++r) acc = acc + da_part[r * (long long)di * ds + e];
  da[e] = acc;
}

template <int DS>
int launch(const float* x, const float* dt, const float* bm, const float* cm,
           const float* a, const float* h_chunks, const float* dy,
           const float* dh_t, float* dx, float* ddt, float* dbm, float* dcm,
           float* da, float* dh0, float* part, float* da_part, int batch,
           int t_len, int di, cudaStream_t stream) {
  constexpr int cpb = kThreads / kTeam;
  const int blocks = (di + cpb - 1) / cpb;
  constexpr int smem = 4 * Smem<DS, kTeam>::kTotal;
  static_assert(smem <= 227 * 1024 / 2, "two blocks an SM");
  auto kern = mamba_scan_bwd_kernel<DS, kTeam>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(blocks, batch), kThreads, smem, stream>>>(
      x, dt, bm, cm, a, h_chunks, dy, dh_t, dx, ddt, part, da_part, dh0,
      t_len, di);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)batch * t_len * 2 * DS + (long long)di * DS;
  const int threads = 256;
  mamba_scan_bwd_reduce_kernel<<<(unsigned)((total + threads - 1) / threads),
                                 threads, 0, stream>>>(
      part, da_part, dbm, dcm, da, blocks, batch, t_len, di, DS);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the main kernel for `di` channels: the first axis of `part`
// ([blocks, batch, t_len, 2 ds]).
extern "C" int mamba_scan_bwd_blocks(int di) {
  const int cpb = kThreads / kTeam;
  return (di + cpb - 1) / cpb;
}

// Steps between the saved states the backward reads (the forward's tile
// when it writes h_chunks).
extern "C" int mamba_scan_bwd_chunk() { return kChunk; }

// dh_t and dh0 may be null.  part [mamba_scan_bwd_blocks(di), batch,
// t_len, 2 ds] and da_part [batch, di, ds] are scratch.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* a, const void* h_chunks, const void* dy, const void* dh_t,
    void* dx, void* ddt, void* dbm, void* dcm, void* da, void* dh0,
    void* part, void* da_part, int batch, int t_len, int di, int ds,
    void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(h_chunks);
  const auto* yf = static_cast<const float*>(dy);
  const auto* gf = static_cast<const float*>(dh_t);
  auto* o_dx = static_cast<float*>(dx);
  auto* o_ddt = static_cast<float*>(ddt);
  auto* o_db = static_cast<float*>(dbm);
  auto* o_dc = static_cast<float*>(dcm);
  auto* o_da = static_cast<float*>(da);
  auto* o_dh = static_cast<float*>(dh0);
  auto* pf = static_cast<float*>(part);
  auto* qf = static_cast<float*>(da_part);
  if (ds == 8)
    return launch<8>(xf, df, bf, cf, af, hf, yf, gf, o_dx, o_ddt, o_db, o_dc,
                     o_da, o_dh, pf, qf, batch, t_len, di, s);
  if (ds == 16)
    return launch<16>(xf, df, bf, cf, af, hf, yf, gf, o_dx, o_ddt, o_db, o_dc,
                      o_da, o_dh, pf, qf, batch, t_len, di, s);
  return (int)cudaErrorInvalidValue;
}

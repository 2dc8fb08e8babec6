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
// forward's state at the start of every span of kSpan steps, h_chunks
// [ceil(T / kSpan), B, di, ds] (mamba_scan.cu's optional output), all
// contiguous; dh_T [B, di, ds] or null (zeros).  Outputs dx, ddt [B, T,
// di], dB, dC [B, T, ds], dA [di, ds] and dh0 [B, di, ds] (null: not
// written).  float32; ds 8 or 16.
//
// What bounds it.  The bound (ops.mamba_scan_bwd_hbm_bytes) is 1.345 GB,
// 0.40 ms at 3.35 TB/s at jamba's training shape (1, 4096, 16384, 16);
// it leaves out the saved states (268 MB read) and the partials (33.6 MB
// written and read), which are the design's.  The kernel is bound by
// issue instead: each of the 1.07e9 (step, state) pairs needs an
// exponential (an IEEE expf, ~8 instructions around one MUFU.EX2, kept
// so that the rebuilt states are the forward's bit for bit), the state
// update, G, five products into the sums and its share of the sums over
// channels and states.  PR 27's kernel issued ~66 SASS instructions and
// ~1.9 exponentials a pair, and summed dB / dC with 32 dependent
// shared-memory adds a thread between two block barriers every 8 steps;
// this one issues ~36 with one MUFU.EX2, and its walk warps wait at no
// block barrier.  It runs at about two thirds of the issue rate; in the
// probe's variants (benchmarks/port_scan_bwd_probe.py on an H100, the
// numbers in PERF.md, PR 28) taking out the sums across lanes saves the
// most, then the second rebuild of a ds-16 span's first half.
//
// Design.  A walk thread holds 4 chains (b, d, s): 2 adjacent channels
// x 2 adjacent states, with A's 2 x 2 slice, G and dA's partial sums in
// registers; a warp covers 8 channels (ds 16) or 16 (ds 8), a block
// kCpb = 128 channels with 16 (8) walk warps and two helper warps, one
// block an SM.  The spans are walked from the last to the first.  Per
// span the walk warps rebuild the states forward from the saved start
// exactly as the forward computes them (the build passes -fmad=false),
// one exponential per (step, state): a_t goes to shared memory, h_{t-1}
// stays in registers (ds 16, at 96 registers a thread: those of the
// span's last 8 steps; the first 8 are rebuilt again from the stored
// a_t once the last 8 are walked), and h_t of each step is the next
// step's h_{t-1} (the last one the rebuild's end state); then they walk
// the span back.  A step's products are summed first in registers (dB
// and dC over the thread's 2 channels, dx and ddt over its 2 states),
// then across the warp by a reduce-scatter of shuffles (each lane ends
// with one sum); dx and ddt are stored from there, and the warp's dB and
// dC sums go to a term buffer in shared memory.  The helper warps do
// the rest off the walk's path: the first stages each span's x, dt, dy,
// B and C two spans ahead with bulk async copies (cp.async of single
// floats where di or a pointer is not 16-byte aligned) into one of two
// buffers; both sum the term buffer over the block's warps into the
// block's dB / dC of the span, half the entries each (two, so that no
// SM scheduler carries all of it beside its walk warps); and, the blocks
// working in clusters of kCluster, the first adds the cluster's block
// sums through distributed shared memory, each block storing half the
// span's steps as one partial row.  The walk warps and the helpers
// synchronise on mbarriers in shared memory (tile full / empty, terms
// full / empty), so a walk warp waits on the helpers alone, never on
// the other walk warps; the blocks of a cluster on two more (their block
// sums full / empty).  A second kernel sums the
// partial rows [ceil(di / (kCluster kCpb)), B, T, 2 ds], 64 at di =
// 16384 (PR 27's kernel had one a block, 512), and dA's per-row sums
// over the batch rows, each in a fixed order: no atomics, so a rerun is
// bitwise the same.  Ragged di and T: a channel past di computes on
// zeros (its tile columns are zero) and stores nothing; the last span,
// when shorter than kSpan, is padded with steps of zero inputs (a_t =
// 1, no input, no gradient in), whose outputs are not stored.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSpan = 16;     // steps between the forward's saved states
constexpr int kCh = 2;        // channels a walk thread holds
constexpr int kNs = 2;        // states a walk thread holds
constexpr int kChains = kCh * kNs;
constexpr int kCpb = 128;     // channels per block
constexpr int kCluster = 2;   // blocks whose dB / dC sums are added on chip
constexpr int kHelpers = 2;   // helper warps a block

template <int DS>
struct Cfg {
  static constexpr int kSg = DS / kNs;          // lanes a channel pair
  static constexpr int kCpw = 32 / kSg * kCh;   // channels a warp
  static constexpr int kWarps = kCpb / kCpw;    // walk warps
  static constexpr int kWalk = 32 * kWarps;     // walk threads
  static constexpr int kThreads = kWalk + 32 * kHelpers;   // and helpers
  static constexpr int kE = 2 * DS;             // dC, dB entries a step
  // shared memory, in floats: two tile buffers, each x, dt, dy
  // [kSpan][kCpb] and B, C [kSpan][DS]; a_t [kSpan][kWalk][4]; the
  // warps' terms [kSpan][kWarps][kE]; two buffers of the block's sums
  // [kSpan][kE]; then the mbarriers
  static constexpr int kTileX = kSpan * kCpb;
  static constexpr int kTile = 3 * kTileX + 2 * kSpan * DS;
  static constexpr int kA = kSpan * kWalk * kChains;
  static constexpr int kTerms = kSpan * kWarps * kE;
  static constexpr int kSums = kSpan * kE;
  static constexpr int kFloats = 2 * kTile + kA + kTerms + 2 * kSums;
  static constexpr int kBars = 10;
  static constexpr int kBytes = 4 * kFloats + 8 * kBars;
};

// ------------------------------------------------------------ PTX

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }" ::"r"(
          smem(b))
      : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, unsigned tx) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1; }" ::"r"(smem(b)),
      "r"(tx)
      : "memory");
}
// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem(b)), "r"(parity)
        : "memory");
  } while (!done);
}
// the same with acquire at cluster scope (another block's arrivals)
__device__ __forceinline__ void bar_wait_cluster(uint64_t* b,
                                                 unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster."
        "shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem(b)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem(p)), "r"(rank));
  return r;
}
// arrive, with release at cluster scope, on block `rank`'s barrier b
__device__ __forceinline__ void bar_arrive_rank(uint64_t* b, unsigned rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          map_rank(b, rank))
      : "memory");
}
__device__ __forceinline__ float4 ld_rank(const float* p, unsigned rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(map_rank(p, rank))
               : "memory");
  return v;
}
// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on barrier b's transaction count
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(b))
      : "memory");
}
// cp.async of one float; `ok` false fills a zero and reads nothing (src
// must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// an arrival on b once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem(b))
               : "memory");
}

// Sum v over the lanes that differ in bits M1, M2 and M3 (M3 0: none) by
// a reduce-scatter: after it the lane holds the sum of v[2 (lane & M1 ?
// 1 : 0) + (lane & M2 ? 1 : 0)], in a fixed order.
template <int M1, int M2, int M3>
__device__ __forceinline__ float reduce4(float v0, float v1, float v2,
                                         float v3, int lane) {
  const bool h1 = lane & M1, h2 = lane & M2;
  float k0 = h1 ? v2 : v0, k1 = h1 ? v3 : v1;
  const float s0 = h1 ? v0 : v2, s1 = h1 ? v1 : v3;
  k0 = k0 + __shfl_xor_sync(0xffffffffu, s0, M1);
  k1 = k1 + __shfl_xor_sync(0xffffffffu, s1, M1);
  float k = h2 ? k1 : k0;
  const float s = h2 ? k0 : k1;
  k = k + __shfl_xor_sync(0xffffffffu, s, M2);
  if (M3 != 0) k = k + __shfl_xor_sync(0xffffffffu, k, M3);
  return k;
}

struct Args {
  const float *x, *dt, *bm, *cm, *a, *h_chunks, *dy, *dh_t;
  float *dx, *ddt, *part, *da_part, *dh0;
  int t_len, di;
  bool bulk;  // 16-byte aligned rows: stage with bulk copies
};

template <int DS>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(Cfg<DS>::kThreads, 1)
        mamba_scan_bwd_kernel(const Args p) {
  using C = Cfg<DS>;
  constexpr int SG = C::kSg, W = C::kWarps, E = C::kE;
  extern __shared__ __align__(128) float sm[];
  float* tiles = sm;                        // [2][kTile]
  float* abuf = tiles + 2 * C::kTile;       // [kSpan][kWalk][4]
  float* terms = abuf + C::kA;              // [kSpan][W][E]
  float* sums = terms + C::kTerms;          // [2][kSpan][E]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + 2 * C::kSums);
  uint64_t* tile_full = bars;               // [2]
  uint64_t* tile_empty = bars + 2;          // [2]
  uint64_t* terms_full = bars + 4;
  uint64_t* terms_empty = bars + 5;
  uint64_t* sums_full = bars + 6;           // [2]
  uint64_t* sums_empty = bars + 8;          // [2]

  const cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32;
  // the warp's role, from one lane, so the compiler knows it is uniform
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int t_len = p.t_len, di = p.di;
  const int ch0 = blockIdx.x * kCpb;
  const int nch = min(kCpb, di - ch0);      // live channels (may be <= 0)
  const int b = blockIdx.y, nb = gridDim.y;
  const long long row = (long long)b * t_len;   // row of step 0 of batch b
  const int n_spans = (t_len + kSpan - 1) / kSpan;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(tile_full + i, 32);
      bar_init(tile_empty + i, C::kWalk);
      bar_init(sums_full + i, 32 * kHelpers * kCluster);
      bar_init(sums_empty + i, 32 * kCluster);
    }
    bar_init(terms_full, C::kWalk);
    bar_init(terms_empty, 32 * kHelpers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // bulk copies write the live columns only: the others stay zero
  if (p.bulk && nch < kCpb)
    for (int i = tid; i < 2 * 3 * kSpan * kCpb; i += C::kThreads) {
      const int buf = i / (3 * C::kTileX), r = i % (3 * C::kTileX);
      if (r % kCpb >= nch) tiles[buf * C::kTile + r] = 0.f;
    }
  cluster.sync();   // barriers initialised and zeros written, cluster-wide

  if (warp >= W) {
    // ----------------------------------------------------- helper warps
    // both sum half the terms; the first also stages and combines
    const int hw = warp - W;
    // span i (from the last, i = 0) into buffer i & 1
    auto stage = [&](int i) {
      const int k = n_spans - 1 - i, t0 = k * kSpan;
      const int n = min(kSpan, t_len - t0);
      float* tb = tiles + (i & 1) * C::kTile;
      uint64_t* full = tile_full + (i & 1);
      const float* src[3] = {p.x, p.dt, p.dy};
      if (p.bulk) {
        const int live = max(nch, 0);
        if (lane == 0)
          bar_arrive_tx(full, 4u * n * (3 * live + 2 * DS));
        __syncwarp();
        if (lane < n) {
          const long long off = (row + t0 + lane) * di + ch0;
          if (live > 0)
            for (int q = 0; q < 3; ++q)
              bulk_copy(tb + q * C::kTileX + lane * kCpb, src[q] + off,
                        4u * live, full);
        } else if (lane == 31) {
          const long long off = (row + t0) * DS;
          bulk_copy(tb + 3 * C::kTileX, p.bm + off, 4u * n * DS, full);
          bulk_copy(tb + 3 * C::kTileX + kSpan * DS, p.cm + off, 4u * n * DS,
                    full);
        }
        // a short last span: its padding steps read zeros
        for (int i2 = n * kCpb + lane; i2 < kSpan * kCpb; i2 += 32)
          for (int q = 0; q < 3; ++q) tb[q * C::kTileX + i2] = 0.f;
        for (int i2 = n * DS + lane; i2 < kSpan * DS; i2 += 32) {
          tb[3 * C::kTileX + i2] = 0.f;
          tb[3 * C::kTileX + kSpan * DS + i2] = 0.f;
        }
        if (lane != 0) bar_arrive(full);
      } else {
        for (int i2 = lane; i2 < kSpan * kCpb; i2 += 32) {
          const int r = i2 / kCpb, c = i2 % kCpb;
          const bool ok = r < n && c < nch;
          const long long off = ok ? (row + t0 + r) * di + ch0 + c : 0;
          for (int q = 0; q < 3; ++q)
            cp_async4(tb + q * C::kTileX + i2, src[q] + off, ok);
        }
        for (int i2 = lane; i2 < kSpan * DS; i2 += 32) {
          const bool ok = i2 < n * DS;
          const long long off = ok ? (row + t0) * DS + i2 : 0;
          cp_async4(tb + 3 * C::kTileX + i2, p.bm + off, ok);
          cp_async4(tb + 3 * C::kTileX + kSpan * DS + i2, p.cm + off, ok);
        }
        cp_async_arrive(full);
      }
    };
    if (hw == 0) {
      stage(0);
      if (n_spans > 1) stage(1);
    }
    constexpr int QPS = E / 4;              // float4s of a step's entries
    constexpr int kJ = QPS / 2 / kHelpers;  // rounds of sums a helper
    static_assert(kJ * 2 * kHelpers == QPS, "the sums split evenly");
    constexpr int kHalf = kSpan / kCluster; // steps each block stores
    for (int i = 0; i < n_spans; ++i) {
      const int k = n_spans - 1 - i, t0 = k * kSpan;
      const int n = min(kSpan, t_len - t0);
      const int buf = i & 1;
      bar_wait(terms_full, i & 1);          // span i's walk is done
      if (hw == 0 && i + 2 < n_spans) {
        bar_wait(tile_empty + buf, (i >> 1) & 1);
        stage(i + 2);
      }
      // the block's sums of span i over its warps, in warp order
      if (i >= 2) bar_wait_cluster(sums_empty + buf, ((i - 2) >> 1) & 1);
      float* sb = sums + buf * C::kSums;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = hw * kJ + jj;
        const int u = lane / QPS + (32 / QPS) * j, q = lane % QPS;
        const float* tp = terms + u * W * E + 4 * q;
        float4 acc = *reinterpret_cast<const float4*>(tp);
#pragma unroll
        for (int w = 1; w < W; ++w) {
          const float4 v = *reinterpret_cast<const float4*>(tp + w * E);
          acc.x = acc.x + v.x;
          acc.y = acc.y + v.y;
          acc.z = acc.z + v.z;
          acc.w = acc.w + v.w;
        }
        *reinterpret_cast<float4*>(sb + u * E + 4 * q) = acc;
      }
      bar_arrive(terms_empty);
      // the cluster's sums of this block's half of the steps, in rank
      // order, into its partial row
#pragma unroll
      for (unsigned r = 0; r < kCluster; ++r)
        bar_arrive_rank(sums_full + buf, r);
      if (hw != 0) continue;
      bar_wait_cluster(sums_full + buf, (i >> 1) & 1);
      const long long prow =
          ((long long)(blockIdx.x / kCluster) * nb + b) * t_len + t0;
#pragma unroll
      for (int j = 0; j < (kHalf * QPS + 31) / 32; ++j) {
        const int qq = lane + 32 * j;
        const int u = rank * kHalf + qq / QPS, q = qq % QPS;
        if (qq < kHalf * QPS) {
          float4 acc = ld_rank(sb + u * E + 4 * q, 0);
#pragma unroll
          for (unsigned r = 1; r < kCluster; ++r) {
            const float4 v = ld_rank(sb + u * E + 4 * q, r);
            acc.x = acc.x + v.x;
            acc.y = acc.y + v.y;
            acc.z = acc.z + v.z;
            acc.w = acc.w + v.w;
          }
          if (u < n)
            *reinterpret_cast<float4*>(p.part + (prow + u) * E + 4 * q) = acc;
        }
      }
#pragma unroll
      for (unsigned r = 0; r < kCluster; ++r)
        bar_arrive_rank(sums_empty + buf, r);
    }
  } else {
    // ------------------------------------------------------- walk warps
    const int sg = lane % SG, cgp = lane / SG;
    const int lc = warp * C::kCpw + cgp * kCh;   // first channel, in block
    float av[kChains], g[kChains], dacc[kChains], h[kChains], hn[kChains];
    // [b, ch, kNs sg] of the thread's first channel; the next is DS on
    const long long hrow = ((long long)b * di + ch0 + lc) * DS + kNs * sg;
    bool ok[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int ch = ch0 + lc + c;
      ok[c] = ch < di;
#pragma unroll
      for (int s = 0; s < kNs; ++s) {
        const int e = c * kNs + s;
        av[e] = ok[c] ? p.a[(long long)ch * DS + kNs * sg + s] : 0.f;
        g[e] = (ok[c] && p.dh_t != nullptr) ? p.dh_t[hrow + c * DS + s]
                                            : 0.f;
        dacc[e] = 0.f;
      }
    }
    const long long cstride = (long long)nb * di * DS;   // one saved state
    const float* const hc = p.h_chunks + hrow;
    auto load_state = [&](int k, float (&v)[kChains]) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        float2 f = make_float2(0.f, 0.f);
        if (ok[c])
          f = *reinterpret_cast<const float2*>(hc + k * cstride + c * DS);
        v[c * kNs] = f.x;
        v[c * kNs + 1] = f.y;
      }
    };
    load_state(n_spans - 1, hn);
    // the lane's share of the reductions: dB / dC over the channel lanes
    // (bits SG, 2 SG; ds 8 also 4 SG), dx / ddt over the state lanes
    // (bits 1, 2; ds 16 also 4)
    constexpr int kCm3 = SG == 4 ? 16 : 0, kSm3 = SG == 8 ? 4 : 0;
    const int e_kind = (lane & SG) ? 1 : 0, e_s = (lane & 2 * SG) ? 1 : 0;
    const int term_at = e_kind * DS + kNs * sg + e_s;     // entry
    const bool term_w = (lane & kCm3) == 0;
    const int o_kind = lane & 1, o_c = (lane & 2) ? 1 : 0;
    const bool out_w = (lane & kSm3) == 0 && ch0 + lc + o_c < di;
    float* const outp = (o_kind ? p.ddt : p.dx) + row * di + ch0 + lc + o_c;
    const int wt = warp * 32 + lane;

    for (int i = 0; i < n_spans; ++i) {
      const int k = n_spans - 1 - i, t0 = k * kSpan;
      const int n = min(kSpan, t_len - t0);
      const int buf = i & 1;
      float hs[kChains];                    // the span's saved start
#pragma unroll
      for (int e = 0; e < kChains; ++e) h[e] = hs[e] = hn[e];
      if (k > 0) load_state(k - 1, hn);     // the next span's, ahead
      bar_wait(tile_full + buf, (i >> 1) & 1);
      const float* xs = tiles + buf * C::kTile;
      const float* dts = xs + C::kTileX;
      const float* dys = dts + C::kTileX;
      const float* bs = dys + C::kTileX;
      const float* cs = bs + kSpan * DS;
      float* const ab = abuf + wt * kChains;
      float* ob = outp + (long long)(t0 + kSpan - 1) * di;   // step 15's

      // one step of the rebuild: a_t (computed, or read back when
      // `fresh` is false) and the state update, exactly the forward's
      auto rebuild = [&](int u, bool fresh, float (&hh)[kChains]) {
        const float2 d = *reinterpret_cast<const float2*>(dts + u * kCpb + lc);
        const float2 xv = *reinterpret_cast<const float2*>(xs + u * kCpb + lc);
        const float2 bv = *reinterpret_cast<const float2*>(bs + u * DS +
                                                           kNs * sg);
        const float dv[kCh] = {d.x, d.y};
        const float dxv[kCh] = {d.x * xv.x, d.y * xv.y};
        const float bb[kNs] = {bv.x, bv.y};
        float at[kChains];
        if (fresh) {
#pragma unroll
          for (int e = 0; e < kChains; ++e) at[e] = expf(dv[e / kNs] * av[e]);
          *reinterpret_cast<float4*>(ab + u * C::kWalk * kChains) =
              make_float4(at[0], at[1], at[2], at[3]);
        } else {
          const float4 a4 =
              *reinterpret_cast<const float4*>(ab + u * C::kWalk * kChains);
          at[0] = a4.x, at[1] = a4.y, at[2] = a4.z, at[3] = a4.w;
        }
#pragma unroll
        for (int e = 0; e < kChains; ++e) {
          const float dbx = dxv[e / kNs] * bb[e % kNs];
          hh[e] = at[e] * hh[e] + dbx;
        }
      };
      // one step of the walk back, given h_{t-1} and h_t
      auto walk = [&](int u, const float (&hpu)[kChains],
                      const float (&ht)[kChains]) {
        const float2 d = *reinterpret_cast<const float2*>(dts + u * kCpb + lc);
        const float2 xv = *reinterpret_cast<const float2*>(xs + u * kCpb + lc);
        const float2 yv = *reinterpret_cast<const float2*>(dys + u * kCpb + lc);
        const float2 bv = *reinterpret_cast<const float2*>(bs + u * DS +
                                                           kNs * sg);
        const float2 cv = *reinterpret_cast<const float2*>(cs + u * DS +
                                                           kNs * sg);
        const float4 a4 =
            *reinterpret_cast<const float4*>(ab + u * C::kWalk * kChains);
        const float dv[kCh] = {d.x, d.y}, xx[kCh] = {xv.x, xv.y};
        const float yy[kCh] = {yv.x, yv.y};
        const float dxv[kCh] = {d.x * xv.x, d.y * xv.y};
        const float bb[kNs] = {bv.x, bv.y}, cc[kNs] = {cv.x, cv.y};
        const float at[kChains] = {a4.x, a4.y, a4.z, a4.w};
        float dcp[kNs], dbp[kNs], gb[kCh], gq[kCh];
#pragma unroll
        for (int c = 0; c < kCh; ++c)
#pragma unroll
          for (int s = 0; s < kNs; ++s) {
            const int e = c * kNs + s;
            g[e] = fmaf(yy[c], cc[s], g[e]);                 // G_t
            dcp[s] = c == 0 ? yy[c] * ht[e] : fmaf(yy[c], ht[e], dcp[s]);
            dbp[s] = c == 0 ? g[e] * dxv[c] : fmaf(g[e], dxv[c], dbp[s]);
            gb[c] = s == 0 ? g[e] * bb[s] : fmaf(g[e], bb[s], gb[c]);
            g[e] = at[e] * g[e];                             // a_t G_t
            const float q = g[e] * hpu[e];
            gq[c] = s == 0 ? q * av[e] : fmaf(q, av[e], gq[c]);
            dacc[e] = fmaf(q, dv[c], dacc[e]);
          }
        const float term = reduce4<SG, 2 * SG, kCm3>(dcp[0], dcp[1], dbp[0],
                                                     dbp[1], lane);
        const float out = reduce4<1, 2, kSm3>(
            dv[0] * gb[0], dv[1] * gb[1], fmaf(xx[0], gb[0], gq[0]),
            fmaf(xx[1], gb[1], gq[1]), lane);
        if (term_w) terms[(u * W + warp) * E + term_at] = term;
        if (out_w && u < n) *ob = out;
        ob -= di;                                      // the steps go down
      };

      // ds 16 (18 warps an SM, 5 on some scheduler, leave 96 registers a
      // thread) takes the span in two parts: the first pass computes
      // every a_t and keeps h_{t-1} of the last kKeep steps; the first
      // kFirst steps' are rebuilt later from the start with the stored
      // a_t.  ds 8 (10 warps, 168 registers) keeps all in one pass.
      constexpr int kFirst = DS == 16 ? kSpan / 2 : 0;
      constexpr int kKeep = kSpan - kFirst;
      float hp[kKeep][kChains];
#pragma unroll
      for (int u = 0; u < kSpan; ++u) {
        if (u >= kFirst)
#pragma unroll
          for (int e = 0; e < kChains; ++e) hp[u - kFirst][e] = h[e];
        rebuild(u, true, h);
      }
      if (i > 0) bar_wait(terms_empty, (i - 1) & 1);
#pragma unroll
      for (int u = kSpan - 1; u >= kFirst; --u)
        walk(u, hp[u - kFirst],
             u == kSpan - 1 ? h : hp[u - kFirst + (u < kSpan - 1)]);
      if constexpr (kFirst > 0) {
#pragma unroll
        for (int e = 0; e < kChains; ++e) h[e] = hp[0][e];  // h_{kFirst-1}
#pragma unroll
        for (int u = 0; u < kFirst; ++u) {
#pragma unroll
          for (int e = 0; e < kChains; ++e) hp[u][e] = hs[e];
          rebuild(u, false, hs);
        }
#pragma unroll
        for (int u = kFirst - 1; u >= 0; --u)
          walk(u, hp[u], u == kFirst - 1 ? h : hp[u + (u < kFirst - 1)]);
      }
      bar_arrive(tile_empty + buf);
      bar_arrive(terms_full);
    }
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      if (ok[c]) {
        *reinterpret_cast<float2*>(p.da_part + hrow + c * DS) =
            make_float2(dacc[c * kNs], dacc[c * kNs + 1]);
        if (p.dh0 != nullptr)
          *reinterpret_cast<float2*>(p.dh0 + hrow + c * DS) =
              make_float2(g[c * kNs], g[c * kNs + 1]);
      }
  }
  cluster.sync();   // no block leaves while its sums may still be read
}

// dC, dB [B, T, ds]: the partial rows summed; dA [di, ds]: the per-row
// sums summed over the batch rows; both in index order
__global__ void mamba_scan_bwd_reduce_kernel(const float* __restrict__ part,
                                             const float* __restrict__ da_part,
                                             float* __restrict__ dbm,
                                             float* __restrict__ dcm,
                                             float* __restrict__ da, int rows,
                                             int nb, int t_len, int di,
                                             int ds) {
  const long long n_part = (long long)nb * t_len * 2 * ds;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_part) {
    float acc = 0.f;
    for (int k = 0; k < rows; ++k) acc = acc + part[k * n_part + idx];
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

int rows_of(int di) {
  return (di + kCluster * kCpb - 1) / (kCluster * kCpb);
}

template <int DS>
int launch(const Args& args, float* dbm, float* dcm, float* da, int batch,
           cudaStream_t stream) {
  using C = Cfg<DS>;
  static_assert(C::kBytes <= 227 * 1024, "shared memory of a block");
  auto kern = mamba_scan_bwd_kernel<DS>;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = rows_of(args.di);
  kern<<<dim3(rows * kCluster, batch), C::kThreads, C::kBytes, stream>>>(
      args);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total =
      (long long)batch * args.t_len * 2 * DS + (long long)args.di * DS;
  const int threads = 256;
  mamba_scan_bwd_reduce_kernel<<<(unsigned)((total + threads - 1) / threads),
                                 threads, 0, stream>>>(
      args.part, args.da_part, dbm, dcm, da, rows, batch, args.t_len,
      args.di, DS);
  return (int)cudaGetLastError();
}

}  // namespace

// Partial rows of dB / dC for `di` channels: the first axis of `part`
// ([rows, batch, t_len, 2 ds]), one per cluster of blocks.
extern "C" int mamba_scan_bwd_rows(int di) { return rows_of(di); }

// Steps between the saved states the backward reads (the forward saves
// its state every this many steps when it writes h_chunks).
extern "C" int mamba_scan_bwd_chunk() { return kSpan; }

// dh_t and dh0 may be null.  part [mamba_scan_bwd_rows(di), batch, t_len,
// 2 ds] and da_part [batch, di, ds] are scratch.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* a, const void* h_chunks, const void* dy, const void* dh_t,
    void* dx, void* ddt, void* dbm, void* dcm, void* da, void* dh0,
    void* part, void* da_part, int batch, int t_len, int di, int ds,
    void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || di < 1)
    return (int)cudaErrorInvalidValue;
  Args args{static_cast<const float*>(x),  static_cast<const float*>(dt),
            static_cast<const float*>(bm), static_cast<const float*>(cm),
            static_cast<const float*>(a),  static_cast<const float*>(h_chunks),
            static_cast<const float*>(dy), static_cast<const float*>(dh_t),
            static_cast<float*>(dx),       static_cast<float*>(ddt),
            static_cast<float*>(part),     static_cast<float*>(da_part),
            static_cast<float*>(dh0),      t_len,
            di,                            false};
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  args.bulk = di % 4 == 0 && aligned(x) && aligned(dt) && aligned(dy) &&
              aligned(bm) && aligned(cm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds == 8)
    return launch<8>(args, static_cast<float*>(dbm), static_cast<float*>(dcm),
                     static_cast<float*>(da), batch, s);
  if (ds == 16)
    return launch<16>(args, static_cast<float*>(dbm),
                      static_cast<float*>(dcm), static_cast<float*>(da),
                      batch, s);
  return (int)cudaErrorInvalidValue;
}

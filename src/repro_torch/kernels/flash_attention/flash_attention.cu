// Causal GQA flash attention with an optional sliding window, for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` of
// src/repro/kernels/flash_attention/flash_attention.py (`_kernel`). Plain
// version: repro_torch/kernels/flash_attention/ref.py, i.e. `sdpa_ref` of
// repro_torch/models/layers.py with no query blocking.
//
// Inputs q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], read through their strides
// (the D axis contiguous; no transpose or padding copy), float32 or
// bfloat16; output o [B, Sq, Hq, D] in the input dtype.  The math is
// float32: scores scaled by D^-0.5, masked scores at -1e30, the normaliser
// floored at 1e-30, kv head h / (Hq / Hkv), causal kpos <= qpos, window kpos
// > qpos - window, and keys at kpos >= Sk masked (the Pallas wrapper pads Sk
// with zero keys and, non-causal, attends to them; the plain version does
// not, and this kernel follows it).  Head dims 32 (the reduced test
// configs), 64, 128 and 256.
//
// Bound.  attention_flops = 4 B Hq Sq Sk D (/2 causal): at glm4-9b's prefill
// shape (1, 4096, 32/2, 128) 1.37e11 flop, 2.05 ms at float32's 67 TFLOP/s
// on the CUDA cores and 0.14 ms at bfloat16's 989 TFLOP/s on the tensor
// cores, against ~0.04 ms for the 143 MB (float32) of q/k/v/o at 3.35 TB/s:
// bound by operations in both dtypes.  So each dtype gets the kernel that
// keeps its arithmetic units fed; the library picks by dtype.  Times against
// the bound: PERF.md, kernel table, row 4.
//
// float32 (namespace f32): true float32 on the CUDA cores (no TF32: the
// kernel is held to 1e-5 of the plain version's float32 math), explicit fmaf
// and IEEE expf (the build turns off FMA contraction).  The first design
// read one shared-memory float per FMA, a quarter of the FMA rate.  Now one
// block of 256 threads takes 128 query rows (64 at D = 256) of one q head
// and batch row, and walks 64-key tiles.  Thread (tr, tc) of a warp's 2 row
// groups x 16 key groups computes the 8 x 4 (4 x 4 at D = 256) micro-tile
// S[tr + 16 i][tc + 16 j] from float4 loads along D, so a shared-memory
// float feeds 2-8 FMAs, and a warp's loads are 2 distinct q rows (broadcast)
// and 16 k rows.  Q, one K tile, one V tile and the probability tile P sit
// in shared memory (160 KB at D = 128), their rows in 16-byte chunks
// XOR-swizzled by the row's low 3 bits, so the reads are conflict-free
// without padding.  The row max takes 4 xor shuffles per row and tile (a
// row's 16 threads share a half-warp); each thread keeps a partial
// normaliser of its own keys, summed once at the end.  O += P V is an 8-row
// x D/16-column outer product per thread streaming P and V rows from shared
// memory.  cp.async copies tile t+1's K while tile t's softmax and P V run,
// and its V while tile t+1's Q K^T runs.
//
// bfloat16 (namespace bf16): the first design widened bf16 to float32 and
// ran the float32 loop, never touching the tensor cores.  Now `wgmma` does
// both products, fed by TMA.  One block of 384 threads per (128 query rows,
// q head, batch row): warpgroup 0 produces (one thread issues the TMA
// copies), warpgroups 1 and 2 each own 64 query rows (`setmaxnreg` moves
// registers from the producer to them).  The producer loads Q once and keeps
// a 2-stage ring of 64-key K and V tiles in flight, each stage completing on
// its own mbarrier (separate full/empty barriers for K and V, so Q K^T
// starts before V lands). TMA writes the tiles swizzled (128-byte rows;
// 64-byte at D = 32) in blocks of 64 columns, the layout the wgmma
// descriptors address.  Per tile a consumer runs S = Q K^T as
// wgmma.m64n64k16 with both operands K-major in shared memory (bf16 x bf16
// products are exact in float32, so this is the float32 dot of the upcast
// inputs in another summation order) and takes the online softmax on the
// accumulator fragment: the row max and sum over the 4 lanes of a row, in
// raw score units so that the scale and log2(e) fold into one multiply
// before ex2, masks only on the tiles that straddle Sk, the diagonal or the
// window edge, and O rescaled only when a row max of the warp moved.  The
// CUDA-core work of this softmax, not the tensor cores, sets the pace
// (PERF.md).  P then enters P V as the register A operand, V read MN-major
// through the transpose bit, as two bfloat16 terms, P = hi + lo: rounding P
// once, as flash kernels usually do, leaves ~1e-3 absolute errors on rows
// with few keys, outside the bound of ~2 bf16 ulps of the float32 math that
// the kernel is held to; the second term costs P V a second wgmma chain
// (1.5x the tensor work).  The normaliser sums the float32 P.  TMA
// zero-fills rows past Sq and Sk; the masks still apply in registers. ptxas
// keeps the consumers at the 168 registers of the entry despite
// `setmaxnreg`, so D = 256 spills (O alone is 128 registers a thread).
//
// Both: the heaviest causal query tiles are launched first; whole key tiles
// outside the causal/window range of a query tile (of a consumer warpgroup,
// for bf16) are skipped, and only the tiles that straddle Sk, the diagonal
// or the window edge are masked per element; rows past Sq compute on zero
// queries and are not stored; no atomics, so two launches on the same inputs
// agree bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {                 // element strides of the B, S, H axes
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// keys [*begin, *end) that query rows [r_lo, r_hi] may see
__device__ __forceinline__ void key_range(int r_lo, int r_hi, int sk,
                                          int causal, int window,
                                          int* begin, int* end) {
  *end = causal ? min(sk, r_hi + 1) : sk;
  *begin = window > 0 ? max(0, r_lo - window + 1) : 0;
}

__device__ __forceinline__ bool visible(int kp, int qp, int sk, int causal,
                                        int window) {
  bool ok = kp < sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- float32
namespace f32 {

constexpr int kKeys = 64;        // keys per tile
constexpr int kThreads = 256;

// query rows a thread holds (rows tr + 16 i, i < R); a block has 16 R.
// 8 up to D = 128; 4 at D = 256, where 128 rows would not fit in shared
// memory
template <int D>
constexpr int rows_per_thread() { return D <= 128 ? 8 : 4; }

template <int D>
constexpr int smem_bytes() {     // Q, K, V tiles and P
  constexpr int rows = 16 * rows_per_thread<D>();
  return (rows + 2 * kKeys) * D * 4 + rows * kKeys * 4;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y),
                     fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float lane4(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy rows [lo, lo + ROWS) of a [n, D] float32 matrix (row stride `rs`
// elements) into `tile`, chunk c of row r at r * D/4 + (c ^ (r & 7));
// rows at or past n are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void stage(float4* tile, const float* base,
                                      long long rs, int lo, int n) {
  constexpr int kChunks = D / 4;
  const uint32_t t0 = smem_u32(tile);
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = lo + r < n;
    const float* src = ok ? base + (long long)(lo + r) * rs + 4 * c : base;
    cp_async16(t0 + 16u * (r * kChunks + (c ^ (r & 7))), src, ok);
  }
}

template <int D, int R = rows_per_thread<D>()>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
       int group, Strides st, int causal, int window, float scale) {
  constexpr int kRows = 16 * R;             // query rows per block
  constexpr int kChunks = D / 4;            // float4 chunks per row
  constexpr int kOut = D / 64;              // float4 output chunks per row
                                            // (D = 32: half of one)
  constexpr int kOutRegs = D >= 64 ? kOut : 1;
  extern __shared__ float4 smem[];
  float4* qs = smem;                        // [rows][D/4], swizzled
  float4* ks = qs + kRows * kChunks;        // [64][D/4], swizzled
  float4* vs = ks + kKeys * kChunks;        // [64][D/4], swizzled
  float4* ps = vs + kKeys * kChunks;        // [rows][16], swizzled

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tr = (tid >> 5) * 2 + (lane >> 4);  // rows tr + 16 i
  const int tc = lane & 15;                     // keys tc + 16 j
  const int sw = tr & 7;                        // swizzle of my rows
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const float* qbase = q + b * st.qb + h * st.qh;
  const float* kbase = k + b * st.kb + hk * st.kh;
  const float* vbase = v + b * st.vb + hk * st.vh;

  int k_begin, k_end;
  key_range(q_lo, min(q_lo + kRows, sq) - 1, sk, causal, window, &k_begin,
            &k_end);
  const int t_lo = k_begin / kKeys;
  const int t_hi = (k_end + kKeys - 1) / kKeys;

  // cp.async groups, in order: [Q, K_lo] [V_lo] [K_lo+1] [V_lo+1] ...; a
  // group is committed (possibly empty) at every step, so "wait until at
  // most 1 group is pending" always means "the tile needed next landed"
  stage<D, kRows>(qs, qbase, st.qs, q_lo, sq);
  if (t_lo < t_hi) stage<D, kKeys>(ks, kbase, st.ks, t_lo * kKeys, sk);
  cp_async_commit();
  if (t_lo < t_hi) stage<D, kKeys>(vs, vbase, st.vs, t_lo * kKeys, sk);
  cp_async_commit();

  float m[R], l[R];
  float4 acc[R][kOutRegs];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kOutRegs; ++e)
      acc[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k_lo = t * kKeys;
    cp_async_wait1();
    __syncthreads();                        // Q and K_t landed

    float s[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < kChunks; ++c) {
      float4 a[R], kk[4];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = qs[(tr + 16 * i) * kChunks + (c ^ sw)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = ks[(tc + 16 * j) * kChunks + (c ^ (tc & 7))];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], kk[j], s[i][j]);
    }
    __syncthreads();                        // K_t consumed
    if (t + 1 < t_hi) stage<D, kKeys>(ks, kbase, st.ks, k_lo + kKeys, sk);
    cp_async_commit();

    // masks only on tiles that straddle Sk, the diagonal or the window
    const bool edge = k_lo + kKeys > sk ||
                      (causal && k_lo + kKeys - 1 > q_lo) ||
                      (window > 0 && k_lo <= q_lo + kRows - 1 - window);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] *= scale;
    if (edge) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!visible(k_lo + tc + 16 * j, q_lo + tr + 16 * i, sk, causal,
                       window))
            s[i][j] = kNegInf;
    }
    float* pf = reinterpret_cast<float*>(ps);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kOutRegs; ++e)
        acc[i][e] = make_float4(acc[i][e].x * alpha, acc[i][e].y * alpha,
                                acc[i][e].z * alpha, acc[i][e].w * alpha);
      const int row = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tc + 16 * j;
        pf[(row * 16 + ((key >> 2) ^ sw)) * 4 + (key & 3)] = s[i][j];
      }
    }
    cp_async_wait1();
    __syncthreads();                        // V_t landed, P written

#pragma unroll 4
    for (int kc = 0; kc < kKeys / 4; ++kc) {
      float4 p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = ps[(tr + 16 * i) * 16 + (kc ^ sw)];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = 4 * kc + jj;
        const float4* vr = vs + key * kChunks;
        if constexpr (D == 32) {            // 2 columns per thread
          const float2 vv = reinterpret_cast<const float2*>(
              vr + ((tc >> 1) ^ (key & 7)))[tc & 1];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float pij = lane4(p[i], jj);
            acc[i][0].x = fmaf(pij, vv.x, acc[i][0].x);
            acc[i][0].y = fmaf(pij, vv.y, acc[i][0].y);
          }
        } else {
#pragma unroll
          for (int e = 0; e < kOut; ++e) {
            const float4 vv = vr[(tc + 16 * e) ^ (key & 7)];
#pragma unroll
            for (int i = 0; i < R; ++i)
              acc[i][e] = axpy4(lane4(p[i], jj), vv, acc[i][e]);
          }
        }
      }
    }
    __syncthreads();                        // V_t and P consumed
    if (t + 1 < t_hi) stage<D, kKeys>(vs, vbase, st.vs, k_lo + kKeys, sk);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    float li = l[i];
#pragma unroll
    for (int x = 1; x < 16; x <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, x);
    const int qp = q_lo + tr + 16 * i;
    if (qp >= sq) continue;
    const float den = fmaxf(li, 1e-30f);
    float* orow = o + b * st.ob + (long long)qp * st.os + h * st.oh;
    if constexpr (D == 32) {
      reinterpret_cast<float2*>(orow)[tc] =
          make_float2(acc[i][0].x / den, acc[i][0].y / den);
    } else {
#pragma unroll
      for (int e = 0; e < kOut; ++e)
        reinterpret_cast<float4*>(orow)[tc + 16 * e] =
            make_float4(acc[i][e].x / den, acc[i][e].y / den,
                        acc[i][e].z / den, acc[i][e].w / den);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int hq, int hkv, const Strides& st, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  auto fn = kernel<D>;
  constexpr int rows = 16 * rows_per_thread<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sq + rows - 1) / rows, hq, batch);
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk,
      hq / hkv, st, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------------ bfloat16
namespace bf16 {

constexpr int kRows = 128;       // query rows per block (2 x 64)
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 384;    // warpgroup 0 produces, 1-2 consume
constexpr int kKeys = 64;        // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kCols = D < 64 ? D : 64;     // columns per block
  static constexpr int kRowBytes = 2 * kCols;       // 128 (64 at D = 32)
  static constexpr int kBlocks = D / kCols;         // column blocks
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;  // one K or V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = kBarOffset + 16 * 8 + 1024;  // + alignment
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
};

// barrier slots
constexpr int kQFull = 0, kKFull = 1, kVFull = 3, kKEmpty = 5, kVEmpty = 7;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  // a wait of ~2^35 cycles (over 10 s) means a copy or an arrival was
  // lost: trap, which the next synchronisation reports as a launch
  // failure, instead of hanging the card
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching accumulators across the async wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] B[16 x N], A in registers (bfloat16 pairs),
// B MN-major in shared memory (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// S[64 x 64] = Q K^T of one consumer warpgroup's 64 query rows (`q_rows`)
// and one K tile (`k_tile`), issued as one wgmma group (not waited)
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_rows,
                                         uint32_t k_tile) {
  using C = Cfg<D>;
  constexpr uint32_t kSbo = 8 * C::kRowBytes;
  // a descriptor's start address steps 32 bytes per k16 slice inside a
  // swizzled row, and one column block per 64 columns
  const uint64_t dq = make_desc(q_rows, 16, kSbo, C::kLayout);
  const uint64_t dk = make_desc(k_tile, 16, kSbo, C::kLayout);
  wg_fence();
#pragma unroll
  for (int cb = 0; cb < C::kBlocks; ++cb)
#pragma unroll
    for (int kk = 0; kk < C::kCols / 16; ++kk)
      wgmma_ss64(sc, dq + ((cb * kRows * C::kRowBytes + 32 * kk) >> 4),
                 dk + ((cb * kKeys * C::kRowBytes + 32 * kk) >> 4),
                 cb + kk > 0);
  wg_commit();
}

// O += (P_hi + P_lo) V for one V tile (`v_tile`), issued as one wgmma
// group (not waited)
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* p_hi,
                                         const uint32_t* p_lo,
                                         uint32_t v_tile) {
  using C = Cfg<D>;
  constexpr uint32_t kSbo = 8 * C::kRowBytes;
  const uint64_t dv = make_desc(v_tile, kKeys * C::kRowBytes, kSbo,
                                C::kLayout);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    if constexpr (D <= 128) {                 // N = D: one chain
      const uint64_t d = dv + ((16 * kk * C::kRowBytes) >> 4);
      wgmma_rs<D>(acc, p_hi + 4 * kk, d);
      wgmma_rs<D>(acc, p_lo + 4 * kk, d);
    } else {                                  // n64 per column block
#pragma unroll
      for (int cb = 0; cb < C::kBlocks; ++cb) {
        const uint64_t d = dv + ((cb * kKeys * C::kRowBytes +
                                  16 * kk * C::kRowBytes) >> 4);
        wgmma_rs<64>(acc + 32 * cb, p_hi + 4 * kk, d);
        wgmma_rs<64>(acc + 32 * cb, p_lo + 4 * kk, d);
      }
    }
  }
  wg_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ CUtensorMap tk,
       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
       int sq, int sk, int group, long long ob, long long os, long long oh,
       int causal, int window, float scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;                        // [blocks][128][cols]
  const uint32_t s_k = base + C::kQBytes;  // [stage][blocks][64][cols]
  const uint32_t s_v = s_k + kStages * C::kTileBytes;
  const uint32_t bars = base + C::kBarOffset;

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  int k_begin, k_end;
  key_range(q_lo, min(q_lo + kRows, sq) - 1, sk, causal, window, &k_begin,
            &k_end);
  const int t_lo = k_begin / kKeys;
  const int n_tiles = max(0, (k_end + kKeys - 1) / kKeys - t_lo);

  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kQFull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (kKFull + s), 1);
      mbar_init(bars + 8 * (kVFull + s), 1);
      mbar_init(bars + 8 * (kKEmpty + s), 8);   // one per consumer warp
      mbar_init(bars + 8 * (kVEmpty + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, made visibly warp-uniform for the compiler
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars + 8 * kQFull, C::kQBytes);
      for (int cb = 0; cb < C::kBlocks; ++cb)
        tma_load(s_q + cb * kRows * C::kRowBytes, &tq, bars + 8 * kQFull,
                 cb * C::kCols, q_lo, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1;
        const uint32_t phase = ((i >> 1) & 1) ^ 1;  // first pass is free
        const int k_lo = (t_lo + i) * kKeys;
        mbar_wait(bars + 8 * (kKEmpty + s), phase);
        mbar_expect_tx(bars + 8 * (kKFull + s), C::kTileBytes);
        for (int cb = 0; cb < C::kBlocks; ++cb)
          tma_load(s_k + s * C::kTileBytes + cb * kKeys * C::kRowBytes, &tk,
                   bars + 8 * (kKFull + s), cb * C::kCols, k_lo, hk, b);
        mbar_wait(bars + 8 * (kVEmpty + s), phase);
        mbar_expect_tx(bars + 8 * (kVFull + s), C::kTileBytes);
        for (int cb = 0; cb < C::kBlocks; ++cb)
          tma_load(s_v + s * C::kTileBytes + cb * kKeys * C::kRowBytes, &tv,
                   bars + 8 * (kVFull + s), cb * C::kCols, k_lo, hk, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int wg = role - 1;                  // consumer warpgroup 0 / 1
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int q_wg = q_lo + 64 * wg;          // first row of this group
    const int qp0 = q_wg + 16 * warp + (lane >> 2);   // my rows: qp0, +8
    const int qp1 = qp0 + 8;
    const int cq = 2 * (lane & 3);            // my columns in an n8 block
    int wk_begin, wk_end;
    key_range(q_wg, min(q_wg + 64, sq) - 1, sk, causal, window, &wk_begin,
              &wk_end);
    const bool rows_ok = q_wg < sq;
    const uint32_t q_rows = s_q + 64 * wg * C::kRowBytes;

    float acc[D / 2];                         // O: n8 blocks x 4
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m: raw units
    const float scale_log2e = scale * kLog2e;

    mbar_wait(bars + 8 * kQFull, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i & 1;
      const uint32_t phase = (i >> 1) & 1;
      const int k_lo = (t_lo + i) * kKeys;
      // a tile outside this warpgroup's key range is waited for and
      // released but not computed
      const bool active = rows_ok && k_lo < wk_end && k_lo + kKeys > wk_begin;
      float sc[kKeys / 2];                    // S: n8 blocks x 4
      uint32_t p_hi[kKeys / 4], p_lo[kKeys / 4];  // P: k16 slices x 4

      mbar_wait(bars + 8 * (kKFull + s), phase);
      if (active) {
        issue_qk<D>(sc, q_rows, s_k + s * C::kTileBytes);
        wg_wait_all();
        reg_fence<kKeys / 2>(sc);
      }
      if (lane == 0) mbar_arrive(bars + 8 * (kKEmpty + s));

      if (active) {
        // Scores stay in raw units (the max of raw scores is the max of
        // scaled ones); the scale and log2(e) fold into one multiply
        // before ex2.  Masks only on tiles that straddle Sk, the diagonal
        // or the window edge.
        const bool edge = k_lo + kKeys > sk ||
                          (causal && k_lo + kKeys - 1 > q_wg) ||
                          (window > 0 && k_lo <= q_wg + 63 - window);
        if (edge) {
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kp = k_lo + 8 * j + cq + (e & 1);
              if (!visible(kp, e < 2 ? qp0 : qp1, sk, causal, window))
                sc[4 * j + e] = kNegInf;
            }
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - mn0) * scale_log2e);
        const float a1 = ex2((m1 - mn1) * scale_log2e);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // x - m is exactly 0 at the max, also for a row masked so far
            const float p =
                ex2((sc[4 * j + e] - (e < 2 ? mn0 : mn1)) * scale_log2e);
            sc[4 * j + e] = p;
            if (e < 2) ps0 += p;
            else ps1 += p;
          }
        l0 = l0 * a0 + ps0;
        l1 = l1 * a1 + ps1;
        // O is rescaled only where a row max moved (ex2(0) is exactly 1)
        if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[4 * j + 0] *= a0;
            acc[4 * j + 1] *= a0;
            acc[4 * j + 2] *= a1;
            acc[4 * j + 3] *= a1;
          }
        }
        // the accumulator fragment of keys 16 kk .. 16 kk + 15 is the A
        // fragment of k16 slice kk: P = hi + lo, two bfloat16 terms
#pragma unroll
        for (int r = 0; r < kKeys / 4; ++r) {
          const float x0 = sc[2 * r], x1 = sc[2 * r + 1];
          p_hi[r] = pack_bf16(x0, x1);
          const float2 hf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&p_hi[r]));
          p_lo[r] = pack_bf16(x0 - hf.x, x1 - hf.y);
        }
      }

      mbar_wait(bars + 8 * (kVFull + s), phase);
      if (active) {
        issue_pv<D>(acc, p_hi, p_lo, s_v + s * C::kTileBytes);
        wg_wait_all();
        reg_fence<D / 2>(acc);
      }
      if (lane == 0) mbar_arrive(bars + 8 * (kVEmpty + s));
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f);
    const float d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = o + b * ob + (long long)qp0 * os + h * oh + cq;
    __nv_bfloat16* o1 = o + b * ob + (long long)qp1 * os + h * oh + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (qp0 < sq)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_bf16(acc[4 * j + 0] / d0, acc[4 * j + 1] / d0);
      if (qp1 < sq)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (this
// library is not linked against libcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a [B, S, H, D] bfloat16 tensor (element strides sb, ss,
// sh; D contiguous) read in boxes of `cols` x `rows` (D x S), swizzled
// as the wgmma descriptors expect.  Returns 0, or minus the CUresult.
int make_map(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
             long long ss, long long sh, long long sb, int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const long long el[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  cuuint64_t packed = 2ull * d;
  for (int i = 0; i < 3; ++i) {
    // an axis of extent 1 is never stepped: any legal stride will do
    strides[i] = dims[i + 1] == 1 ? packed : (cuuint64_t)el[i] * 2;
    packed *= dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int hq, int hkv, const Strides& st, int causal,
           int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, D, sq, hq, batch, st.qs, st.qh, st.qb, C::kCols,
                    kRows);
  if (rc == 0)
    rc = make_map(&tk, k, D, sk, hkv, batch, st.ks, st.kh, st.kb, C::kCols,
                  kKeys);
  if (rc == 0)
    rc = make_map(&tv, v, D, sk, hkv, batch, st.vs, st.vh, st.vb, C::kCols,
                  kKeys);
  if (rc != 0) return rc;
  auto fn = kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sq + kRows - 1) / kRows, hq, batch);
  fn<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, hq / hkv, st.ob,
      st.os, st.oh, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace bf16

#define FLASH_DISPATCH(NS)                                                   \
  switch (d) {                                                               \
    case 32:                                                                 \
      return NS::launch<32>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal,  \
                            window, scale, s);                               \
    case 64:                                                                 \
      return NS::launch<64>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal,  \
                            window, scale, s);                               \
    case 128:                                                                \
      return NS::launch<128>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal, \
                             window, scale, s);                              \
    case 256:                                                                \
      return NS::launch<256>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal, \
                             window, scale, s);                              \
    default:                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
  }

}  // namespace

// dtype: 0 float32, 1 bfloat16; window <= 0: none; scale: D^-0.5 as the
// plain version rounds it.  Returns the CUDA error of the launch (0 on
// success), or minus the driver's CUresult when a bfloat16 tensor map
// could not be encoded.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int sk, int hq, int hkv, int d, int dtype, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    int causal, int window, float scale, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || hkv < 1 || hq % hkv != 0 ||
      hq > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) FLASH_DISPATCH(f32)
  if (dtype == 1) FLASH_DISPATCH(bf16)
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block for (dtype, head dim), in bytes, or
// -1 for a pair the kernel does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int d) {
  switch (dtype * 1000 + d) {
    case 32: return f32::smem_bytes<32>();
    case 64: return f32::smem_bytes<64>();
    case 128: return f32::smem_bytes<128>();
    case 256: return f32::smem_bytes<256>();
    case 1032: return bf16::Cfg<32>::kSmem;
    case 1064: return bf16::Cfg<64>::kSmem;
    case 1128: return bf16::Cfg<128>::kSmem;
    case 1256: return bf16::Cfg<256>::kSmem;
    default: return -1;
  }
}

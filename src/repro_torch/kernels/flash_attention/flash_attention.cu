// Causal GQA flash attention with an optional sliding window, for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` of
// src/repro/kernels/flash_attention/flash_attention.py (`_kernel`).
// Plain version: repro_torch/kernels/flash_attention/ref.py, i.e.
// `sdpa_ref` of repro_torch/models/layers.py with no query blocking.
//
// Inputs q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], read through their
// strides (the D axis contiguous; no transpose or padding copy), float32
// or bfloat16; output o [B, Sq, Hq, D] in the input dtype.  The math is
// float32: scores scaled by D^-0.5, masked scores at -1e30, the
// normaliser floored at 1e-30, kv head h / (Hq / Hkv), causal
// kpos <= qpos, window kpos > qpos - window, and keys at kpos >= Sk
// masked (the Pallas wrapper pads Sk with zero keys and, non-causal,
// attends to them; the plain version does not, and this kernel follows
// it).  Head dims 32 (the reduced test configs), 64, 128 and 256.
//
// Design.  One block per (query tile of 64 rows, q head, batch row); the
// heaviest causal tiles (the last) are launched first.  Four threads
// share a query row: thread c holds the row's D/4 elements {16e + 4c ..
// 16e + 4c + 3} of q in registers, its D/4 output columns of the same
// pattern in a float32 accumulator, and the row's running max and
// normaliser.  Key/value tiles of 32 rows are staged through shared
// memory as float32 (2 x 32 x D x 4 bytes: 64 KB at D = 256, taken as
// dynamic shared memory); rows past Sk are staged as zeros.  A score is
// four partial dot products summed with two xor shuffles, so all four
// threads of a row hold identical scores and softmax statistics.  Whole
// key tiles outside the causal/window range of a query tile are skipped;
// the tiles that straddle it are masked per element.  Rows past Sq
// compute on zero queries and are not stored.  Explicit fmaf() (the
// build turns off FMA contraction).
//
// Bound.  attention_flops = 4 B Hq Sq Sk D (/2 causal): at glm4-9b's
// prefill shape (1, 4096, 32/2, 128) 1.37e11 flop, 2.05 ms at float32's
// 67 TFLOP/s (0.14 ms at bf16's 989 on tensor cores), against ~0.04 ms
// for the 143 MB of q/k/v/o at 3.35 TB/s: bound by operations.  This
// first kernel runs on the float32 CUDA cores and reads every key tile
// from shared memory once per query row: wgmma, TMA and register blocking
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;      // query rows per block
constexpr int kBlockK = 32;      // key rows per staged tile
constexpr int kRowThreads = 4;   // threads per query row
constexpr int kThreads = kBlockQ * kRowThreads;
constexpr float kNegInf = -1e30f;

struct Strides {                 // element strides of the B, S, H axes
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int group, Strides st, int causal, int window,
                       float scale) {
  constexpr int kVec = D / 16;          // float4 chunks a thread holds
  constexpr int kRow4 = D / 4;          // float4 chunks per staged row
  extern __shared__ float4 smem[];
  float4* ks = smem;                    // [kBlockK][kRow4]
  float4* vs = smem + kBlockK * kRow4;  // [kBlockK][kRow4]

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int c = tid % kRowThreads;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int qpos = q_lo + row;
  const bool q_ok = qpos < sq;

  float4 qv[kVec];
  float4 acc[kVec];
  const T* qrow = q + b * st.qb + (long long)qpos * st.qs + h * st.qh;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    qv[e] = q_ok ? load4(qrow + (e * kRowThreads + c) * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  // key range of the whole query tile: [k_begin, k_end)
  const int q_hi = min(q_lo + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const T* kbase = k + b * st.kb + hk * st.kh;
  const T* vbase = v + b * st.vb + hk * st.vh;

  for (int k_lo = (k_begin / kBlockK) * kBlockK; k_lo < k_end;
       k_lo += kBlockK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < kBlockK * kRow4; i += kThreads) {
      const int kp = k_lo + i / kRow4;
      const int col = (i % kRow4) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kp < sk) {
        kk = load4(kbase + (long long)kp * st.ks + col);
        vv = load4(vbase + (long long)kp * st.vs + col);
      }
      ks[i] = kk;
      vs[i] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = ks + j * kRow4;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        part = dot4(qv[e], kr[e * kRowThreads + c], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k_lo + j;
      bool ok = kp < sk;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? part * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      acc[e] = make_float4(acc[e].x * alpha, acc[e].y * alpha,
                           acc[e].z * alpha, acc[e].w * alpha);
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* vr = vs + j * kRow4;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[e] = axpy4(s[j], vr[e * kRowThreads + c], acc[e]);
    }
    m = m_new;
  }

  if (!q_ok) return;
  const float den = fmaxf(l, 1e-30f);
  T* orow = o + b * st.ob + (long long)qpos * st.os + h * st.oh;
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    store4(orow + (e * kRowThreads + c) * 4,
           make_float4(acc[e].x / den, acc[e].y / den, acc[e].z / den,
                       acc[e].w / den));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int hq, int hkv, const Strides& st, int causal,
           int window, float scale, cudaStream_t stream) {
  const int smem = 2 * kBlockK * D * (int)sizeof(float);
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq / hkv, st,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int batch, int sq, int sk, int hq, int hkv, const Strides& st,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal,
                            window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, sq, sk, hq, hkv, st, causal,
                            window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window <= 0: none; scale: D^-0.5 as the
// plain version rounds it.  Returns the CUDA error of the launch (0 on
// success).
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
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, batch, sq, sk, hq, hkv, st,
                           causal, window, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, batch, sq, sk, hq, hkv,
                                   st, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

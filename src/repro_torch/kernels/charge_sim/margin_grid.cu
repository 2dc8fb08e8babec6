// Dense (cells x combos) steady-state read/write margin grid for Hopper.
//
// Replaces the Pallas TPU kernel `margin_grid` of
// src/repro/kernels/charge_sim/charge_sim.py (`_kernel`, `_margin_block`).
// Plain version: repro_torch/kernels/charge_sim/ref.py (`margin_grid`),
// i.e. repro_torch/core/charge.py evaluated densely.
//
// Inputs (float32, row-major):
//   cells_t  [7, n]: tau_r, xfer, tau_ret85, tau_p, tau_w, and the per-cell
//                    read / write tREFI overrides (<= 0: use the combo's)
//   combos_t [6, m]: trcd, tras, twr, trp, trefi, temp_c
// Outputs: read [n, m], write [n, m] (float32, row-major).
//
// Design.  One thread per (cell, combo) element; a 2-D grid of 32 x 8
// blocks (combos on x, so a warp writes 32 consecutive floats of one
// output row).  Each block stages its 32 combo columns and 8 cell rows in
// shared memory; the ragged edge is masked here, so no padded copy of the
// inputs or outputs exists.  The 14 physics constants arrive by value.
//
// Bound.  Per element ~320 float32 operations (the reference's
// `margin_grid_flops`) including 23 expf/logf, against 8 bytes of output:
// at the profiling-campaign shape (176,640 x 8,505) the 12.0 GB of output
// take 3.6 ms at 3.35 TB/s and the 4.8e11 operations 7.2 ms at 67 TFLOP/s,
// so the kernel is bound by operations.  Writing the 12 GB is the cost a
// fused on-chip `>= 0` reduction would remove.
//
// Rounding.  Where the restore collapses (tRAS at the 12.5 ns end of the
// grid) the 8-step fixed point amplifies last-bit differences: two
// correct float32 evaluations in different operation orders differ there
// by up to ~1e-2 on margins <= -1.8 (never near the pass/fail boundary).
// So the kernel follows the plain version operation for operation, as
// PyTorch evaluates it on the card: IEEE expf/logf (no --use_fast_math),
// no FMA contraction (-fmad=false, see build.py), a tensor divided by a
// constant as a product with the constant's float reciprocal, and a
// constant divided by a tensor as the tensor's reciprocal times the
// constant (PyTorch's CUDA `div` with a scalar divisor and its
// `__rtruediv__`).

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct ChargeConsts {
  float t_wl, alpha_share, tau_s, dv_full, dv_min, t_p0, t_wr_base,
      t_wr_floor, kappa_w, beta_w, dv_full_w, k_ret, k_rc, v_precharge;
};

constexpr int kTileM = 32;   // combos per block (threadIdx.x)
constexpr int kTileN = 8;    // cells per block (threadIdx.y)
constexpr int kFixedPointIters = 8;

__device__ __forceinline__ float sense_t(float q, float xfer, float residual,
                                         float tau_r_t,
                                         const ChargeConsts& c) {
  float dv_eff = fmaxf((q - 0.5f) * xfer - residual, 1e-6f);
  return c.t_wl + c.alpha_share * tau_r_t +
         c.tau_s * logf((1.0f / dv_eff) * c.dv_full);
}

__global__ void __launch_bounds__(kTileM * kTileN)
margin_grid_kernel(const float* __restrict__ cells_t,
                   const float* __restrict__ combos_t,
                   float* __restrict__ read_out,
                   float* __restrict__ write_out, int n, int m,
                   ChargeConsts c) {
  __shared__ float s_combo[6][kTileM];
  __shared__ float s_cell[7][kTileN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileM + tx;
  const long long i0 = (long long)blockIdx.x * kTileN;   // first cell
  const int j0 = blockIdx.y * kTileM;                    // first combo

  if (tid < 6 * kTileM) {
    const int r = tid / kTileM, col = tid % kTileM, j = j0 + col;
    s_combo[r][col] = j < m ? combos_t[(long long)r * m + j] : 100.0f;
  }
  if (tid < 7 * kTileN) {
    const int r = tid / kTileN, row = tid % kTileN;
    const long long i = i0 + row;
    s_cell[r][row] = i < n ? cells_t[(long long)r * n + i] : 1.0f;
  }
  __syncthreads();

  const long long i = i0 + ty;
  const int j = j0 + tx;
  if (i >= n || j >= m) return;

  const float tau_r = s_cell[0][ty], xfer = s_cell[1][ty];
  const float tau_ret85 = s_cell[2][ty], tau_p = s_cell[3][ty];
  const float tau_w_c = s_cell[4][ty];
  const float trefi_r_cell = s_cell[5][ty], trefi_w_cell = s_cell[6][ty];
  const float trcd = s_combo[0][tx], tras = s_combo[1][tx];
  const float twr = s_combo[2][tx], trp = s_combo[3][tx];
  const float trefi = s_combo[4][tx], temp_c = s_combo[5][tx];
  const float trefi_r = trefi_r_cell > 0.0f ? trefi_r_cell : trefi;
  const float trefi_w = trefi_w_cell > 0.0f ? trefi_w_cell : trefi;

  const float hot = 1.0f + c.k_rc * fmaxf(temp_c - 55.0f, 0.0f);
  const float tau_r_t = tau_r * hot;
  const float tau_w_t = tau_w_c * hot;
  const float tau_ret = tau_ret85 * expf(c.k_ret * (85.0f - temp_c));
  const float leak = expf(-trefi_r / tau_ret);
  const float residual =
      c.v_precharge * expf(-fmaxf(trp - c.t_p0, 0.0f) / tau_p);

  // read steady state: affine fixed point of the refresh/restore loop
  float q_r = 0.95f;
#pragma unroll
  for (int it = 0; it < kFixedPointIters; ++it) {
    const float q_acc = 0.5f + (q_r - 0.5f) * leak;
    const float ts = sense_t(q_acc, xfer, residual, tau_r_t, c);
    const float t_rest = fmaxf(tras - ts, 0.0f);
    // restore starts from the charge-shared level (paper Fig. 1)
    const float q_shared = 0.5f + (q_acc - 0.5f) * xfer;
    q_r = 1.0f - (1.0f - q_shared) * expf(-t_rest / tau_w_t);
  }
  const float q_acc = 0.5f + (q_r - 0.5f) * leak;
  const float ts = sense_t(q_acc, xfer, residual, tau_r_t, c);
  const float m_sense =
      ((q_acc - 0.5f) * xfer - residual - c.dv_min) * (1.0f / c.dv_min);
  const float read_m = fminf(m_sense, trcd - ts);

  // write steady state (worst case: flip of a freshly written value);
  // write tests exercise worst-case coupling -> derated retention
  const float tau_w = tau_w_t * c.beta_w;
  const float leak_w = expf(-trefi_w / (tau_ret * c.kappa_w));
  const float q_low = 0.05f;
  const float q_written =
      1.0f - (1.0f - q_low) * expf(-fmaxf(twr + c.t_wr_base, 0.0f) / tau_w);
  const float q_s = 0.5f + (q_written - 0.5f) * leak_w;
  const float dv_eff_w = fmaxf((q_s - 0.5f) * xfer - residual, 1e-6f);
  const float t_open = c.t_wl + c.alpha_share * tau_r_t +
                       c.tau_s * logf(fmaxf((1.0f / dv_eff_w) * c.dv_full_w,
                                            1e-6f));
  const float m_sense_w =
      ((q_s - 0.5f) * xfer - residual - c.dv_min) * (1.0f / c.dv_min);
  const float m_floor = twr - c.t_wr_floor * (tau_r_t * (1.0f / 4.5f));
  const float write_m = fminf(fminf(m_sense_w, trcd - t_open), m_floor);

  const long long o = i * m + j;
  read_out[o] = read_m;
  write_out[o] = write_m;
}

}  // namespace

// C interface (ctypes).  `consts` points to the 14 ChargeConsts floats in
// host memory; `stream` is a cudaStream_t.  Returns the cudaError_t of the
// launch (0 = success); the kernel runs asynchronously on `stream`.
extern "C" int margin_grid_launch(const float* cells_t, const float* combos_t,
                                  float* read_out, float* write_out, int n,
                                  int m, const float* consts, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  ChargeConsts c;
  c.t_wl = consts[0];
  c.alpha_share = consts[1];
  c.tau_s = consts[2];
  c.dv_full = consts[3];
  c.dv_min = consts[4];
  c.t_p0 = consts[5];
  c.t_wr_base = consts[6];
  c.t_wr_floor = consts[7];
  c.kappa_w = consts[8];
  c.beta_w = consts[9];
  c.dv_full_w = consts[10];
  c.k_ret = consts[11];
  c.k_rc = consts[12];
  c.v_precharge = consts[13];
  const long long gx = ((long long)n + kTileN - 1) / kTileN;
  const long long gy = ((long long)m + kTileM - 1) / kTileM;
  if (gx > 2147483647LL || gy > 65535LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)gy);
  dim3 block(kTileM, kTileN);
  margin_grid_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cells_t, combos_t, read_out, write_out, n, m, c);
  return (int)cudaGetLastError();
}

// Fault injection inside the replay kernels (variant e of replay.cu,
// variant d of adaptive.cu): the arithmetic of repro_torch/core/faults.py
// (the port of src/repro/core/faults.py), operation for operation, for
// one lane held in registers.
//
// A lane reads its fault row once ([F_COLS, L] tile, column l) and carries
// the watchdog (error budget, implausibility run, clean-probe run, probe
// countdown, tripped flag) and the five counters in registers.  The
// constants are the float32 values the plain version rounds its Python
// literals to, written as exact hex literals; the build turns off FMA
// contraction, so every product and sum rounds as PyTorch's do.
#pragma once

#include <math.h>

namespace faults {

// fault-row columns (faults.py)
constexpr int kStuckC = 0, kStuckFrom = 1, kDrift = 2, kNoise = 3;
constexpr int kQuant = 4, kLagTau = 5, kDropP = 6, kErrScale = 7;
constexpr int kErrFree = 8, kErrBinC = 9, kDetFrac = 10, kRetryNs = 11;
constexpr int kWdErrN = 12, kWdJumpC = 13, kWdSenseN = 14, kWdProbe = 15;
constexpr int kWdRecoverN = 16, kSeed = 17, kFCols = 18;
constexpr int kNCounters = 5;   // detected, silent, trips, degraded, probes

constexpr float kErrCap = 0x1.e66666p-1f;      // float32(0.95)
constexpr float kNoReading = -1.0e9f;          // no previous reading yet
constexpr float kNoReadingHalf = -5.0e8f;      // 0.5 * NO_READING
constexpr float kHashK = 0x1.9fac72p+3f;       // float32(12.9898)
constexpr float kHashSeed = 0x1.38ee98p+6f;    // float32(78.233)
constexpr float kHashScale = 0x1.55dd18p+15f;  // float32(43758.5453)
constexpr float kFloor = 0x1.12e0bep-30f;      // float32(1e-9)

// One lane's fault row; the WD_* counts truncate toward zero like the
// plain version's float -> int32 conversion.
struct Row {
  float stuck_c, stuck_from, drift, noise, quant, lag_tau, drop_p;
  float err_scale, err_free, err_bin_c, det_frac, retry_ns, jump_c, seed;
  int err_n, sense_n, probe_n, recover_n;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ tile,
                                        int lanes, int l) {
  Row r;
  r.stuck_c = tile[kStuckC * lanes + l];
  r.stuck_from = tile[kStuckFrom * lanes + l];
  r.drift = tile[kDrift * lanes + l];
  r.noise = tile[kNoise * lanes + l];
  r.quant = tile[kQuant * lanes + l];
  r.lag_tau = tile[kLagTau * lanes + l];
  r.drop_p = tile[kDropP * lanes + l];
  r.err_scale = tile[kErrScale * lanes + l];
  r.err_free = tile[kErrFree * lanes + l];
  r.err_bin_c = tile[kErrBinC * lanes + l];
  r.det_frac = tile[kDetFrac * lanes + l];
  r.retry_ns = tile[kRetryNs * lanes + l];
  r.jump_c = tile[kWdJumpC * lanes + l];
  r.seed = tile[kSeed * lanes + l];
  r.err_n = (int)tile[kWdErrN * lanes + l];
  r.sense_n = (int)tile[kWdSenseN * lanes + l];
  r.probe_n = (int)tile[kWdProbe * lanes + l];
  r.recover_n = (int)tile[kWdRecoverN * lanes + l];
  return r;
}

struct Watchdog {
  int err = 0, bad = 0, clean = 0, probe_cnt = 0, tripped = 0;
};

struct Counters {
  int det = 0, sil = 0, trips = 0, degraded = 0, probes = 0;
};

// fract(sin(k * 12.9898 + seed * 78.233 + 0.5) * 43758.5453)
__device__ __forceinline__ float hash01(float seed, int k) {
  const float x =
      sinf(((float)k * kHashK + seed * kHashSeed) + 0.5f) * kHashScale;
  return x - floorf(x);
}

// Pre-service gate: is this request a probe (served at the adaptive row
// while tripped)?  The adaptive row serves when !tripped || probe.
__device__ __forceinline__ bool wd_probe(const Watchdog& wd, const Row& f) {
  return wd.tripped > 0 && f.probe_n > 0 && wd.probe_cnt >= f.probe_n - 1;
}

// Post-service transition (faults.wd_update); returns new_trip.
__device__ __forceinline__ bool wd_update(Watchdog& wd, const Row& f,
                                          bool det, bool implaus,
                                          bool is_probe) {
  wd.err += det ? 1 : 0;
  wd.bad = implaus ? wd.bad + 1 : 0;
  const bool trip_now = (f.err_n > 0 && wd.err >= f.err_n) ||
                        (f.sense_n > 0 && wd.bad >= f.sense_n);
  const bool new_trip = wd.tripped == 0 && trip_now;
  if (trip_now) wd.tripped = 1;
  if (is_probe) wd.clean = det ? 0 : wd.clean + 1;
  if (wd.tripped > 0 && f.recover_n > 0 && wd.clean >= f.recover_n) {
    wd.err = 0;
    wd.bad = 0;
    wd.clean = 0;
    wd.tripped = 0;
  }
  wd.probe_cnt = wd.tripped > 0 ? (is_probe ? 0 : wd.probe_cnt + 1) : 0;
  return new_trip;
}

// Margin-conditioned error probability (faults.error_prob): red is the
// served row's reduction against the JEDEC row, excess the true
// temperature's excess over the served bin's edge.
__device__ __forceinline__ float error_prob(const Row& f, float red,
                                            float excess) {
  const float p = f.err_scale * fmaxf(red - f.err_free, 0.0f) +
                  f.err_bin_c * excess;
  return fminf(fmaxf(p, 0.0f), kErrCap);
}

// The error outcome of one request (error_prob and error_draw).  Sets
// det / sil; returns the error probability.
__device__ __forceinline__ float error_outcome(const Row& f, float red,
                                               float excess, float u,
                                               bool& det, bool& sil) {
  const float p = error_prob(f, red, excess);
  const bool err = u < p;
  det = err && u < p * f.det_frac;
  sil = err && !det;
  return p;
}

// (((trcd + tras) + twr) + trp) over the JEDEC sum, floored at 0, a true
// division.
__device__ __forceinline__ float reduction(float trcd, float tras, float twr,
                                           float trp, float jsum) {
  return fmaxf(1.0f - (((trcd + tras) + twr) + trp) / jsum, 0.0f);
}

__device__ __forceinline__ void count(Counters& c, bool det, bool sil,
                                      bool new_trip, bool degraded,
                                      bool is_probe) {
  c.det += det ? 1 : 0;
  c.sil += sil ? 1 : 0;
  c.trips += new_trip ? 1 : 0;
  c.degraded += degraded ? 1 : 0;
  c.probes += is_probe ? 1 : 0;
}

// counters [kNCounters, G, L] int32
__device__ __forceinline__ void store(const Counters& c, int* __restrict__ out,
                                      long long g_stride, long long o) {
  out[0 * g_stride + o] = c.det;
  out[1 * g_stride + o] = c.sil;
  out[2 * g_stride + o] = c.trips;
  out[3 * g_stride + o] = c.degraded;
  out[4 * g_stride + o] = c.probes;
}

// A faulted sensor reading (faults.fault_sensor) in two parts.
//
// sensor_terms: what depends only on the request (arrival t, gap dt,
// request counter k) and the lane's fault row — the lag factor alpha, the
// noise term noise * (2h - 1), and the stuck-at (bit 0) and dropout
// (bit 1) flags.  The hash draws are skipped where their amplitude or
// probability is 0: the noise term is then a signed zero and the dropout
// flag false, as in the plain version.  The replay computes these ahead
// of the lane's dependent chain.
struct SensorTerms {
  float alpha, noise;
  int flags;
};
constexpr int kStuckBit = 1, kDropBit = 2;

__device__ __forceinline__ SensorTerms sensor_terms(float lag_tau,
                                                    float noise, float seed,
                                                    float drop_p,
                                                    float stuck_from,
                                                    float t, float dt, int k) {
  SensorTerms s;
  s.alpha = lag_tau > 0.0f
                ? 1.0f - expf(-fmaxf(dt, 0.0f) / fmaxf(lag_tau, kFloor))
                : 1.0f;
  const float h = noise != 0.0f ? hash01(seed, k) : 0.0f;
  s.noise = noise * (2.0f * h - 1.0f);
  s.flags = (stuck_from >= 0.0f && t >= stuck_from ? kStuckBit : 0) |
            (drop_p > 0.0f && hash01(seed + 1.0f, k) < drop_p ? kDropBit : 0);
  return s;
}

// sensor_chain: the rest, on the chain — the reading of the true sensed
// temperature `raw` through the lag state, drift, noise, stuck-at,
// dropout and quantization, in the plain version's order.  Updates the
// lag state; returns the reading (the caller keeps it as the held value).
__device__ __forceinline__ float sensor_chain(const Row& f, float t,
                                              float raw, float& lag,
                                              float held, float alpha,
                                              float noise_term, int flags) {
  const float lagged =
      lag > kNoReadingHalf ? lag + alpha * (raw - lag) : raw;
  lag = lagged;
  float r = f.lag_tau > 0.0f ? lagged : raw;
  r = r + f.drift * t;
  r = r + noise_term;
  if (flags & kStuckBit) r = f.stuck_c;
  if ((flags & kDropBit) && held > kNoReadingHalf) r = held;
  if (f.quant > 0.0f) {
    const float q = fmaxf(f.quant, kFloor);
    r = rintf(r / q) * q;
  }
  return r;
}

}  // namespace faults

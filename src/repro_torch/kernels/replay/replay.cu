// Batched DRAM trace replay for Hopper: every (cell g, timing row s) lane
// replays cell g's request stream under timing row s.
//
// Replaces variants (a)-(e) of the Pallas TPU kernel `replay_blocks` of
// src/repro/kernels/replay/replay.py (`_kernel`, launched at :726):
// module-level timing rows [6, S] (a), the per-bank tile [n_banks, 6, S]
// (b, the banked branch at replay.py:99/:172), the mask-compressed
// subarray-region store [U, 6, S] gathered through an index map (c, the
// regioned branch at replay.py:162), the multi-channel, multi-rank module
// (d, the `multi` branches at replay.py:95-120, :143-160, :216-219) and
// module rows under a fault axis (e, the faulted branch at
// replay.py:82-90, :125-134, :181-193, :201-237).  Plain version:
// repro_torch/core/dram_sim.py (`replay_cells`, `service_math`).
//
// Inputs (row-major): closed [G] float32 (1 = closed page); arrival [G, N]
// float32; bank, row, is_write, valid [G, N] int32 (flags 0/1); timings
// [6, S] (n_cols = 0), or a tile [n_cols, 6, S] float32 (rows = trcd,
// tras, twr, trp, trefi, tcl): the per-bank tile (n_cols = n_banks) or
// the region store (n_cols = U); for (c) region_map int32 [n_banks * R]
// shared by every lane, or [n_banks * R, S] per lane, with values in
// [0, U); for (e) the lane-tiled fault rows [F_COLS, S], the JEDEC column
// [6] and the issue-order error uniforms [G, N], all float32; for (d) the
// per-cell interleave codes [G] int32 (dram_sim.ILEAVE_CODES),
// n_channels, n_ranks and t_burst.
// Outputs: lat [G, N, S] float32 (0 at padding), total [G, S] float32;
// for (e) the counters [5, G, S] int32 (detected, silent, trips, degraded,
// probes).
//
// Bound.  The N requests of a lane form one dependent chain: the bank
// state, the done-ring and (d) the channel bus carry from one request to
// the next, so the kernel is bound by N steps of latency, not by its
// bytes (20 B read per request per cell, 4 B written per request per
// lane) or its ~25 operations per request per lane; at the Fig. 4 shapes
// only 140-420 lanes are live on the whole card, one or two warps an SM,
// so nothing hides a stall.  What must stay on the chain is
// `service_math` from one request's bank state to the next's: the
// forwarding select, two maxes to the start, the conflict max, + tRP,
// + tRCD, the hit/empty selects, + tCL and the page-policy select, ~11
// dependent float operations (ops.replay_chain_ops: 44 cycles; (d) adds
// the bus, 48; (e)'s watchdog loop is as long).
//
// Design.  Each step splits into what depends on the request alone and
// the chain.  A block is one thread per timing-row lane (at most
// kMaxLanes, the chain warps) plus kProducerWarps producer warps.  The
// producers stage the cell's stream a chunk ahead of the chain into the
// second of two shared buffers, while the chain warps walk the first
// (one __syncthreads a chunk).  Per request they write one or two
// 16-byte words: the arrival, the row as float, the bank-state slot's
// offset (in (d) the global slot (ch*R + rank)*n_banks + bank from the
// cell's interleave code, int32 floored modulo and division as
// dram_sim.chan_rank), the flags (is_write, valid and, for a window other
// than 8, the ring slot's offset, k % mlp_window), and as needed the
// timing column's offset ((b) the bank; (c) with a shared map the
// resolved column map[bank * R + region_of(row, R)]; with a per-lane map
// the (bank, region) slot), (d) the channel's bus offset and (e) the
// request's uniform.  Past the chunk's end they pad to a multiple of 8
// requests, plus two, with invalid requests on slot 0.
//
// The chain warps keep only what carries.  The bank state (open_row,
// act_time, wr_done, ready) sits in shared memory as one float4 per
// [slot][lane] (a request's slot is data; a dynamically indexed
// per-thread array would spill), read and written by one 16-byte access.
// Step k loads request k+2's words and request k+1's state, timing row,
// ring gate and bus into registers, so those loads land while step k
// computes.  A load issued during step k sees every earlier step's store
// but not step k's own, so step k+1 takes step k's registers instead
// where it names the same slot (or channel; or, at mlp_window 1, the same
// ring slot) and step k was valid: forwarding, one select on the chain.
// An invalid request stores nothing and forwards nothing.  With
// mlp_window == 8, its own instantiation, the loop runs in groups of 8
// steps, unrolled, chunks being multiples of 8, so ring slot k % 8 is a
// register; other windows keep the ring in shared memory.
//
// Timing rows: (a) and (e) hold the lane's row in registers.  (b) and (c)
// stage the lane's [n_cols][5] values in shared memory ([col][lane] as a
// float4 and a float) when they fit beside the buffers (`plan`), else
// read them through the read-only path; either way a step ahead.  A
// per-lane map resolves its column on the chain warp, a step ahead.
//
// No branch inside a group of steps: a branch cuts the unrolled steps
// into blocks the compiler schedules one at a time, so the next step's
// independent work no longer overlaps this one's chain.  So the timing
// source (module row, staged tile, read-only tile), a per-lane map, the
// fault loop, the channel state and the register ring are each compiled
// into their own instantiation, and the ragged tail's latency stores are
// predicated (`store_if`), not branched around.
//
// (e) and faulted (d): the served row is the lane's own or JEDEC, so the
// error probability and its detected threshold take two values a lane;
// they are computed once, before the loop, with the same float
// operations as faults::error_outcome (bit for bit the same).  Each step
// keeps the probe gate, the served-row select, the draw's two compares,
// a detected error's retry surcharge (JEDEC tCL + RETRY_NS on the
// completion, the latency, a write's recovery and the bank's readiness,
// as `dram_sim._service(surcharge=...)`), the watchdog's transition
// (`StaticWd`: faults::wd_update without implausibility, each test one
// compare against a lane threshold) and the counters.
// (d): the gate is fmaxf(ring, bus[ch]); a valid request leaves the bus
// busy until (done - tCL) + t_burst.  The timing gather of (b) and (c)
// stays on the rank-level bank.
//
// Numerics.  Each request runs `service_math` (dram_sim.py) operation for
// operation: float32 add, max and select only, no multiply (the build
// turns off FMA contraction anyway), so `lat`, `total` and the counters
// are bitwise the plain version's.  `open_row` is kept in float32 as in
// the Pallas kernel (row ids stay far below 2^24).  The ring slot is the
// request's position k modulo mlp_window, which equals the reference's
// served-request counter because padding is a suffix (the wrapper checks
// it).

#include <climits>
#include <cuda_runtime.h>

#include "faults.cuh"

namespace {

constexpr int kMaxLanes = 128;       // chain lanes per block (4 warps)
constexpr int kProducerWarps = 2;    // stream-staging warps per block
constexpr int kProducers = kProducerWarps * 32;
constexpr int kGroup = 8;            // unrolled steps; the register ring
constexpr int kSlack = 8;            // entries past a chunk (pad + 2)
constexpr int kMaxChunk = 512;       // requests per buffer, at most
constexpr int kMinChunk = 64;        // least chunk of a plan
constexpr int kMinStagedChunk = 128; // least chunk worth staging tiles for
constexpr int kSubarrayRows = 512;   // dram_sim.SUBARRAY_ROWS
constexpr int kSmemLimit = 232448;   // shared memory of one Hopper block

// int32 floored modulo and division by a positive m (Python's % and //)
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}
__device__ __forceinline__ int floor_div(int a, int m) {
  return (a - floor_mod(a, m)) / m;
}

// word 0 of a request: arrival, row, slot offset, flags; word 1: timing
// column (offset, or a per-lane map's slot), bus offset, uniform
constexpr int kWrite = 1, kValid = 2, kRingShift = 2;

struct Tim {
  float rcd, ras, wr, rp, cl;
};

// The watchdog of static replay: faults::wd_probe and faults::wd_update
// with no implausibility (its run stays 0, so only the error budget
// trips), each test one compare against a lane threshold (a count <= 0,
// which disables its test, becomes INT_MAX).  It also steps through
// padding: padding is a suffix and the final state is not an output,
// so only the counters need the valid flag.
struct StaticWd {
  int err = 0, clean = 0, probe_cnt = 0, tripped = 0;
  int err_n, probe_m1, recover_n;     // thresholds

  __device__ explicit StaticWd(const faults::Row& f)
      : err_n(f.err_n > 0 ? f.err_n : INT_MAX),
        probe_m1(f.probe_n > 0 ? f.probe_n - 1 : INT_MAX),
        recover_n(f.recover_n > 0 ? f.recover_n : INT_MAX) {}

  __device__ __forceinline__ bool probe() const {
    return tripped != 0 && probe_cnt >= probe_m1;
  }

  // returns new_trip
  __device__ __forceinline__ bool update(bool det, bool is_probe) {
    const int err1 = err + (det ? 1 : 0);
    const bool trip_now = err1 >= err_n;
    const bool new_trip = tripped == 0 && trip_now;
    const int tr1 = trip_now ? 1 : tripped;
    const int clean1 = is_probe ? (det ? 0 : clean + 1) : clean;
    const bool recover = tr1 != 0 && clean1 >= recover_n;
    err = recover ? 0 : err1;
    clean = recover ? 0 : clean1;
    tripped = recover ? 0 : tr1;
    probe_cnt = tripped != 0 ? (is_probe ? 0 : probe_cnt + 1) : 0;
    return new_trip;
  }
};

struct Stream {
  const float* __restrict__ arrival;
  const int* __restrict__ bank;
  const int* __restrict__ row;
  const int* __restrict__ is_write;
  const int* __restrict__ valid;
  const float* __restrict__ uniforms;
  const int* __restrict__ region_map;
};

struct Geo {
  int bs, n_banks, mlp_window, n_regions, n_channels, n_ranks, il, col_mul;
};

// A store that is predicated, not branched around: a branch would cut
// the unrolled steps into blocks the compiler schedules one by one.
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q st.global.f32 [%0], %1;\n\t}" ::"l"(p),
      "f"(v), "r"((int)pred));
}

// Requests [k0, k0 + len) of a cell (`cell` = g * n) into one buffer, by
// producer p of kProducers; entries [len, round8(len) + 2) are padding.
template <bool kGathered, bool kLaneMap, bool kFaulted, bool kMulti,
          bool kRing8>
__device__ __forceinline__ void produce(int p, float4* buf, int cs,
                                        long long cell, int k0, int len,
                                        const Stream& in, const Geo& geo) {
  constexpr bool kTwo = kGathered || kFaulted || kMulti;
  const int lp = (len + kGroup - 1) & ~(kGroup - 1);
  for (int i = p; i < lp + 2; i += kProducers) {
    float4 w0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 w1 = w0;
    if (i < len) {
      const long long q = cell + k0 + i;
      const int b = in.bank[q], r = in.row[q];
      int slot = b, ch = 0;
      if constexpr (kMulti) {       // dram_sim.chan_rank
        const int nc = geo.n_channels;
        ch = geo.il == 0   ? floor_mod(r, nc)
             : geo.il == 1 ? floor_mod(r * geo.n_banks + b, nc)
                           : floor_mod(b ^ r, nc);
        const int rank = floor_mod(floor_div(r, nc), geo.n_ranks);
        slot = (ch * geo.n_ranks + rank) * geo.n_banks + b;
      }
      const int ring = kRing8 ? 0 : (k0 + i) % geo.mlp_window;
      w0.x = in.arrival[q];
      w0.y = (float)r;
      w0.z = __int_as_float(slot * geo.bs);
      w0.w = __int_as_float((in.is_write[q] != 0 ? kWrite : 0) |
                            (in.valid[q] != 0 ? kValid : 0) |
                            ((ring * geo.bs) << kRingShift));
      if constexpr (kGathered) {
        int col = b * geo.col_mul;
        if (geo.n_regions > 0) {    // dram_sim.region_of, floored modulo
          const int rs = b * geo.n_regions +
                         floor_mod(r, kSubarrayRows) * geo.n_regions /
                             kSubarrayRows;
          col = kLaneMap ? rs : in.region_map[rs] * geo.col_mul;
        }
        w1.x = __int_as_float(col);
      }
      if constexpr (kMulti) w1.y = __int_as_float(ch * geo.bs);
      if constexpr (kFaulted) w1.z = in.uniforms[q];
    }
    buf[i] = w0;
    if constexpr (kTwo) buf[cs + i] = w1;
  }
}

// kTim: where a step's timing row comes from — 0 the lane's module row
// in registers, 1 the tile staged in shared memory, 2 the tile through
// the read-only path; kLaneMap: a per-lane region map, resolved on the
// chain warp.
template <int kTim, bool kLaneMap, bool kFaulted, bool kMulti, bool kRing8>
__global__ void __launch_bounds__(kMaxLanes + kProducers, 2)
replay_kernel(const float* __restrict__ closed,
              const float* __restrict__ arrival,
              const int* __restrict__ bank, const int* __restrict__ row,
              const int* __restrict__ is_write,
              const int* __restrict__ valid,
              const float* __restrict__ timings,
              const int* __restrict__ region_map,
              const float* __restrict__ fault,
              const float* __restrict__ jedec,
              const float* __restrict__ uniforms,
              const int* __restrict__ ileave, float* __restrict__ lat,
              float* __restrict__ total, int* __restrict__ counters, int n,
              int s_rows, int n_banks, int mlp_window, int n_cols,
              int n_regions, int n_channels, int n_ranks, float t_burst,
              int chunk) {
  constexpr bool kGathered = kTim != 0;
  constexpr bool kStaged = kTim == 1;
  constexpr bool kTwo = kGathered || kFaulted || kMulti;
  extern __shared__ float4 smem[];
  const int bs = blockDim.x - kProducers;   // chain lanes of a block
  const int tid = threadIdx.x;
  const int lane = tid;
  const int g = blockIdx.x;
  const int l0 = blockIdx.y * bs;
  const int cl = min(bs, s_rows - l0);      // live lanes of this block
  const int s = l0 + lane;
  const bool is_chain = tid < bs;
  const bool live = is_chain && lane < cl;

  // shared layout: [state n_slots x bs float4][2 buffers x (1|2) x cs
  // float4][staged tile: n_cols x bs float4, n_cols x bs float]
  // [ring W x bs (W != 8)][bus C x bs (d)]
  const int n_slots = kMulti ? n_channels * n_ranks * n_banks : n_banks;
  const int cs = chunk + kSlack;
  const int buf_len = (kTwo ? 2 : 1) * cs;
  float4* st = smem;
  float4* bufs = st + n_slots * bs;
  const int tile = kStaged ? n_cols * bs : 0;
  float4* tim4 = bufs + 2 * buf_len;
  float* tim_cl = reinterpret_cast<float*>(tim4 + tile);
  float* st_ring = tim_cl + tile;
  float* st_bus = st_ring + (kRing8 ? 0 : mlp_window * bs);

  if (is_chain) {
    for (int b = 0; b < n_slots; ++b)
      st[b * bs + lane] = make_float4(-1.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (!kRing8)
      for (int w = 0; w < mlp_window; ++w) st_ring[w * bs + lane] = 0.0f;
    if constexpr (kMulti)
      for (int c = 0; c < n_channels; ++c) st_bus[c * bs + lane] = 0.0f;
  }
  if (kStaged) {   // [col][lane] <- [col][6][S], lanes l0..
    for (int i = tid; i < n_cols * cl; i += blockDim.x) {
      const int c = i / cl, j = i - c * cl;
      const float* tp = timings + (long long)c * 6 * s_rows + l0 + j;
      tim4[c * bs + j] = make_float4(tp[0], tp[s_rows], tp[2 * s_rows],
                                     tp[3 * s_rows]);
      tim_cl[c * bs + j] = tp[5 * s_rows];
    }
  }
  const Stream in{arrival, bank, row, is_write, valid, uniforms,
                  region_map};
  const Geo geo{bs, n_banks, mlp_window, n_regions, n_channels, n_ranks,
                kMulti ? ileave[g] : 0, kStaged ? bs : 6 * s_rows};
  const long long cell = (long long)g * n;
  if (!is_chain)                             // the first chunk
    produce<kGathered, kLaneMap, kFaulted, kMulti, kRing8>(
        tid - bs, bufs, cs, cell, 0, min(chunk, n), in, geo);

  // the lane's constants
  const bool is_closed = closed[g] > 0.5f;
  float trcd = 0.f, tras = 0.f, twr = 0.f, trp = 0.f, tcl = 0.f;
  if (live && !kGathered) {
    trcd = timings[0 * s_rows + s];
    tras = timings[1 * s_rows + s];
    twr = timings[2 * s_rows + s];
    trp = timings[3 * s_rows + s];
    tcl = timings[5 * s_rows + s];
  }
  faults::Row fr{};
  faults::Counters cnt;
  float j_trcd = 0.f, j_tras = 0.f, j_twr = 0.f, j_trp = 0.f, j_tcl = 0.f;
  // error probability and detected threshold, own row and JEDEC row
  float p_own = 0.f, pd_own = 0.f, p_jed = 0.f, pd_jed = 0.f, sur_c = 0.f;
  if constexpr (kFaulted) {
    if (live) fr = faults::load_row(fault, s_rows, s);
    j_trcd = jedec[0];
    j_tras = jedec[1];
    j_twr = jedec[2];
    j_trp = jedec[3];
    j_tcl = jedec[5];
    const float jsum = ((j_trcd + j_tras) + j_twr) + j_trp;
    p_own = faults::error_prob(
        fr, faults::reduction(trcd, tras, twr, trp, jsum), 0.0f);
    p_jed = faults::error_prob(
        fr, faults::reduction(j_trcd, j_tras, j_twr, j_trp, jsum), 0.0f);
    pd_own = p_own * fr.det_frac;
    pd_jed = p_jed * fr.det_frac;
    sur_c = j_tcl + fr.retry_ns;
  }
  StaticWd wd(fr);
  const int col_mul = geo.col_mul;
  // the five timings of a step's column: staged (shared) or read-only
  auto tim_of = [&](const float4& x) -> Tim {
    int col = __float_as_int(x.x);
    if constexpr (kLaneMap)
      col = __ldg(region_map + (long long)col * s_rows + s) * col_mul;
    if constexpr (kStaged) {
      const float4 a = tim4[col + lane];
      return {a.x, a.y, a.z, a.w, tim_cl[col + lane]};
    } else {
      const float* p = timings + col + s;
      return {__ldg(p), __ldg(p + s_rows), __ldg(p + 2 * s_rows),
              __ldg(p + 3 * s_rows), __ldg(p + 5 * s_rows)};
    }
  };

  // carried across steps: the register ring (mlp_window 8) and the
  // previous step's stores, forwarded to a step whose loads missed them
  float ring[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) ring[j] = 0.0f;
  float4 pst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int pkey = -1, pbus = -1;
  bool pv = false;
  float pdone = 0.0f, pbusv = 0.0f;
  __syncthreads();                           // staged tile, chunk 0

  for (int c = 0, k0 = 0; k0 < n; ++c, k0 += chunk) {
    const int len = min(chunk, n - k0);
    const float4* B = bufs + (c & 1) * buf_len;
    if (!is_chain) {
      if (k0 + chunk < n)                    // the next chunk
        produce<kGathered, kLaneMap, kFaulted, kMulti, kRing8>(
            tid - bs, bufs + ((c + 1) & 1) * buf_len, cs, cell, k0 + chunk,
            min(chunk, n - k0 - chunk), in, geo);
    } else if (live) {
      const int lp = (len + kGroup - 1) & ~(kGroup - 1);
      const float4* B1 = B + cs;
      float* lat_q = lat + (cell + k0) * s_rows + s;
      // requests 0 and 1's words, request 0's state and operands
      float4 q0 = B[0], q1 = B[1];
      float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
      if constexpr (kTwo) {
        x0 = B1[0];
        x1 = B1[1];
      }
      float4 s0 = st[__float_as_int(q0.z) + lane];
      Tim tm0{};
      if constexpr (kGathered) tm0 = tim_of(x0);
      float g0 = 0.0f, b0 = 0.0f;
      if constexpr (!kRing8)
        g0 = st_ring[(__float_as_int(q0.w) >> kRingShift) + lane];
      if constexpr (kMulti) b0 = st_bus[__float_as_int(x0.y) + lane];

      for (int i0 = 0; i0 < lp; i0 += kGroup) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int i = i0 + j;
          // a step ahead: request i+2's words, request i+1's state,
          // timing row, ring gate and bus (they miss only step i's
          // stores, forwarded below at step i+1)
          const float4 q2 = B[i + 2];
          float4 x2 = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (kTwo) x2 = B1[i + 2];
          const float4 s1 = st[__float_as_int(q1.z) + lane];
          Tim tm1{};
          if constexpr (kGathered) tm1 = tim_of(x1);
          float g1 = 0.0f, b1 = 0.0f;
          if constexpr (!kRing8)
            g1 = st_ring[(__float_as_int(q1.w) >> kRingShift) + lane];
          if constexpr (kMulti) b1 = st_bus[__float_as_int(x1.y) + lane];

          // step i: forward step i-1's stores its loads missed
          const int key = __float_as_int(q0.z);
          const int fl = __float_as_int(q0.w);
          const bool v = (fl & kValid) != 0;
          const bool w = (fl & kWrite) != 0;
          const float t = q0.x, rf = q0.y;
          const float4 sb = (pv && key == pkey) ? pst : s0;
          float gate;
          if constexpr (kRing8)
            gate = ring[j];
          else
            gate = (pv && mlp_window == 1) ? pdone : g0;
          int busk = 0;
          if constexpr (kMulti) {
            busk = __float_as_int(x0.y);
            gate = fmaxf(gate, (pv && busk == pbus) ? pbusv : b0);
          }
          if constexpr (kGathered) {
            trcd = tm0.rcd;
            tras = tm0.ras;
            twr = tm0.wr;
            trp = tm0.rp;
            tcl = tm0.cl;
          }

          // the served row: the lane's own, or JEDEC while the watchdog
          // is tripped (except on a probe); the error draw and its price
          float c_rcd = trcd, c_ras = tras, c_wr = twr, c_rp = trp;
          float c_cl = tcl;
          bool is_probe = false, det = false, sil = false;
          float sur = 0.0f;
          if constexpr (kFaulted) {
            is_probe = wd.probe();
            const bool own = wd.tripped == 0 || is_probe;
            c_rcd = own ? trcd : j_trcd;
            c_ras = own ? tras : j_tras;
            c_wr = own ? twr : j_twr;
            c_rp = own ? trp : j_trp;
            c_cl = own ? tcl : j_tcl;
            const float u = x0.z;
            const bool err = u < (own ? p_own : p_jed);
            det = err && u < (own ? pd_own : pd_jed);
            sil = err && !det;
            sur = det ? sur_c : 0.0f;
          }

          // service_math (dram_sim.py), operation for operation
          const float open_b = sb.x, act_b = sb.y, wrd_b = sb.z;
          const float rdy_b = sb.w;
          const float start = fmaxf(fmaxf(t, rdy_b), gate);
          const bool is_hit = open_b == rf;
          const bool is_empty = open_b == -1.0f;
          const float pre_ok = fmaxf(act_b + c_ras, wrd_b);
          const float conflict_start = fmaxf(start, pre_ok);
          const float act_new =
              is_hit ? act_b
                     : (is_empty ? start + 0.0f : conflict_start + c_rp);
          const float data_start =
              is_hit ? start
                     : (is_empty ? start + c_rcd
                                 : (conflict_start + c_rp) + c_rcd);
          float done = data_start + c_cl;
          float wrd_new = w ? done + c_wr : wrd_b;
          const float pre_start =
              fmaxf(fmaxf(done, act_new + c_ras), wrd_new);
          float ready_new = is_closed ? pre_start + c_rp : done;
          const float latched = is_closed ? -1.0f : rf;
          float lat_v = done - fmaxf(t, gate);
          if constexpr (kFaulted) {     // the retry surcharge
            done = done + sur;
            lat_v = lat_v + sur;
            wrd_new = w ? wrd_new + sur : wrd_new;
            ready_new = ready_new + sur;
          }
          const float4 ns = make_float4(latched, act_new, wrd_new, ready_new);
          // the bus stays busy for t_burst from the burst start
          const float busv = (done - c_cl) + t_burst;

          if (v) {
            st[key + lane] = ns;
            if constexpr (kRing8)
              ring[j] = done;
            else
              st_ring[(fl >> kRingShift) + lane] = done;
            if constexpr (kMulti) st_bus[busk + lane] = busv;
          }
          if constexpr (kFaulted) {
            const bool degraded = wd.tripped != 0;
            const bool new_trip = wd.update(det, is_probe);
            faults::count(cnt, v && det, v && sil, v && new_trip,
                          v && degraded, v && is_probe);
          }
          store_if(lat_q, v ? lat_v : 0.0f, i < len);
          lat_q += s_rows;

          pst = ns;
          pkey = key;
          pv = v;
          pdone = done;
          pbus = busk;
          pbusv = busv;
          q0 = q1;
          q1 = q2;
          x0 = x1;
          x1 = x2;
          s0 = s1;
          tm0 = tm1;
          g0 = g1;
          b0 = b1;
        }
      }
    }
    __syncthreads();     // chunk c walked, chunk c + 1 staged
  }

  if (live) {
    float rdy_max = st[lane].w, wrd_max = st[lane].z;
    for (int b = 1; b < n_slots; ++b) {
      rdy_max = fmaxf(rdy_max, st[b * bs + lane].w);
      wrd_max = fmaxf(wrd_max, st[b * bs + lane].z);
    }
    total[(long long)g * s_rows + s] = fmaxf(rdy_max, wrd_max);
    if constexpr (kFaulted)
      faults::store(cnt, counters, (long long)gridDim.x * s_rows,
                    (long long)g * s_rows + s);
  }
}

// Chain lanes of a block: the lanes rounded up to a warp, at most
// kMaxLanes or the caller's cap (32, 64 or 128; 0 keeps kMaxLanes).  Lanes
// are independent, so the block size changes no output.
int block_lanes(int s_rows, int cap) {
  const int top = cap > 0 ? cap : kMaxLanes;
  return s_rows < top ? ((s_rows + 31) / 32) * 32 : top;
}

bool valid_cap(int cap) {
  return cap == 0 || cap == 32 || cap == 64 || cap == kMaxLanes;
}

// The launch plan: the chunk of requests per buffer and whether the
// timing tile is staged, from the shared memory each needs.
struct Plan {
  int chunk, staged;
  long long smem;
};

long long smem_bytes(int bs, int n_slots, int ring_words, int bus_words,
                     int chunk, bool two_words, long long tile_cols) {
  return 16LL * n_slots * bs + 2LL * 16 * (two_words ? 2 : 1) *
                                   (chunk + kSlack) +
         20LL * tile_cols * bs + 4LL * (ring_words + bus_words) * bs;
}

Plan plan(int s_rows, int n_slots, int n_cols, int mlp_window, int n_bus,
          bool two_words, int cap) {
  const int bs = block_lanes(s_rows, cap);
  const int ring = mlp_window == kGroup ? 0 : mlp_window;
  for (int stage = n_cols > 0 ? 1 : 0; stage >= 0; --stage)
    for (int k = kMaxChunk; k >= (stage ? kMinStagedChunk : kMinChunk);
         k /= 2) {
      const long long b = smem_bytes(bs, n_slots, ring, n_bus, k, two_words,
                                     stage ? n_cols : 0);
      if (b <= kSmemLimit) return {k, stage, b};
    }
  return {0, 0, 0};
}

template <int kTim, bool kLaneMap, bool kFaulted, bool kMulti>
auto pick_ring(bool ring8) {
  return ring8 ? replay_kernel<kTim, kLaneMap, kFaulted, kMulti, true>
               : replay_kernel<kTim, kLaneMap, kFaulted, kMulti, false>;
}

// the instantiation for a variant: the timing source (module row, staged
// or read-only tile), a per-lane map, the fault loop, the channel state
// and the register ring are compiled in, so (a) pays nothing for the
// others and C*R == 1 launches (a)-(c), (e)
template <bool kMulti>
auto pick(bool faulted, int tim, bool lane_map, bool ring8) {
  return faulted     ? pick_ring<0, false, true, kMulti>(ring8)
         : tim == 0  ? pick_ring<0, false, false, kMulti>(ring8)
         : tim == 1  ? (lane_map ? pick_ring<1, true, false, kMulti>(ring8)
                                 : pick_ring<1, false, false, kMulti>(ring8))
                     : (lane_map ? pick_ring<2, true, false, kMulti>(ring8)
                                 : pick_ring<2, false, false, kMulti>(ring8));
}

}  // namespace

// The least shared memory of a block at this geometry: the bank state,
// the ring and bus rows and two buffers of the least chunk, no staged
// tile.  A geometry over the card's 227 KB cannot launch.
extern "C" int replay_smem_bytes(int s_rows, int n_banks, int mlp_window,
                                 int faulted, int n_channels, int n_ranks,
                                 int max_lanes) {
  (void)faulted;
  const bool multi = n_channels * n_ranks > 1;
  const long long b = smem_bytes(
      block_lanes(s_rows, max_lanes),
      multi ? n_channels * n_ranks * n_banks : n_banks,
      mlp_window == kGroup ? 0 : mlp_window, multi ? n_channels : 0,
      kMinChunk, true, 0);
  return b > 0x7fffffff ? 0x7fffffff : (int)b;
}

// C interface (ctypes).  Returns the cudaError_t of the launch (0 =
// success); the kernel runs asynchronously on `stream` (a cudaStream_t).
// n_cols is 0 for module rows [6, S], else the tile's leading extent
// (n_banks for the per-bank tile, U for the region store).  region_map
// may be NULL when n_regions is 0 (variants a, b and e); fault, jedec,
// uniforms and counters are all NULL or all given (module rows only);
// ileave is read only when n_channels * n_ranks > 1 (variant d).
// max_lanes caps the chain lanes of a block (32, 64 or 128; 0 keeps the
// default, block_lanes).
extern "C" int replay_launch(const float* closed, const float* arrival,
                             const int* bank, const int* row,
                             const int* is_write, const int* valid,
                             const float* timings, const int* region_map,
                             const float* fault, const float* jedec,
                             const float* uniforms, const int* ileave,
                             float* lat, float* total, int* counters, int g,
                             int n, int s_rows, int n_banks, int mlp_window,
                             int n_cols, int n_regions, int map_per_lane,
                             int n_channels, int n_ranks, float t_burst,
                             int max_lanes, void* stream) {
  const bool faulted = fault != nullptr;
  const bool multi = n_channels * n_ranks > 1;
  const bool gathered = n_cols > 0;
  if (g <= 0 || n <= 0 || s_rows <= 0 || n_banks <= 0 || mlp_window <= 0 ||
      n_cols < 0 || n_regions < 0 ||
      (n_regions > 0 && (!gathered || region_map == nullptr)) ||
      (faulted && (gathered || jedec == nullptr || uniforms == nullptr ||
                   counters == nullptr)) ||
      n_channels <= 0 || n_ranks <= 0 || (multi && ileave == nullptr) ||
      (long long)n_cols * 6 * s_rows > 0x7fffffffLL ||
      (long long)mlp_window * kMaxLanes * 4 > 0x7fffffffLL ||
      !valid_cap(max_lanes))
    return (int)cudaErrorInvalidValue;
  const int bs = block_lanes(s_rows, max_lanes);
  const int n_slots = multi ? n_channels * n_ranks * n_banks : n_banks;
  const Plan pl = plan(s_rows, n_slots, n_cols, mlp_window,
                       multi ? n_channels : 0, gathered || faulted || multi,
                       max_lanes);
  if (pl.chunk == 0) return (int)cudaErrorInvalidValue;
  const int tim = !gathered ? 0 : pl.staged ? 1 : 2;
  const bool lane_map = n_regions > 0 && map_per_lane;
  const bool ring8 = mlp_window == kGroup;
  auto kern = multi ? pick<true>(faulted, tim, lane_map, ring8)
                    : pick<false>(faulted, tim, lane_map, ring8);
  if (pl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int gy = (s_rows + bs - 1) / bs;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)g, (unsigned)gy);
  kern<<<grid, bs + kProducers, pl.smem, (cudaStream_t)stream>>>(
      closed, arrival, bank, row, is_write, valid, timings, region_map, fault,
      jedec, uniforms, ileave, lat, total, counters, n, s_rows, n_banks,
      mlp_window, n_cols, n_regions, n_channels, n_ranks, t_burst,
      pl.chunk);
  return (int)cudaGetLastError();
}

// The launch plan of `replay_launch` for these sizes: out[0] chunk
// length (0: no plan fits), out[1] tile staged, out[2] shared bytes,
// out[3] threads per block, out[4] chain lanes per block.
extern "C" void replay_plan(int s_rows, int n_banks, int mlp_window,
                            int n_cols, int faulted, int n_channels,
                            int n_ranks, int max_lanes, int* out) {
  const bool multi = n_channels * n_ranks > 1;
  const Plan pl = plan(
      s_rows, multi ? n_channels * n_ranks * n_banks : n_banks, n_cols,
      mlp_window, multi ? n_channels : 0, n_cols > 0 || faulted || multi,
      max_lanes);
  out[0] = pl.chunk;
  out[1] = pl.staged;
  out[2] = (int)pl.smem;
  out[3] = block_lanes(s_rows, max_lanes) + kProducers;
  out[4] = block_lanes(s_rows, max_lanes);
}

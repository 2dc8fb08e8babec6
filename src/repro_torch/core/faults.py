"""In-scan fault injection for the replay (port of `repro.core.faults`).

AL-DRAM's safety argument trusts two inputs: the sensed module
temperature (which picks the timing bin) and the profiled margins
(which picked the rows).  This module makes both faultable inside the
replay launch:

  * sensor faults — stuck-at, additive drift, bounded noise,
    quantization, first-order sensing lag and dropout (the sensor
    repeats its last reading), applied to the sensed temperature
    before the adaptive replay selects its bin;
  * transient read errors — a margin-conditioned per-request error
    probability (the further the served row sits below the JEDEC timing
    sum, and the further the true temperature sits above the served
    bin's edge, the likelier).  A detected error re-issues the request
    at the JEDEC row (`RETRY_NS` on top of the JEDEC tCL, priced into
    the latency and the bank state); an undetected one is counted as a
    silent corruption;
  * the watchdog — a cumulative detected-error budget and a consecutive
    sensor-implausibility counter trip a sticky degradation to the JEDEC
    row; every `WD_PROBE`-th degraded request probes the adaptive row
    and `WD_RECOVER_N` consecutive clean probes recover.  Because the
    error budget resets only on a recovery, a watchdog replay holds

        detected <= wd_err_n * (trips + 1) + probes

    exactly.

`FaultSpec` is a campaign axis (`sim_engine.SimSpec(faults=...)`).  The
functions below are plain elementwise tensor code over an indexable
fault row `fp` (``fp[col]`` a scalar, or an [L] lane row of an
[F_COLS, L] tile), shared by the plain replays in `dram_sim`; the CUDA
kernels repeat them operation for operation (`kernels/replay/
faults.cuh`).

The error uniforms are a [T, N] float32 draw per campaign
(`fault_uniforms`), positional by issue order and shared by every lane
of a trace row.  They come from a `torch.Generator`, so they follow the
reference's distribution, not its threefry bits; a caller that needs
the reference's bits passes them in (`SimEngine.run(fault_uniforms=)`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------- layout
# fault-row column indices (`FaultScenario.as_row()` packs them)
STUCK_C = 0        # stuck-at reading (C); active once t >= STUCK_FROM
STUCK_FROM = 1     # ns; < 0 = stuck-at disabled
DRIFT = 2          # additive sensor drift (C per ns)
NOISE = 3          # bounded additive noise amplitude (C, uniform +-)
QUANT = 4          # quantization step (C); 0 = off
LAG_TAU = 5        # first-order sensing-lag time constant (ns); 0 = off
DROP_P = 6         # per-request dropout probability (repeat last)
ERR_SCALE = 7      # error prob per unit of timing reduction beyond
ERR_FREE = 8       # ... this error-free reduction margin
ERR_BIN_C = 9      # error prob per C of true-temp excess over the bin
DET_FRAC = 10      # fraction of errors the ECC detects (rest silent)
RETRY_NS = 11      # detected-error retry surcharge on top of JEDEC tCL
WD_ERR_N = 12      # detected-error budget per serving period; 0 = off
WD_JUMP_C = 13     # implausible per-request reading jump (C); 0 = off
WD_SENSE_N = 14    # consecutive implausible readings to trip; 0 = off
WD_PROBE = 15      # probe every k-th degraded request; 0 = no probes
WD_RECOVER_N = 16  # consecutive clean probes to recover; 0 = never
SEED = 17          # per-scenario noise/dropout hash seed
F_COLS = 18

ERR_CAP = 0.95     # error-probability ceiling (a retry must terminate)
NO_READING = -1.0e9   # sensor-state sentinel: no previous reading yet
N_COUNTERS = 5     # detected, silent, trips, degraded, probes


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One fault-injection scenario — one row of the fault axis.  Every
    default is inert: `FaultScenario()` senses perfectly, never errors
    and never trips."""

    name: str = "none"
    # sensor faults
    stuck_c: float = 0.0
    stuck_from_ns: float = -1.0
    drift_c_per_ns: float = 0.0
    noise_c: float = 0.0
    quant_c: float = 0.0
    lag_tau_ns: float = 0.0
    dropout_p: float = 0.0
    # transient read errors
    err_scale: float = 0.0
    err_free_red: float = 0.05
    err_bin_c: float = 0.0
    detect_frac: float = 1.0
    retry_ns: float = 50.0
    # watchdog
    wd_err_n: int = 0
    wd_jump_c: float = 0.0
    wd_sense_n: int = 0
    wd_probe: int = 0
    wd_recover_n: int = 0
    seed: int = 0

    def as_row(self) -> np.ndarray:
        """[F_COLS] float32 packed row."""
        r = np.zeros((F_COLS,), np.float32)
        r[STUCK_C] = self.stuck_c
        r[STUCK_FROM] = self.stuck_from_ns
        r[DRIFT] = self.drift_c_per_ns
        r[NOISE] = self.noise_c
        r[QUANT] = self.quant_c
        r[LAG_TAU] = self.lag_tau_ns
        r[DROP_P] = self.dropout_p
        r[ERR_SCALE] = self.err_scale
        r[ERR_FREE] = self.err_free_red
        r[ERR_BIN_C] = self.err_bin_c
        r[DET_FRAC] = self.detect_frac
        r[RETRY_NS] = self.retry_ns
        r[WD_ERR_N] = self.wd_err_n
        r[WD_JUMP_C] = self.wd_jump_c
        r[WD_SENSE_N] = self.wd_sense_n
        r[WD_PROBE] = self.wd_probe
        r[WD_RECOVER_N] = self.wd_recover_n
        r[SEED] = self.seed
        return r

    @property
    def is_inert(self) -> bool:
        """True when this scenario can never perturb the replay."""
        return (self.stuck_from_ns < 0 and self.drift_c_per_ns == 0
                and self.noise_c == 0 and self.quant_c == 0
                and self.lag_tau_ns == 0 and self.dropout_p == 0
                and self.err_scale == 0 and self.err_bin_c == 0
                and self.wd_err_n == 0 and self.wd_sense_n == 0)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """The fault axis of a campaign: `FaultScenario` rows replayed
    against every (trace, policy, timing, thermal) cell of a
    `sim_engine.SimSpec` in the same launch.  `seed` seeds the error
    uniforms (`fault_uniforms`)."""

    scenarios: tuple[FaultScenario, ...] = (FaultScenario(),)
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        if not self.scenarios:
            raise ValueError("FaultSpec needs at least one scenario")
        for s in self.scenarios:
            if not isinstance(s, FaultScenario):
                raise TypeError(f"FaultSpec rows must be FaultScenario, "
                                f"got {type(s).__name__}")

    @classmethod
    def none(cls) -> "FaultSpec":
        """The no-fault spec: one inert row.  The engine replays it
        through the unfaulted launch (no faulted kernel runs)."""
        return cls()

    def __len__(self) -> int:
        return len(self.scenarios)

    @property
    def is_none(self) -> bool:
        """True when every row is inert."""
        return all(s.is_inert for s in self.scenarios)

    def pack(self) -> np.ndarray:
        """[F, F_COLS] float32 scenario rows."""
        return np.stack([s.as_row() for s in self.scenarios])

    def names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.scenarios)


def fault_uniforms(seed: int, n_traces: int, n: int,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """[T, N] float32 error uniforms in [0, 1): one issue-order stream
    per trace row, shared by every lane of that row, drawn from a
    `torch.Generator` on `device` seeded with `seed` (the card unless
    the caller asks for the CPU; a generator on another device draws
    other bits)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return torch.rand((n_traces, n), generator=gen, dtype=torch.float32,
                      device=dev)


def hash01(seed, k):
    """Deterministic per-request uniform-ish hash in [0, 1) (the
    fract-sin mix of the reference): the in-loop sensor noise and
    dropout draws.  `seed` (float32) broadcasts against the request
    counter `k` (an integer tensor)."""
    x = torch.sin(k.to(torch.float32) * 12.9898 + seed * 78.233
                  + 0.5) * 43758.5453
    return x - torch.floor(x)


def fault_sensor(fp, t, dt, raw, lag_prev, held_prev, k):
    """One faulted temperature reading.

    fp: indexable fault row; t: request arrival (ns); dt: inter-arrival
    gap; raw: the true sensed temperature; lag_prev / held_prev: the
    carried sensor state (`NO_READING` before the first reading); k:
    integer request counter (tensor).  Returns (reading, lag_new,
    held_new); every stage is inert at the `FaultScenario` defaults."""
    # first-order sensing lag toward the true temperature
    tau = fp[LAG_TAU]
    decay = torch.exp(-torch.clamp(dt, min=0.0)
                      / torch.clamp(tau, min=1e-9))
    alpha = torch.where(tau > 0.0, 1.0 - decay, 1.0)
    have_lag = lag_prev > 0.5 * NO_READING
    lagged = torch.where(have_lag, lag_prev + alpha * (raw - lag_prev), raw)
    r = torch.where(tau > 0.0, lagged, raw)
    # additive drift + bounded noise
    r = r + fp[DRIFT] * t
    r = r + fp[NOISE] * (2.0 * hash01(fp[SEED], k) - 1.0)
    # stuck-at overrides everything once active
    r = torch.where((fp[STUCK_FROM] >= 0.0) & (t >= fp[STUCK_FROM]),
                    fp[STUCK_C], r)
    # dropout: the sensor repeats its last reported reading
    drop = hash01(fp[SEED] + 1.0, k) < fp[DROP_P]
    have_held = held_prev > 0.5 * NO_READING
    r = torch.where(drop & have_held, held_prev, r)
    # quantization last (the register the controller reads); round half
    # to even, as the reference
    q = torch.clamp(fp[QUANT], min=1e-9)
    r = torch.where(fp[QUANT] > 0.0, torch.round(r / q) * q, r)
    return r, lagged, r


def error_prob(fp, red, excess_c):
    """Margin-conditioned per-request error probability: `red` is the
    served row's fractional timing reduction against the JEDEC row
    (tRCD + tRAS + tWR + tRP), `excess_c` how far the true temperature
    sits above the served bin's upper edge (0 for the static replay and
    for the JEDEC row).  Clipped to `ERR_CAP`."""
    p = (fp[ERR_SCALE] * torch.clamp(red - fp[ERR_FREE], min=0.0)
         + fp[ERR_BIN_C] * excess_c)
    return torch.clamp(p, 0.0, ERR_CAP)


def error_draw(fp, u, p):
    """(errored, detected, silent) bool from one issue-order uniform."""
    err = u < p
    det = err & (u < p * fp[DET_FRAC])
    return err, det, err & ~det


def wd_state0(shape=(), *, device):
    """(wd_err, wd_bad, wd_clean, probe_cnt, tripped) int32 zeros."""
    return tuple(torch.zeros(shape, dtype=torch.int32, device=device)
                 for _ in range(5))


def wd_gate(fp, wd):
    """Pre-service watchdog gate of the current request: (is_probe,
    use_agg).  `use_agg` selects the adaptive row, else the JEDEC
    fallback; every `WD_PROBE`-th degraded request is a probe served at
    the adaptive row."""
    tripped, probe_cnt = wd[4], wd[3]
    probe_n = fp[WD_PROBE].to(torch.int32)
    is_probe = (tripped > 0) & (probe_n > 0) & (probe_cnt >= probe_n - 1)
    return is_probe, (tripped == 0) | is_probe


def wd_update(fp, wd, det, implaus, is_probe):
    """Post-service watchdog transition: (wd', new_trip).  The error
    budget is cumulative per serving period (reset only on a recovery),
    the implausibility counter consecutive, the trip sticky until
    `WD_RECOVER_N` consecutive clean probes."""
    wd_err, wd_bad, wd_clean, probe_cnt, tripped = wd
    z = torch.zeros_like(wd_err)
    wd_err = wd_err + det.to(torch.int32)
    wd_bad = torch.where(implaus, wd_bad + 1, z)
    err_n = fp[WD_ERR_N].to(torch.int32)
    sense_n = fp[WD_SENSE_N].to(torch.int32)
    trip_now = (((err_n > 0) & (wd_err >= err_n))
                | ((sense_n > 0) & (wd_bad >= sense_n)))
    new_trip = (tripped == 0) & trip_now
    tripped = torch.where(trip_now, 1, tripped).to(torch.int32)
    wd_clean = torch.where(is_probe, torch.where(det, z, wd_clean + 1),
                           wd_clean)
    rec_n = fp[WD_RECOVER_N].to(torch.int32)
    recover = (tripped > 0) & (rec_n > 0) & (wd_clean >= rec_n)
    wd_err = torch.where(recover, z, wd_err)
    wd_bad = torch.where(recover, z, wd_bad)
    wd_clean = torch.where(recover, z, wd_clean)
    tripped = torch.where(recover, z, tripped)
    probe_cnt = torch.where(tripped > 0,
                            torch.where(is_probe, z, probe_cnt + 1), z)
    return (wd_err, wd_bad, wd_clean, probe_cnt, tripped), new_trip


def counter_update(cnt, v, det, sil, new_trip, degraded, is_probe):
    """Accumulate the five fault counters (detected, silent, trips,
    degraded, probes), gated on request validity."""
    vi = v.to(torch.int32)
    return tuple(c + x.to(torch.int32) * vi
                 for c, x in zip(cnt, (det, sil, new_trip, degraded,
                                       is_probe)))


__all__ = ["FaultScenario", "FaultSpec", "F_COLS", "N_COUNTERS",
           "ERR_CAP", "NO_READING", "fault_uniforms", "hash01",
           "fault_sensor", "error_prob", "error_draw", "wd_state0",
           "wd_gate", "wd_update", "counter_update"]

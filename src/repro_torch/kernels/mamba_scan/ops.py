"""Wrapper of the selective-scan kernel.

CUDA tensors launch `mamba_scan.cu` (counted in `mamba_scan.launches`);
CPU tensors run the plain version (`ref.mamba_scan`) — chosen by the
tensors' device alone, and a CUDA tensor never falls back.  The kernel
reads x, dt, B and C through their batch and time strides (the last axis
contiguous), masks ragged T and di itself (no padding copy), takes an
optional initial state h0 and writes the final state (the decode
cache's); state dims 8 and 16, float32.  Decode calls it with T = 1 and
h0 from the cache.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ref

STATE_DIMS = (8, 16)      # jamba's and the reduced configs'


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    lib.mamba_scan_launch.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
    lib.mamba_scan_launch.restype = ctypes.c_int
    return lib


def _check(x, dt, bmat, cmat, a, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape or bmat.dim() != 3 \
            or cmat.shape != bmat.shape:
        raise ValueError(f"mamba_scan: x, dt [B, T, di] and B, C [B, T, ds], "
                         f"got {[tuple(t.shape) for t in (x, dt, bmat, cmat)]}")
    b, t, di = x.shape
    ds = bmat.shape[-1]
    if bmat.shape[:2] != x.shape[:2] or tuple(a.shape) != (di, ds) \
            or b < 1 or t < 1 or di < 1:
        raise ValueError(f"mamba_scan: B, T >= 1, B/C [B, T, ds] beside x "
                         f"{tuple(x.shape)} and A [di, ds], got B "
                         f"{tuple(bmat.shape)}, A {tuple(a.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, di, ds):
        raise ValueError(f"mamba_scan: h0 [B, di, ds] = {(b, di, ds)}, got "
                         f"{tuple(h0.shape)}")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None):
    """x, dt: [B, T, di]; bmat, cmat: [B, T, ds]; a: [di, ds]; h0
    [B, di, ds] or None (zeros) -> (y [B, T, di], final state [B, di, ds]),
    float32.  No D-skip, no gate."""
    _check(x, dt, bmat, cmat, a, h0)
    xs = [x, dt, bmat, cmat, a] + ([] if h0 is None else [h0])
    devs = {t.device for t in xs}
    if devs == {torch.device("cpu")}:
        return ref.mamba_scan(x, dt, bmat, cmat, a, h0=h0)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"mamba_scan: every input must lie on one CUDA "
                         f"device, got {sorted(str(d) for d in devs)}")
    if any(t.dtype != torch.float32 for t in xs):
        raise ValueError(f"mamba_scan: float32 inputs only, got "
                         f"{sorted({str(t.dtype) for t in xs})}")
    b, t, di = x.shape
    ds = bmat.shape[-1]
    if ds not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim {ds} not in {STATE_DIMS}")
    x, dt, bmat, cmat = (z if z.stride(-1) == 1 else z.contiguous()
                         for z in (x, dt, bmat, cmat))
    a = a.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    h_out = torch.empty((b, di, ds), dtype=torch.float32, device=x.device)
    strides = [s for z in (x, dt, bmat, cmat, y) for s in z.stride()[:2]]
    with torch.cuda.device(x.device):
        rc = _lib().mamba_scan_launch(
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(),
            b, t, di, ds, *strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan: kernel launch failed (CUDA error "
                           f"{rc})")
    mamba_scan.launches += 1
    return y, h_out


mamba_scan.launches = 0


def mamba_scan_hbm_bytes(b, t, di, ds, itemsize=4) -> int:
    """Kernel-exact HBM traffic (the reference's helper): inputs and
    outputs once (the state and every per-step intermediate stay on
    chip)."""
    return itemsize * b * t * (3 * di + 2 * ds)


def mamba_scan_flops(b, t, di, ds) -> int:
    """Operations per call: dt * x per channel and step; per state
    element dt * A, its exp, the B product, the state's multiply and add
    and the C product and sum."""
    return b * t * di * (1 + 7 * ds)

"""Wrapper of the WKV kernel on the model layout [B, T, H, D].

CUDA tensors launch `wkv.cu` (counted in `wkv.launches`, one per call;
a call runs three CUDA kernels: chunk summaries, the state scan and the
outputs, through scratch this wrapper allocates); CPU tensors run the
plain version (`ref.wkv`, the reference's chunk 16) — chosen by the
tensors' device alone, and a CUDA tensor never falls back.  The kernels
read r, k, v and w_log through their strides (the D axis contiguous),
mask a ragged T themselves (no padding copy), take an optional initial
state and write the final state (the decode cache's); head dims 32 and
64, float32.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import ref

HEAD_DIMS = (32, 64)      # rwkv6-3b's and the reduced configs'
CHUNK = 64                # the kernel's chunk (the TPU kernel's)


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv")
    lib.wkv_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    lib.wkv_launch.restype = ctypes.c_int
    return lib


def _check(r, k, v, w_log, u, state) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w_log)):
        raise ValueError(f"wkv: r, k, v and w_log [B, T, H, D] of one shape, "
                         f"got {[tuple(x.shape) for x in (r, k, v, w_log)]}")
    b, t, h, d = r.shape
    if b < 1 or t < 1 or tuple(u.shape) != (h, d):
        raise ValueError(f"wkv: B, T >= 1 and u [H, D] = {(h, d)}, got "
                         f"{tuple(r.shape)} and u {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (b, h, d, d):
        raise ValueError(f"wkv: state [B, H, D, D] = {(b, h, d, d)}, got "
                         f"{tuple(state.shape)}")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor,
        state: torch.Tensor | None = None):
    """r/k/v/w_log: [B, T, H, D]; u: [H, D]; state [B, H, D, D] or None
    (zeros) -> (o [B, T, H, D], final state [B, H, D, D]), float32.
    w_log = log(decay) <= 0."""
    _check(r, k, v, w_log, u, state)
    xs = [r, k, v, w_log, u] + ([] if state is None else [state])
    devs = {x.device for x in xs}
    if devs == {torch.device("cpu")}:
        return ref.wkv(r, k, v, w_log, u, state=state)
    if len(devs) != 1 or r.device.type != "cuda":
        raise ValueError(f"wkv: every input must lie on one CUDA device, "
                         f"got {sorted(str(d) for d in devs)}")
    if any(x.dtype != torch.float32 for x in xs):
        raise ValueError(f"wkv: float32 inputs only, got "
                         f"{sorted({str(x.dtype) for x in xs})}")
    b, t, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {d} not in {HEAD_DIMS}")
    r, k, v, w_log = (x if x.stride(-1) == 1 else x.contiguous()
                      for x in (r, k, v, w_log))
    u = u.contiguous()
    if state is not None:
        state = state.contiguous()
    o = torch.empty((b, t, h, d), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    n_chunks = -(-t // CHUNK)
    kv = torch.empty((n_chunks, b, h, d, d), dtype=torch.float32,
                     device=r.device)
    dec = torch.empty((n_chunks, b, h, d), dtype=torch.float32,
                      device=r.device)
    strides = [s for x in (r, k, v, w_log) for s in x.stride()[:3]]
    with torch.cuda.device(r.device):
        rc = _lib().wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            o.data_ptr(), s_out.data_ptr(), kv.data_ptr(), dec.data_ptr(),
            b, t, h, d, *strides,
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv: kernel launch failed (CUDA error {rc})")
    wkv.launches += 1
    return o, s_out


wkv.launches = 0


def wkv_flops(b, t, h, d, chunk: int = CHUNK) -> int:
    """Operations the chunked method needs per call: for each chunk of l
    steps, r @ S (2 l D^2), the pairwise A[i, j] for j < i only (3 D per
    entry: r k product, decay factor, sum), A @ v over the same triangle
    (2 D per entry), the diagonal bonus r.(u k) v (5 l D) and the state
    update (2 l D^2).  A ragged last chunk counts its own l."""
    def per_chunk(n: int) -> int:
        pairs = n * (n - 1) // 2
        return 4 * n * d * d + 5 * pairs * d + 5 * n * d
    full, rest = divmod(t, chunk)
    return b * h * (full * per_chunk(chunk) + per_chunk(rest))


def wkv_hbm_bytes(b, t, h, d) -> int:
    """Bytes a call from a zero state must move: r, k, v, w_log and u read
    once, o and the final state written once."""
    return 4 * (5 * b * t * h * d + h * d + b * h * d * d)

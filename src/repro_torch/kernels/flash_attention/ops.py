"""Wrapper of the flash attention kernel on the model layout [B, S, H, D].

CUDA tensors launch `flash_attention.cu` (counted in
`flash_attention.launches`); CPU tensors run the plain version
(`ref.flash_attention`) — chosen by the tensors' device alone, and a
CUDA tensor never falls back.  The kernel reads [B, S, H, D] through
its strides (the last axis contiguous), handles ragged Sq and Sk itself
(no padding copies: keys at kpos >= Sk are masked, as in the plain
version) and takes head dims 32, 64, 128 and 256 in float32 (register
tiles on the CUDA cores) or bfloat16 (wgmma fed by TMA; the library
builds the TMA descriptors from the strides passed here).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (32, 64, 128, 256)   # the configs' and the reduced configs'
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12 \
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of one block of the kernel that takes
    (dtype, head dim), in bytes (builds the library)."""
    return _lib().flash_attention_smem_bytes(DTYPES[dtype], d)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` itself when the kernel's vector loads can read it in place
    (last axis contiguous, 16-byte aligned rows and base), else a
    contiguous copy."""
    vec = 16 // x.element_size()
    if x.stride(-1) == 1 and all(s % vec == 0 for s in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, Sq, Hq, D], k/v [B, Sk, "
                         f"Hkv, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv or sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} / "
                         f"{tuple(k.shape)} (batch and D must agree, Hq a "
                         "multiple of Hkv, Sq and Sk >= 1)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D] in q's
    dtype.  Scale D^-0.5, kv head h // (Hq / Hkv), causal kpos <= qpos,
    window kpos > qpos - window; float32 math."""
    _check(q, k, v, window)
    devs = {x.device for x in (q, k, v)}
    if devs == {torch.device("cpu")}:
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k and v must lie on one "
                         f"CUDA device, got {[str(d) for d in devs]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: float32 or bfloat16 inputs of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    q, k, v = (_aligned(x) for x in (q, k, v))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, hq, hkv, d, DTYPES[q.dtype], *strides, int(causal),
            0 if window is None else int(window), d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"flash_attention: the driver refused a TMA "
                           f"descriptor (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (CUDA "
                           f"error {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_flops(b, sq, sk, hq, d, causal=True) -> int:
    """Roofline helper."""
    full = 4 * b * hq * sq * sk * d
    return full // 2 if causal else full

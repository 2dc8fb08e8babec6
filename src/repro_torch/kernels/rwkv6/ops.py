"""Wrappers of the WKV kernels on the model layout [B, T, H, D].

CUDA tensors launch `wkv.cu` (counted in `wkv.launches`, one per call;
a call runs three CUDA kernels: chunk summaries, the state scan and the
outputs, through scratch this wrapper allocates); CPU tensors run the
plain version (`ref.wkv`, the reference's chunk 16) — chosen by the
tensors' device alone, and a CUDA tensor never falls back.  The kernels
read r, k, v and w_log through their strides (the D axis contiguous),
mask a ragged T themselves (no padding copy), take an optional initial
state and write the final state (the decode cache's); head dims 32 and
64, float32.

Both are `torch.library` custom ops (`repro_torch::wkv`,
`repro_torch::wkv_bwd`; `kernels.library`): one op on every device, with
a fake implementation that returns outputs of the kernels' shapes and
launches nothing.  The forward's autograd keeps the chunk-start states
that the forward's state scan leaves in its scratch and the final
state, and its backward is `repro_torch::wkv_bwd`, which on the card
launches `wkv_bwd.cu` (`wkv_backward`, counted in
`wkv_backward.launches`, one per call; a call runs four CUDA kernels:
chunk sums of the state gradient, the reverse scan over chunks, each
chunk's gradients, and du's sum) and returns the gradients of r, k, v,
w_log, u and, when a state was passed in, of the state.  On the CPU the
backward differentiates the plain version's forward, recomputed.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels import build
from repro_torch.kernels.library import (autograd_inside, float_of,
                                         no_states, route)
from repro_torch.kernels.rwkv6 import ref

HEAD_DIMS = (32, 64)      # rwkv6-3b's and the reduced configs'
CHUNK = 64                # the kernel's chunk (the TPU kernel's)


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv")
    lib.wkv_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    lib.wkv_launch.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("wkv_bwd")
    lib.wkv_bwd_launch.argtypes = [ctypes.c_void_p] * 18 \
        + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 15 + [ctypes.c_void_p]
    lib.wkv_bwd_launch.restype = ctypes.c_int
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


def _check_cuda(name: str, xs) -> None:
    devs = {x.device for x in xs}
    if len(devs) != 1 or xs[0].device.type != "cuda":
        raise ValueError(f"{name}: every input must lie on one CUDA device, "
                         f"got {sorted(str(d) for d in devs)}")
    if any(x.dtype != torch.float32 for x in xs):
        raise ValueError(f"{name}: float32 inputs only, got "
                         f"{sorted({str(x.dtype) for x in xs})}")
    if xs[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {xs[0].shape[-1]} not in "
                         f"{HEAD_DIMS}")


def _d_contiguous(*xs):
    return tuple(x if x.stride(-1) == 1 else x.contiguous() for x in xs)


def _forward(r, k, v, w_log, u, state):
    """Launch the forward kernel: (o, final state, the states at the
    start of every chunk [ceil(T / 64), B, H, D, D])."""
    b, t, h, d = r.shape
    r, k, v, w_log = _d_contiguous(r, k, v, w_log)
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
    return o, s_out, kv


def _backward(r, k, v, w_log, u, s_chunks, d_o, d_state, need_state,
              s_out):
    """Launch the backward kernel (inputs checked by `wkv_backward`)."""
    b, t, h, d = r.shape
    n_chunks = -(-t // CHUNK)
    r, k, v, w_log, d_o = _d_contiguous(r, k, v, w_log, d_o)
    u, s_chunks = u.contiguous(), s_chunks.contiguous()
    if d_state is not None:
        d_state, s_out = d_state.contiguous(), s_out.contiguous()
    dev = r.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dr, dk, dv, dw = (empty(b, t, h, d) for _ in range(4))
    du = empty(h, d)
    ds = empty(b, h, d, d) if need_state else None
    g_end = empty(n_chunks, b, h, d, d)      # G at each chunk's end
    dec, du_part = empty(n_chunks, b, h, d), empty(n_chunks, b, h, d)
    strides = [s for x in (r, k, v, w_log, d_o) for s in x.stride()[:3]]

    def ptr(x):
        return None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        rc = _bwd_lib().wkv_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            d_o.data_ptr(), u.data_ptr(), s_chunks.data_ptr(),
            ptr(s_out), ptr(d_state),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), ptr(ds), g_end.data_ptr(),
            dec.data_ptr(), b, t, h, d, *strides,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv_backward: kernel launch failed (CUDA "
                           f"error {rc})")
    wkv_backward.launches += 1
    return dr, dk, dv, dw, du, ds


# ------------------------------------------------------------ custom ops
@torch.library.custom_op("repro_torch::wkv", mutates_args=(),
                         device_types="cpu")
def _wkv_op(r: Tensor, k: Tensor, v: Tensor, w_log: Tensor, u: Tensor,
            state: Optional[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    """(o, final state, the chunk-start states).  On the CPU the plain
    version, which keeps no chunk-start states (`library.no_states`):
    its backward recomputes the forward."""
    o, s = ref.wkv(r, k, v, w_log, u, state=state)
    b, t, h, d = r.shape
    return o, s, no_states(o, (-(-t // CHUNK), b, h, d, d))


@_wkv_op.register_kernel("cuda")
def _(r, k, v, w_log, u, state):
    return _forward(r, k, v, w_log, u, state)


@_wkv_op.register_fake
def _(r, k, v, w_log, u, state):
    b, t, h, d = r.shape
    f = float_of(r)
    return (r.new_empty((b, t, h, d), dtype=f),
            r.new_empty((b, h, d, d), dtype=f),
            r.new_empty((-(-t // CHUNK), b, h, d, d), dtype=f))


@torch.library.custom_op("repro_torch::wkv_bwd", mutates_args=(),
                         device_types="cpu")
def _wkv_bwd_op(r: Tensor, k: Tensor, v: Tensor, w_log: Tensor, u: Tensor,
                s_chunks: Tensor, d_o: Tensor, d_state: Optional[Tensor],
                s_out: Optional[Tensor], state: Optional[Tensor],
                need_state: bool) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                           Tensor, Tensor]:
    """(dr, dk, dv, dw_log, du, the initial state's gradient or an empty
    tensor).  On the CPU autograd through the plain version's forward,
    recomputed from `state`."""
    if need_state and state is None:
        b, _, h, d = r.shape
        state = r.new_zeros((b, h, d, d), dtype=float_of(r))
    with autograd_inside():
        *g, ds = ref.wkv_backward(r, k, v, w_log, u, d_o,
                                  state=state if need_state else None,
                                  d_state=d_state)
    return (*g, ds if need_state else r.new_empty(0))


@_wkv_bwd_op.register_kernel("cuda")
def _(r, k, v, w_log, u, s_chunks, d_o, d_state, s_out, state, need_state):
    *g, ds = _backward(r, k, v, w_log, u, s_chunks, d_o, d_state,
                       need_state, s_out)
    return (*g, ds if need_state else r.new_empty(0))


@_wkv_bwd_op.register_fake
def _(r, k, v, w_log, u, s_chunks, d_o, d_state, s_out, state, need_state):
    b, _, h, d = r.shape
    f = float_of(r)
    return (*(r.new_empty(r.shape, dtype=f) for _ in range(4)),
            r.new_empty((h, d), dtype=f),
            r.new_empty((b, h, d, d) if need_state else (0,), dtype=f))


def _wkv_setup(ctx, inputs, output):
    r, k, v, w_log, u, state = inputs
    ctx.save_for_backward(r, k, v, w_log, u, state, output[2], output[1])
    ctx.set_materialize_grads(False)


def _wkv_grad(ctx, d_o, d_state, _):
    r, k, v, w_log, u, state, s_chunks, s_out = ctx.saved_tensors
    if d_o is None:                  # only the final state was used
        d_o = torch.zeros_like(r)
    *g, ds = torch.ops.repro_torch.wkv_bwd(
        r, k, v, w_log, u, s_chunks, d_o, d_state,
        None if d_state is None else s_out, state, state is not None)
    return (*g, ds if state is not None else None)


_wkv_op.register_autograd(_wkv_grad, setup_context=_wkv_setup)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_log: torch.Tensor, u: torch.Tensor,
        state: torch.Tensor | None = None):
    """r/k/v/w_log: [B, T, H, D]; u: [H, D]; state [B, H, D, D] or None
    (zeros) -> (o [B, T, H, D], final state [B, H, D, D]), float32.
    w_log = log(decay) <= 0.  Differentiable on both devices.  The CUDA
    kernels take float32 only; on the CPU float64 inputs give float64.
    The op `repro_torch::wkv`: one op on every device, fake tensors
    included (outputs of the kernel's shapes, nothing launched)."""
    _check(r, k, v, w_log, u, state)
    xs = [r, k, v, w_log, u] + ([] if state is None else [state])
    if route("wkv", xs) == "cuda":
        _check_cuda("wkv", xs)
    o, s, _ = _wkv_op(r, k, v, w_log, u, state)
    return o, s


wkv.launches = 0


def wkv_backward(r, k, v, w_log, u, s_chunks, d_o, d_state=None,
                 need_state: bool = False, s_out=None, state=None):
    """The backward kernel (`repro_torch::wkv_bwd`): r/k/v/w_log and the
    output's gradient d_o [B, T, H, D], u [H, D], the forward's
    chunk-start states `s_chunks` [ceil(T / 64), B, H, D, D], the final
    state's gradient [B, H, D, D] or None (zeros) and, when that is
    given, the forward's final state `s_out` [B, H, D, D] -> (dr, dk,
    dv, dw_log [B, T, H, D], du [H, D], the initial state's gradient
    [B, H, D, D] or None unless `need_state`).  On the CPU the plain
    version differentiates the forward recomputed from the initial state
    `state` (None: zeros), and `s_chunks` is not read."""
    _check(r, k, v, w_log, u, None)
    b, t, h, d = r.shape
    if d_state is None:
        s_out = None                  # the last chunk's end term is 0
    elif s_out is None:
        raise ValueError("wkv_backward: a final state's gradient needs the "
                         "final state s_out")
    given = [] if d_state is None else [d_state, s_out]
    xs = [r, k, v, w_log, u, s_chunks, d_o] + given
    if route("wkv_backward", xs) == "cuda":
        _check_cuda("wkv_backward", xs)
    n_chunks = -(-t // CHUNK)
    if tuple(d_o.shape) != (b, t, h, d) or tuple(s_chunks.shape) != (
            n_chunks, b, h, d, d) or any(tuple(x.shape) != (b, h, d, d)
                                         for x in given):
        raise ValueError(f"wkv_backward: d_o {tuple(d_o.shape)}, chunk "
                         f"states {tuple(s_chunks.shape)}, final state or "
                         f"its gradient do not match r {tuple(r.shape)}")
    *g, ds = _wkv_bwd_op(r, k, v, w_log, u, s_chunks, d_o, d_state, s_out,
                         state, need_state)
    return (*g, ds if need_state else None)


wkv_backward.launches = 0


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


def wkv_hbm_bytes(b, t, h, d, state: bool = False) -> int:
    """Bytes a call must move: r, k, v, w_log and u read once, o and the
    final state written once (and the initial state read, when given)."""
    return 4 * (5 * b * t * h * d + h * d
                + b * h * d * d * (1 + int(state)))


def wkv_bwd_flops(b, t, h, d) -> int:
    """Operations of the sequential backward algorithm, the kernel's
    yardstick (its chunk-parallel design does about as many): per step
    and (batch row, head) 14 D^2 — the state rebuilt from the chunk-start
    state (3 D^2), S_{t-1} do_t, G_t v_t, G_t * S_{t-1} and G_t^T k_t
    (2 D^2 each), the G update (3 D^2) — and 16 D for the u terms, the
    dot products and dw_log's factor."""
    return b * h * t * (14 * d * d + 16 * d)


def wkv_bwd_hbm_bytes(b, t, h, d, d_state: bool = False,
                      need_state: bool = False) -> int:
    """Bytes a backward call must move: r, k, v, w_log, d_o, u and the
    chunk-start states read once (and the final state's gradient and the
    final state when the gradient is given), dr, dk, dv, dw_log and du
    written once (and the initial state's gradient when asked)."""
    n_chunks = -(-t // CHUNK)
    return 4 * (9 * b * t * h * d + 2 * h * d + n_chunks * b * h * d * d
                + (b * h * d * d) * (2 * int(d_state) + int(need_state)))

"""Wrappers of the selective-scan kernel and its backward.

CUDA tensors launch `mamba_scan.cu` (counted in `mamba_scan.launches`);
CPU tensors run the plain version (`ref.mamba_scan`) — chosen by the
tensors' device alone, and a CUDA tensor never falls back.  The kernel
reads x, dt, B and C through their batch and time strides (the last axis
contiguous), masks ragged T and di itself (no padding copy), takes an
optional initial state h0 and writes the final state (the decode
cache's); state dims 8 and 16, float32.  Decode calls it with T = 1 and
h0 from the cache.  `scan_plan` picks each launch's team of threads per
channel, channels per block and steps per staged tile (`SCAN_PLANS`,
measured on the card); `scan_thread_map` repeats the kernel's index
arithmetic, so the CPU tests can check that a plan covers every state
exactly once.

Both are `torch.library` custom ops (`repro_torch::mamba_scan`,
`repro_torch::mamba_scan_bwd`; `kernels.library`): one op on every
device, with a fake implementation that returns outputs of the kernels'
shapes and launches nothing.  For inputs that require grad (with grad
enabled) the forward launches the kernel with its usual plan and keeps
the state before every `chunk()`-th step (the kernel's optional
`h_chunks` output, at the backward kernel's spacing; the serve path's
launches do not ask for it), and its backward is
`repro_torch::mamba_scan_bwd`, which on the card launches
`mamba_scan_bwd.cu` (`mamba_scan_backward`, counted in
`mamba_scan_backward.launches`, one per call; a call runs two CUDA
kernels: the reverse scan, whose clusters of blocks write partial rows
of dB and dC, then the sums of those rows) and returns the gradients of
x, dt, B, C, A and, when a state was passed in, of h0.  On the CPU the
backward differentiates the plain step loop, recomputed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels import build
from repro_torch.kernels.library import (autograd_inside, float_of,
                                         no_states, route)
from repro_torch.kernels.mamba_scan import ref

STATE_DIMS = (8, 16)      # jamba's and the reduced configs'
TEAMS = {8: (2, 4, 8), 16: (2, 4, 8, 16)}    # the kernel's instantiations
SMEM_LIMIT = 227 * 1024   # mamba_scan.cu's bound on a block's shared memory
MAX_THREADS = 512         # ... and on its threads (`kMaxThreads`)
SPAN = 16                 # mamba_scan_bwd.cu's `kSpan`: steps between the
                          # states the forward saves for the backward


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch's shape: `team` threads per (batch row, channel), each
    holding ds / team states; `channels` per block; `steps` per staged
    tile of x, dt, B, C and y."""
    team: int
    channels: int
    steps: int

    @property
    def threads(self) -> int:
        return self.team * self.channels


# (ds, decode) -> plan; decode is T = 1.  Chosen by measurement on an
# H100 (benchmarks/port_kernel_redesign.py --plans).
SCAN_PLANS = {
    (16, False): ScanPlan(team=4, channels=128, steps=64),
    (8, False): ScanPlan(team=8, channels=16, steps=128),
    (16, True): ScanPlan(team=4, channels=64, steps=1),
    (8, True): ScanPlan(team=2, channels=64, steps=1),
}


def scan_plan(t: int, ds: int) -> ScanPlan:
    """The launch plan for T steps of state dim ds (steps cut to T)."""
    p = SCAN_PLANS[(ds, t == 1)]
    return dataclasses.replace(p, steps=min(p.steps, t))


def scan_smem_bytes(plan: ScanPlan, ds: int) -> int:
    """Shared memory of a block: two tile buffers of B, C [steps, ds]
    and x, dt [steps, channels], and the y tile."""
    return 4 * plan.steps * (2 * (2 * ds + 2 * plan.channels)
                             + plan.channels)


def check_plan(plan: ScanPlan, ds: int) -> None:
    """What the kernel takes: a team it was built for (dividing ds), a
    block of whole warps up to MAX_THREADS, a tile of >= 1 step, and
    the block's shared memory within the card's 227 KB."""
    if plan.team not in TEAMS.get(ds, ()) or ds % plan.team \
            or plan.threads % 32 or not 32 <= plan.threads <= MAX_THREADS \
            or plan.steps < 1 or scan_smem_bytes(plan, ds) > SMEM_LIMIT:
        raise ValueError(f"mamba_scan: plan {plan} does not fit ds = {ds} "
                         f"(teams {TEAMS.get(ds)}, blocks of whole warps "
                         f"up to {MAX_THREADS} threads, <= {SMEM_LIMIT} "
                         "bytes of shared memory)")


def scan_thread_map(plan: ScanPlan, b: int, di: int, ds: int):
    """The (batch row, channel, state) each live thread of a launch
    holds, as the kernel computes it: block (x, y) of ceil(di /
    channels) x b, thread tid -> channel x * channels + tid // team,
    states (tid % team) * ds / team + [0, ds / team); a thread past di
    holds none.  Returns int64 [n, 3]."""
    ns = ds // plan.team
    tid = torch.arange(plan.threads)
    bx = torch.arange(-(-di // plan.channels))
    ch = (bx[:, None] * plan.channels + tid[None, :] // plan.team)
    s0 = (tid % plan.team * ns)[None, :].expand_as(ch)
    ok = ch < di
    ch, s0 = ch[ok], s0[ok]
    st = s0[:, None] + torch.arange(ns)[None, :]
    rows = [torch.stack([torch.full_like(st, bi), ch[:, None].expand_as(st),
                         st], -1).reshape(-1, 3) for bi in range(b)]
    return torch.cat(rows)


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    lib.mamba_scan_launch.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
    lib.mamba_scan_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan_bwd")
    lib.mamba_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 16 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_scan_bwd_launch.restype = ctypes.c_int
    lib.mamba_scan_bwd_rows.argtypes = [ctypes.c_int]
    lib.mamba_scan_bwd_rows.restype = ctypes.c_int
    lib.mamba_scan_bwd_chunk.restype = ctypes.c_int
    return lib


@functools.cache
def chunk() -> int:
    """Steps between the states the backward reads: the backward
    kernel's own spacing (`mamba_scan_bwd_chunk`), at which the forward
    saves them, whatever its tile; `SPAN`, which the CPU and fake
    implementations use, must be it.  Builds the kernels on first use."""
    n = _bwd_lib().mamba_scan_bwd_chunk()
    if n != SPAN:
        raise RuntimeError(f"mamba_scan: the backward kernel reads states "
                           f"every {n} steps, SPAN says {SPAN}")
    return n


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


def _cuda_inputs(name: str, xs) -> None:
    devs = {t.device for t in xs}
    if len(devs) != 1 or xs[0].device.type != "cuda":
        raise ValueError(f"{name}: every input must lie on one CUDA device, "
                         f"got {sorted(str(d) for d in devs)}")
    if any(t.dtype != torch.float32 for t in xs):
        raise ValueError(f"{name}: float32 inputs only, got "
                         f"{sorted({str(t.dtype) for t in xs})}")


def _forward(x, dt, bmat, cmat, a, h0, plan: ScanPlan | None,
             save_chunks: bool = False):
    """Launch the forward kernel: (y, final state, and with `save_chunks`
    the state at the start of every `chunk()` steps [ceil(T / chunk()),
    B, di, ds], else None)."""
    b, t, di = x.shape
    ds = bmat.shape[-1]
    if ds not in STATE_DIMS:
        raise ValueError(f"mamba_scan: state dim {ds} not in {STATE_DIMS}")
    x, dt, bmat, cmat = (z if z.stride(-1) == 1 else z.contiguous()
                         for z in (x, dt, bmat, cmat))
    a = a.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    plan = plan or scan_plan(t, ds)
    check_plan(plan, ds)
    if save_chunks and plan.steps < t and plan.steps % chunk():
        raise ValueError(f"mamba_scan: with its states saved every "
                         f"{chunk()} steps a tile of {plan.steps} steps "
                         "must be a multiple of that spacing")
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    h_out = torch.empty((b, di, ds), dtype=torch.float32, device=x.device)
    chunks = (torch.empty((-(-t // chunk()), b, di, ds), dtype=torch.float32,
                          device=x.device) if save_chunks else None)
    strides = [s for z in (x, dt, bmat, cmat, y) for s in z.stride()[:2]]
    with torch.cuda.device(x.device):
        rc = _lib().mamba_scan_launch(
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(),
            None if chunks is None else chunks.data_ptr(),
            b, t, di, ds, plan.team, plan.channels, plan.steps,
            chunk() if save_chunks else 0, *strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan: kernel launch failed (CUDA error "
                           f"{rc})")
    mamba_scan.launches += 1
    return y, h_out, chunks


def _backward(x, dt, bmat, cmat, a, h_chunks, dy, dh, need_h0):
    """Launch the backward kernel (inputs checked by
    `mamba_scan_backward`)."""
    b, t, di = x.shape
    ds = bmat.shape[-1]
    lib = _bwd_lib()
    x, dt, bmat, cmat, a, h_chunks, dy = (z.contiguous() for z in (
        x, dt, bmat, cmat, a, h_chunks, dy))
    if dh is not None:
        dh = dh.contiguous()
    dev = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    # the outputs of a custom op may not share storage: dx, ddt, dB and
    # dC are buffers of their own; the scratch (the partial rows [rows,
    # B, T, 2 ds], then dA's per-row sums [B, di, ds]) is one buffer
    dx, ddt = empty(b, t, di), empty(b, t, di)
    db, dc = empty(b, t, ds), empty(b, t, ds)
    da = empty(di, ds)
    dh0 = empty(b, di, ds) if need_h0 else None
    n_part = lib.mamba_scan_bwd_rows(di) * b * t * 2 * ds
    scratch = empty(n_part + b * di * ds)

    def ptr(z):
        return None if z is None else z.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.mamba_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), h_chunks.data_ptr(), dy.data_ptr(), ptr(dh),
            dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
            da.data_ptr(), ptr(dh0), scratch.data_ptr(),
            scratch.data_ptr() + 4 * n_part,
            b, t, di, ds, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_backward: kernel launch failed (CUDA "
                           f"error {rc})")
    mamba_scan_backward.launches += 1
    return dx, ddt, db, dc, da, dh0


# ------------------------------------------------------------ custom ops
@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=(),
                         device_types="cpu")
def _scan_op(x: Tensor, dt: Tensor, bmat: Tensor, cmat: Tensor, a: Tensor,
             h0: Optional[Tensor], save_states: bool, team: int,
             channels: int, steps: int) -> tuple[Tensor, Tensor, Tensor]:
    """(y, final state, the states every `SPAN` steps or an empty tensor
    unless `save_states`); team / channels / steps a `ScanPlan`, 0 for
    `scan_plan`'s.  On the CPU the plain version, which keeps no saved
    states (`library.no_states`): its backward recomputes the forward."""
    y, h = ref.mamba_scan(x, dt, bmat, cmat, a, h0=h0)
    b, t, di = x.shape
    shape = (-(-t // SPAN), b, di, bmat.shape[-1]) if save_states else (0,)
    return y, h, no_states(h, shape)


@_scan_op.register_kernel("cuda")
def _(x, dt, bmat, cmat, a, h0, save_states, team, channels, steps):
    plan = ScanPlan(team, channels, steps) if team else None
    y, h, chunks = _forward(x, dt, bmat, cmat, a, h0, plan,
                            save_chunks=save_states)
    return y, h, x.new_empty(0) if chunks is None else chunks


@_scan_op.register_fake
def _(x, dt, bmat, cmat, a, h0, save_states, team, channels, steps):
    b, t, di = x.shape
    ds = bmat.shape[-1]
    f = float_of(x)
    return (x.new_empty((b, t, di)), x.new_empty((b, di, ds), dtype=f),
            x.new_empty((-(-t // SPAN), b, di, ds) if save_states else (0,),
                        dtype=f))


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=(),
                         device_types="cpu")
def _scan_bwd_op(x: Tensor, dt: Tensor, bmat: Tensor, cmat: Tensor,
                 a: Tensor, h_chunks: Tensor, dy: Tensor,
                 dh: Optional[Tensor], h0: Optional[Tensor],
                 need_h0: bool) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                         Tensor, Tensor]:
    """(dx, ddt, dB, dC, dA, dh0 or an empty tensor).  On the CPU autograd
    through the plain version's step loop, recomputed from `h0`."""
    if need_h0 and h0 is None:
        b, _, di = x.shape
        h0 = x.new_zeros((b, di, bmat.shape[-1]), dtype=float_of(x))
    with autograd_inside():
        xs = [z.detach().requires_grad_() for z in (x, dt, bmat, cmat, a)]
        hs = [h0.detach().requires_grad_()] if need_h0 else []
        y, h = ref.mamba_scan(*xs, h0=hs[0] if hs else h0)
        outs, grads = [y], [dy]
        if dh is not None:
            outs.append(h)
            grads.append(dh)
        g = torch.autograd.grad(outs, xs + hs, grads)
    return (*g[:5], g[5] if need_h0 else x.new_empty(0))


@_scan_bwd_op.register_kernel("cuda")
def _(x, dt, bmat, cmat, a, h_chunks, dy, dh, h0, need_h0):
    *g, dh0 = _backward(x, dt, bmat, cmat, a, h_chunks, dy, dh, need_h0)
    return (*g, x.new_empty(0) if dh0 is None else dh0)


@_scan_bwd_op.register_fake
def _(x, dt, bmat, cmat, a, h_chunks, dy, dh, h0, need_h0):
    b, _, di = x.shape
    ds = bmat.shape[-1]
    return (x.new_empty(x.shape), x.new_empty(x.shape),
            bmat.new_empty(bmat.shape), bmat.new_empty(bmat.shape),
            a.new_empty(a.shape),
            x.new_empty((b, di, ds) if need_h0 else (0,), dtype=float_of(x)))


def _scan_setup(ctx, inputs, output):
    x, dt, bmat, cmat, a, h0 = inputs[:6]
    ctx.save_for_backward(x, dt, bmat, cmat, a, h0, output[2])
    ctx.set_materialize_grads(False)


def _scan_grad(ctx, dy, dh, _):
    x, dt, bmat, cmat, a, h0, chunks = ctx.saved_tensors
    if dy is None:                   # only the final state was used
        dy = torch.zeros_like(x)
    *g, dh0 = torch.ops.repro_torch.mamba_scan_bwd(
        x, dt, bmat, cmat, a, chunks, dy, dh, h0, h0 is not None)
    return (*g, dh0 if h0 is not None else None, None, None, None, None)


_scan_op.register_autograd(_scan_grad, setup_context=_scan_setup)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None, plan: ScanPlan | None = None):
    """x, dt: [B, T, di]; bmat, cmat: [B, T, ds]; a: [di, ds]; h0
    [B, di, ds] or None (zeros) -> (y [B, T, di], final state [B, di, ds]),
    float32.  No D-skip, no gate.  Differentiable on both devices.
    `plan` overrides `scan_plan` (the card only; with grad, a tile
    shorter than T is a multiple of `chunk()` steps).  The op
    `repro_torch::mamba_scan`: one op on every device, fake tensors
    included (outputs of the kernel's shapes, nothing launched); with
    grad the forward saves the states its backward reads."""
    _check(x, dt, bmat, cmat, a, h0)
    xs = [x, dt, bmat, cmat, a] + ([] if h0 is None else [h0])
    if route("mamba_scan", xs) == "cuda":
        _cuda_inputs("mamba_scan", xs)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in xs)
    p = plan or ScanPlan(0, 0, 0)
    y, h_out, _ = _scan_op(x, dt, bmat, cmat, a, h0, grad, p.team,
                           p.channels, p.steps)
    return y, h_out


mamba_scan.launches = 0


def mamba_scan_backward(x, dt, bmat, cmat, a, h_chunks, dy, dh=None,
                        need_h0: bool = False, h0=None):
    """The backward kernel (`repro_torch::mamba_scan_bwd`): x, dt and the
    output's gradient dy [B, T, di], bmat, cmat [B, T, ds], a [di, ds],
    the forward's states at the start of every `SPAN` steps `h_chunks`
    [ceil(T / SPAN), B, di, ds] and the final state's gradient dh
    [B, di, ds] or None (zeros) -> (dx, ddt [B, T, di], dB, dC [B, T,
    ds], dA [di, ds], dh0 [B, di, ds] or None unless `need_h0`).  On the
    CPU autograd differentiates the plain step loop recomputed from the
    initial state `h0` (None: zeros), and `h_chunks` is not read."""
    _check(x, dt, bmat, cmat, a, dh)
    b, t, di = x.shape
    ds = bmat.shape[-1]
    given = [] if dh is None else [dh]
    xs = [x, dt, bmat, cmat, a, h_chunks, dy] + given
    if route("mamba_scan_backward", xs) == "cuda":
        _cuda_inputs("mamba_scan_backward", xs)
        if ds not in STATE_DIMS:
            raise ValueError(f"mamba_scan_backward: state dim {ds} not in "
                             f"{STATE_DIMS}")
    if tuple(dy.shape) != (b, t, di) or tuple(h_chunks.shape) != (
            -(-t // SPAN), b, di, ds):
        raise ValueError(f"mamba_scan_backward: dy {tuple(dy.shape)} or the "
                         f"chunk states {tuple(h_chunks.shape)} do not match "
                         f"x {tuple(x.shape)} and ds {ds}")
    *g, dh0 = _scan_bwd_op(x, dt, bmat, cmat, a, h_chunks, dy, dh, h0,
                           need_h0)
    return (*g, dh0 if need_h0 else None)


mamba_scan_backward.launches = 0


def mamba_scan_hbm_bytes(b, t, di, ds, itemsize=4) -> int:
    """Kernel-exact HBM traffic (the reference's helper): inputs and
    outputs once (the state and every per-step intermediate stay on
    chip)."""
    return itemsize * b * t * (3 * di + 2 * ds)


def mamba_scan_state_bytes(b, di, ds, itemsize=4) -> int:
    """The state's traffic when it starts from h0: read once, written
    once (a decode step's largest term)."""
    return 2 * itemsize * b * di * ds


def mamba_scan_flops(b, t, di, ds) -> int:
    """Operations per call: dt * x per channel and step; per state
    element dt * A, its exp, the B product, the state's multiply and add
    and the C product and sum."""
    return b * t * di * (1 + 7 * ds)


def mamba_scan_bwd_flops(b, t, di, ds) -> int:
    """Operations of the backward per call: per state and step the
    state rebuilt as the forward computes it (dt * A, its exp, the B
    product, the decay product and the sum: 5), G (2), the dC and dB
    terms with their sums over the channels (4), G B with its sum over
    the states (2), q = G a h_{t-1} (2), q A with its sum (2), dA (2) and
    a G (1): 20; per channel and step dt * x, dx and ddt (4)."""
    return b * t * di * (20 * ds + 4)


def mamba_scan_bwd_hbm_bytes(b, t, di, ds, h0: bool = False,
                             d_state: bool = False, itemsize=4) -> int:
    """Bytes a backward call must move: x, dt, dy [B, T, di] and B, C
    [B, T, ds] read once, A read once, dx, ddt, dB, dC and dA written
    once; with `h0` the initial state read and its gradient written, with
    `d_state` the final state's gradient read."""
    state = b * di * ds
    return itemsize * (5 * b * t * di + 4 * b * t * ds + 2 * di * ds
                       + state * (2 * int(h0) + int(d_state)))

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

On the card, inputs that require grad (with grad enabled) go through a
`torch.autograd.Function`: its forward launches the kernel with its
usual plan and keeps the state before every `chunk()`-th step (the
kernel's optional `h_chunks` output, at the backward kernel's spacing;
the serve path's launches do not ask for it), and its backward launches
`mamba_scan_bwd.cu` (`mamba_scan_backward`, counted in
`mamba_scan_backward.launches`, one per call; a call runs two CUDA
kernels: the reverse scan, whose clusters of blocks write partial rows
of dB and dC, then the sums of those rows), which returns the gradients
of x, dt, B, C, A and, when a state was passed in, of h0.  On the CPU
autograd differentiates the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ref

STATE_DIMS = (8, 16)      # jamba's and the reduced configs'
TEAMS = {8: (2, 4, 8), 16: (2, 4, 8, 16)}    # the kernel's instantiations
SMEM_LIMIT = 227 * 1024   # mamba_scan.cu's bound on a block's shared memory
MAX_THREADS = 512         # ... and on its threads (`kMaxThreads`)


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
    saves them, whatever its tile.  Builds the kernels on first use."""
    return _bwd_lib().mamba_scan_bwd_chunk()


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


class _Scan(torch.autograd.Function):
    """The scan kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, h0, plan):
        y, h_out, chunks = _forward(x, dt, bmat, cmat, a, h0, plan,
                                    save_chunks=True)
        ctx.save_for_backward(x, dt, bmat, cmat, a, chunks)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, bmat, cmat, a, chunks = ctx.saved_tensors
        if dy is None:                   # only the final state was used
            dy = torch.zeros_like(x)
        grads = mamba_scan_backward(x, dt, bmat, cmat, a, chunks, dy, dh,
                                    need_h0=ctx.has_h0)
        return (*grads, None)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None, plan: ScanPlan | None = None):
    """x, dt: [B, T, di]; bmat, cmat: [B, T, ds]; a: [di, ds]; h0
    [B, di, ds] or None (zeros) -> (y [B, T, di], final state [B, di, ds]),
    float32.  No D-skip, no gate.  Differentiable on both devices.
    `plan` overrides `scan_plan` (the card only; with grad, a tile
    shorter than T is a multiple of `chunk()` steps)."""
    _check(x, dt, bmat, cmat, a, h0)
    xs = [x, dt, bmat, cmat, a] + ([] if h0 is None else [h0])
    if {t.device for t in xs} == {torch.device("cpu")}:
        return ref.mamba_scan(x, dt, bmat, cmat, a, h0=h0)
    _cuda_inputs("mamba_scan", xs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        return _Scan.apply(x, dt, bmat, cmat, a, h0, plan)
    y, h_out, _ = _forward(x, dt, bmat, cmat, a, h0, plan)
    return y, h_out


mamba_scan.launches = 0


def mamba_scan_backward(x, dt, bmat, cmat, a, h_chunks, dy, dh=None,
                        need_h0: bool = False):
    """The backward kernel on CUDA tensors: x, dt and the output's
    gradient dy [B, T, di], bmat, cmat [B, T, ds], a [di, ds], the
    forward's states at the start of every `chunk()` steps `h_chunks`
    [ceil(T / chunk()), B, di, ds] and the final state's gradient dh
    [B, di, ds] or None (zeros) -> (dx, ddt [B, T, di], dB, dC [B, T,
    ds], dA [di, ds], dh0 [B, di, ds] or None unless `need_h0`)."""
    _check(x, dt, bmat, cmat, a, dh)
    b, t, di = x.shape
    ds = bmat.shape[-1]
    given = [] if dh is None else [dh]
    _cuda_inputs("mamba_scan_backward", [x, dt, bmat, cmat, a, h_chunks, dy]
                 + given)
    if ds not in STATE_DIMS:
        raise ValueError(f"mamba_scan_backward: state dim {ds} not in "
                         f"{STATE_DIMS}")
    if tuple(dy.shape) != (b, t, di) or tuple(h_chunks.shape) != (
            -(-t // chunk()), b, di, ds):
        raise ValueError(f"mamba_scan_backward: dy {tuple(dy.shape)} or the "
                         f"chunk states {tuple(h_chunks.shape)} do not match "
                         f"x {tuple(x.shape)} and ds {ds}")
    lib = _bwd_lib()
    x, dt, bmat, cmat, a, h_chunks, dy = (z.contiguous() for z in (
        x, dt, bmat, cmat, a, h_chunks, dy))
    if dh is not None:
        dh = dh.contiguous()
    dev = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    # few allocations (each costs the call host time while the card
    # waits): dx and ddt, dB and dC are halves of one buffer each, and
    # the scratch (the partial rows [rows, B, T, 2 ds], then dA's per-row
    # sums [B, di, ds]) is one buffer
    dx, ddt = empty(2, b, t, di).unbind(0)
    db, dc = empty(2, b, t, ds).unbind(0)
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

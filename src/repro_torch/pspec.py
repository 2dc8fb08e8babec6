"""Sharding helpers usable from model code (port of `repro.pspec`).

`set_mesh(mesh)` activates a mesh for the code it wraps.  Axis names
follow the production mesh ("pod", "data", "model"); the data-parallel
group is ("pod", "data") where the pod axis exists.  `constrain(x,
*spec)` redistributes a `DTensor` to a spec under the active mesh when
it tiles evenly, and is the identity on a plain tensor or with no mesh,
so model code runs unchanged on one device.  `dp_mean(x)` averages a
constant over the data-parallel ranks, so a statistic the reference
takes over the global batch (MoE's routing fractions) is the same when
each rank holds a shard of the batch.

The model code runs on each rank's local tensors, Megatron-style: where
the reference constrains an activation to a layout over "model", the
port calls the collective that layout needs, as an autograd function
whose backward is the adjoint for how the result is used:
  * `tp_enter(x)` — a tensor replicated over "model" enters a
    computation split over it (column-parallel products, a head or
    channel shard, local experts): identity forward, the gradient
    summed over "model" backward;
  * `tp_exit(x)` — a result partial over "model" (row-parallel
    products, local experts' outputs) becomes replicated: summed
    forward, identity backward (the reference's `constrain(x, "dp",
    None, None)` after such a product);
  * `tp_sum(x)` — summed both ways: a partial result that is consumed
    again by split computation (Mamba's x_proj, the softmax
    denominators of scores sharded by key positions);
  * `tp_gather(x, dim)` / `tp_slice(x, dim)` — a dim split over "model"
    made whole (vocab-sharded logits, the `seq_parallel` stream at a
    layer group's start) or cut to the rank's block (the stream at a
    group's end);
  * `dp_gather(x, dim)` — the batch's data-parallel shards made whole
    (MoE routing groups that span ranks), the gradient reduce-scattered.
Every rank computes the loss; a gradient that reaches a replicated
tensor is complete on every rank, which is what each backward above
keeps true.  Each is the identity over a group of one rank, so on a
mesh of one rank the model runs the mesh-free ops.  `split(n)` is the
rank's block of a dim of n split over "model" by the rule of
`launch.sharding.sanitize`, or None where the dim stays whole.
`gather_param` gathers one layer's parameter shard over the
data-parallel axes where the layer runs (`launch.sharding.Local`).

The active mesh is one per process, not per thread: the autograd engine
recomputes a remat group's forward (and its collectives) in its own
threads on a CUDA device.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial

from repro_torch.launch.sharding import Local, placements

_ACTIVE: list = []      # (mesh, batch split over dp) that `set_mesh` has
                        # entered, innermost last


def active_mesh():
    """The innermost mesh `set_mesh` has activated, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


def _mesh_axes() -> tuple[str, ...]:
    m = active_mesh()
    return tuple(m.mesh_dim_names or ()) if m is not None else ()


@contextlib.contextmanager
def set_mesh(mesh, batch_dims: list[int] | None = None):
    """Activate `mesh` (a `DeviceMesh`) for the enclosed code; None
    activates nothing.  `batch_dims` are the mesh dims that split the
    activations' batch, major first (None: every data-parallel dim of
    more than one rank, `dp_dims`; [] where each rank holds the whole
    batch, as a decode batch of one row)."""
    if mesh is None:
        yield None
        return
    _ACTIVE.append((mesh, dp_dims(mesh) if batch_dims is None
                    else list(batch_dims)))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def dp_axes() -> tuple[str, ...]:
    axes = _mesh_axes()
    return tuple(a for a in ("pod", "data") if a in axes)


def resolve(*spec) -> tuple:
    """A spec with the symbolic "dp" axis mapped to the data-parallel
    axes and the axes absent from the mesh dropped."""
    axes = _mesh_axes()
    out = []
    for s in spec:
        if s == "dp":
            dp = dp_axes()
            out.append((dp[0] if len(dp) == 1 else dp) if dp else None)
        elif s is None or s in axes:
            out.append(s)
        elif isinstance(s, tuple):
            keep = tuple(a for a in s if a in axes)
            out.append((keep[0] if len(keep) == 1 else keep) if keep
                       else None)
        else:
            out.append(None)
    return tuple(out)


def axis_size(name: str) -> int:
    m = active_mesh()
    if m is None or name not in (m.mesh_dim_names or ()):
        return 1
    return m.size(m.mesh_dim_names.index(name))


def _divisible(x, spec) -> bool:
    for dim, s in zip(x.shape, spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        if dim % math.prod(axis_size(a) for a in axes):
            return False
    return True


def constrain(x, *spec):
    """Redistribute a `DTensor` to `spec` under the active mesh if it
    tiles evenly; otherwise (and on a plain tensor) the identity."""
    if not _mesh_axes() or not isinstance(x, DTensor):
        return x
    p = resolve(*spec)
    if not _divisible(x, p):
        return x
    return x.redistribute(active_mesh(), placements(active_mesh(), p))


def dp_dims(mesh) -> list[int]:
    """The dims of `mesh` that are data-parallel axes of more than one
    rank, major first."""
    names = list(mesh.mesh_dim_names)
    return [names.index(a) for a in ("pod", "data")
            if a in names and mesh.size(names.index(a)) > 1]


def _batch_dims() -> list[int]:
    """The active mesh's dims that split the batch, major first."""
    return _ACTIVE[-1][1] if _ACTIVE else []


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the data-parallel ranks that split the batch,
    as a constant (no gradient flows through it); `x` itself with no
    mesh or one such rank."""
    m = active_mesh()
    dims = _batch_dims()
    if not dims:
        return x
    y = x.detach().clone()
    for d in dims:
        dist.all_reduce(y, group=m.get_group(d))
    return y / math.prod(m.size(d) for d in dims)


def dp_size() -> int:
    """Data-parallel ranks that split the batch (1 without a mesh, or
    where each holds the whole batch)."""
    m = active_mesh()
    return math.prod(m.size(d) for d in _batch_dims()) if m is not None \
        else 1


# ------------------------------------------------- tensor parallelism
def model_size() -> int:
    return axis_size("model")


def model_rank() -> int:
    m = active_mesh()
    if m is None or "model" not in (m.mesh_dim_names or ()):
        return 0
    return m.get_coordinate()[m.mesh_dim_names.index("model")]


def split(n: int) -> tuple[int, int] | None:
    """This rank's block [lo, hi) of a dim of `n` split over "model", or
    None where the dim stays whole: one "model" rank, or `n` not a
    multiple of their number (`sanitize`'s rule)."""
    m = model_size()
    if m == 1 or n % m:
        return None
    r = model_rank()
    return r * (n // m), (r + 1) * (n // m)


def _groups(axes_dims) -> list:
    m = active_mesh()
    return [(m.get_group(d), m.size(d)) for d in axes_dims]


def _model_dims() -> list[int]:
    m = active_mesh()
    if model_size() == 1:
        return []
    return [m.mesh_dim_names.index("model")]


_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_reduce(x, groups, op=dist.ReduceOp.SUM):
    y = x.clone(memory_format=torch.contiguous_format)
    for g, _ in groups:
        dist.all_reduce(y, op=op, group=g)
    return y


def _all_gather(x, dim, groups):
    """`x`'s blocks along `dim` from every rank of `groups` (innermost
    first), in rank order, major first."""
    for g, n in groups:
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
        _gather_into(out, xm, group=g)
        x = out.movedim(0, dim)
    return x if dim == 0 else x.contiguous()


def _reduce_scatter(x, dim, groups):
    """The sum of `x` over `groups` (outermost first), cut to this rank's
    block along `dim`."""
    for g, n in groups:
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
        _scatter_into(out, xm, group=g)
        x = out.movedim(0, dim)
    return x if dim == 0 else x.contiguous()


def _block(x, dim, groups):
    """This rank's block of `x` along `dim` over `groups` (outermost
    first)."""
    for g, n in groups:
        size = x.shape[dim] // n
        x = x.narrow(dim, dist.get_rank(g) * size, size)
    return x


class _Collective(torch.autograd.Function):
    """One collective forward and one backward over the same groups:
    "id", "sum" (all-reduce), "gather" (all-gather along `dim`),
    "block" (this rank's block along `dim`), "scatter"
    (reduce-scatter along `dim`)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, dim, groups):
        ctx.bwd, ctx.dim, ctx.groups = bwd, dim, groups
        return _apply(fwd, x, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return _apply(ctx.bwd, g, ctx.dim, ctx.groups), None, None, None, \
            None


def _apply(kind, x, dim, groups):
    if kind == "id":
        return x.view_as(x)
    if kind == "sum":
        return _all_reduce(x, groups)
    if kind == "gather":
        return _all_gather(x, dim, groups)
    if kind == "scatter":
        return _reduce_scatter(x, dim, groups[::-1])
    # a copy, never a view: a view of a contiguous block would keep the
    # whole tensor alive (the remat stash under `seq_parallel`)
    return _block(x, dim, groups[::-1]).clone(
        memory_format=torch.contiguous_format)


def _collective(x, fwd, bwd, dims, dim=0):
    if not dims:
        return x
    return _Collective.apply(x, fwd, bwd, dim, _groups(dims))


def tp_enter(x):
    """Identity forward; the gradient summed over "model" backward."""
    return _collective(x, "id", "sum", _model_dims())


def tp_exit(x):
    """The sum over "model" forward; identity backward."""
    return _collective(x, "sum", "id", _model_dims())


def tp_sum(x):
    """The sum over "model" forward and backward."""
    return _collective(x, "sum", "sum", _model_dims())


def tp_max(x):
    """The maximum over "model", as a constant."""
    dims = _model_dims()
    if not dims:
        return x
    return _all_reduce(x.detach(), _groups(dims), dist.ReduceOp.MAX)


def tp_gather(x, dim: int):
    """The "model" ranks' blocks of `dim` joined forward; this rank's
    block of the (complete) gradient backward."""
    return _collective(x, "gather", "block", _model_dims(), dim)


def tp_slice(x, dim: int):
    """This rank's block of `dim` forward; the ranks' gradient blocks
    joined backward."""
    return _collective(x, "block", "gather", _model_dims(), dim)


def dp_rows(x, dim: int):
    """This rank's block of a whole batch along `dim` (the adjoint of
    `dp_gather`'s forward; a plain slice)."""
    return _block(x, dim, _groups(_batch_dims()))


def dp_gather(x, dim: int):
    """The data-parallel ranks' shards of the batch joined along `dim`
    (in the global batch's order) forward; the gradient summed over them
    and cut to this rank's shard backward."""
    return _collective(x, "gather", "scatter", _batch_dims()[::-1], dim)


# ------------------------------------------------ parameters per layer
def _partial_dims(ref: Local) -> list[int]:
    """The mesh dims over which a layer's gradient of `ref` is partial:
    the data-parallel dims of more than one rank (each holds its own
    rows of the batch) and the dims it was gathered over."""
    names = ref.mesh.mesh_dim_names
    return [i for i in range(ref.mesh.ndim) if ref.mesh.size(i) > 1 and (
        names[i] != "model" or ref.placements[i] != ref.gathered[i])]


class _GatherParam(torch.autograd.Function):
    """A parameter shard gathered over the mesh dims it is to be whole
    on; backward the gradient, partial over the data-parallel dims and
    those, reduced to the gradient placements and added into the
    shard's."""

    @staticmethod
    def forward(ctx, t, ref: Local):
        ctx.ref = ref
        if tuple(ref.placements) == tuple(ref.gathered):
            return t.view_as(t)
        d = DTensor.from_local(t, ref.mesh, ref.placements, run_check=False,
                               shape=ref.shape, stride=ref.stride)
        return d.redistribute(ref.mesh, ref.gathered).to_local()

    @staticmethod
    def backward(ctx, g):
        ref = ctx.ref
        dims = _partial_dims(ref)
        part = tuple(Partial() if i in dims else p
                     for i, p in enumerate(ref.gathered))
        d = DTensor.from_local(g.contiguous(), ref.mesh, part,
                               run_check=False, shape=ref.shape,
                               stride=ref.stride)
        if ref.grad_placements is not None:
            d = d.redistribute(ref.mesh, ref.grad_placements)
        return d.redistribute(ref.mesh, ref.placements).to_local(), None


def gather_param(x):
    """A layer's parameter where the layer runs: a `Local` shard gathered
    over the data-parallel axes (and over "model" where
    `launch.sharding` says so), any other tensor as it is."""
    if not isinstance(x, Local):
        return x
    if not _partial_dims(x):
        return x.tensor
    return _GatherParam.apply(x.tensor, x)

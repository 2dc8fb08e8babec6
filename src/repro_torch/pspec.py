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

The active mesh is one per process, not per thread: the autograd engine
recomputes a remat group's forward (and its `dp_mean`) in its own
threads on a CUDA device.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.sharding import placements

_ACTIVE: list = []      # the meshes `set_mesh` has entered, innermost last


def active_mesh():
    """The innermost mesh `set_mesh` has activated, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _mesh_axes() -> tuple[str, ...]:
    m = active_mesh()
    return tuple(m.mesh_dim_names or ()) if m is not None else ()


@contextlib.contextmanager
def set_mesh(mesh):
    """Activate `mesh` (a `DeviceMesh`) for the enclosed code; None
    activates nothing."""
    if mesh is None:
        yield None
        return
    _ACTIVE.append(mesh)
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


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the data-parallel ranks of the active mesh, as
    a constant (no gradient flows through it); `x` itself with no mesh or
    one such rank."""
    m = active_mesh()
    dims = dp_dims(m) if m is not None else []
    if not dims:
        return x
    y = x.detach().clone()
    for d in dims:
        dist.all_reduce(y, group=m.get_group(d))
    return y / math.prod(m.size(d) for d in dims)


def dp_size() -> int:
    """Ranks of the active mesh's data-parallel axes (1 without one)."""
    return math.prod(axis_size(a) for a in dp_axes())

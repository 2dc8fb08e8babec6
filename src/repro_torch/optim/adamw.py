"""AdamW over parameter trees (port of `repro.optim.adamw`): nested
dicts of tensors, moments in float32.

The reference is functional; at rwkv6-3b's full width a functional
update would hold a second copy of the parameters and both moments
(43 GB) beside them, so `adamw_update(..., inplace=True)` writes every
leaf in place under `torch.no_grad()`, in slices of at most
`SLICE_ELEMS` elements along the leading axis (the update is elementwise,
so slicing changes no value) to bound its temporaries.  The default
returns new trees and leaves its arguments untouched; both give the same
values.

Leaves may be `DTensor`s on a mesh (`launch.sharding`): the moments take
their parameters' placements, each rank updates its local shards, and
the global norm counts every element once (`sharded_sums`)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.sharding import local

SLICE_ELEMS = 1 << 26        # elements per in-place slice (256 MB float32)


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32, 0-d: updates applied so far
    m: Any
    v: Any


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts (`rest` of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order (`jax.tree.leaves`'
    order, so sums over the leaves add in the reference's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _clone(tree):
    if isinstance(tree, tuple):            # a NamedTuple (QTensor)
        return type(tree)(*(t.clone() for t in tree))
    return tree.clone()


def locals_of(p, *rest) -> tuple:
    """The local shards of a parameter and the leaves that go with it,
    which must share its placements."""
    for x in rest:
        if isinstance(x, DTensor) and (not isinstance(p, DTensor) or
                                       x.placements != p.placements):
            raise ValueError(f"a leaf placed {x.placements} goes with a "
                             f"parameter placed "
                             f"{getattr(p, 'placements', 'locally')}")
    return tuple(local(x) for x in (p, *rest))


def sharded_dims(x) -> tuple[int, ...]:
    """The mesh dims of size > 1 that shard a `DTensor` (() for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return ()
    m = x.device_mesh
    return tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard() and m.size(i) > 1)


def sharded_sums(xs: list, fn) -> list:
    """`fn` (a sum over elements) of each tensor: of its local shard,
    summed over the mesh dims that shard it, so that every element counts
    once and its replicas not at all.  One all-reduce per set of mesh
    dims; a plain tensor's value is `fn` of it."""
    sums = [fn(local(x)) for x in xs]
    groups: dict[tuple, list] = {}
    for i, x in enumerate(xs):
        if sharded_dims(x):
            groups.setdefault(sharded_dims(x), []).append(i)
    for dims, idx in sorted(groups.items()):
        mesh = xs[idx[0]].device_mesh
        v = torch.stack([sums[i] for i in idx])
        for d in dims:
            dist.all_reduce(v, group=mesh.get_group(d))
        for k, i in enumerate(idx):
            sums[i] = v[k]
    return sums


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's float32 sum of
    squares (summed leaf by leaf, as the reference)."""
    return torch.sqrt(sum(sharded_sums(
        tree_leaves(grads), lambda g: torch.sum(torch.square(g.float())))))


def clip_scale(grads, grad_clip: float | None):
    """The factor that clips `grads` to global norm `grad_clip`: min(1,
    clip / (norm + 1e-9)), or None without clipping."""
    if grad_clip is None:
        return None
    return torch.clamp(grad_clip / (global_norm(grads) + 1e-9), max=1.0)


def bias_corrections(step: torch.Tensor, b1: float, b2: float):
    """(1 - b1^step, 1 - b2^step) in float32."""
    s = step.to(torch.float32)
    return 1 - b1 ** s, 1 - b2 ** s


def slices(*xs):
    """Matching slices of same-shaped tensors along the leading axis, at
    most `SLICE_ELEMS` elements each (the whole tensor when it is 0-d or
    small)."""
    n = xs[0].numel()
    if xs[0].dim() == 0 or n <= SLICE_ELEMS:
        yield xs
        return
    rows = max(1, SLICE_ELEMS // max(n // xs[0].shape[0], 1))
    for i in range(0, xs[0].shape[0], rows):
        yield tuple(x[i:i + rows] for x in xs)


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float | None = 1.0, inplace: bool = False):
    """Returns (new_params, new_state).  `lr` may be a 0-d tensor.
    Clip by the global norm, bias-correct, decay matrices only (ndim >=
    2), in the reference's order.  With `inplace` the parameters and the
    moments are updated where they lie and returned."""
    if not inplace:
        params = tree_map(_clone, params)
        state = AdamWState(state.step, tree_map(_clone, state.m),
                           tree_map(_clone, state.v))
    step = state.step + 1
    scale = clip_scale(grads, grad_clip)
    b1c, b2c = bias_corrections(step, b1, b2)

    def upd(p, g, m, v):
        wd = weight_decay if p.dim() >= 2 else 0.0
        for ps, gs, ms, vs in slices(p, g, m, v):
            gs = gs.float()
            if scale is not None:
                gs = gs * scale
            ms.mul_(b1).add_((1 - b1) * gs)
            vs.mul_(b2).add_((1 - b2) * gs * gs)
            u = (ms / b1c) / (torch.sqrt(vs / b2c) + eps)
            pf = ps.float()
            ps.copy_(pf - lr * (u + wd * pf))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        upd(*locals_of(p, g, m, v))
    return params, AdamWState(step=step, m=state.m, v=state.v)

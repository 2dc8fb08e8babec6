"""Sharding rules of the port (`repro.launch.sharding`).

The model half places parameters, batches and decode caches on the
production mesh (`launch.mesh`), by the reference's rules:
  * FSDP: large matrices shard their d_model-ish axis over ("pod",
    "data"); the optimizer state inherits it (ZeRO-3).
  * TP over "model": attention and RWKV head axes, the MLP hidden axis,
    the MoE expert axis, Mamba's inner channels; GQA K/V projections
    replicate over "model" (the Megatron GQA layout).
  * Decode caches shard the sequence over "model".
  * Embedding: vocab over "model".
A spec is the reference's `PartitionSpec` as a tuple: one entry per
tensor dim, None, an axis name, or a tuple of names (a one-name tuple is
written as the name, as `PartitionSpec` normalizes it).  `sanitize` drops
a mesh axis whose size does not divide the dim (granite's 49,155 vocab,
rwkv's 40 heads on 16), so every shard is even.  A `NamedSharding` turns
a spec into `DTensor` placements: a dim sharded over several mesh axes
takes `Shard(d)` on each, the major axis first, as JAX's tuple order.
A layer runs on its parameters' "model" shards: `Local` views of the
local shards are gathered over the data-parallel axes only, one layer
at a time, where the layer runs (`pspec.gather_param`), and the model
code partitions its activations over "model" to match (`pspec`).

The campaign half: a replay campaign's trace axis partitions over the
campaign mesh (`launch.mesh.make_campaign_mesh`), and everything else
(timing tables, scenario rows, policy knobs) is replicated, i.e. copied
to each shard's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import CampaignMesh, axis_sizes

Spec = tuple          # entries: None | str | tuple[str, ...]


# ------------------------------------------------------------- the rules
def _entry(axes):
    """One spec entry as `PartitionSpec` keeps it: None, a name, or a
    tuple of two names or more."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes
    axes = tuple(axes)
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


def _fsdp(mesh):
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return axes if axes else None


def path_str(path) -> str:
    """A leaf's path in a tree of nested dicts, keys joined by "/"
    (the reference's `_path_str`)."""
    return "/".join(str(k) for k in path)


def param_spec(path: str, ndim: int, mesh, cfg: ModelConfig) -> Spec:
    """The spec of one parameter, by its path (the reference's rules,
    leaf for leaf)."""
    fsdp = _fsdp(mesh)
    stacked = path.startswith("stage/")   # scan-stacked: leading R dim
    leaf = path.rsplit("/", 1)[-1]
    rwkv_kv = cfg.ssm_kind == "rwkv6" and leaf in ("wk", "wv")

    def wrap(*spec):
        spec = spec + (None,) * (ndim - len(spec) - (1 if stacked else 0))
        return tuple(_entry(s) for s in ((None,) + spec if stacked
                                         else spec))

    if leaf == "embed":
        return wrap("model", None)
    if leaf == "lm_head":
        return wrap(fsdp, "model")

    d3 = (ndim - (1 if stacked else 0)) == 3

    # attention / rwkv head-structured weights [d, H, dh] / [H, dh, d]
    if d3 and (leaf in ("wq", "wr", "wg") or rwkv_kv):
        return wrap(fsdp, "model", None)
    if d3 and leaf in ("wk", "wv"):
        return wrap(fsdp, None, None)              # GQA KV: TP-replicated
    if d3 and leaf == "wo":
        return wrap("model", None, fsdp)           # row-parallel
    if leaf == "bq":
        return wrap("model", None)
    if leaf in ("bk", "bv"):
        return wrap()
    if leaf == "u":
        return wrap("model", None)

    # MoE: expert-parallel over 'model'
    if leaf == "router":
        return wrap(fsdp, None)
    if d3 and leaf in ("w_gate", "w_up"):
        return wrap("model", fsdp, None)           # [E, d, f]
    if d3 and leaf == "w_down":
        return wrap("model", None, fsdp)           # [E, f, d]

    # dense MLP
    if leaf in ("w_gate", "w_up"):
        return wrap(fsdp, "model")                 # [d, f] column-parallel
    if leaf == "w_down":
        return wrap("model", fsdp)                 # [f, d] row-parallel

    # mamba
    if leaf == "in_proj":
        return wrap(fsdp, "model")
    if leaf == "conv_w":
        return wrap(None, "model")
    if leaf in ("conv_b", "dt_bias", "d_skip"):
        return wrap("model")
    if leaf == "x_proj":
        return wrap("model", None)
    if leaf == "dt_proj":
        return wrap(None, "model")
    if leaf == "a_log":
        return wrap("model", None)
    if leaf == "out_proj":
        return wrap("model", fsdp)

    # rwkv lora
    if leaf == "w_lora_a":
        return wrap(fsdp, None)

    # norms / mixes / scalars / small vectors: replicate
    return wrap()


def sanitize(spec: Spec, shape: tuple, mesh) -> Spec:
    """Drop the mesh axes whose size does not evenly divide the dim
    (each axis in turn, against the product of those kept before it)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        keep: list[str] = []
        size = 1
        for a in (s if isinstance(s, tuple) else (s,)):
            if shape[i] % (size * sizes[a]) == 0:
                keep.append(a)
                size *= sizes[a]
        out.append(_entry(keep))
    return tuple(out)


# ------------------------------------------------------ per-layer views
# leaves that a layer gathers whole over "model" as well: Mamba's
# in_proj [d, 2 di] is stored split over its 2 di columns, so a rank's
# block is not its channels' x and z halves
WHOLE_OVER_MODEL = ("in_proj",)


@dataclasses.dataclass(frozen=True, eq=False)
class Local:
    """A rank's shard of a parameter as a layer runs it: `tensor` (the
    local shard, or one layer's slice of a stacked one; often an
    autograd leaf) of a whole tensor of `shape` and `stride` placed by
    `placements` on `mesh`; `gathered`, the placements the layer runs it
    with (the data-parallel dims whole); `grad_placements`, where each
    microbatch's gradient is reduced to before it is placed like the
    shard (None: straight there)."""

    tensor: torch.Tensor
    mesh: Any
    placements: tuple
    shape: torch.Size
    stride: tuple
    gathered: tuple
    grad_placements: tuple | None = None


def local_view(x: DTensor, t: torch.Tensor, leaf: str, layer: bool = False,
               grad_sharding: NamedSharding | None = None) -> Local:
    """`t`, the local shard of `x` (or, with `layer`, one layer's slice
    [i] of it, x being stacked [R, ...]), as a `Local`; `leaf` is the
    parameter's name (its path's last key)."""
    mesh = x.device_mesh
    where, shape, stride = tuple(x.placements), x.shape, x.stride()
    gp = None if grad_sharding is None else tuple(grad_sharding.placements)
    if layer:
        def drop(ps):
            return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                         for p in ps)
        where, shape, stride = drop(where), shape[1:], stride[1:]
        gp = None if gp is None else drop(gp)
    gathered = tuple(
        Replicate() if mesh.size(i) > 1 and (
            n != "model" or leaf in WHOLE_OVER_MODEL) else p
        for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, where)))
    if gp == where:
        gp = None
    return Local(t, mesh, where, torch.Size(shape), tuple(stride), gathered,
                 gp)


def layer_views(tree, path: tuple = ()):
    """A tree of `DTensor` parameters as the model runs it on their mesh:
    every leaf a `Local` of its local shard, a stage leaf [R, ...] a list
    of R per-layer views; plain tensors as they are."""
    if isinstance(tree, dict):
        return {k: layer_views(v, path + (k,)) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    t = tree.to_local()
    if path and path[0] == "stage":
        return [local_view(tree, t[i], path[-1], True)
                for i in range(t.shape[0])]
    return local_view(tree, t, path[-1])


# ------------------------------------------------------------- placements
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (`jax.sharding.NamedSharding`); `placements` needs
    a `DeviceMesh`.  A spec shorter than the tensor replicates the rest."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """`DTensor` placements of `spec`: `Shard(d)` on each mesh dim that
    shards tensor dim d, `Replicate()` elsewhere.  Several axes on one
    dim must come in the mesh's order (major first)."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        axes = () if s is None else (s if isinstance(s, tuple) else (s,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(x: torch.Tensor, mesh: DeviceMesh, where) -> DTensor:
    """`x` (the whole tensor, the same on every rank) as a `DTensor` under
    the placements `where`: each rank keeps its own block, with no
    communication.  A dim sharded over mesh dims of sizes n1, n2, ...
    (major first) splits into n1 * n2 * ... even blocks; an uneven split
    raises.  With every mesh dim replicated or of size 1 the local tensor
    is `x` itself."""
    coord = mesh.get_coordinate()
    blk = x
    for d in range(x.dim()):
        dims = [i for i, p in enumerate(where) if p == Shard(d)]
        n = math.prod(mesh.size(i) for i in dims)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(x.shape)} tensor does "
                             f"not split evenly over {n} ranks")
        block = 0
        for i in dims:
            block = block * mesh.size(i) + coord[i]
        step = x.shape[d] // n
        blk = blk.narrow(d, block * step, step)
    if blk is not x:
        blk = blk.contiguous().clone()
    return DTensor.from_local(blk, mesh, where, run_check=False,
                              shape=x.shape, stride=x.stride())


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    return distribute(x, sharding.mesh, sharding.placements)


def local(x):
    """The local shard of a `DTensor` (sharing its storage), or `x`."""
    return x.to_local() if isinstance(x, DTensor) else x


def gather(x):
    """The whole tensor of a `DTensor` (sharing its storage where no mesh
    dim of size > 1 shards it), or `x`."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def tree_map_with_path(fn, tree, path: tuple = ()):
    """`fn(path, leaf)` over a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(cfg: ModelConfig, mesh, params_shape) -> Any:
    """A `NamedSharding` for every leaf of a param tree (tensors of any
    device, `meta` included: only shapes are read)."""
    def one(path, leaf):
        spec = param_spec(path_str(path), len(leaf.shape), mesh, cfg)
        return NamedSharding(mesh, sanitize(spec, tuple(leaf.shape), mesh))

    return tree_map_with_path(one, params_shape)


def distribute_params(tree, cfg: ModelConfig, mesh: DeviceMesh) -> Any:
    """Place a param tree (whole tensors on every rank, e.g. the
    reference's parameters carried across) under `param_shardings`: the
    counterpart of `jax.device_put(x, param_shardings)`, no new draw."""
    sh = param_shardings(cfg, mesh, tree)
    return tree_map_with_path(
        lambda path, x: place(x, at(sh, path)), tree)


def at(tree, path):
    """The node of nested dicts at `path`."""
    for k in path:
        tree = tree[k]
    return tree


def opt_shardings(p_sh, opt_state) -> Any:
    """Shardings of an `AdamWState` or `AdamW8State` (`optim`) under
    parameter shardings `p_sh`: the moments (8-bit codes) like their
    parameters, an 8-bit row scale [..., 1] like its parameter with the
    last dim replicated, the step counter None (a plain tensor)."""
    def moment(sh, leaf):
        if isinstance(leaf, tuple):                    # QTensor(q, scale)
            spec = tuple(sh.spec) + (None,) * (len(leaf.q.shape)
                                               - len(sh.spec))
            scale = spec[:-1] + (None,) if spec else ()
            return type(leaf)(sh, NamedSharding(sh.mesh, scale))
        return sh

    def both(sh, leaves):
        return (moment(sh, leaves) if isinstance(sh, NamedSharding)
                else {k: both(sh[k], leaves[k]) for k in sh})

    return type(opt_state)(None, both(p_sh, opt_state.m),
                           both(p_sh, opt_state.v))


# ------------------------------------------------------------------ inputs
def batch_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, (_entry(_fsdp(mesh)), None))


def cache_shardings(cfg: ModelConfig, mesh, cache_shape,
                    batch: int) -> Any:
    """Decode caches: batch over the data axes when it divides their size,
    sequence over "model"; SSM states shard their channel axes."""
    fsdp = _fsdp(mesh)
    sizes = axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in (fsdp or ()))
    bdim = fsdp if batch % max(dp_size, 1) == 0 and batch >= dp_size \
        else None

    def one(path, leaf):
        nd = len(leaf.shape)
        name = path[-1]
        if name in ("k", "v"):                 # [R, B, S, Hkv, dh]
            spec = (None, bdim, "model", None, None)
        elif name == "h":                      # mamba [R, B, di, ds]
            spec = (None, bdim, "model", None)
        elif name == "conv":                   # [R, B, dc-1, di]
            spec = (None, bdim, None, "model")
        elif name == "wkv":                    # rwkv [R, B, H, dk, dv]
            spec = (None, bdim, "model", None, None)
        elif name == "x_prev":                 # [R, B, 1, d]
            spec = (None, bdim, None, None)
        else:
            spec = (None,) * nd
        spec = tuple(_entry(s) for s in spec)
        return NamedSharding(mesh, sanitize(spec, tuple(leaf.shape), mesh))

    return tree_map_with_path(one, cache_shape)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ------------------------------------------------------ campaign sharding
def campaign_spec() -> tuple[str, ...]:
    """Partition the leading (trace) axis over "campaign"; every other
    axis is replicated."""
    return ("campaign",)


@dataclasses.dataclass(frozen=True)
class CampaignSharding:
    """`campaign_spec` on a mesh: row block i of a [T]-leading tensor
    lives on `mesh.devices[i]`."""

    mesh: CampaignMesh
    spec: tuple[str, ...] = campaign_spec()

    def slices(self, t: int) -> list[slice]:
        """The row block of each device; T must be a multiple of the
        device count."""
        k = self.mesh.size
        if t % k:
            raise ValueError(f"the trace axis ({t}) must be a multiple of "
                             f"the campaign mesh's {k} devices")
        tl = t // k
        return [slice(i * tl, (i + 1) * tl) for i in range(k)]


def campaign_sharding(mesh: CampaignMesh) -> CampaignSharding:
    return CampaignSharding(mesh)


def tree_map(fn, tree):
    """`fn` over every tensor leaf of a tuple / list / dict /
    NamedTuple tree (None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def shard_campaign(mesh: CampaignMesh, tree) -> list:
    """Split every [T, ...]-leading tensor of a per-stream tree into one
    row block per mesh device, placed on that device: a list of
    `mesh.size` trees.  T must be a multiple of the device count (the
    engine's `_shard_pad` handles a ragged T)."""
    t = int(tree_leaves(tree)[0].shape[0])
    sl = campaign_sharding(mesh).slices(t)
    return [tree_map(lambda x, s=s, d=d: x[s].to(d), tree)
            for s, d in zip(sl, mesh.devices)]

"""Per-rank cost counter of the port (`repro.launch.hlo_cost`).

The reference re-derives a step's roofline inputs from XLA's optimized
per-device HLO text.  The port has no HLO: it runs eagerly, op by op.
This module keeps the reference's name, so that a reader finds it, but
counts the aten ops one rank runs, through a `TorchDispatchMode`
(`CostMode`), with the reference's accounting rules:

  * flops        — matrix products (`mm`, `bmm`, `addmm`, `baddbmm`;
                   `einsum`, `matmul` and `linear` reach the mode as
                   these) 2 * output elements * K, plus 1 flop per
                   output element of the arithmetic ops of the
                   reference's `_ARITH` under their aten names
                   (`_ARITH_ATEN`); a fused aten op whose XLA lowering
                   is several of those ops (softmax, silu, their
                   backwards, ...) counts that many per output element
                   (`_FUSED`); reductions, copies, casts, gathers and
                   scatters count none, as the reference's movement ops;
  * hbm_bytes    — per op: operand bytes + output bytes.  Eager mode
                   launches one kernel per op, so this is the port's own
                   unfused traffic, not XLA's fusion-boundary estimate.
                   Views and metadata ops (the counterparts of `bitcast`,
                   `get-tuple-element`, `tuple`, `parameter`) count 0, as
                   do `empty` and its kin; a factory (`zeros`, `full`,
                   `*_like`, `fill_`) counts its output only;
  * collectives  — result bytes per kind (all-gather, reduce-scatter,
                   all-reduce, all-to-all), for the functional
                   collectives `DTensor` issues and `torch.distributed`
                   calls alike; a collective's result also counts as
                   HBM bytes, as in the reference.

Each hand-written kernel of the LLM path (`repro_torch::flash_attention`,
`wkv`, `wkv_bwd`, `mamba_scan`, `mamba_scan_bwd`; `kernels.library`)
is one op on every device and counts the kernel's own work: the flops and
bytes behind its bound (`*_flops`, `*_hbm_bytes` of its `ops.py`), the
same on the CPU, on the card and on fake tensors.  The mode sees the op,
never the plain version's inner ops.

Loops: the reference multiplies a while loop's body by its trip count
(`_trip`, XLA's `known_trip_count`), because HLO holds the body once.
Eager mode runs every trip, and each one is counted as it runs, so the
port has no trip-count logic.

Counts are per rank, over local tensors: an op on a `DTensor` is handed
back to `DTensor` (modes run before tensor subclasses), which runs it on
the local shards, and those ops are counted; the ops that `DTensor`'s
sharding propagation runs on fake tensors of the global shapes are not
(the mode enters that propagation's lock, `ShardingPropagator.
_fake_mode_lock`, and fake tensors of another `FakeTensorMode` than the
mode's are never counted).  Backward
ops run on autograd's threads (on the card a device thread), which carry
the mode with them, as `torch.utils.flop_counter.FlopCounterMode` relies
on.

Memory: the mode follows the storages that the counted ops create, from
their creation to their release, and keeps the largest sum live at once
(`peak_created`); `count` adds the arguments' bytes for `peak_bytes`.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

# the reference's _ARITH, by aten name (in-place and out= forms included)
_ARITH_ATEN = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp",
    "log", "tanh", "rsqrt", "sqrt", "pow", "neg", "abs", "floor", "ceil",
    "cos", "sin", "sigmoid", "expm1", "log1p", "where", "eq", "ne", "lt",
    "le", "gt", "ge", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "clamp", "clamp_min", "clamp_max", "atan2",
    "remainder", "fmod", "erf", "reciprocal", "square",
}
# fused aten ops: the number of _ARITH ops of their XLA lowering, per
# output element
_FUSED = {
    "silu": 2, "silu_backward": 5, "sigmoid_backward": 3,
    "tanh_backward": 3, "threshold_backward": 1, "_softmax": 3,
    "_softmax_backward_data": 3, "_log_softmax": 3,
    "_log_softmax_backward_data": 3, "logaddexp": 5, "addcmul": 2,
    "addcdiv": 2, "lerp": 3, "erfinv": 1,
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
# no traffic: allocation without a write, metadata, synchronisation
# (views, and ops that return their input, are recognised by schema and
# storage)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "set", "resize",
         "wait_tensor", "record_stream", "_wrap_tensor_autograd"}
# writes its output, reads no operand
_WRITES_ONLY = {"zeros", "ones", "full", "arange", "scalar_tensor",
                "zeros_like", "ones_like", "full_like", "new_zeros",
                "new_ones", "new_full", "fill", "zero", "rand", "randn",
                "randint", "rand_like", "randn_like", "normal", "uniform",
                "bernoulli", "random", "exponential", "linspace"}

# collective op name -> (kind, where its result tensors are): the
# functional collectives (`DTensor`'s redistributions) return theirs,
# the `torch.distributed` calls write into their first argument
_COLL_OPS = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "all_reduce": ("all-reduce", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "allreduce_": ("all-reduce", "arg0"),
    "allgather_": ("all-gather", "arg0"),
    "_allgather_base_": ("all-gather", "arg0"),
    "reduce_scatter_": ("reduce-scatter", "arg0"),
    "_reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "alltoall_base_": ("all-to-all", "arg0"),
}


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: dict = field(default_factory=dict)

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k, v in other.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0.0) + v * mult


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _kernel_costs() -> dict:
    """op name -> fn(args, outputs) -> (flops, bytes): each kernel's own
    counts (its `ops.py`)."""
    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.mamba_scan import ops as M
    from repro_torch.kernels.rwkv6 import ops as W

    def flash(a, out):
        q, k, v, causal, window = a
        b, sq, hq, d = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        return (F.attention_flops(b, sq, sk, hq, d, causal),
                F.attention_hbm_bytes(b, sq, sk, hq, hkv, d,
                                      q.element_size()))

    def wkv(a, out):
        b, t, h, d = a[0].shape
        return W.wkv_flops(b, t, h, d), W.wkv_hbm_bytes(
            b, t, h, d, state=a[5] is not None)

    def wkv_bwd(a, out):
        b, t, h, d = a[0].shape
        return W.wkv_bwd_flops(b, t, h, d), W.wkv_bwd_hbm_bytes(
            b, t, h, d, d_state=a[7] is not None, need_state=a[10])

    def scan(a, out):
        b, t, di = a[0].shape
        ds = a[2].shape[-1]
        state = M.mamba_scan_state_bytes(b, di, ds) if a[5] is not None \
            else 0
        return M.mamba_scan_flops(b, t, di, ds), \
            M.mamba_scan_hbm_bytes(b, t, di, ds) + state

    def scan_bwd(a, out):
        b, t, di = a[0].shape
        ds = a[2].shape[-1]
        return M.mamba_scan_bwd_flops(b, t, di, ds), \
            M.mamba_scan_bwd_hbm_bytes(b, t, di, ds, h0=a[9],
                                       d_state=a[7] is not None)

    return {"repro_torch::flash_attention": flash, "repro_torch::wkv": wkv,
            "repro_torch::wkv_bwd": wkv_bwd,
            "repro_torch::mamba_scan": scan,
            "repro_torch::mamba_scan_bwd": scan_bwd}


class _Quiet:
    """`DTensor`'s propagation lock, entered with the mode's counting
    off."""

    def __init__(self, mode, lock):
        self.mode, self.lock = mode, lock or contextlib.nullcontext()

    def __enter__(self):
        self.lock.__enter__()
        self.mode._quiet += 1

    def __exit__(self, *exc):
        self.mode._quiet -= 1
        return self.lock.__exit__(*exc)


class CostMode(TorchDispatchMode):
    """Counts every op it sees (see the module docstring): `costs`, a
    `Costs`; `ops`, {op name: [calls, flops, bytes]}; `peak_created`,
    the most bytes of storages created under the mode live at once.
    Ops on fake tensors of another `FakeTensorMode` than the one active
    where the mode is entered (`DTensor`'s sharding propagation) are not
    counted."""

    def __init__(self):
        super().__init__()
        self._quiet = 0
        self._lock = None
        self.costs = Costs()
        self.ops: dict[str, list] = {}
        self.live_created = 0
        self.peak_created = 0
        self._fake: FakeTensorMode | None = None
        self._live: dict[int, int] = {}
        self._kernels = _kernel_costs()

    def __enter__(self):
        self._fake = next((m for m in reversed(
            _get_current_dispatch_mode_stack())
            if isinstance(m, FakeTensorMode)), None)
        self._lock = ShardingPropagator.__dict__.get("_fake_mode_lock")
        ShardingPropagator._fake_mode_lock = _Quiet(self, self._lock)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._lock is not None:
            ShardingPropagator._fake_mode_lock = self._lock
        return super().__exit__(*exc)

    # ------------------------------------------------------------ memory
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_created -= n

    def _track(self, outs, ins) -> None:
        seen = {id(x.untyped_storage()) for x in ins}
        for x in outs:
            st = x.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_created += n
            weakref.finalize(st, self._free, key, n).atexit = False
        self.peak_created = max(self.peak_created, self.live_created)

    # ------------------------------------------------------------ counts
    def _note(self, name: str, flops: float, nbytes: float) -> None:
        self.costs.flops += flops
        self.costs.hbm_bytes += nbytes
        row = self.ops.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _foreign(self, xs) -> bool:
        return any(isinstance(x, FakeTensor) and x.fake_mode is not self._fake
                   for x in xs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs it on its shards
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self._foreign(ins) or self._foreign(outs):
            return out
        self._count(func, args, kwargs, ins, outs)
        self._track(outs, ins)
        return out

    def _count(self, func, args, kwargs, ins, outs) -> None:
        op = func._schema.name                      # "aten::add_" etc.
        ns, _, base = op.partition("::")
        if op in self._kernels:
            fl, nb = self._kernels[op](args, outs)
            self._note(op, fl, nb)
            return
        if base in _COLL_OPS:
            kind, where = _COLL_OPS[base]
            res = outs if where == "out" else _tensors(args[0])
            nb = sum(_nbytes(x) for x in res)
            self.costs.collectives[kind] = (self.costs.collectives.get(
                kind, 0.0) + nb)
            self._note(op, 0.0, nb)
            return
        name = base[:-1] if base.endswith("_") and not base.endswith(
            "__") else base                 # in-place: as its op
        if name in _FREE or func.is_view or ns == "prim":
            return
        if not func._schema.is_mutable and outs and {
                id(x.untyped_storage()) for x in outs} <= {
                id(x.untyped_storage()) for x in ins}:
            return                          # a view under another name
        out_b = sum(_nbytes(x) for x in outs)
        nb = out_b if name in _WRITES_ONLY else out_b + sum(
            _nbytes(x) for x in ins)
        fl = 0.0
        if name in _MATMUL:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            fl = 2.0 * outs[0].numel() * a.shape[-1]
            if name in ("addmm", "baddbmm"):
                fl += outs[0].numel()       # the added term
        elif name in _ARITH_ATEN:
            fl = float(sum(x.numel() for x in outs))
        elif name in _FUSED:
            fl = float(_FUSED[name] * sum(x.numel() for x in outs))
        self._note(op, fl, nb)


def local_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors, a `DTensor`
    by its local shard (what a rank holds)."""
    seen: dict[int, int] = {}
    for x in _tensors(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        st = x.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def result(costs: Costs) -> dict:
    """The reference's dict from counts."""
    c = costs
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes,
            "collectives": dict(c.collectives),
            "collective_bytes": sum(c.collectives.values())}


def count(fn, *args, **kw):
    """Run `fn(*args, **kw)` under a `CostMode`: (its output, the mode,
    the memory dict {argument_bytes, output_bytes, temp_bytes,
    peak_bytes}).  peak_bytes = the arguments' bytes + `peak_created`;
    temp_bytes = `peak_created`; output_bytes = the bytes of what the
    call returns (`local_bytes`)."""
    arg_b = local_bytes((args, kw))
    mode = CostMode()
    with mode:
        out = fn(*args, **kw)
    mem = {"argument_bytes": arg_b,
           "output_bytes": local_bytes(out) if _tensors(out) else 0,
           "temp_bytes": mode.peak_created,
           "peak_bytes": arg_b + mode.peak_created}
    return out, mode, mem


def analyze(fn, *args, **kw) -> dict:
    """The reference's `analyze` dict for one call of `fn(*args, **kw)`:
    {"flops", "hbm_bytes", "collectives", "collective_bytes"}."""
    _, mode, _ = count(fn, *args, **kw)
    return result(mode.costs)

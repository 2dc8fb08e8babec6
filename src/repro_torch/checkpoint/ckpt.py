"""Atomic, async-capable checkpoints of tensor trees (port of
`repro.checkpoint.ckpt`).

Layout: one directory per step with one `.npy` file per leaf (named
after its path in the tree), a JSON manifest, and a COMMIT marker
written last, so a partly written checkpoint is never restored.  A tree
is nested `dict` / `list` / `tuple` / NamedTuple with `torch.Tensor`,
numpy or scalar leaves; its path keys are dict keys, sequence indices
and NamedTuple field names joined by "/".

numpy has no bfloat16: a bfloat16 leaf is stored as its int16 bit view
and the manifest records every leaf's dtype.  An asynchronous save
copies every leaf to the host before its writer thread starts, so an
in-place update of the state after `save_checkpoint` returns cannot
reach the file.  On restore each leaf goes to the dtype and device of
the matching leaf of `like`, or to `device` when one is given (the
reference's `shardings`; the sharded counterpart waits for the model
half of `launch/sharding.py`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_BF16 = "torch.bfloat16"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: tuple = ()) -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {"/".join(prefix): tree}
    flat = {}
    for k, child in kids:
        flat.update(_flatten(child, prefix + (str(k),)))
    return flat


def _rebuild(like, leaves: dict, prefix: tuple = ()):
    """`like`'s structure with each leaf replaced by `leaves[path]`."""
    kids = _children(like)
    if kids is None:
        return leaves["/".join(prefix)]
    vals = [_rebuild(c, leaves, prefix + (str(k),)) for k, c in kids]
    if isinstance(like, dict):
        return type(like)(zip(like.keys(), vals))
    if _is_namedtuple(like):
        return type(like)(*vals)
    return type(like)(vals)


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf that shares no memory with it, and its
    dtype name (bfloat16 as its int16 bit view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        return t.numpy(), str(t.dtype)
    arr = np.array(leaf)
    return arr, f"numpy.{arr.dtype}"


def save_checkpoint(path: str, step: int, tree, *, blocking: bool = True
                    ) -> threading.Thread | None:
    """Write `tree` under path/step_<n>/ atomically.  With
    `blocking=False` the files are written by a thread (returned; its
    `error` attribute holds an exception it raised) from host copies
    taken before it starts."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    host = {k: _host_copy(v) for k, v in _flatten(tree).items()}
    names = {k: _SAFE.sub("_", k) + ".npy" for k in host}
    if len(set(names.values())) != len(names):
        raise ValueError(f"leaf paths collide as file names: {names}")

    def write():
        os.makedirs(tmp, exist_ok=True)
        for key, (arr, _) in host.items():
            np.save(os.path.join(tmp, names[key]), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": names,
                       "dtypes": {k: d for k, (_, d) in host.items()},
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write(str(step))

    if blocking:
        write()
        return None

    def run():
        try:
            write()
        except BaseException as e:          # re-raised by the caller's wait
            t.error = e

    t = threading.Thread(target=run, daemon=True)
    t.error = None
    t.start()
    return t


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        full = os.path.join(path, d)
        if d.startswith("step_") and os.path.exists(
                os.path.join(full, "COMMIT")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, dtype: str | None, like, key: str,
                  device):
    shape = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint leaf {key!r}: shape {arr.shape}, "
                         f"the restore target has {shape}")
    if dtype == _BF16:
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(dtype=like.dtype,
                    device=like.device if device is None else device)
    if isinstance(like, np.ndarray):
        return t.float().numpy().astype(like.dtype) if dtype == _BF16 \
            else arr.astype(like.dtype)
    return type(like)(arr.item()) if arr.ndim == 0 else arr


def load_checkpoint(path: str, like, step: int | None = None,
                    device: str | torch.device | None = None):
    """Restore the latest committed step (or `step`) into the structure
    of `like`: each leaf takes its `like` leaf's dtype and device, or
    `device` when given.  A shape that differs from `like`'s raises.
    Returns (tree, step)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    files, dtypes = manifest["leaves"], manifest.get("dtypes", {})
    dev = None if device is None else torch.device(device)
    out = {key: _restore_leaf(np.load(os.path.join(d, files[key])),
                              dtypes.get(key), leaf, key, dev)
           for key, leaf in _flatten(like).items()}
    return _rebuild(like, out), step


class CheckpointManager:
    """Keep-last-k manager with async save."""

    def __init__(self, path: str, keep: int = 3, every: int = 100):
        self.path = path
        self.keep = keep
        self.every = every
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree, force: bool = False):
        if not force and (step % self.every != 0):
            return
        self.wait()
        self._pending = save_checkpoint(self.path, step, tree,
                                        blocking=False)
        self._gc()

    def wait(self):
        if self._pending is not None:
            t, self._pending = self._pending, None
            t.join()
            if t.error is not None:
                raise t.error

    def _gc(self):
        if not os.path.isdir(self.path):
            return
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.path)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, like, device: str | torch.device | None = None):
        return load_checkpoint(self.path, like, device=device)

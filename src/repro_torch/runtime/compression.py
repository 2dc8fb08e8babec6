"""Compression utilities (port of `repro.runtime.compression`).

The gradient compressors for the slow cross-pod tier, the "pod" axis'
all-reduce: top-k sparsification with error feedback (the residual is
added back the next step), and int8 block quantisation (a float32
absmax scale per block of 256).  Both are plain torch on the
gradients' device, trees of nested dicts in and out, as the reference's
are plain `jnp`.  Top-k keeps the lower index among equal |g|, as
`lax.top_k` does (`torch.topk` does not promise an order among ties);
`torch.round` rounds half to even, as `jnp.round`.

The lossless unique-rows + index-map compressor the subarray-region
timing tables are stored in: a [..., G, D] row table whose G spatial
slots (banks x subarray regions) mostly share rows collapses to a
[..., U, D] unique-row store and an int32 [..., G] index map, with U the
maximum unique count over the leading axes so the store stays
rectangular.  The round trip is bit-exact: a storage layout, not an
approximation.  The tables are small (at most modules x bins x
banks*regions rows), so this stays numpy on the host:
`np.unique(axis=0)` fixes the lexicographic order of the store and
padding repeats the last unique row, which gives the reference's store
and index map bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import tree_leaves, tree_map


# ------------------------------------------------- gradient compressors
class TopKState(NamedTuple):
    residual: Any          # error-feedback memory, the gradients' tree


def topk_init(grads) -> TopKState:
    return TopKState(tree_map(torch.zeros_like, grads))


def kth_largest(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest entry of a 1-D tensor: a selection on the CPU
    (`kthvalue`), the least of `topk`'s k on a card, whose `topk` splits
    one long row over many blocks (its `kthvalue` walks it in one)."""
    if a.device.type == "cpu":
        return torch.kthvalue(a, a.numel() - k + 1).values
    return torch.topk(a, k, sorted=False).values.min()


def top_k_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, ties to the
    lower index (the set `lax.top_k` keeps): every entry above the k-th
    largest value, then the lowest-indexed entries equal to it."""
    thr = kth_largest(a, k)
    above = torch.nonzero(a > thr).squeeze(1)
    tied = torch.nonzero(a == thr).squeeze(1)[:k - above.numel()]
    return torch.cat([above, tied])


def topk_compress(grads, state: TopKState, ratio: float = 0.01):
    """Returns (sent, new state): each tensor's k = ratio * size entries of
    largest |g + residual| in dense form, the rest kept as the new
    residual."""
    def one(g, r):
        g = g + r                                     # error feedback
        flat = g.reshape(-1)
        k = max(1, int(flat.numel() * ratio))
        mask = torch.zeros_like(flat)
        mask[top_k_indices(flat.abs(), k)] = 1.0
        sent = (flat * mask).reshape(g.shape)
        return sent, g - sent

    out = tree_map(one, grads, state.residual)      # (sent, residual) leaves
    return (tree_map(lambda t: t[0], out),
            TopKState(tree_map(lambda t: t[1], out)))


def topk_wire_bytes(grads, ratio: float = 0.01) -> int:
    """Bytes on the wire: value (f16) + index (u32) per kept entry."""
    return sum(max(1, int(g.numel() * ratio)) * (2 + 4)
               for g in tree_leaves(grads))


class Int8State(NamedTuple):
    pass


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device: torch divides a CUDA
    tensor by a Python number as a product with its reciprocal, which can
    differ from the quotient in the last bit."""
    return x / torch.full_like(x, c)


def int8_compress(grads, block: int = 256):
    """Per-block absmax int8 quantisation: each leaf becomes (q int8
    [blocks, block], scale float32 [blocks, 1], shape, pad)."""
    def one(g):
        flat = g.reshape(-1)
        pad = (-flat.numel()) % block
        blocks = F.pad(flat, (0, pad)).reshape(-1, block)
        scale = torch.clamp_min(_div(blocks.abs().amax(1, keepdim=True),
                                     127.0), 1e-12)
        q = torch.clamp(torch.round(blocks / scale), -127, 127
                        ).to(torch.int8)
        return q, scale, tuple(g.shape), pad

    return tree_map(one, grads)


def int8_decompress(compressed):
    def one(t):
        q, scale, shape, pad = t
        flat = (q.float() * scale).reshape(-1)
        if pad:
            flat = flat[:-pad]
        return flat.reshape(shape)

    return tree_map(one, compressed)


def int8_error_bound(g: torch.Tensor, block: int = 256) -> float:
    """Max elementwise error <= scale / 2 = absmax / 254 per block."""
    flat = g.reshape(-1).abs()
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    return float(_div(flat.reshape(-1, block).amax(1), 254.0).max())


# ------------------------------------------- lossless row compression
def compress_rows(rows, min_u: int = 1):
    """Compress a [..., G, D] row table to (unique [..., U, D], index
    [..., G] int32).  Each leading-axis slice is deduplicated on its
    own (`np.unique(axis=0)`: unique rows sort lexicographically); U is
    the max unique count over all slices, floored at `min_u`, and
    shorter slices pad by repeating their last unique row (real rows,
    never indexed)."""
    rows = np.asarray(rows)
    if rows.ndim < 2:
        raise ValueError(f"rows must be [..., G, D], got {rows.shape}")
    lead = rows.shape[:-2]
    g, d = rows.shape[-2], rows.shape[-1]
    flat = rows.reshape(-1, g, d)
    uniqs, idxs = [], []
    for sl in flat:
        u, inv = np.unique(sl, axis=0, return_inverse=True)
        uniqs.append(u)
        idxs.append(inv.astype(np.int32).reshape(g))
    u_max = max(min_u, max(u.shape[0] for u in uniqs))
    store = np.empty((flat.shape[0], u_max, d), rows.dtype)
    for i, u in enumerate(uniqs):
        store[i, :u.shape[0]] = u
        store[i, u.shape[0]:] = u[-1]            # pad: repeat last row
    index = np.stack(idxs).reshape(lead + (g,))
    return store.reshape(lead + (u_max, d)), index


def decompress_rows(unique, index):
    """Exact inverse of `compress_rows`: gather [..., U, D] unique rows
    through the int [..., G] index map back to [..., G, D]."""
    unique = np.asarray(unique)
    index = np.asarray(index)
    return np.take_along_axis(unique, index[..., None], axis=-2)


def compress_stack(rows):
    """Compress a [S, G, D] row stack to (unique [S, U, D], index [G]
    int32) with ONE index map shared across the stack axis — the form
    the replay kernels gather through (the selected stack row varies
    per request, so the map must not vary with it).  Two slots share a
    unique column only if their rows agree at every stack position."""
    rows = np.asarray(rows)
    if rows.ndim != 3:
        raise ValueError(f"rows must be [S, G, D], got {rows.shape}")
    s, g, d = rows.shape
    cols = rows.transpose(1, 0, 2).reshape(g, s * d)
    uq, idx = compress_rows(cols)
    return (np.ascontiguousarray(
        uq.reshape(-1, s, d).transpose(1, 0, 2)), idx)


def rows_compression_ratio(unique, index) -> float:
    """Stored rows / dense rows of a compressed table: U / G (< 1.0
    means the unique store beats materializing every slot)."""
    return float(unique.shape[-2]) / float(index.shape[-1])

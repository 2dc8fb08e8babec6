"""The lossless unique-rows + index-map compressor the subarray-region
timing tables are stored in (port of the `compress_rows` family of
`repro.runtime.compression`).

A [..., G, D] row table whose G spatial slots (banks x subarray
regions) mostly share rows collapses to a [..., U, D] unique-row store
and an int32 [..., G] index map, with U the maximum unique count over
the leading axes so the store stays rectangular.  The round trip is
bit-exact: a storage layout, not an approximation.

The tables are small (at most modules x bins x banks*regions rows), so
this stays numpy on the host: `np.unique(axis=0)` fixes the
lexicographic order of the store and padding repeats the last unique
row, which gives the reference's store and index map bit for bit.
"""

from __future__ import annotations

import numpy as np


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

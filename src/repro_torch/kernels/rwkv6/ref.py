"""Plain PyTorch version of the WKV kernel: the chunked RWKV6 scan of the
reference's `repro.models.ssm.wkv_chunked` (its `repro.kernels.rwkv6.ref`
oracle), operation for operation, with the initial state and the final
state the decode cache needs."""

from __future__ import annotations

import torch

RWKV_CHUNK = 16   # the oracle's chunk; the CUDA kernel blocks at 64


def wkv_chunked(r, k, v, w_log, u, chunk: int = RWKV_CHUNK,
                state: torch.Tensor | None = None):
    """Chunked WKV scan.  r/k/v/w_log: [B, T, H, D] with T % chunk == 0,
    u [H, D], w_log = log(decay) <= 0, state [B, H, D, D] (zeros when
    None).  Returns (out [B, T, H, D], final state [B, H, D, D]), both
    float32.

    Within a chunk the pairwise decays are taken in log space (every
    exponent on the causal triangle is <= 0); across chunks the state
    S [Dk, Dv] is carried by a loop over the chunks, which reads and
    updates only S (every other term is formed for all chunks at once,
    element for element as the reference's scan body)."""
    b, t, h, dh = r.shape
    if t % chunk:
        raise ValueError(f"wkv_chunked: T = {t} is not a multiple of the "
                         f"chunk {chunk}")
    n = t // chunk

    def resh(x):  # [B,T,H,D] -> [N, B, H, L, D]
        return (x.float().reshape(b, n, chunk, h, dh)
                .permute(1, 0, 3, 2, 4))

    r_, k_, v_, wl = map(resh, (r, k, v, w_log))
    lcum = torch.cumsum(wl, dim=-2)                   # inclusive logs
    lprev = lcum - wl                                 # exclusive
    ltot = lcum[..., -1:, :]                          # [N, B, H, 1, D]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)

    # the terms that do not read the state, for every chunk at once
    # (the reference's scan body, batched over the chunk axis):
    # intra-chunk pairwise A[i,j] = sum_d r_i k_j exp(lp_i - lc_j), j < i
    ldiff = lprev[..., :, None, :] - lcum[..., None, :, :]  # [N,B,H,L,L,D]
    dec = torch.exp(torch.where(tri[:, :, None], ldiff, -torch.inf))
    del ldiff
    amat = torch.einsum("nbhid,nbhjd,nbhijd->nbhij", r_, k_, dec)
    del dec
    o_intra = torch.einsum("nbhij,nbhjd->nbhid", amat, v_)
    # diagonal u bonus: o_i += (r_i . (u * k_i)) v_i
    o_diag = torch.einsum("nbhld,nbhld->nbhl", r_,
                          u.float()[None, None, :, None, :] * k_)[..., None] \
        * v_
    rdec = r_ * torch.exp(lprev)
    # each chunk's state increment sum_j (k_j exp(lt - lc_j)) v_j
    kv = torch.einsum("nbhld,nbhle->nbhde", k_ * torch.exp(ltot - lcum), v_)
    decay = torch.exp(ltot)[..., 0, :, None]          # [N, B, H, D, 1]

    s = (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    o_inter = []
    for c in range(n):
        # inter-chunk: o_i += (r_i * exp(lp_i)) @ S;
        # S' = diag(exp(lt)) S + sum_j (k_j exp(lt - lc_j)) v_j
        o_inter.append(torch.einsum("bhld,bhde->bhle", rdec[c], s))
        s = decay[c] * s + kv[c]
    out = torch.stack(o_inter) + o_intra + o_diag
    out = out.permute(1, 0, 3, 2, 4).reshape(b, t, h, dh)
    return out, s


def wkv(r, k, v, w_log, u, state: torch.Tensor | None = None,
        chunk: int = RWKV_CHUNK):
    """r/k/v/w_log: [B, T, H, D] (any T); u: [H, D]; state [B, H, D, D] or
    None -> (o [B, T, H, D], final state [B, H, D, D]), float32.  T is
    padded to the chunk with zeros: a padded step has log-decay 0 and
    k = 0, so it leaves the state untouched."""
    t = r.shape[1]
    pad = (-t) % chunk
    if pad:
        r, k, v, w_log = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (r, k, v, w_log))
    o, s = wkv_chunked(r, k, v, w_log, u, chunk=chunk, state=state)
    return o[:, :t], s

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
    float32 (float64 when r is).

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
    dt = torch.promote_types(r.dtype, torch.float32)

    def resh(x):  # [B,T,H,D] -> [N, B, H, L, D]
        return (x.to(dt).reshape(b, n, chunk, h, dh)
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
                          u.to(dt)[None, None, :, None, :] * k_)[..., None] \
        * v_
    rdec = r_ * torch.exp(lprev)
    # each chunk's state increment sum_j (k_j exp(lt - lc_j)) v_j
    kv = torch.einsum("nbhld,nbhle->nbhde", k_ * torch.exp(ltot - lcum), v_)
    decay = torch.exp(ltot)[..., 0, :, None]          # [N, B, H, D, 1]

    s = (torch.zeros((b, h, dh, dh), dtype=dt, device=r.device)
         if state is None else state.to(dt))
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
    None -> (o [B, T, H, D], final state [B, H, D, D]), float32 (float64
    when r is).  T is padded to the chunk with zeros: a padded step has
    log-decay 0 and k = 0, so it leaves the state untouched."""
    t = r.shape[1]
    pad = (-t) % chunk
    if pad:
        r, k, v, w_log = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (r, k, v, w_log))
    o, s = wkv_chunked(r, k, v, w_log, u, chunk=chunk, state=state)
    return o[:, :t], s


def wkv_backward(r, k, v, w_log, u, d_o, state: torch.Tensor | None = None,
                 d_state: torch.Tensor | None = None,
                 chunk: int = RWKV_CHUNK):
    """Plain version of the backward kernel: `torch.autograd.grad`
    through `wkv` (chunk 16) on the same inputs, given the output's
    gradient d_o [B, T, H, D] and the final state's [B, H, D, D] (None:
    zeros).  Returns (dr, dk, dv, dw_log, du, the initial state's
    gradient or None when no state is given)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (r, k, v, w_log, u)]
        s0 = None if state is None else state.detach().requires_grad_()
        o, s = wkv(*xs, state=s0, chunk=chunk)
        outs, grads = [o], [d_o]
        if d_state is not None:
            outs.append(s)
            grads.append(d_state)
        g = torch.autograd.grad(outs, xs + ([] if s0 is None else [s0]),
                                grads)
    return (*g[:5], None if s0 is None else g[5])

"""Plain PyTorch version of the selective-scan kernel: the step loop of
the reference's oracle (`repro.kernels.mamba_scan.ref`, the recurrence
`repro.models.ssm.mamba_apply` scans), with the initial state h0 and the
final state the decode cache needs."""

from __future__ import annotations

import torch


def mamba_scan(x, dt, bmat, cmat, a, h0: torch.Tensor | None = None):
    """x, dt: [B, T, di]; bmat, cmat: [B, T, ds]; a: [di, ds]; h0
    [B, di, ds] (zeros when None) -> (y [B, T, di] in x's dtype, final
    state [B, di, ds] float32).

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = h_t . C_t

    No D-skip and no gate: they stay with the caller, as in the
    reference."""
    b, t, di = x.shape
    ds = bmat.shape[-1]
    h = (torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(t):
        x_t, d_t, b_t, c_t = x[:, i], dt[:, i], bmat[:, i], cmat[:, i]
        da = torch.exp(d_t.float()[..., None] * a)
        dbx = (d_t * x_t).float()[..., None] * b_t.float()[:, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, c_t.float()))
    return torch.stack(ys, dim=1).to(x.dtype), h

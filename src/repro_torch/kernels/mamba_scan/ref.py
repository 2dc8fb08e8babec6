"""Plain PyTorch versions of the selective-scan kernel and its backward:
the step loop of the reference's oracle (`repro.kernels.mamba_scan.ref`,
the recurrence `repro.models.ssm.mamba_apply` scans), with the initial
state h0 and the final state the decode cache needs, and its gradients
as the explicit reverse recurrence (`mamba_scan_backward`, and
`mamba_scan_with_grad`, the step loop with that recurrence as its
gradient)."""

from __future__ import annotations

import torch


def mamba_scan(x, dt, bmat, cmat, a, h0: torch.Tensor | None = None):
    """x, dt: [B, T, di]; bmat, cmat: [B, T, ds]; a: [di, ds]; h0
    [B, di, ds] (zeros when None) -> (y [B, T, di] in x's dtype, final
    state [B, di, ds] float32, float64 for float64 inputs).

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = h_t . C_t

    No D-skip and no gate: they stay with the caller, as in the
    reference.  float64 inputs compute in float64 (the gradient tests'
    witness)."""
    b, t, di = x.shape
    ds = bmat.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    h = (torch.zeros((b, di, ds), dtype=f, device=x.device)
         if h0 is None else h0.to(f))
    ys = []
    for i in range(t):
        x_t, d_t, b_t, c_t = x[:, i], dt[:, i], bmat[:, i], cmat[:, i]
        da = torch.exp(d_t.to(f)[..., None] * a)
        dbx = (d_t * x_t).to(f)[..., None] * b_t.to(f)[:, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, c_t.to(f)))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba_scan_backward(x, dt, bmat, cmat, a, dy, h0=None, dh=None):
    """The gradients of `mamba_scan` as its explicit reverse recurrence:
    x, dt, dy [B, T, di]; bmat, cmat [B, T, ds]; a [di, ds]; h0 and the
    final state's gradient dh [B, di, ds] or None (zeros) -> (dx, ddt
    [B, T, di], dB, dC [B, T, ds], dA [di, ds], dh0 [B, di, ds]), in the
    inputs' dtype (float64 inputs give float64).  With a_t = exp(dt_t A)
    and G_t the gradient with respect to h_t:

        G_t = dy_t C_t + a_{t+1} G_{t+1}      (G_T also takes dh)
        dC_t = sum_d dy_t h_t,  dB_t = sum_d G_t dt_t x_t
        dx_t = dt_t sum_s G_t B_t
        ddt_t = x_t sum_s G_t B_t + sum_s G_t a_t A h_{t-1}
        dA = sum_{b, t} G_t a_t dt_t h_{t-1},  dh0 = a_1 G_1

    The forward's states are kept (T of [B, di, ds])."""
    b, t, di = x.shape
    ds = bmat.shape[-1]
    f = torch.promote_types(x.dtype, torch.float32)
    x, dt, bmat, cmat, a, dy = (z.to(f) for z in (x, dt, bmat, cmat, a, dy))
    h = (torch.zeros((b, di, ds), dtype=f, device=x.device) if h0 is None
         else h0.to(f))
    hs = [h]
    for i in range(t):
        h = (torch.exp(dt[:, i, :, None] * a) * h
             + (dt[:, i] * x[:, i])[..., None] * bmat[:, i, None, :])
        hs.append(h)
    g = (torch.zeros((b, di, ds), dtype=f, device=x.device) if dh is None
         else dh.to(f))
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    da = torch.zeros_like(a)
    for i in reversed(range(t)):
        d_t, x_t, y_t = dt[:, i], x[:, i], dy[:, i]
        ea = torch.exp(d_t[..., None] * a)
        g = g + y_t[..., None] * cmat[:, i, None, :]               # G_t
        dc[:, i] = torch.einsum("bd,bds->bs", y_t, hs[i + 1])
        db[:, i] = torch.einsum("bds,bd->bs", g, d_t * x_t)
        gb = torch.einsum("bds,bs->bd", g, bmat[:, i])
        q = g * ea * hs[i]
        dx[:, i] = d_t * gb
        ddt[:, i] = x_t * gb + (q * a).sum(-1)
        da = da + (q * d_t[..., None]).sum(0)
        g = ea * g
    return dx, ddt, db, dc, da, g


class _PlainScan(torch.autograd.Function):
    """`mamba_scan` with `mamba_scan_backward` as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, h0):
        ctx.save_for_backward(x, dt, bmat, cmat, a, h0)
        return mamba_scan(x, dt, bmat, cmat, a, h0=h0)

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, bmat, cmat, a, h0 = ctx.saved_tensors
        *grads, dh0 = mamba_scan_backward(x, dt, bmat, cmat, a, dy, h0=h0,
                                          dh=dh)
        return (*grads, None if h0 is None else dh0)


def mamba_scan_with_grad(x, dt, bmat, cmat, a, h0=None):
    """`mamba_scan`, differentiated by the explicit reverse recurrence
    (`mamba_scan_backward`) instead of autograd through the step loop:
    the plain gradient the backward kernel is held against."""
    return _PlainScan.apply(x, dt, bmat, cmat, a, h0)

"""The selective scan's backward on the CPU: the port's plain backward
`repro_torch.kernels.mamba_scan.ref.mamba_scan_backward` (the explicit
reverse recurrence, the plain version the card's `mamba_scan_bwd.cu` is
held to) against autograd through `ref.mamba_scan` in float64, and
against the reference in float32: `jax.vjp` of its oracle
(`repro.kernels.mamba_scan.ref.mamba_scan`, from a zero state) and
`jax.vjp` of its Mamba mixer (`repro.models.ssm.mamba_apply`, whose
`lax.scan` the reference trains through) from a nonzero carried state,
with the port's mixer differentiating the scan through the plain
backward; and the card kernel's order of work (`mamba_scan_bwd.cu`:
16-step spans rebuilt from saved states and walked back, dB / dC
summed per thread, warp, block and cluster into partial rows) modelled
in float64 against the plain backward.  The wrapper on CPU tensors
stays differentiable.

Inputs from numpy, in tests/test_kernels.py's distribution (dt a
softplus, A = -exp(0.3 z)); ds 8 and 16, a ragged T.  Bounds: 1e-10 in
float64; atol = rtol = 1e-5 in float32.  The card's kernel is held to
the plain backward in tests/test_torch_train_card.py, which imports no
JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.kernels.mamba_scan import ref as ref_oracle
from repro.models import ssm as RSSM
from repro.models import transformer as RTF
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.models import ssm as SSM
from _torch_parity import one_thread as _one_thread  # noqa: F401

TOL = 1e-5
TOL64 = 1e-10
NAMES = ("x", "dt", "B", "C", "A", "h0")


def _inputs(seed, b, t, di, ds, state):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, t, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)) - 1.0))
    bm, cm = (0.5 * rng.standard_normal((b, t, ds)) for _ in range(2))
    a = -np.exp(0.3 * rng.standard_normal((di, ds)))
    h0 = 0.5 * rng.standard_normal((b, di, ds)) if state else None
    dy = rng.standard_normal((b, t, di))
    dh = rng.standard_normal((b, di, ds)) if state else None
    return x, dt, bm, cm, a, h0, dy, dh


def _t(arrs, dtype):
    return [None if z is None else torch.tensor(z, dtype=dtype)
            for z in arrs]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("b,t,di,ds,state", [
    (2, 37, 6, 8, False), (1, 70, 5, 16, True), (2, 130, 3, 8, True)])
def test_plain_backward_is_autograd_in_float64(b, t, di, ds, state):
    x, dt, bm, cm, a, h0, dy, dh = _t(_inputs(0, b, t, di, ds, state),
                                      torch.float64)
    ins = [x, dt, bm, cm, a] + ([h0] if state else [])
    for z in ins:
        z.requires_grad_()
    y, h = scan_ref.mamba_scan(x, dt, bm, cm, a, h0=h0)
    loss = (y * dy).sum() + ((h * dh).sum() if state else 0.0)
    want = torch.autograd.grad(loss, ins)
    got = scan_ref.mamba_scan_backward(
        *(z.detach() for z in (x, dt, bm, cm, a)), dy,
        h0=None if h0 is None else h0.detach(), dh=dh)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64
        _close(g, w, TOL64, name)


@pytest.mark.parametrize("b,t,di,ds", [(2, 37, 24, 8), (1, 64, 16, 16),
                                       (2, 21, 32, 16)])
def test_plain_backward_matches_the_reference_oracle(b, t, di, ds):
    """jax.vjp of the reference's oracle (zero initial state) in float32."""
    x, dt, bm, cm, a, _, dy, _ = (
        None if z is None else z.astype(np.float32)
        for z in _inputs(1, b, t, di, ds, False))
    _, vjp = jax.vjp(ref_oracle.mamba_scan, *map(jnp.asarray,
                                                  (x, dt, bm, cm, a)))
    want = vjp(jnp.asarray(dy))
    got = scan_ref.mamba_scan_backward(*_t((x, dt, bm, cm, a, dy),
                                           torch.float32))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _close(g, w, TOL, name)


def _mixer(ds, seed=0):
    """One Mamba layer of reduced Jamba (without experts) on both sides,
    d_state `ds`, and the configs."""
    kw = {"n_experts": 0, "top_k": 0, "d_state": ds}
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(
        "jamba-1.5-large-398b"), n_layers=8), **kw)
    cfg = dataclasses.replace(reduced(get_config("jamba-1.5-large-398b"),
                                      n_layers=8), **kw)
    tree = jax.tree.map(np.asarray, RTF.init_params(
        jax.random.PRNGKey(seed), ref_cfg))
    params = convert.model_params(tree, cfg, device="cpu")
    name = next(f"l{i}" for i, s in enumerate(cfg.group_spec())
                if s.mixer == "mamba")
    rp = jax.tree.map(lambda z: z[0], tree["stage"][name]["mixer"])
    pp = {k: v[0].clone().requires_grad_()
          for k, v in params["stage"][name]["mixer"].items()}
    return ref_cfg, cfg, rp, pp


@pytest.mark.parametrize("ds", [8, 16])
def test_mixer_gradients_through_the_plain_backward(ds, monkeypatch):
    """The Mamba mixer from a nonzero carried state (conv tail and scan
    state): every parameter's gradient and the state's, the port's scan
    differentiated by the plain backward, against jax.vjp of the
    reference's mamba_apply, float32."""
    ref_cfg, cfg, rp, pp = _mixer(ds)
    rng = np.random.default_rng(5)
    b, s = 2, 23
    di = cfg.expand * cfg.d_model
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    conv = (0.5 * rng.standard_normal((b, cfg.d_conv - 1, di))).astype(
        np.float32)
    h0 = (0.5 * rng.standard_normal((b, di, ds))).astype(np.float32)
    dout = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    dh = rng.standard_normal((b, di, ds)).astype(np.float32)

    def fn(p, x, h0):
        out, st = RSSM.mamba_apply(p, x, ref_cfg,
                                   state={"conv": jnp.asarray(conv),
                                          "h": h0})
        return out, st["h"]
    _, vjp = jax.vjp(fn, rp, jnp.asarray(x), jnp.asarray(h0))
    r_p, r_x, r_h = vjp((jnp.asarray(dout), jnp.asarray(dh)))

    calls = []

    def scan(*args, h0=None):
        calls.append(1)
        return scan_ref.mamba_scan_with_grad(*args, h0=h0)
    monkeypatch.setattr(scan_ops, "mamba_scan", scan)
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(h0, requires_grad=True)
    out, st = SSM.mamba_apply(pp, tx, cfg, state={"conv": torch.tensor(conv),
                                                  "h": th})
    ((out * torch.tensor(dout)).sum() + (st["h"] * torch.tensor(dh)).sum()
     ).backward()
    assert calls == [1]
    for k, w in r_p.items():
        _close(pp[k].grad, w, TOL, k)
    _close(tx.grad, r_x, TOL, "x")
    _close(th.grad, r_h, TOL, "h0")


def test_wrapper_on_cpu_tensors_stays_differentiable():
    x, dt, bm, cm, a, h0, dy, dh = _t(_inputs(2, 2, 19, 8, 8, True),
                                      torch.float32)
    ins = [x, dt, bm, cm, a, h0]
    for z in ins:
        z.requires_grad_()
    before = scan_ops.mamba_scan.launches
    y, h = scan_ops.mamba_scan(x, dt, bm, cm, a, h0=h0)
    assert y.grad_fn is not None and h.grad_fn is not None
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    want = scan_ref.mamba_scan_backward(
        *(z.detach() for z in (x, dt, bm, cm, a)), dy, h0=h0.detach(), dh=dh)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, TOL, name)
    assert scan_ops.mamba_scan.launches == before


# mamba_scan_bwd.cu's shape of work: saved states every SPAN steps; a
# thread holds CH channels x NS states, a block CPB channels, a cluster
# CLUSTER blocks (one partial row of dB / dC)
SPAN, CH, NS, CPB, CLUSTER = 16, 2, 2, 128, 2


def _kernel_order_backward(x, dt, bm, cm, a, dy, h0, dh):
    """The backward in the kernel's order of work, in float64: the
    forward's states saved every SPAN steps; per span (the last first)
    the states rebuilt from the saved start, h_{t-1} and a_t kept, the
    span walked back with h_t the next step's h_{t-1} (the last step's the
    rebuild's end state); a short last span padded with steps of zero
    inputs; dB / dC summed over a thread's channels, its warp's lanes,
    the block's warps and the cluster's blocks into partial rows [rows,
    B, T, 2 ds], then over the rows; dx / ddt from a thread's partial
    sums over its states (dt gb, x gb + gq), then over the lanes; dA per
    chain, then over the batch rows."""
    b, t, di = x.shape
    ds = bm.shape[-1]
    sg = ds // NS                     # lanes a channel pair
    cgs = 32 // sg                    # channel pairs a warp
    warps = CPB // (cgs * CH)
    rows = -(-di // (CLUSTER * CPB))
    dp = rows * CLUSTER * CPB
    n_spans = -(-t // SPAN)
    tp = n_spans * SPAN

    def pad(z, shape):
        out = torch.zeros(shape, dtype=torch.float64)
        out[tuple(slice(0, n) for n in z.shape)] = z
        return out
    x, dt, dy = (pad(z, (b, tp, dp)) for z in (x, dt, dy))
    bm, cm = pad(bm, (b, tp, ds)), pad(cm, (b, tp, ds))
    a = pad(a, (dp, ds))
    h = torch.zeros((b, dp, ds), dtype=torch.float64) if h0 is None \
        else pad(h0, (b, dp, ds))
    g = torch.zeros_like(h) if dh is None else pad(dh, (b, dp, ds))
    saved = []
    for i in range(tp):                # the forward, saving every SPAN
        if i % SPAN == 0:
            saved.append(h)
        h = torch.exp(dt[:, i, :, None] * a) * h \
            + (dt[:, i] * x[:, i])[..., None] * bm[:, i, None, :]

    def channel_sum(prod):             # [B, dp, ds] -> [B, rows, ds]
        p = prod.reshape(b, rows, CLUSTER, warps, cgs, CH, ds)
        for axis in (5, 4, 3, 2):      # thread, lanes, warps, cluster
            p = p.sum(axis)
        return p

    def state_sum(prod):               # [B, dp, ds] -> [B, dp]
        return prod.reshape(b, dp, sg, NS).sum(-1).sum(-1)
    part = torch.zeros((rows, b, tp, 2 * ds), dtype=torch.float64)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dacc = torch.zeros_like(h)
    for k in reversed(range(n_spans)):
        h, hp, at = saved[k], [], []
        for u in range(SPAN):
            i = k * SPAN + u
            at.append(torch.exp(dt[:, i, :, None] * a))
            hp.append(h)
            h = at[u] * h + (dt[:, i] * x[:, i])[..., None] * bm[:, i, None, :]
        for u in reversed(range(SPAN)):
            i = k * SPAN + u
            d, xv, yv = dt[:, i, :, None], x[:, i, :, None], dy[:, i, :, None]
            ht = h if u == SPAN - 1 else hp[u + 1]
            g = g + yv * cm[:, i, None, :]
            part[:, :, i, :ds] = channel_sum(yv * ht).transpose(0, 1)
            part[:, :, i, ds:] = channel_sum(g * d * xv).transpose(0, 1)
            gb = (g * bm[:, i, None, :]).reshape(b, dp, sg, NS).sum(-1)
            g = at[u] * g
            q = g * hp[u]
            gq = (q * a).reshape(b, dp, sg, NS).sum(-1)
            dx[:, i] = (d * gb).sum(-1)
            ddt[:, i] = (xv * gb + gq).sum(-1)
            dacc = dacc + q * d
    db_dc = part.sum(0)
    return (dx[:, :t, :di], ddt[:, :t, :di], db_dc[:, :t, ds:],
            db_dc[:, :t, :ds], dacc.sum(0)[:di], g[:, :di])


@pytest.mark.parametrize("di,state", [(130, False), (300, True)])
@pytest.mark.parametrize("t", [1, 16, 37, 130])
@pytest.mark.parametrize("ds", [8, 16])
def test_kernel_order_of_work_matches_the_plain_backward(ds, t, di, state):
    """mamba_scan_bwd.cu's order of work, modelled in float64, gives the
    plain backward's gradients (`ref.mamba_scan_backward`, float64): T
    ragged against the saved states' spacing and di against a block's and
    a cluster's channels, from a zero state and from a state with a
    gradient into the final state."""
    x, dt, bm, cm, a, h0, dy, dh = _t(_inputs(7, 2, t, di, ds, state),
                                      torch.float64)
    got = _kernel_order_backward(x, dt, bm, cm, a, dy, h0, dh)
    want = scan_ref.mamba_scan_backward(x, dt, bm, cm, a, dy, h0=h0, dh=dh)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, TOL64, f"ds {ds}, T {t}, di {di}: d{name}")


def test_backward_bounds_count_the_work():
    """The bound's counts at jamba's training shape (1, 4096, 16384,
    16): 1.35 GB and 2.17e10 operations."""
    n_bytes = scan_ops.mamba_scan_bwd_hbm_bytes(1, 4096, 16384, 16)
    assert n_bytes == 4 * (5 * 4096 * 16384 + 4 * 4096 * 16 + 2 * 16384 * 16)
    assert scan_ops.mamba_scan_bwd_flops(1, 4096, 16384, 16) \
        == 4096 * 16384 * (20 * 16 + 4)
    with_state = scan_ops.mamba_scan_bwd_hbm_bytes(2, 10, 8, 8, h0=True,
                                                   d_state=True)
    assert with_state - scan_ops.mamba_scan_bwd_hbm_bytes(2, 10, 8, 8) \
        == 4 * 3 * 2 * 8 * 8

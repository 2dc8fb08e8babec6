"""The gradient of the port's WKV plain version against the reference on
the CPU: autograd through `repro_torch.kernels.rwkv6.ref.wkv` (what the
wrapper runs on a CPU tensor, and `ref.wkv_backward`, the plain version
the card's backward kernel is held to) against `jax.vjp` of
`repro.models.ssm.wkv_chunked` (the chunked scan the reference trains
RWKV6 through), with and without an initial state and with a gradient
flowing into the final state.  A ragged T is padded as the reference's
`rwkv6_apply` pads it (zeros, log decay 0).  Inputs from numpy, in
tests/test_kernels.py's distribution.  Bound: atol = rtol = 1e-4.

Then the algebra of the card's chunk-parallel backward kernel
(`wkv_bwd.cu`): `_three_pass_backward` is a float64 model of its three
passes in the kernel's order (chunk sums of the state gradient, the
reverse scan over chunks, each chunk's gradients from the state at its
start and the gradient at its end, the intra-chunk triangles factored
over sub-chunks, dw_log from the chunk-local identity), held against
`ref.wkv_backward` in float64 at rtol = atol = 1e-10, at the kernel's
chunk of 64 (sub-chunks of 16) and at 8 (sub-chunks of 2)."""

import jax
import jax.numpy as jnp
import torch.nn.functional as F
import numpy as np
import pytest
import torch

from repro.models import ssm as RSSM
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from _torch_parity import one_thread as _one_thread  # noqa: F401

TOL = 1e-4
TOL64 = 1e-10             # the float64 model of the kernel's passes


def _inputs(seed, b, t, h, d, state):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, t, h, d)) for _ in range(3))
    w = -np.exp(rng.standard_normal((b, t, h, d)) - 2.0)
    u = 0.3 * rng.standard_normal((h, d))
    s0 = 0.5 * rng.standard_normal((b, h, d, d)) if state else None
    d_o = rng.standard_normal((b, t, h, d))
    d_s = rng.standard_normal((b, h, d, d)) if state else None
    f32 = (lambda x: None if x is None else np.asarray(x, np.float32))
    return [f32(x) for x in (r, k, v, w, u, s0, d_o, d_s)]


def _ref_grads(r, k, v, w, u, s0, d_o, d_s):
    """jax.vjp of wkv_chunked, T padded to its chunk of 16."""
    t = r.shape[1]
    pad = (-t) % RSSM.RWKV_CHUNK

    def fn(r, k, v, w, u, s0):
        r, k, v, w = (jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
                      for x in (r, k, v, w))
        o, s = RSSM.wkv_chunked(r, k, v, w, u, state=s0)
        return o[:, :t], s

    args = [jnp.asarray(x) for x in (r, k, v, w, u)]
    if s0 is None:
        (o, s), vjp = jax.vjp(lambda *a: fn(*a, None), *args)
    else:
        (o, s), vjp = jax.vjp(fn, *args, jnp.asarray(s0))
    ct_s = jnp.zeros_like(s) if d_s is None else jnp.asarray(d_s)
    return [np.asarray(g) for g in vjp((jnp.asarray(d_o), ct_s))]


CASES = {"zero state": ((2, 64, 3, 64), False),
         "ragged T, D 32": ((2, 45, 4, 32), False),
         "from a state": ((2, 80, 2, 64), True),
         "from a state, ragged, D 32": ((1, 37, 3, 32), True)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_the_reference(case):
    shape, state = CASES[case]
    r, k, v, w, u, s0, d_o, d_s = _inputs(0, *shape, state)
    want = _ref_grads(r, k, v, w, u, s0, d_o, d_s)
    t = [None if x is None else torch.tensor(x)
         for x in (r, k, v, w, u, s0, d_o, d_s)]
    got = wkv_ref.wkv_backward(*t[:5], t[6], state=t[5], d_state=t[7])
    names = ["r", "k", "v", "w_log", "u"] + (["state"] if state else [])
    assert (got[5] is None) == (not state)
    for name, g, wnt in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=TOL, atol=TOL,
                                   err_msg=f"{case}: d{name}")


@pytest.mark.parametrize("state", [False, True])
def test_wrapper_is_differentiable_on_the_cpu(state):
    """`ops.wkv` on CPU tensors is the plain version: autograd through it
    gives `ref.wkv_backward`'s gradients bit for bit, final state's
    gradient included."""
    r, k, v, w, u, s0, d_o, d_s = _inputs(1, 2, 40, 2, 32, state)
    xs = [torch.tensor(x).requires_grad_() for x in (r, k, v, w, u)]
    s0_t = None if s0 is None else torch.tensor(s0).requires_grad_()
    o, s = wkv_ops.wkv(*xs, state=s0_t)
    outs, cts = [o], [torch.tensor(d_o)]
    if state:
        outs.append(s)
        cts.append(torch.tensor(d_s))
    got = torch.autograd.grad(outs, xs + ([s0_t] if state else []), cts)
    want = wkv_ref.wkv_backward(
        *(torch.tensor(x) for x in (r, k, v, w, u)), torch.tensor(d_o),
        state=None if s0 is None else torch.tensor(s0),
        d_state=None if d_s is None else torch.tensor(d_s))
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def test_backward_flop_and_byte_counts():
    """`wkv_bwd_flops` counts 14 D^2 + 16 D per step and (row, head);
    `wkv_bwd_hbm_bytes` the inputs, the chunk-start states and the
    outputs once, and with a final state's gradient that gradient and
    the final state."""
    assert wkv_ops.wkv_bwd_flops(1, 4096, 40, 64) == \
        4096 * 40 * (14 * 64 * 64 + 16 * 64)
    b, t, h, d = 2, 100, 3, 32
    n_chunks = 2
    base = 4 * (9 * b * t * h * d + 2 * h * d + n_chunks * b * h * d * d)
    assert wkv_ops.wkv_bwd_hbm_bytes(b, t, h, d) == base
    assert wkv_ops.wkv_bwd_hbm_bytes(b, t, h, d, d_state=True,
                                     need_state=True) == \
        base + 3 * 4 * b * h * d * d


# -------------------------------------------- the backward kernel's algebra
def _three_pass_backward(r, k, v, w, u, d_o, s0, d_s, chunk, sub):
    """float64 model of wkv_bwd.cu on [B, T, H, D] inputs, in its order.

    Pass 1, per chunk: dG = (r * exp(lprev))^T d_o and exp(ltot).  Pass
    2: G_end(c) for every chunk, from the final state's gradient (zeros
    when None) backwards, G_end(c - 1) = exp(ltot_c) * G_end(c) + dG_c;
    the initial state's gradient is G at chunk 0's start.  Pass 3, per
    chunk, from S at its start (the plain forward's) and G_end:
    dr = exp(lprev) (S d_o) + intra + u k (v . d_o), dk = exp(ltot -
    lcum) (G v) + intra + u r (d_o . v), dv = (k exp(ltot - lcum)) G +
    A^T d_o + (r . (u k)) d_o; the triangles' off-diagonal sub-blocks as
    products of tiles scaled from the anchors lam_J (J's last inclusive
    log, for A and dr) and mu_I (the inclusive log before I, for dk),
    the diagonal sub-blocks pairwise in log space; and
    dw_log_t = rowsum(G_end * S_end) + sum_{s > t} a_s - sum_{s >= t} b_s
    with a = r * (S_{t-1} d_o) and b = k * (G_t v), the state parts of
    dr and dk."""
    b, t, h, d = r.shape
    n = -(-t // chunk)
    pad = n * chunk - t

    def prep(x):                       # [B, T, H, D] -> [B, H, n L, D]
        return F.pad(x, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    r_, k_, v_, w_, g_ = map(prep, (r, k, v, w, d_o))
    states, s = [], (torch.zeros((b, h, d, d), dtype=r.dtype)
                     if s0 is None else s0)
    for c in range(n):                 # chunk-start states, plain forward
        states.append(s)
        lo, hi = c * chunk, min(t, (c + 1) * chunk)
        _, s = wkv_ref.wkv(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                           w[:, lo:hi], u, state=s)
    states.append(s)                   # the final state

    def logs(c):
        lc = torch.cumsum(w_[:, :, c * chunk:(c + 1) * chunk], dim=2)
        lp = F.pad(lc[:, :, :-1], (0, 0, 1, 0))    # lprev_i = lcum_{i-1}
        return lc, lp, lc[:, :, -1:]

    def part(x, c):
        return x[:, :, c * chunk:(c + 1) * chunk]

    # pass 1
    dg, dec = [], []
    for c in range(n):
        lc, lp, lt = logs(c)
        dg.append(torch.einsum("bhld,bhle->bhde", part(r_, c) * torch.exp(lp),
                               part(g_, c)))
        dec.append(torch.exp(lt[:, :, 0]))
    # pass 2
    g_end = [None] * n
    g = torch.zeros((b, h, d, d), dtype=r.dtype) if d_s is None else d_s
    for c in reversed(range(n)):
        g_end[c] = g
        g = dec[c][..., None] * g + dg[c]
    d_state = g
    # pass 3
    out = {x: [] for x in ("dr", "dk", "dv", "dw")}
    du = torch.zeros((h, d), dtype=r.dtype)
    for c in range(n):
        rc, kc, vc, gc = (part(x, c) for x in (r_, k_, v_, g_))
        lc, lp, lt = logs(c)
        ge = g_end[c]
        bm = torch.einsum("bhid,bhjd->bhij", gc, vc)   # d_o_i . v_j
        vdo = torch.diagonal(bm, dim1=2, dim2=3)
        dr = torch.exp(lp) * torch.einsum("bhie,bhde->bhid", gc, states[c])
        dk = torch.exp(lt - lc) * torch.einsum("bhie,bhde->bhid", vc, ge)
        dv = torch.einsum("bhjd,bhde->bhje", kc * torch.exp(lt - lc), ge)
        am = torch.zeros((b, h, chunk, chunk), dtype=r.dtype)
        for big_i in range(chunk // sub):
            si = slice(big_i * sub, (big_i + 1) * sub)
            for i in range(big_i * sub, (big_i + 1) * sub):
                for j in range(big_i * sub, i):       # diagonal, pairwise
                    e = torch.exp(lp[:, :, i] - lc[:, :, j])
                    am[:, :, i, j] = (rc[:, :, i] * kc[:, :, j] * e).sum(-1)
                    dr[:, :, i] += e * kc[:, :, j] * bm[:, :, i, j, None]
                    dk[:, :, j] += e * rc[:, :, i] * bm[:, :, i, j, None]
            mu = lc[:, :, big_i * sub - 1, None] if big_i else None
            for big_j in range(big_i):                # off-diagonal, I > J
                sj = slice(big_j * sub, (big_j + 1) * sub)
                lam = lc[:, :, (big_j + 1) * sub - 1, None]
                kq = kc[:, :, sj] * torch.exp(lam - lc[:, :, sj])
                pf = torch.exp(lp[:, :, si] - lam)
                am[:, :, si, sj] = torch.einsum("bhid,bhjd->bhij",
                                                rc[:, :, si] * pf, kq)
                dr[:, :, si] += pf * torch.einsum(
                    "bhij,bhjd->bhid", bm[:, :, si, sj], kq)
                rp = rc[:, :, si] * torch.exp(lp[:, :, si] - mu)
                dk[:, :, sj] += torch.exp(mu - lc[:, :, sj]) * torch.einsum(
                    "bhij,bhid->bhjd", bm[:, :, si, sj], rp)
        dv = dv + torch.einsum("bhij,bhie->bhje", am, gc)
        a, bb = rc * dr, kc * dk                      # the state parts
        bonus = u[None, :, None, :] * vdo[..., None]
        dr = dr + bonus * kc
        dk = dk + bonus * rc
        dv = dv + (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True) * gc
        du = du + (rc * kc * vdo[..., None]).sum((0, 2))
        z = (0.0 if c == n - 1 and d_s is None
             else (ge * states[c + 1]).sum(-1)[:, :, None])
        x = a - bb
        suffix = torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2]) - x
        dw = z + suffix - bb
        for name, val in zip(out, (dr, dk, dv, dw)):
            out[name].append(val)

    def back(parts):                   # [B, H, n L, D] -> [B, T, H, D]
        return torch.cat(parts, 2).permute(0, 2, 1, 3)[:, :t]
    return (*(back(out[x]) for x in out), du,
            None if s0 is None else d_state)


@pytest.mark.parametrize("chunk,sub", [(64, 16), (8, 2)])
@pytest.mark.parametrize("case", list(CASES))
def test_three_pass_algebra_matches_the_plain_backward(case, chunk, sub):
    """The kernel's three passes, modelled in float64, give autograd's
    gradients through the plain forward (`ref.wkv_backward`, float64):
    one chunk and a ragged last chunk, from a zero state and from a
    state with a gradient flowing into the final state."""
    shape, state = CASES[case]
    xs = [None if x is None else torch.tensor(x, dtype=torch.float64)
          for x in _inputs(2, *shape, state)]
    r, k, v, w, u, s0, d_o, d_s = xs
    got = _three_pass_backward(r, k, v, w, u, d_o, s0, d_s, chunk, sub)
    want = wkv_ref.wkv_backward(r, k, v, w, u, d_o, state=s0, d_state=d_s)
    assert (got[5] is None) == (want[5] is None) == (not state)
    for name, g, wnt in zip(["r", "k", "v", "w_log", "u", "state"], got,
                            want):
        if wnt is not None:
            torch.testing.assert_close(g, wnt, rtol=TOL64, atol=TOL64,
                                       msg=f"{case}, chunk {chunk}: d{name}")

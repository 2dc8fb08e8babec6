"""The gradient of the port's WKV plain version against the reference on
the CPU: autograd through `repro_torch.kernels.rwkv6.ref.wkv` (what the
wrapper runs on a CPU tensor, and `ref.wkv_backward`, the plain version
the card's backward kernel is held to) against `jax.vjp` of
`repro.models.ssm.wkv_chunked` (the chunked scan the reference trains
RWKV6 through), with and without an initial state and with a gradient
flowing into the final state.  A ragged T is padded as the reference's
`rwkv6_apply` pads it (zeros, log decay 0).  Inputs from numpy, in
tests/test_kernels.py's distribution.  Bound: atol = rtol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RSSM
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: on some CPU hosts a multi-threaded
    `torch.exp` returned values off in the fourth significant digit in
    some processes, never with one thread (ROADMAP queue C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    outputs once."""
    assert wkv_ops.wkv_bwd_flops(1, 4096, 40, 64) == \
        4096 * 40 * (14 * 64 * 64 + 16 * 64)
    b, t, h, d = 2, 100, 3, 32
    n_chunks = 2
    base = 4 * (9 * b * t * h * d + 2 * h * d + n_chunks * b * h * d * d)
    assert wkv_ops.wkv_bwd_hbm_bytes(b, t, h, d) == base
    assert wkv_ops.wkv_bwd_hbm_bytes(b, t, h, d, d_state=True,
                                     need_state=True) == \
        base + 2 * 4 * b * h * d * d

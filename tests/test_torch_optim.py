"""Parity of the port's optimizers (`repro_torch.optim`) with the JAX
reference on the CPU: tests/test_optim.py's cases on the port, and
AdamW, 8-bit AdamW and the warm-up-cosine schedule step for step against
the reference on the same numpy inputs.

Bounds: AdamW's parameters and moments within rtol 1e-6 (a few float32
ulps: the same order of operations, other `sqrt` and division code),
plus one ulp of the leaf's largest magnitude for an element that a
difference (`b1 m + (1 - b1) g`, `p - lr (u + wd p)`) cancels to near
zero; the schedule within rtol 1e-6
(XLA's and PyTorch's `cos` may differ in the last bit).  8-bit AdamW's
codes may differ by one where `x ** (1 / power)` rounds across a half of
the code grid on one side only: such flips are counted and printed and
held to one code each; scales within one float32 ulp.  Where clipping
is active the clip factor min(1, clip / norm) differs by the global
norm's last bits (the two libraries sum a leaf's squares in different
orders; measured and printed), and every moment and scale carries that
factor: its relative difference (twice for v, which squares it) is added
to those bounds, and two ulps to a scale's for the rounding of the
product and the sum that carry it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis or deterministic fallback

from repro.optim import adamw as R_adamw
from repro.optim import adamw8bit as R_adamw8
from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
from repro_torch import convert
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.adamw8bit import (QTensor, _dequant, _quant,
                                         adamw8_init, adamw8_update)
from repro_torch.optim.schedules import warmup_cosine
from _torch_parity import one_thread as _one_thread  # noqa: F401

F32_ULP = 2.0 ** -23


def _tree(seed, scale=1.0):
    """A small parameter tree with matrices, a vector and a stacked
    [R, ...] leaf, and a gradient tree of the same shapes (numpy)."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)
    params = {"w": n(16, 24, s=0.1), "b": n(24, s=0.1),
              "stage": {"k": n(3, 8, 12, s=0.1)}}
    grads = [{"w": n(16, 24, s=scale), "b": n(24, s=scale),
              "stage": {"k": n(3, 8, 12, s=scale)}} for _ in range(3)]
    return params, grads


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_tree_close(port, ref, rtol, atol_ulps=0.0):
    """Leaf by leaf within `rtol`, plus `atol_ulps` float32 ulps of the
    leaf's largest magnitude."""
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        node = port
        for p in path:
            node = node[p.key]
        r = np.asarray(r)
        atol = atol_ulps * F32_ULP * float(np.abs(r).max())
        np.testing.assert_allclose(node.numpy(), r, rtol=rtol, atol=atol,
                                   err_msg=str(path))


def _clip_gap(g, grad_clip=1.0) -> float:
    """Relative difference of the two clip factors on gradients `g`."""
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                              for x in jax.tree.leaves(g))))
    r = min(1.0, float(np.float32(grad_clip) / np.float32(norm + 1e-9)))
    from repro_torch.optim.adamw import clip_scale
    p = float(clip_scale(_t(g), grad_clip))
    return abs(p / r - 1)


# ------------------------------------------- tests/test_optim.py on the port
class TestQuant:
    @given(st.integers(0, 10), st.floats(0.1, 100.0))
    @settings(max_examples=20, deadline=None)
    def test_roundtrip_relative_error(self, seed, scale):
        x = torch.tensor(np.random.default_rng(seed).standard_normal(
            (8, 64)).astype(np.float32)) * scale
        d = _dequant(_quant(x, power=2.0), x.shape, x.numel(), power=2.0)
        err = (d - x).abs()
        s = x.abs().amax(-1, keepdim=True)
        tol = 2.2 * torch.sqrt(x.abs() * s) / 127.0 + 1.2 * s / 127.0 ** 2
        assert bool((err <= tol).all())

    def test_high_dynamic_range_survives(self):
        x = torch.tensor([1e-4, 1e-2, 1.0, 100.0])
        d = _dequant(_quant(x, power=4.0), x.shape, x.numel(), power=4.0)
        assert float(d[0]) > 0, "small entry collapsed to zero"
        np.testing.assert_allclose(d.numpy(), x.numpy(), rtol=0.25)

    def test_shapes_preserved(self):
        t = _quant(torch.zeros((3, 5, 7)))
        assert t.q.shape == (3, 5, 7) and t.q.dtype == torch.int8
        assert t.scale.shape == (3, 5, 1)


def test_adamw8_tracks_adamw():
    rng = np.random.default_rng(0)
    p = {"w": torch.tensor(rng.standard_normal((64, 64)).astype(
        np.float32)) * 0.1}
    tgt = torch.tensor(rng.standard_normal((64, 64)).astype(np.float32))

    def loss(q):
        return torch.mean((q["w"] @ q["w"].T - tgt @ tgt.T) ** 2)

    def grad(q):
        w = q["w"].clone().requires_grad_()
        loss({"w": w}).backward()
        return {"w": w.grad}

    o32, o8 = adamw_init(p), adamw8_init(p)
    p32 = p8 = p
    for _ in range(50):
        p32, o32 = adamw_update(grad(p32), o32, p32, 1e-2)
        p8, o8 = adamw8_update(grad(p8), o8, p8, 1e-2)
    l0, l32, l8 = (float(loss(q)) for q in (p, p32, p8))
    assert l8 < 0.6 * l0, (l0, l8)
    assert l8 < 1.5 * l32 + 0.05 * l0, (l32, l8)


def test_warmup_cosine_shape():
    lr = [float(warmup_cosine(s, 1e-3, warmup=10, total=100))
          for s in range(100)]
    assert lr[0] < lr[9] <= 1e-3 + 1e-9
    assert lr[50] < lr[10]
    assert lr[99] >= 1e-4 - 1e-9


# ----------------------------------------------------- parity per update
def test_warmup_cosine_matches_reference():
    steps = np.arange(0, 301, dtype=np.int32)
    for kw in ({}, {"peak_lr": 1e-3, "warmup": 10, "total": 100},
               {"peak_lr": 3e-3, "warmup": 5, "total": 40, "floor": 0.0}):
        want = np.asarray(ref_warmup_cosine(jnp.asarray(steps), **kw))
        got = warmup_cosine(torch.tensor(steps), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=kw)
        # a Python step and a 0-d int32 step (the optimizer's) agree
        for s in (0, 7, 150):
            assert float(warmup_cosine(s, **kw)) == float(
                warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw))


@pytest.mark.parametrize("clip", ["active", "inactive", "off"])
def test_adamw_update_matches_reference(clip):
    """Three updates from the same state: parameters, m and v within
    rtol 1e-6, the step equal; the in-place update gives the functional
    one's values bit for bit and leaves nothing else changed."""
    # gradient norms ~40 (clipped to 1.0) or ~4e-3 (not clipped)
    params, grads = _tree(0, scale=1.0 if clip == "active" else 1e-4)
    grad_clip = None if clip == "off" else 1.0
    lr = 1e-2
    r_p, r_o = params, R_adamw.adamw_init(params)
    p_p, p_o = _t(params), adamw_init(_t(params))
    i_p, i_o = _t(params), adamw_init(_t(params))
    for g in grads:
        r_p, r_o = R_adamw.adamw_update(g, r_o, r_p, lr, grad_clip=grad_clip)
        before = jax.tree.map(torch.clone, _t(g))
        p_p, p_o = adamw_update(_t(g), p_o, p_p, lr, grad_clip=grad_clip)
        i_p2, i_o2 = adamw_update(_t(g), i_o, i_p, lr, grad_clip=grad_clip,
                                  inplace=True)
        assert i_p2 is i_p and i_o2.m is i_o.m
        i_o = i_o2
        for a, b in zip(jax.tree.leaves(p_p), jax.tree.leaves(i_p)):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(before), jax.tree.leaves(_t(g))))
    assert int(p_o.step) == int(r_o.step) == 3
    gap = max(_clip_gap(g) for g in grads) if clip == "active" else 0.0
    print(f"adamw clip {clip}: clip factors differ by {gap:.3e} relative")
    _assert_tree_close(p_p, r_p, rtol=1e-6 + gap, atol_ulps=1)
    _assert_tree_close(p_o.m, r_o.m, rtol=1e-6 + gap, atol_ulps=1)
    _assert_tree_close(p_o.v, r_o.v, rtol=1e-6 + 2 * gap, atol_ulps=1)
    # and from the reference's state carried across
    carried = convert.optimizer_state(jax.tree.map(np.asarray, r_o), "cpu")
    _assert_tree_close(carried.m, r_o.m, rtol=0)
    assert int(carried.step) == 3


def _flips(port_q, ref_q):
    d = port_q.numpy().astype(np.int32) - np.asarray(ref_q).astype(np.int32)
    assert np.abs(d).max() <= 1, f"a code moved by {np.abs(d).max()}"
    return int((d != 0).sum())


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw8_update_matches_reference(clip):
    """Three 8-bit updates from the same state: codes equal up to
    counted flips of one code (printed), scales within one ulp, the
    parameters within rtol 1e-6 plus what a flipped code moves (held
    against the port's own dequantised moments)."""
    params, grads = _tree(1, scale=1.0 if clip == "active" else 1e-4)
    gap = max(_clip_gap(g) for g in grads) if clip == "active" else 0.0
    r_p, r_o = params, R_adamw8.adamw8_init(params)
    p_p, p_o = _t(params), adamw8_init(_t(params))
    flips, n_codes = {"m": 0, "v": 0}, 0
    for g in grads:
        r_p, r_o = R_adamw8.adamw8_update(g, r_o, r_p, 1e-2)
        p_p, p_o = adamw8_update(_t(g), p_o, p_p, 1e-2)
        for name in ("m", "v"):
            for path, rq in jax.tree_util.tree_leaves_with_path(
                    getattr(r_o, name),
                    is_leaf=lambda x: isinstance(x, R_adamw8.QTensor)):
                node = getattr(p_o, name)
                for p in path:
                    node = node[p.key]
                assert isinstance(node, QTensor)
                flips[name] += _flips(node.q, rq.q)
                np.testing.assert_allclose(
                    node.scale.numpy(), np.asarray(rq.scale),
                    rtol=F32_ULP + (2 * F32_ULP + (2 if name == "v" else 1)
                                    * gap if gap else 0.0),
                    atol=0, err_msg=str(path))
                n_codes += node.q.numel()
        # carry the reference's state across: the next update starts from
        # the same codes, so a flip cannot compound
        p_o = convert.optimizer_state(jax.tree.map(np.asarray, r_o), "cpu")
        p_p = _t(r_p)
    print(f"adamw8 clip {clip}: {flips['m']} m and {flips['v']} v code "
          f"flips of {n_codes // 2} codes each over 3 updates; clip "
          f"factors differ by {gap:.3e} relative")
    assert flips["m"] + flips["v"] <= n_codes // 100
    # one more update from the carried state: the parameters agree
    g = _t(grads[0])
    r_p2, _ = R_adamw8.adamw8_update(grads[0], r_o, r_p, 1e-2)
    p_p2, _ = adamw8_update(g, p_o, p_p, 1e-2)
    _assert_tree_close(p_p2, r_p2, rtol=1e-6 + gap, atol_ulps=1)


def test_quant_codes_match_reference():
    """The power-law codes of both powers on the same rows: equal up to
    counted flips of one code; scales (absmax) bitwise."""
    x = np.random.default_rng(3).standard_normal((64, 256)).astype(
        np.float32) * np.logspace(-6, 2, 256, dtype=np.float32)
    for power in (2.0, 4.0):
        r = R_adamw8._quant(jnp.asarray(x), power=power)
        p = _quant(torch.tensor(x), power=power)
        n = _flips(p.q, r.q)
        print(f"power {power}: {n} of {x.size} codes differ by one")
        assert n <= x.size // 100
        assert np.array_equal(p.scale.numpy(), np.asarray(r.scale))
        d = _dequant(p, x.shape, x.size, power=power).numpy()
        dr = np.asarray(R_adamw8._dequant(r, x.shape, x.size, power=power))
        same = p.q.numpy() == np.asarray(r.q)
        np.testing.assert_allclose(d[same], dr[same], rtol=F32_ULP * 4)

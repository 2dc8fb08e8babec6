"""The port's gradient at full depth against the reference on the CPU:
reduced rwkv6-3b (narrow, but its full 32 layers) in float32, with the
port's float64 run (`models.layers.widen`) as the witness.

At this depth and initialisation float32 does not resolve the gradient:
one float32 ulp of noise on the parameters moves either package's
grad_norm by up to ~4e-2, and both lie ~5e-4-5e-3 from the float64
witness.  So the bound on every float32 grad_norm gap is twice the
larger of the two packages' spreads under such noise (the same three
numpy draws on both), and the two spreads must be of one order: the
port's gradient is as sensitive as the reference's, no more.  This is
the CPU counterpart of `chip_smoke.py`'s full-width gradient check."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import transformer as RTF
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                    global_grad_norm)
from _torch_parity import one_thread as _one_thread  # noqa: F401

ARCH, LAYERS = "rwkv6-3b", 32
SEEDS = (100, 101, 102)
F32 = TrainConfig(dtype=torch.float32)
F64 = TrainConfig(dtype=torch.float64, grad_dtype=torch.float64)


def _tokens(cfg):
    return np.random.default_rng(10).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _norms():
    """Both packages' float32 grad norms, their moves under each noise
    draw, and the port's float64 norm, on one batch."""
    cfg = ref_reduced(ref_get_config(ARCH), n_layers=LAYERS)
    pcfg = reduced(get_config(ARCH), n_layers=LAYERS)
    params = RTF.init_params(jax.random.PRNGKey(0), cfg)
    toks = _tokens(cfg)
    grad = jax.jit(jax.grad(lambda p: RTF.loss_fn(
        p, toks[:, :-1], toks[:, 1:], cfg, dtype=jnp.float32)))
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "targets": torch.tensor(toks[:, 1:])}

    def ref_norm(p):
        return float(jnp.sqrt(sum(jnp.sum(x * x)
                                  for x in jax.tree.leaves(grad(p)))))

    def port_norm(p, tcfg=F32):
        port = convert.model_params(jax.tree.map(np.asarray, p), pcfg,
                                    device="cpu")
        if tcfg is F64:
            port = tree_map(lambda x: x.double(), port)
        return float(global_grad_norm(accumulate_grads(port, batch, pcfg,
                                                       tcfg)[0]))

    base = {"ref": ref_norm(params), "port": port_norm(params)}
    moves = {"ref": [], "port": []}
    leaves, tree = jax.tree.flatten(params)
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        noisy = jax.tree.unflatten(tree, [
            x * (1 + 2.0 ** -23 * rng.choice([-1, 0, 1], size=x.shape)
                 .astype(np.float32)) for x in leaves])
        moves["ref"].append(ref_norm(noisy) / base["ref"] - 1)
        moves["port"].append(port_norm(noisy) / base["port"] - 1)
    return base, moves, port_norm(params, F64)


def _spread(moves, who):
    return max(abs(x) for x in moves[who])


def test_port_is_as_sensitive_as_the_reference_at_full_depth():
    base, moves, _ = _norms()
    sp = {who: _spread(moves, who) for who in moves}
    print(f"{ARCH} at {LAYERS} layers: grad_norm reference "
          f"{base['ref']:.6f}, port {base['port']:.6f}; 1-ulp moves "
          f"reference {[f'{x:+.2e}' for x in moves['ref']]}, port "
          f"{[f'{x:+.2e}' for x in moves['port']]}")
    assert max(sp.values()) <= 10 * min(sp.values()), sp
    gap = abs(base["port"] / base["ref"] - 1)
    assert gap <= max(1e-5, 2 * max(sp.values())), (gap, sp)


def test_both_packages_lie_within_their_spread_of_the_float64_witness():
    base, moves, n64 = _norms()
    bound = max(1e-5, 2 * max(_spread(moves, w) for w in moves))
    gaps = {who: abs(n / n64 - 1) for who, n in base.items()}
    print(f"float64 witness {n64:.6f}; float32 gaps to it {gaps}, bound "
          f"{bound:.2e}")
    assert max(gaps.values()) <= bound, (gaps, bound)


def test_a_float64_run_stays_float64():
    """`widen` keeps float64 through the norms, the RWKV6 mixer, the
    logits and the loss: a float64 run's loss and gradients are float64,
    its loss within 1e-6 of the float32 run's and its grad norm within
    1e-3 (at two layers one float32 ulp of parameter noise moves the
    float32 grad norm by 2e-5-1e-4: tests/test_torch_train.py).  The
    plain WKV takes float64 inputs to float64 outputs."""
    pcfg = reduced(get_config(ARCH))
    params = convert.model_params(jax.tree.map(np.asarray, RTF.init_params(
        jax.random.PRNGKey(0), ref_reduced(ref_get_config(ARCH)))), pcfg,
        device="cpu")
    toks = _tokens(pcfg)
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "targets": torch.tensor(toks[:, 1:])}
    g32, l32 = accumulate_grads(params, batch, pcfg, F32)
    g64, l64 = accumulate_grads(tree_map(lambda x: x.double(), params),
                                batch, pcfg, F64)
    assert l64.dtype == torch.float64
    assert {g.dtype for g in tree_leaves(g64)} == {torch.float64}
    n32, n64 = float(global_grad_norm(g32)), float(global_grad_norm(g64))
    assert abs(n32 / n64 - 1) <= 1e-3, (n32, n64)
    assert abs(float(l32) / float(l64) - 1) <= 1e-6
    g = torch.Generator().manual_seed(3)
    r, k, v = (torch.randn((1, 40, 2, 8), generator=g, dtype=torch.float64)
               for _ in range(3))
    w = -torch.exp(torch.randn((1, 40, 2, 8), generator=g,
                               dtype=torch.float64) - 2)
    u = torch.randn((2, 8), generator=g, dtype=torch.float64)
    o64, s64 = wkv_ref.wkv(r, k, v, w, u)
    o32, s32 = wkv_ref.wkv(*(x.float() for x in (r, k, v, w, u)))
    assert o64.dtype == s64.dtype == torch.float64
    torch.testing.assert_close(o32, o64.float(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s32, s64.float(), rtol=1e-5, atol=1e-6)

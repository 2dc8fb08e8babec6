"""The port's training half on the card: the WKV backward kernel against
its plain version, the guards of the two kernels that have no backward,
and one reduced `train_step` on the card against the CPU.  This file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src:. python -m pytest -q --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_train_card.py

Every test needs an NVIDIA card and skips without one (decided inside
the `cuda` fixture, never at import).  Bounds: the backward kernel within
rtol = atol = 1e-3 of `torch.autograd.grad` through the plain version
(chunk 16; the kernel works on the forward's 64-step chunks in
parallel, from their saved start states); the card's training step within 1e-5 relative of
the CPU's on the loss, on grad_norm within 1e-5 or twice what one
float32 ulp of noise on the parameters moves the CPU's own
(`_grad_norm_noise`; tests/test_torch_train.py says why), every
parameter within atol 1e-6 + rtol 1e-4 (float32, TF32 off)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_map
from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                    global_grad_norm, train_step)

TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _wkv_inputs(b, t, h, d, device, seed, state):
    g = torch.Generator().manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g)
    r, k, v = (0.5 * n(b, t, h, d) for _ in range(3))
    w = -torch.exp(n(b, t, h, d) - 2.0)
    u = 0.3 * n(h, d)
    s0 = 0.5 * n(b, h, d, d) if state else None
    d_o = n(b, t, h, d)
    d_s = n(b, h, d, d) if state else None
    return [None if x is None else x.to(device)
            for x in (r, k, v, w, u, s0, d_o, d_s)]


BWD_CASES = [
    # b, t, h, d, initial state and final state's gradient
    (1, 64, 2, 64, False),       # one chunk
    (2, 200, 3, 64, False),      # ragged T, B > 1
    (1, 1, 2, 64, True),         # one step
    (2, 130, 2, 64, True),       # from a state, ragged
    (2, 45, 4, 32, True),        # D = 32
    (1, 300, 3, 32, False),      # D = 32, several chunks
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_wkv_backward_kernel_matches_plain(cuda, case):
    """Autograd through `ops.wkv` on the card (the forward kernel, then
    the backward kernel, one launch each) against the plain version's
    gradients on the same inputs."""
    b, t, h, d, state = case
    r, k, v, w, u, s0, d_o, d_s = _wkv_inputs(b, t, h, d, cuda, 7, state)
    xs = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    s0_t = None if s0 is None else s0.clone().requires_grad_()
    f0, b0 = wkv_ops.wkv.launches, wkv_ops.wkv_backward.launches
    o, s = wkv_ops.wkv(*xs, state=s0_t)
    outs, cts = [o], [d_o]
    if state:
        outs.append(s)
        cts.append(d_s)
    got = torch.autograd.grad(outs, xs + ([s0_t] if state else []), cts)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == f0 + 1
    assert wkv_ops.wkv_backward.launches == b0 + 1
    want = wkv_ref.wkv_backward(r, k, v, w, u, d_o, state=s0, d_state=d_s)
    names = ["r", "k", "v", "w_log", "u", "state"]
    for name, g, wnt in zip(names, got, want):
        err = (g - wnt).abs().max().item()
        print(f"{case} d{name}: max abs {err:.3e}")
        torch.testing.assert_close(g, wnt, rtol=TOL, atol=TOL,
                                   msg=f"{case} d{name}")


@pytest.mark.gpu
def test_wkv_backward_refuses_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u, _, d_o, _ = _wkv_inputs(1, 16, 2, 64, cuda, 0, False)
    chunks = torch.zeros((1, 1, 2, 64, 64), device=cuda)
    before = wkv_ops.wkv_backward.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_ops.wkv_backward(r, k, v, w, u, chunks, d_o.cpu())
    with pytest.raises(ValueError, match="chunk"):
        wkv_ops.wkv_backward(r, k, v, w, u, chunks[:, :, :1], d_o)
    assert wkv_ops.wkv_backward.launches == before


@pytest.mark.gpu
def test_kernels_without_a_backward_refuse_grad(cuda):
    """flash_attention and mamba_scan raise on grad-requiring CUDA inputs
    rather than return outputs that carry no gradient; under no_grad they
    launch as before."""
    q = torch.randn((1, 64, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_ops.flash_attention(q, kv, kv)
    x = torch.randn((1, 16, 32), device=cuda, requires_grad=True)
    dt = torch.rand((1, 16, 32), device=cuda)
    bm = torch.randn((1, 16, 16), device=cuda)
    a = -torch.rand((32, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        scan_ops.mamba_scan(x, dt, bm, bm, a)
    with torch.no_grad():
        f0, m0 = flash_ops.flash_attention.launches, \
            scan_ops.mamba_scan.launches
        flash_ops.flash_attention(q, kv, kv)
        scan_ops.mamba_scan(x, dt, bm, bm, a)
        assert flash_ops.flash_attention.launches == f0 + 1
        assert scan_ops.mamba_scan.launches == m0 + 1


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _grad_norm_noise(params, batch, cfg, tcfg, seeds=(100, 101, 102)):
    """How far one float32 ulp of noise on the parameters moves the
    gradient norm (relative, the largest over `seeds`: each parameter
    times 1 + 2^-23 * {-1, 0, 1} drawn with numpy)."""
    def norm(p):
        return float(global_grad_norm(accumulate_grads(p, batch, cfg,
                                                       tcfg)[0]))
    base, worst = norm(params), 0.0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        noisy = tree_map(lambda p: p * (1 + 2.0 ** -23 * torch.as_tensor(
            rng.choice([-1, 0, 1], size=tuple(p.shape)).astype(np.float32),
            device=p.device)), params)
        worst = max(worst, abs(norm(noisy) / base - 1))
    return worst


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three float32 steps of reduced rwkv6-3b (D = 32, accum 2, remat)
    on the card, through the WKV kernels, and on the CPU through the
    plain versions, from the same weights and batches."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced(get_config("rwkv6-3b"))
    tcfg = TrainConfig(accum_steps=2, dtype=torch.float32)
    cpu = TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    card = _tree(cpu, lambda t: t.to(cuda))
    opts = {"cpu": adamw_init(cpu), "cuda": adamw_init(card)}
    params = {"cpu": cpu, "cuda": card}
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (4, 65)).astype(np.int32)
               for _ in range(3)]

    def batch(toks, dev):
        return {"tokens": torch.tensor(toks[:, :-1], device=dev),
                "targets": torch.tensor(toks[:, 1:], device=dev)}

    noise = _grad_norm_noise(cpu, batch(batches[0], "cpu"), cfg, tcfg)
    bound = {"loss": 1e-5, "lr": 1e-5, "grad_norm": max(1e-5, 2 * noise)}
    b0 = wkv_ops.wkv_backward.launches
    for step, toks in enumerate(batches):
        metrics = {}
        for dev in ("cuda", "cpu"):
            params[dev], opts[dev], metrics[dev] = train_step(
                params[dev], opts[dev], batch(toks, dev), cfg, tcfg,
                inplace=True)
        for key, tol in bound.items():
            a, b = float(metrics["cuda"][key]), float(metrics["cpu"][key])
            print(f"step {step} {key}: card {a:.7g} cpu {b:.7g}")
            assert abs(a - b) <= tol * abs(b), (step, key, a, b, tol)
    assert wkv_ops.wkv_backward.launches == b0 + 3 * 2 * cfg.n_layers
    flat = []
    _tree({"a": params["cuda"], "b": params["cpu"]}, flat.append)
    n = len(flat) // 2
    for a, b in zip(flat[:n], flat[n:]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)

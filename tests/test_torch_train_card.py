"""The port's training half on the card: the WKV and selective-scan
backward kernels against their plain versions, flash attention's guard
(it has no backward), and reduced `train_step`s on the card against the
CPU (rwkv6-3b; Jamba with its experts, whose Mamba layers train through
both scan kernels).  This file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src:. python -m pytest -q --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_train_card.py

Every test needs an NVIDIA card and skips without one (decided inside
the `cuda` fixture, never at import).  Bounds: the backward kernel within
rtol = atol = 1e-3 of `torch.autograd.grad` through the plain version
(chunk 16; the WKV kernel works on the forward's 64-step chunks in
parallel, from their saved start states; the scan's on the forward's
`scan_ops.chunk()`-step spans, from theirs); the card's training step
within 1e-5 relative of
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
from repro_torch.kernels.mamba_scan import ref as scan_ref
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
    """flash_attention raises on grad-requiring CUDA inputs rather than
    return an output that carries no gradient; mamba_scan, which has its
    backward kernel, returns outputs with a grad_fn; under no_grad both
    launch as before."""
    q = torch.randn((1, 64, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_ops.flash_attention(q, kv, kv)
    x = torch.randn((1, 16, 32), device=cuda, requires_grad=True)
    dt = torch.rand((1, 16, 32), device=cuda)
    bm = torch.randn((1, 16, 16), device=cuda)
    a = -torch.rand((32, 16), device=cuda)
    y, h = scan_ops.mamba_scan(x, dt, bm, bm, a)
    assert y.grad_fn is not None and h.grad_fn is not None
    with torch.no_grad():
        f0, m0 = flash_ops.flash_attention.launches, \
            scan_ops.mamba_scan.launches
        flash_ops.flash_attention(q, kv, kv)
        scan_ops.mamba_scan(x, dt, bm, bm, a)
        assert flash_ops.flash_attention.launches == f0 + 1
        assert scan_ops.mamba_scan.launches == m0 + 1


SCAN_BWD_CASES = [
    # b, t, di, ds, initial state and final state's gradient
    (1, 64, 256, 16, False),        # one chunk
    (2, 200, 300, 16, False),       # ragged T and di, B > 1
    (1, 1, 64, 16, True),           # one step
    (2, 130, 96, 8, True),          # ds 8, from a state, ragged
    (1, 300, 128, 16, True),        # several chunks, from a state
    (2, 77, 40, 8, False),          # ds 8, di below a block
    # T not a multiple of the saved states' spacing (16), di not one of
    # a block's (128) or a cluster's (256) channels, B = 2
    (2, 37, 300, 16, True),         # 3 blocks: a cluster's second idle
    (2, 261, 390, 8, False),        # di % 4 != 0: single-float staging
    (2, 130, 520, 16, False),       # 5 blocks, 3 partial rows
]


def _scan_inputs(b, t, di, ds, device, seed, state):
    g = torch.Generator().manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g)
    x = 0.5 * n(b, t, di)
    dt = torch.nn.functional.softplus(n(b, t, di) - 1.0)
    bm, cm = 0.5 * n(b, t, ds), 0.5 * n(b, t, ds)
    a = -torch.exp(0.3 * n(di, ds))
    h0 = 0.5 * n(b, di, ds) if state else None
    dy = n(b, t, di)
    dh = n(b, di, ds) if state else None
    return [None if z is None else z.to(device)
            for z in (x, dt, bm, cm, a, h0, dy, dh)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_BWD_CASES)
def test_mamba_scan_backward_kernel_matches_plain(cuda, case):
    """Autograd through `ops.mamba_scan` on the card (the forward kernel
    saving its chunk states, then the backward kernel, one launch each)
    against `ref.mamba_scan_backward` on the same inputs, and a rerun
    bitwise the same."""
    b, t, di, ds, state = case
    x, dt, bm, cm, a, h0, dy, dh = _scan_inputs(b, t, di, ds, cuda, 11,
                                                state)
    runs = []
    for _ in range(2):
        xs = [z.clone().requires_grad_() for z in (x, dt, bm, cm, a)]
        h0_t = None if h0 is None else h0.clone().requires_grad_()
        f0 = scan_ops.mamba_scan.launches
        b0 = scan_ops.mamba_scan_backward.launches
        y, h = scan_ops.mamba_scan(*xs, h0=h0_t)
        outs, cts = [y], [dy]
        if state:
            outs.append(h)
            cts.append(dh)
        runs.append(torch.autograd.grad(
            outs, xs + ([h0_t] if state else []), cts))
        torch.cuda.synchronize()
        assert scan_ops.mamba_scan.launches == f0 + 1
        assert scan_ops.mamba_scan_backward.launches == b0 + 1
    want = scan_ref.mamba_scan_backward(x, dt, bm, cm, a, dy, h0=h0, dh=dh)
    names = ["x", "dt", "B", "C", "A", "h0"]
    for name, g, g2, wnt in zip(names, runs[0], runs[1], want):
        err = (g - wnt).abs().max().item()
        print(f"{case} d{name}: max abs {err:.3e}")
        assert torch.equal(g, g2), f"{case} d{name}: a rerun differs"
        torch.testing.assert_close(g, wnt, rtol=TOL, atol=TOL,
                                   msg=f"{case} d{name}")


@pytest.mark.gpu
def test_mamba_scan_saved_states_leave_the_forward_bitwise(cuda):
    """The forward with its states asked for (the grad path, its usual
    tile) gives the serve path's outputs bit for bit, and its saved
    states are the step loop's at every `scan_ops.chunk()`-th step: the
    serve launch's final state on each prefix, bit for bit."""
    every = scan_ops.chunk()
    for ds in (16, 8):
        x, dt, bm, cm, a, h0, _, _ = _scan_inputs(2, 200, 300, ds, cuda, 3,
                                                  True)
        y0, h_0 = scan_ops.mamba_scan(x, dt, bm, cm, a, h0=h0)
        y1, h_1, chunks = scan_ops._forward(x, dt, bm, cm, a, h0, None,
                                            save_chunks=True)
        assert torch.equal(y0, y1) and torch.equal(h_0, h_1)
        assert tuple(chunks.shape) == (-(-200 // every), 2, 300, ds)
        assert torch.equal(chunks[0], h0)
        for k in range(1, chunks.shape[0]):
            t = k * every
            _, h_t = scan_ops.mamba_scan(x[:, :t], dt[:, :t], bm[:, :t],
                                         cm[:, :t], a, h0=h0)
            assert torch.equal(chunks[k], h_t), f"ds {ds}, step {t}"


@pytest.mark.gpu
def test_mamba_scan_backward_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, bm, cm, a, _, dy, _ = _scan_inputs(1, 70, 64, 16, cuda, 0, False)
    chunks = torch.zeros((-(-70 // scan_ops.chunk()), 1, 64, 16),
                         device=cuda)
    before = scan_ops.mamba_scan_backward.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_ops.mamba_scan_backward(x, dt, bm, cm, a, chunks, dy.cpu())
    with pytest.raises(ValueError, match="chunk"):
        scan_ops.mamba_scan_backward(x, dt, bm, cm, a, chunks[:1], dy)
    with pytest.raises(ValueError, match="state dim"):
        scan_ops.mamba_scan_backward(x, dt, bm[..., :4], cm[..., :4],
                                     a[:, :4], chunks[..., :4], dy)
    assert scan_ops.mamba_scan_backward.launches == before


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


def _card_vs_cpu(cfg, cuda):
    """Three float32 steps (accum 2, remat) of `cfg` on the card and on
    the CPU from the same weights and batches, held to the file's
    bounds."""
    assert not torch.backends.cuda.matmul.allow_tf32
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
    flat = []
    _tree({"a": params["cuda"], "b": params["cpu"]}, flat.append)
    n = len(flat) // 2
    for a, b in zip(flat[:n], flat[n:]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Three float32 steps of reduced rwkv6-3b (D = 32, accum 2, remat)
    on the card, through the WKV kernels, and on the CPU through the
    plain versions, from the same weights and batches."""
    cfg = reduced(get_config("rwkv6-3b"))
    b0 = wkv_ops.wkv_backward.launches
    _card_vs_cpu(cfg, cuda)
    assert wkv_ops.wkv_backward.launches == b0 + 3 * 2 * cfg.n_layers


@pytest.mark.gpu
def test_jamba_train_step_on_the_card_matches_the_cpu(cuda):
    """The same for reduced Jamba with its experts (one 8-layer period:
    7 Mamba layers through the scan kernel and its backward, MoE on every
    second layer)."""
    cfg = reduced(get_config("jamba-1.5-large-398b"), n_layers=8)
    assert cfg.n_experts
    b0 = scan_ops.mamba_scan_backward.launches
    _card_vs_cpu(cfg, cuda)
    assert scan_ops.mamba_scan_backward.launches == b0 + 3 * 2 * 7

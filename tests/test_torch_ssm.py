"""Parity of the port's attention-free mixers with the JAX reference on
the CPU: the plain versions of the WKV and selective-scan kernels
(against the reference's oracles and its Pallas kernels in interpret
mode), and `models/ssm.py`'s RWKV6 and Mamba layers (prefill, a carried
state, decode) and initialisers.

Inputs are drawn with numpy from a seed; layer parameters are the
reference's initial tree with its constant leaves redrawn from numpy
(so no term is trivially 0 or 1), carried across with
`repro_torch.convert.model_params`.  Bounds: 1e-5 where the port follows
the oracle's order of operations (its einsums contract in their own
order); the reference's own 3e-4 against its Pallas kernels
(tests/test_kernels.py); 1e-4 between chunk sizes 16 and 64 (the
reference's bound between its chunks 32 and 64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.kernels.mamba_scan import ops as ref_scan
from repro.kernels.rwkv6 import ops as ref_wkv
from repro.models import ssm as RSSM
from repro.models import transformer as RTF
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF
from _torch_parity import one_thread as _one_thread  # noqa: F401


PALLAS_TOL = 3e-4


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _wkv_np(seed, b, t, h, d):
    """tests/test_kernels.py's distribution, from numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, t, h, d)) for _ in range(3))
    w = -np.exp(rng.standard_normal((b, t, h, d)) - 2.0)
    u = 0.3 * rng.standard_normal((h, d))
    return [x.astype(np.float32) for x in (r, k, v, w, u)]


def _scan_np(seed, b, t, di, ds):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, t, di))
    dt = np.logaddexp(rng.standard_normal((b, t, di)) - 1.0, 0.0)
    bm, cm = (0.5 * rng.standard_normal((b, t, ds)) for _ in range(2))
    a = -np.exp(0.3 * rng.standard_normal((di, ds)))
    return [z.astype(np.float32) for z in (x, dt, bm, cm, a)]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.tensor(x) for x in xs]


# ------------------------------------------------------------------- wkv
WKV_SHAPES = [(1, 64, 2, 64), (2, 128, 3, 64), (1, 100, 2, 64),  # pad path
              (2, 45, 4, 32)]                                   # reduced D


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv_plain_matches_the_oracle_and_pallas(shape):
    ins = _wkv_np(0, *shape)
    o, _ = wkv_ops.wkv(*_t(ins))
    assert o.dtype == torch.float32 and tuple(o.shape) == shape
    _close(o, ref_wkv.wkv(*_j(ins), impl="ref"), 1e-5)
    _close(o, ref_wkv.wkv(*_j(ins), impl="pallas_interpret"), PALLAS_TOL)


def test_wkv_plain_strong_decay_matches_pallas():
    """The reference's strong-decay case (log decay -7, u = 0)."""
    r, k, v, _, _ = _wkv_np(1, 1, 128, 2, 64)
    w = np.full_like(r, -7.0)
    u = np.zeros((2, 64), np.float32)
    o, _ = wkv_ops.wkv(*_t([r, k, v, w, u]))
    assert bool(torch.isfinite(o).all())
    _close(o, ref_wkv.wkv(*_j([r, k, v, w, u]), impl="pallas_interpret"),
           PALLAS_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_final_state_matches_wkv_chunked(with_state):
    """The state the decode cache takes, from zeros and from a carried
    state, against the reference's `wkv_chunked` (T a multiple of 16, as
    `rwkv6_apply` pads it)."""
    ins = _wkv_np(2, 2, 96, 3, 64)
    s0 = (0.5 * np.random.default_rng(3).standard_normal((2, 3, 64, 64))
          .astype(np.float32)) if with_state else None
    o, s = wkv_ops.wkv(*_t(ins), state=None if s0 is None
                       else torch.tensor(s0))
    o_r, s_r = RSSM.wkv_chunked(*_j(ins), state=None if s0 is None
                                else jnp.asarray(s0))
    _close(o, o_r, 1e-5)
    _close(s, s_r, 1e-5)


def test_wkv_chunk_16_and_64_agree():
    """The plain version's chunk (16) against the kernel's (64), ragged T:
    the same function up to rounding."""
    ins = _t(_wkv_np(4, 1, 200, 2, 64))
    o16, s16 = wkv_ref.wkv(*ins, chunk=16)
    o64, s64 = wkv_ref.wkv(*ins, chunk=64)
    _close(o16, o64, 1e-4)
    _close(s16, s64, 1e-4)


def test_wkv_chunked_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="multiple"):
        wkv_ref.wkv_chunked(*_t(_wkv_np(5, 1, 40, 2, 32)), chunk=16)


# ------------------------------------------------------------ mamba_scan
SCAN_SHAPES = [(1, 32, 64, 8), (2, 48, 128, 16), (1, 30, 96, 8)]  # padded


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_mamba_scan_plain_matches_the_oracle_and_pallas(shape):
    ins = _scan_np(0, *shape)
    y, _ = scan_ops.mamba_scan(*_t(ins))
    assert tuple(y.shape) == shape[:3]
    _close(y, ref_scan.mamba_scan(*_j(ins), impl="ref"), 1e-5)
    _close(y, ref_scan.mamba_scan(*_j(ins), impl="pallas_interpret",
                                  chunk=16), PALLAS_TOL)


def test_mamba_scan_state_carries_across_a_split():
    """Scanning T = 50 in one call equals 20 steps and then 30 from the
    first call's final state: outputs and final state."""
    x, dt, bm, cm, a = _t(_scan_np(1, 2, 50, 96, 16))
    y, h = scan_ops.mamba_scan(x, dt, bm, cm, a)
    y1, h1 = scan_ops.mamba_scan(x[:, :20], dt[:, :20], bm[:, :20],
                                 cm[:, :20], a)
    y2, h2 = scan_ops.mamba_scan(x[:, 20:], dt[:, 20:], bm[:, 20:],
                                 cm[:, 20:], a, h0=h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


# ------------------------------------------------------------ the layers
def _cfg(arch):
    kw = {"n_experts": 0, "top_k": 0} if arch.startswith("jamba") else {}
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _redraw_constants(tree, seed):
    """The reference's tree with its constant leaves (mixes, decay base,
    dt bias, conv bias, D-skip) redrawn from numpy."""
    rng = np.random.default_rng(seed)
    draws = {"mu_": lambda s: rng.uniform(0.0, 1.0, s),
             "w0": lambda s: -3.0 + rng.standard_normal(s),
             "dt_bias": lambda s: -2.0 + rng.standard_normal(s),
             "conv_b": lambda s: 0.1 * rng.standard_normal(s),
             "d_skip": lambda s: 1.0 + 0.1 * rng.standard_normal(s)}

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            fn = next((f for p, f in draws.items() if k.startswith(p)), None)
            out[k] = v if fn is None else fn(v.shape).astype(np.float32)
        return out

    return walk(tree)


def _layer(arch, seed=0):
    """One mixer layer's params on both sides (the first repeat of the
    reduced model's first layer of that kind), and the configs."""
    ref_cfg, cfg = _cfg(arch)
    tree = _redraw_constants(jax.tree.map(
        np.asarray, RTF.init_params(jax.random.PRNGKey(seed), ref_cfg)),
        seed)
    params = convert.model_params(tree, cfg, device="cpu")
    name = next(f"l{i}" for i, s in enumerate(cfg.group_spec())
                if s.mixer in ("mamba", "rwkv6"))
    ref_p = jax.tree.map(lambda x: jnp.asarray(x[0]),
                         tree["stage"][name]["mixer"])
    port_p = jax.tree.map(lambda x: x[0], params["stage"][name]["mixer"])
    return ref_cfg, cfg, ref_p, port_p


def _state_np(st):
    return {k: np.asarray(v) for k, v in st.items()}


@pytest.mark.parametrize("arch,apply_ref,apply_port", [
    ("rwkv6-3b", RSSM.rwkv6_apply, SSM.rwkv6_apply),
    ("jamba-1.5-large-398b", RSSM.mamba_apply, SSM.mamba_apply),
])
@pytest.mark.parametrize("mode", ["prefill", "carried", "decode"])
def test_mixer_matches_the_reference(arch, apply_ref, apply_port, mode):
    """Prefill (no state, ragged S = 37), a 23-token segment from a
    carried state, and one decode step from it: outputs and new
    states."""
    ref_cfg, cfg, ref_p, port_p = _layer(arch)
    rng = np.random.default_rng(9)
    x0, x1 = (rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
              for s in (37, 23 if mode == "carried" else 1))
    out_r, st_r = apply_ref(ref_p, jnp.asarray(x0), ref_cfg)
    out, st = apply_port(port_p, torch.tensor(x0), cfg)
    if mode != "prefill":
        st = {k: torch.tensor(v) for k, v in _state_np(st_r).items()}
        out_r, st_r = apply_ref(ref_p, jnp.asarray(x1), ref_cfg,
                                state=st_r)
        out, st = apply_port(port_p, torch.tensor(x1), cfg, state=st)
    assert set(st) == set(st_r)
    _close(out, out_r, 1e-5)
    for k in st_r:
        assert tuple(st[k].shape) == st_r[k].shape, k
        assert st[k].dtype == torch.float32, k
        _close(st[k], st_r[k], 1e-5)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_init_params_tree_and_constants(arch):
    """Leaf for leaf the reference's shapes; the constant leaves hold the
    reference's values: mixes 0.5, w0 -6, dt_bias -4.6, a_log =
    log(1..ds), D-skip 1, conv bias 0, group-norm scales 1."""
    ref_cfg, cfg = _cfg(arch)
    ref_tree = jax.tree.map(np.asarray, RTF.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    params = TF.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    consts = {"mu_r": 0.5, "mu_k": 0.5, "mu_v": 0.5, "mu_g": 0.5,
              "mu_w": 0.5, "w0": -6.0, "dt_bias": -4.6, "d_skip": 1.0,
              "conv_b": 0.0}
    seen = set()

    def walk(got, want, path):
        assert set(got) == set(want), path
        for k in want:
            g, w = got[k], want[k]
            if isinstance(w, dict):
                walk(g, w, f"{path}.{k}")
                continue
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32, \
                f"{path}.{k}"
            if k in consts:
                assert bool((g == consts[k]).all()), f"{path}.{k}"
                np.testing.assert_array_equal(w, np.float32(consts[k]))
                seen.add(k)
            if k == "a_log":
                # XLA's and PyTorch's log differ in the last bit at 1 in 8
                # of the values (1.2e-7 at log 7)
                np.testing.assert_allclose(g.numpy(), w, rtol=2e-7, atol=0)
                ds = cfg.d_state
                np.testing.assert_allclose(
                    np.exp(g.numpy()[0, 0]), np.arange(1, ds + 1), rtol=1e-6)
                seen.add(k)

    walk(params, ref_tree, "")
    want = ({"mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0"}
            if arch == "rwkv6-3b"
            else {"dt_bias", "d_skip", "conv_b", "a_log"})
    assert seen == want
    mixer = params["stage"]["l0"]["mixer"]
    if arch == "rwkv6-3b":
        assert bool((mixer["ln_out"]["scale"] == 1).all())
        # u at unit scale, w_lora_b at 0.01 (the reference's scales)
        assert 0.8 < float(mixer["u"].std()) < 1.0
        assert float(mixer["w_lora_b"].abs().max()) <= 0.02


def test_init_cache_matches_the_reference_tree():
    for arch in ("rwkv6-3b", "jamba-1.5-large-398b"):
        ref_cfg, cfg = _cfg(arch)
        want = RTF.init_cache(ref_cfg, 3, 40, dtype=jnp.float32)
        got = TF.init_cache(cfg, 3, 40, dtype=torch.float32, device="cpu")
        assert set(got) == set(want)
        for name in want:
            assert set(got[name]) == set(want[name])
            for leaf, w in want[name].items():
                g = got[name][leaf]
                assert tuple(g.shape) == w.shape and g.dtype == torch.float32
                assert not bool(g.any())


def test_moe_ffns_still_raise():
    """Jamba with its experts builds (MoE on every second layer, since
    models/moe.py is ported); what MoE still refuses is a top-k beyond
    its experts."""
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    assert cfg.n_experts > 0
    params = TF.init_params(torch.Generator(), cfg, device="meta")
    ffns = [sorted(params["stage"][f"l{i}"]["ffn"]) for i in range(8)]
    assert ffns[0] == ["w_down", "w_gate", "w_up"]
    assert ffns[1] == ["router", "w_down", "w_gate", "w_up"]
    bad = dataclasses.replace(cfg, top_k=cfg.n_experts + 1)
    tok = torch.zeros((1, 4), dtype=torch.long)
    p = TF.init_params(torch.Generator().manual_seed(0),
                       dataclasses.replace(cfg, n_layers=8), device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        TF.apply(p, tok, dataclasses.replace(bad, n_layers=8),
                 dtype=torch.float32)

"""Parity of the port's MoE FFN (`repro_torch.models.moe`) with the JAX
reference (`repro.models.moe`) on the CPU, and of the transformer,
serving engine and train step on the reduced MoE configs.

Inputs are drawn with numpy from a seed; the reference's params are
carried across with `repro_torch.convert.model_params`.  Configs:
reduced granite with its 32 experts (top-8, capacity 88 of a 256-token
group: plain `reduced()` gives 8 experts at top-8, whose capacity 328
exceeds the group and admits every choice), reduced arctic (8 experts,
top-2, a dense residual), reduced Jamba with its experts (8, top-2,
every second layer), a forced-drop case (top-4, inputs x 3, as
tests/test_models.py) and a padded group whose pads tie (300 tokens at
a group of 256: the 212 zero pads have uniform probabilities).

Bounds, float32: outputs within atol 1e-5 + rtol 1e-5, the atol in
units of the reference output's mean magnitude where that exceeds 1
(the forced-drop case's skewed inputs x 3 give outputs of mean
magnitude 96.8 and up to 605, where float32 sums taken in another order
differ by up to 5.7e-4, 3.2e-6 of the mean, at elements near zero); aux within 1e-6 relative; the
admitted (token, slot, expert, position) set equal to the reference's;
gradients of every MoE leaf and of the input within atol 1e-6 + rtol
1e-4, the atol in units of the leaf's largest reference gradient where
that exceeds 1 (sums of many large products that cancel: the
forced-drop case's router gradients reach 4.3e4); transformer logits
within 1e-4 (as tests/test_torch_serve.py); served tokens equal; train
steps at tests/test_torch_train.py's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import moe as RM
from repro.models import transformer as RTF
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_train import check_train_step
from _torch_parity import one_thread as _one_thread  # noqa: F401

# name -> (arch, `reduced` keywords, config fields replaced after it)
CONFIGS = {
    "granite32": ("granite-moe-1b-a400m", {"n_experts": 32}, {}),
    "arctic": ("arctic-480b", {}, {}),
    "jamba": ("jamba-1.5-large-398b", {"n_layers": 8}, {}),
    "forced_drop": ("granite-moe-1b-a400m", {}, {"top_k": 4}),
}
# name -> (config, input shape [B, S], input scale)
CASES = {
    "granite32": ("granite32", (2, 256), 1.0),
    "arctic": ("arctic", (2, 40), 1.0),
    "jamba": ("jamba", (1, 96), 1.0),
    "forced_drop": ("forced_drop", (1, 128), 3.0),
    "padded_ties": ("granite32", (1, 300), 1.0),
}


def _cfgs(name):
    arch, red, kw = CONFIGS[name]
    ref = ref_reduced(ref_get_config(arch), **red)
    port = reduced(get_config(arch), **red)
    if kw:
        ref = dataclasses.replace(ref, **kw)
        port = dataclasses.replace(port, **kw)
    return ref, port


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, requires_grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32),
                        requires_grad=requires_grad)


def _moe_case(case):
    """The case's configs, the reference's MoE params (a layer's, drawn by
    `moe_init`) and the input."""
    name, shape, scale = CASES[case]
    ref_cfg, cfg = _cfgs(name)
    dense = ref_cfg.dense_residual
    p = RM.moe_init(jax.random.PRNGKey(1), ref_cfg, dense)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((*shape, cfg.d_model))
    if case == "forced_drop":
        # a direction shared by every token skews the routing, so that
        # some experts receive more choices than their capacity
        x = x + rng.standard_normal(cfg.d_model)
    return ref_cfg, cfg, p, (x * scale).astype(np.float32)


class _Spy:
    """A module whose named attributes are replaced (the rest pass
    through), to record a function's intermediate results."""

    def __init__(self, mod, **hooks):
        self._mod, self._hooks = mod, hooks

    def __getattr__(self, name):
        return self._hooks.get(name) or getattr(self._mod, name)


def _admitted(dispatch, gate_idx) -> set:
    """{(token, slot, expert, position)} of a [G, S, E, C] dispatch mask
    and the [G, S, K] top-k indices (token = g * S + s)."""
    dispatch, gate_idx = np.asarray(dispatch), np.asarray(gate_idx)
    s = dispatch.shape[1]
    out = set()
    for g, si, e, c in zip(*np.nonzero(dispatch)):
        slot = int(np.nonzero(gate_idx[g, si] == e)[0][0])
        out.add((int(g * s + si), slot, int(e), int(c)))
    return out


def _ref_routed(p, x, cfg, monkeypatch):
    """The reference's (out, aux, dispatch, gate indices), un-jitted."""
    rec = {}

    def einsum(spec, *ops, **kw):
        if spec == "gsec,gsd->gecd":
            rec["dispatch"] = ops[0]
        return jnp.einsum(spec, *ops, **kw)

    def top_k(probs, k):
        rec["idx"] = jax.lax.top_k(probs, k)[1]
        return jax.lax.top_k(probs, k)

    monkeypatch.setattr(RM, "jnp", _Spy(jnp, einsum=einsum))
    monkeypatch.setattr(RM, "jax", _Spy(jax, lax=_Spy(jax.lax, top_k=top_k)))
    out, aux = RM.moe_apply(p, jnp.asarray(x), cfg)
    monkeypatch.undo()
    return out, aux, rec["dispatch"], rec["idx"]


def _port_routed(p, x, cfg, monkeypatch):
    rec = {}
    top_k = M.top_k

    def einsum(spec, *ops, **kw):
        if spec == "gsec,gsd->gecd":
            rec["dispatch"] = ops[0].detach()
        return torch.einsum(spec, *ops, **kw)

    def spy_top_k(probs, k):
        vals, idx = top_k(probs, k)
        rec["idx"] = idx
        return vals, idx

    monkeypatch.setattr(M, "torch", _Spy(torch, einsum=einsum))
    monkeypatch.setattr(M, "top_k", spy_top_k)
    out, aux = M.moe_apply(_t(p), torch.tensor(x), cfg)
    monkeypatch.undo()
    return out, aux, rec["dispatch"], rec["idx"]


# ------------------------------------------------------------- routing
def test_top_k_breaks_ties_to_the_lower_index():
    """All-equal probabilities (a padded token's): experts 0..k-1, as
    `jax.lax.top_k`; and rows with repeated values give the reference's
    values and indices."""
    flat = torch.full((32,), 1 / 32)
    assert M.top_k(flat, 8)[1].tolist() == list(range(8))
    assert np.asarray(jax.lax.top_k(jnp.full((32,), 1 / 32), 8)[1]).tolist() \
        == list(range(8))
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 5, (64, 32)).astype(np.float32) / 4
    vals, idx = M.top_k(torch.tensor(probs), 8)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(probs), 8)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    assert np.array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.mark.parametrize("s,e,k", [(256, 32, 8), (512, 32, 8), (2, 32, 8),
                                   (80, 8, 2), (300, 8, 4), (4096, 128, 2)])
def test_capacity_matches_the_reference(s, e, k):
    assert M.capacity(s, e, k) == RM.capacity(s, e, k)
    assert M.CAPACITY_FACTOR == RM.CAPACITY_FACTOR


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_group_size_matches_the_reference(name):
    ref_cfg, cfg = _cfgs(name)
    assert M.group_size(cfg) == RM.group_size(ref_cfg)


def test_granite32_capacity_is_below_the_group():
    _, cfg = _cfgs("granite32")
    s = M.group_size(cfg)
    assert (s, M.capacity(s, cfg.n_experts, cfg.top_k)) == (256, 88)


# --------------------------------------------------------------- moe_apply
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_the_reference(case, monkeypatch):
    ref_cfg, cfg, p, x = _moe_case(case)
    r_out, r_aux, r_disp, r_idx = _ref_routed(p, x, ref_cfg, monkeypatch)
    out, aux, disp, idx = _port_routed(p, x, cfg, monkeypatch)
    r_out = np.asarray(r_out)
    scale = max(1.0, float(np.abs(r_out).mean()))
    np.testing.assert_allclose(out.detach().numpy(), r_out,
                               atol=1e-5 * scale, rtol=1e-5)
    assert abs(float(aux) / float(r_aux) - 1) <= 1e-6, (aux, r_aux)
    got, want = _admitted(disp, idx), _admitted(r_disp, r_idx)
    assert got == want, (len(got - want), len(want - got))
    t = x.shape[0] * x.shape[1]
    if case == "forced_drop":
        assert len(want) < t * cfg.top_k, "no choice was dropped"
    if case == "padded_ties":
        s = disp.shape[1]
        pads = np.asarray(r_idx).reshape(-1, cfg.top_k)[t:]
        assert len(pads) == (-t) % s
        assert (pads == np.arange(cfg.top_k)).all()
        assert any(tok >= t for tok, *_ in want), "no pad was admitted"


@pytest.mark.parametrize("case", ["granite32", "arctic", "forced_drop",
                                  "padded_ties"])
def test_moe_grads_match_the_reference(case):
    """jax.grad and torch.autograd of sum(out * w) + aux with respect to
    every MoE leaf and the input."""
    ref_cfg, cfg, p, x = _moe_case(case)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        out, aux = RM.moe_apply(p, x, ref_cfg)
        return jnp.sum(out * w) + aux
    r_gp, r_gx = jax.grad(ref_loss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = _t(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = M.moe_apply(tp, tx, cfg)
    (torch.sum(out * torch.tensor(w)) + aux).backward()

    def close(got, want, path):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * scale,
                                   rtol=1e-4, err_msg=path)

    def walk(got, want, path):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                walk(got[k], want[k], f"{path}.{k}")
            return
        close(got.grad, want, path)
    walk(tp, r_gp, "ffn")
    close(tx.grad, r_gx, "x")


def test_moe_bf16_keeps_the_reference_dtypes():
    """bf16 inputs: the output in bf16, aux in float32, and within the
    reference's bf16 run by a few bf16 ulps: rtol 2^-6, atol one bf16
    ulp at the output's largest magnitude (2^-7 of it: the expert
    outputs are rounded to bf16 at that scale before they are
    combined)."""
    ref_cfg, cfg, p, x = _moe_case("arctic")
    r_out, r_aux = RM.moe_apply(p, jnp.asarray(x, jnp.bfloat16), ref_cfg)
    out, aux = M.moe_apply(_t(p), torch.tensor(x).bfloat16(), cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    r_out = np.asarray(r_out, np.float32)
    np.testing.assert_allclose(out.float().numpy(), r_out,
                               atol=2 ** -7 * float(np.abs(r_out).max()),
                               rtol=2 ** -6)
    assert abs(float(aux) / float(r_aux) - 1) <= 1e-3


def test_moe_ffns_refuse_a_top_k_beyond_the_experts():
    _, cfg = _cfgs("granite32")
    p = M.moe_init(torch.Generator(), cfg, False, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        M.moe_apply(p, torch.zeros((1, 4, cfg.d_model)),
                    dataclasses.replace(cfg, top_k=cfg.n_experts + 1))


# ------------------------------------------------------------- transformer
def _models(name):
    ref_cfg, cfg = _cfgs(name)
    ref_params = RTF.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, ref_params, convert.model_params(
        _np(ref_params), cfg, device="cpu")


@pytest.mark.parametrize("name", ["granite32", "arctic", "jamba"])
def test_model_params_carries_the_moe_leaves(name):
    """`convert.model_params` takes the MoE leaves (the arctic residual
    included) from the reference's tree, value for value, and
    `init_params` draws the same tree of shapes."""
    ref_cfg, cfg, ref_params, params = _models(name)
    own = TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(ref_params["stage"])
    moe = [(jax.tree_util.keystr(path), path, leaf) for path, leaf in leaves
           if path[1].key == "ffn"
           and "router" in ref_params["stage"][path[0].key]["ffn"]]
    assert any("router" in k for k, _, _ in moe)
    if name == "arctic":
        assert any("residual" in k for k, _, _ in moe)
    for key, path, leaf in moe:
        got, mine = params["stage"], own["stage"]
        for p in path:
            got, mine = got[p.key], mine[p.key]
        assert np.array_equal(got.numpy(), np.asarray(leaf)), key
        assert tuple(mine.shape) == leaf.shape, key


@pytest.mark.parametrize("name,s", [("granite32", 40), ("arctic", 40),
                                    ("jamba", 40)])
def test_prefill_decode_apply_match_the_reference(name, s):
    ref_cfg, cfg, ref_params, params = _models(name)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, s + 1))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.tensor(toks)
    f32 = {"dtype": jnp.float32}

    def close(got, want, tol=1e-4):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)

    lg_r, cache_r = RTF.prefill(ref_params, jt[:, :s], ref_cfg, max_len=64,
                                **f32)
    lg, cache = TF.prefill(params, tt[:, :s], cfg, max_len=64,
                           dtype=torch.float32)
    close(lg, lg_r)
    st_r, _ = RTF.decode_step(ref_params, cache_r, jt[:, s:], jnp.int32(s),
                              ref_cfg, **f32)
    st, _ = TF.decode_step(params, cache, tt[:, s:], s, cfg,
                           dtype=torch.float32)
    close(st, st_r)

    full_r, aux_r = RTF.apply(ref_params, jt, ref_cfg, **f32)
    full, aux = TF.apply(params, tt, cfg, dtype=torch.float32)
    close(full, full_r)
    assert abs(float(aux) / float(aux_r) - 1) <= 1e-6
    loss_r = RTF.loss_fn(ref_params, jt[:, :-1], jt[:, 1:], ref_cfg, **f32)
    loss = TF.loss_fn(params, tt[:, :-1], tt[:, 1:], cfg,
                      dtype=torch.float32)
    assert abs(float(loss) / float(loss_r) - 1) <= 1e-5


@pytest.mark.parametrize("name", ["granite32", "arctic", "jamba"])
def test_serve_engine_matches_the_reference_engine(name):
    """Two slots, three requests: admission mid-run, decode routing both
    slots' tokens as one group, token for token."""
    ref_cfg, cfg, ref_params, params = _models(name)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 13)]
    ref_eng = RefEngine(ref_params, ref_cfg, batch_slots=2, max_len=48,
                        dtype=jnp.float32)
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=48,
                      dtype=torch.float32, device="cpu")
    for i, pr in enumerate(prompts):
        ref_eng.submit(RefRequest(rid=i, prompt=pr, max_new_tokens=4 + i))
        eng.submit(Request(rid=i, prompt=pr, max_new_tokens=4 + i))
    want = {r.rid: r.out for r in ref_eng.run_until_drained()}
    got = {r.rid: r.out for r in eng.run_until_drained()}
    assert got == want


@pytest.mark.parametrize("arch,accum,remat,opt", [
    ("granite-moe-1b-a400m", 2, True, "adamw"),
    ("arctic-480b", 1, False, "adamw8bit"),
    ("jamba-1.5-large-398b+experts", 2, False, "adamw"),
])
def test_train_step_matches_reference(arch, accum, remat, opt):
    """tests/test_torch_train.py's three float32 steps and bounds on the
    MoE configs (granite with its 32 experts)."""
    check_train_step(arch, accum, remat, opt)

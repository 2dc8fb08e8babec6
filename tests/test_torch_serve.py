"""Parity of the port's serving slice with the JAX reference on the CPU:
the flash attention plain version (against the reference's oracle and
its Pallas kernel in interpret mode), the attention layers, the
transformer's prefill / decode_step / apply on reduced configs (the
RWKV6 and expert-free Jamba ones included), the serving engine and
example, and the port's copies of the ten configs.

Inputs are drawn with numpy from a seed; the reference's params are
carried across with `repro_torch.convert.model_params`.  Bounds: the
flash plain version within the reference's own kernel bound (rtol = atol
= 2e-3 float32, 2e-2 bfloat16; tests/test_kernels.py) and within 1e-5 of
the oracle in float32; layers within rtol = atol = 1e-5; logits and
caches within 1e-4 (float32 matrix products in another order over a few
layers); prefill + decode against apply within the reference's 5e-3
(tests/test_models.py); served tokens equal.
"""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import input_shapes as ref_input_shapes
from repro.configs.base import reduced as ref_reduced
from repro.kernels.flash_attention import ops as ref_flash
from repro.models import layers as RL
from repro.models import transformer as RTF
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, input_shapes
from repro_torch.configs.base import reduced
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import one_thread as _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


def _normal(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """A numpy / JAX tree as float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tree_close(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], tol, f"{path}.{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), path
    _close(got, want, tol)


def _flash_inputs(seed, b, sq, sk, hq, hkv, d, dtype):
    q, k, v = _normal(seed, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tq, tk, tv = (torch.tensor(np.asarray(x.astype(jnp.float32)))
                  .to(torch.bfloat16 if dtype == jnp.bfloat16
                      else torch.float32) for x in (jq, jk, jv))
    return (jq, jk, jv), (tq, tk, tv)


# ------------------------------------------------------------ flash attention
class TestFlashPlain:
    @pytest.mark.parametrize("b,sq,hq,hkv,d", [
        (1, 128, 2, 2, 64),       # MHA
        (2, 256, 4, 2, 64),       # GQA 2:1
        (1, 256, 8, 2, 128),      # GQA 4:1
        (1, 192, 4, 1, 64),       # MQA, unaligned seq
    ])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_causal_matches_reference_and_pallas(self, b, sq, hq, hkv, d,
                                                 dtype):
        (jq, jk, jv), (tq, tk, tv) = _flash_inputs(0, b, sq, sq, hq, hkv, d,
                                                   dtype)
        out = flash_ops.flash_attention(tq, tk, tv)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        o_ref = ref_flash.flash_attention(jq, jk, jv, impl="ref")
        o_pl = ref_flash.flash_attention(jq, jk, jv, impl="pallas_interpret",
                                         block_q=64, block_k=128)
        tol = 2e-2 if dtype == jnp.bfloat16 else 2e-3
        _close(out.float(), o_pl, tol)
        _close(out.float(), o_ref, tol if dtype == jnp.bfloat16 else 1e-5)

    @pytest.mark.parametrize("window", [32, 64, 128])
    def test_sliding_window(self, window):
        (jq, jk, jv), (tq, tk, tv) = _flash_inputs(1, 1, 256, 256, 4, 2, 64,
                                                   jnp.float32)
        out = flash_ops.flash_attention(tq, tk, tv, window=window)
        o_ref = ref_flash.flash_attention(jq, jk, jv, impl="ref",
                                          window=window)
        o_pl = ref_flash.flash_attention(jq, jk, jv, impl="pallas_interpret",
                                         window=window, block_q=64,
                                         block_k=64)
        _close(out, o_pl, 2e-3)
        _close(out, o_ref, 1e-5)

    @pytest.mark.parametrize("sk", [100, 150])
    def test_non_causal_ragged_keys_follow_the_oracle(self, sk):
        # The reference's Pallas wrapper pads Sk to its key block with zero
        # keys and, non-causal, attends to them: at (1, 100, 4/2 heads, 32)
        # its `impl="pallas_interpret"` differs from `impl="ref"` by 0.112
        # (max abs).  The port (plain version and CUDA kernel) masks keys at
        # kpos >= Sk, as the oracle does.
        (jq, jk, jv), (tq, tk, tv) = _flash_inputs(2, 1, 100, sk, 4, 2, 32,
                                                   jnp.float32)
        out = flash_ops.flash_attention(tq, tk, tv, causal=False)
        o_ref = ref_flash.flash_attention(jq, jk, jv, causal=False,
                                          impl="ref")
        _close(out, o_ref, 1e-5)


class TestSdpaRef:
    def test_long_prompt_blocks_match_the_reference(self):
        q, k, v = _normal(4, (1, 4096, 2, 16), (1, 4096, 1, 16),
                          (1, 4096, 1, 16))
        out = L.sdpa_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v))
        _close(out, RL.sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v)), 1e-5)

    def test_unaligned_long_prompt_raises_as_the_reference(self):
        q, k, v = _normal(5, (1, 2100, 2, 16), (1, 2100, 1, 16),
                          (1, 2100, 1, 16))
        with pytest.raises(AssertionError):
            RL.sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        with pytest.raises(ValueError, match="multiple"):
            L.sdpa_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v))
        # the flash path serves it
        out = flash_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                        torch.tensor(v))
        assert bool(torch.isfinite(out).all())


# --------------------------------------------------------------------- layers
class TestLayers:
    def test_rmsnorm(self):
        x, s = _normal(10, (2, 5, 128), (128,))
        got = L.rmsnorm({"scale": torch.tensor(s)}, torch.tensor(x), 1e-5)
        _close(got, RL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x),
                               1e-5), 1e-5)

    @pytest.mark.parametrize("theta", [1e4, 1e6])
    def test_rope(self, theta):
        (x,) = _normal(11, (2, 7, 4, 32))
        pos = np.random.default_rng(11).integers(0, 5000, (2, 7))
        got = L.rope(torch.tensor(x), torch.tensor(pos), theta)
        _close(got, RL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                            theta), 1e-5)

    def test_qkv_with_bias_and_qk_norm(self):
        cfg = dataclasses.replace(ref_reduced(ref_get_config("glm4-9b")),
                                  qkv_bias=True, qk_norm=True)
        p = _np(RL.attention_init(jax.random.PRNGKey(0), cfg))
        for i, name in enumerate(("bq", "bk", "bv")):
            (p[name],) = _normal(20 + i, p[name].shape)
        for i, name in enumerate(("q_norm", "k_norm")):
            p[name] = {"scale": 1 + 0.1 * _normal(30 + i, p[name]["scale"]
                                                  .shape)[0]}
        (x,) = _normal(12, (2, 9, cfg.d_model))
        pos = np.broadcast_to(np.arange(9), (2, 9))
        want = RL._qkv(p, jnp.asarray(x), cfg, jnp.asarray(pos, jnp.int32))
        got = L._qkv(_t(p), torch.tensor(x), cfg, torch.tensor(pos))
        for g, w in zip(got, want):
            _close(g, w, 1e-5)

    @pytest.mark.parametrize("window", [None, 64])
    def test_sdpa_online(self, window):
        q, k, v = _normal(13, (1, 200, 4, 32), (1, 200, 2, 32),
                          (1, 200, 2, 32))
        got = L.sdpa_online(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), window=window, k_block=64)
        want = RL.sdpa_online(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, k_block=64)
        _close(got, want, 1e-5)

    def test_decode_attend(self):
        q, ck, cv = _normal(14, (2, 1, 4, 32), (2, 50, 2, 32), (2, 50, 2, 32))
        valid = np.random.default_rng(14).random(50) < 0.6
        got = L.decode_attend(torch.tensor(q), torch.tensor(ck),
                              torch.tensor(cv), torch.tensor(valid), 32)
        want = RL.decode_attend(jnp.asarray(q), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(valid), 32)
        _close(got, want, 1e-5)

    @pytest.mark.parametrize("arch,local,pos", [
        ("glm4-9b", False, 37),          # global cache
        ("gemma3-12b", True, 100),       # local ring, pos > window (64)
        ("gemma3-12b", True, 20),        # local ring before it wraps
    ])
    def test_attention_apply_with_cache(self, arch, local, pos):
        cfg = ref_reduced(ref_get_config(arch))
        p = _np(RL.attention_init(jax.random.PRNGKey(1), cfg))
        size = 64
        x, ck, cv = _normal(15, (2, 1, cfg.d_model),
                            (2, size, cfg.n_kv_heads, cfg.head_dim),
                            (2, size, cfg.n_kv_heads, cfg.head_dim))
        positions = np.full((2, 1), pos)
        out_r, cache_r = RL.attention_apply(
            p, jnp.asarray(x), cfg, jnp.asarray(positions, jnp.int32),
            local=local, cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)})
        out, cache = L.attention_apply(
            _t(p), torch.tensor(x), cfg, torch.tensor(positions),
            local=local, cache={"k": torch.tensor(ck), "v": torch.tensor(cv)})
        _close(out, out_r, 1e-5)
        _tree_close(cache, cache_r, 1e-5)

    def test_mlp(self):
        p = _np(RL.mlp_init(jax.random.PRNGKey(2), 64, 96))
        (x,) = _normal(16, (2, 3, 64))
        _close(L.mlp_apply(_t(p), torch.tensor(x)),
               RL.mlp_apply(p, jnp.asarray(x)), 1e-5)


# ---------------------------------------------------------------- transformer
def _models(arch, **kw):
    """The reference's and the port's reduced `arch` with the same weights;
    `n_layers`, `d_model`, `n_heads`, `d_ff` and `vocab` go to `reduced`,
    any other override replaces a config field."""
    red = {n: kw.pop(n) for n in ("n_layers", "d_model", "n_heads", "d_ff",
                                  "vocab") if n in kw}
    ref_cfg = ref_reduced(ref_get_config(arch), **red)
    cfg = reduced(get_config(arch), **red)
    if kw:
        ref_cfg = dataclasses.replace(ref_cfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    ref_params = RTF.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, ref_params, convert.model_params(
        _np(ref_params), cfg, device="cpu")


# the hybrid without its experts (models/moe.py is not ported)
NO_EXPERTS = {"jamba-1.5-large-398b": {"n_experts": 0, "top_k": 0}}


@pytest.mark.parametrize("arch,s", [
    ("glm4-9b", 40), ("qwen2.5-14b", 40),        # qkv bias
    ("gemma3-12b", 80),                          # window 64, prompt > 64
    ("chameleon-34b", 40),                       # qk-norm
    ("musicgen-large", 40),                      # MHA
    ("rwkv6-3b", 40),                            # WKV, S % 16 != 0
    ("jamba-1.5-large-398b", 40),                # mamba 7 : 1 attention
])
def test_prefill_decode_apply_match_the_reference(arch, s):
    ref_cfg, cfg, ref_params, params = _models(arch,
                                               **NO_EXPERTS.get(arch, {}))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, s + 1))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.tensor(toks)
    f32 = {"dtype": jnp.float32}

    lg_r, cache_r = RTF.prefill(ref_params, jt[:, :s], ref_cfg, max_len=128,
                                **f32)
    lg, cache = TF.prefill(params, tt[:, :s], cfg, max_len=128,
                           dtype=torch.float32)
    _close(lg, lg_r, 1e-4)
    _tree_close(cache, cache_r, 1e-4)

    st_r, cache_r = RTF.decode_step(ref_params, cache_r, jt[:, s:],
                                    jnp.int32(s), ref_cfg, **f32)
    st, cache = TF.decode_step(params, cache, tt[:, s:], s, cfg,
                               dtype=torch.float32)
    _close(st, st_r, 1e-4)
    _tree_close(cache, cache_r, 1e-4)

    full_r, _ = RTF.apply(ref_params, jt, ref_cfg, **f32)
    full, aux = TF.apply(params, tt, cfg, dtype=torch.float32)
    assert aux == 0.0
    _close(full, full_r, 1e-4)
    # the reference's own consistency bound (tests/test_models.py)
    _close(st[0], full[0, s], 5e-3)
    # the flash path on the CPU is the same plain math
    lg_f, _ = TF.prefill(params, tt[:, :s], cfg, max_len=128,
                         use_flash=True, dtype=torch.float32)
    _close(lg_f, lg, 1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_unported_mixers_and_ffns_raise(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError, match="LLM scaffold"):
        TF.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="LLM scaffold"):
        TF.init_cache(cfg, 1, 16, device="cpu")


def test_init_params_matches_the_reference_tree_and_scales():
    cfg = reduced(get_config("qwen2.5-14b"))
    ref_params = _np(RTF.init_params(jax.random.PRNGKey(0),
                                     ref_reduced(ref_get_config(
                                         "qwen2.5-14b"))))
    params = TF.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")

    def walk(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                walk(got[k], want[k], f"{path}.{k}")
            return
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        g = got.numpy()
        # same distribution: the truncation bound (the embedding is an
        # untruncated normal), spread within 10 % of the reference's
        if path != ".embed":
            assert np.abs(g).max() <= np.abs(want).max() * 1.05 + 1e-6, path
        if want.std() > 0:
            assert abs(g.std() / want.std() - 1) < 0.1, path
        else:
            assert np.array_equal(g, want), path

    walk(params, ref_params)


def test_model_params_refuses_another_tree():
    cfg = reduced(get_config("glm4-9b"))
    tree = _np(RTF.init_params(jax.random.PRNGKey(0),
                               ref_reduced(ref_get_config("glm4-9b"))))
    params = convert.model_params(tree, cfg, dtype=torch.bfloat16,
                                  device="cpu")
    assert params["stage"]["l0"]["mixer"]["wq"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        convert.model_params(tree, reduced(get_config("glm4-9b"),
                                           d_model=64), device="cpu")
    del tree["stage"]["l0"]["mixer"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        convert.model_params(tree, cfg, device="cpu")


# -------------------------------------------------------------- serve engine
def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{Path(name).stem}", ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def reference_example():
    """The reference example's output and its weights (PRNGKey(0))."""
    ref = _load_example("serve_batch.py")
    out = _stdout(ref.main)
    cfg = dataclasses.replace(ref_reduced(ref_get_config("glm4-9b")),
                              max_seq_len=256)
    return out, _np(RTF.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("flash", [False, True])
def test_port_example_serves_the_reference_tokens(reference_example, flash,
                                                  monkeypatch):
    """examples/port_serve_batch.py on the reference's weights prints
    exactly what examples/serve_batch.py prints: through the engine's
    flash prefill (on the CPU, the kernel's plain version), and with the
    engine's prefill sent through `sdpa_ref` instead, as the reference's
    engine prefills."""
    want, ref_params = reference_example
    port = _load_example("port_serve_batch.py")
    params = convert.model_params(ref_params, port.config(), device="cpu")
    if not flash:
        monkeypatch.setattr(ServeEngine, "_prefill", lambda self, tokens:
                            TF.prefill(self.params, tokens, self.cfg,
                                       max_len=self.max_len, use_flash=False,
                                       dtype=self.dtype))
    got = _stdout(port.main, ["--device", "cpu"], params=params)
    assert got == want
    assert "served 6 requests" in got


@pytest.fixture(scope="module")
def tiny():
    ref_cfg = ref_reduced(ref_get_config("glm4-9b"), n_layers=2, d_model=64,
                          n_heads=2, d_ff=128, vocab=128)
    cfg = reduced(get_config("glm4-9b"), n_layers=2, d_model=64, n_heads=2,
                  d_ff=128, vocab=128)
    ref_params = RTF.init_params(jax.random.PRNGKey(0), ref_cfg)
    return (ref_cfg, ref_params), (cfg, convert.model_params(
        _np(ref_params), cfg, device="cpu"))


def test_serve_engine_rejects_oversized_prompt(tiny):
    """As tests/test_train.py: an over-long prompt raises at submit (and
    in the `_prefill_into` backstop) and leaves other slots untouched."""
    _, (cfg, params) = tiny
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=16,
                      dtype=torch.float32, device="cpu")
    ok = Request(rid=0, prompt=np.arange(6, dtype=np.int32) % cfg.vocab_size,
                 max_new_tokens=3)
    too_long = Request(rid=1, prompt=np.zeros(16, np.int32),
                       max_new_tokens=3)      # == max_len: no decode slot
    way_too_long = Request(rid=2, prompt=np.zeros(33, np.int32),
                           max_new_tokens=3)
    eng.submit(ok)
    for bad in (too_long, way_too_long):
        with pytest.raises(ValueError, match="does not fit"):
            eng.submit(bad)
        assert not bad.out
        assert bad not in eng.waiting
        with pytest.raises(ValueError, match="does not fit"):
            eng._prefill_into(1, bad)
    eng.run_until_drained()
    assert len(ok.out) == 3


@pytest.mark.parametrize("arch,kw,lengths,max_len", [
    ("glm4-9b", {"n_layers": 2, "d_model": 64, "n_heads": 2, "d_ff": 128,
                 "vocab": 128}, (5, 9, 13), 32),
    # the attention-free and hybrid mixers (one jamba period of 8 layers):
    # their states ride in the shared cache, spliced at admission and
    # updated in place by decode
    ("rwkv6-3b", {"n_layers": 8}, (5, 19, 13), 48),
    ("jamba-1.5-large-398b", {"n_layers": 8, **NO_EXPERTS[
        "jamba-1.5-large-398b"]}, (5, 19, 13), 48),
])
def test_serve_engine_matches_the_reference_engine(arch, kw, lengths,
                                                   max_len):
    """Two slots, three requests of different lengths: admission mid-run
    and the uniform decode position, token for token."""
    ref_cfg, cfg, ref_params, params = _models(arch, **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    ref_eng = RefEngine(ref_params, ref_cfg, batch_slots=2, max_len=max_len,
                        dtype=jnp.float32)
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=max_len,
                      dtype=torch.float32, device="cpu")
    for i, pr in enumerate(prompts):
        ref_eng.submit(RefRequest(rid=i, prompt=pr, max_new_tokens=4 + i))
        eng.submit(Request(rid=i, prompt=pr, max_new_tokens=4 + i))
    want = {r.rid: r.out for r in ref_eng.run_until_drained()}
    got = {r.rid: r.out for r in eng.run_until_drained()}
    assert got == want


def test_serve_engine_prefills_through_the_flash_wrapper(tiny, monkeypatch):
    """Every prefill layer calls the flash wrapper once (on the CPU, its
    plain version) and no decode step calls it."""
    _, (cfg, params) = tiny
    calls = []
    wrapper = flash_ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(q.shape[1])
        return wrapper(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", spy)
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=32,
                      dtype=torch.float32, device="cpu")
    for i, n in enumerate((5, 9, 13)):
        eng.submit(Request(rid=i, prompt=np.arange(n, dtype=np.int32),
                           max_new_tokens=3))
    assert len(eng.run_until_drained()) == 3
    assert calls == [n for n in (5, 9, 13) for _ in range(cfg.n_layers)]


def test_engine_refuses_params_on_another_device(tiny):
    _, (cfg, params) = tiny
    with pytest.raises(ValueError, match="live on"):
        ServeEngine(params, cfg, device="meta")


# -------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_config_copies_match_the_reference(arch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    ref, cfg = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.flops_per_token(4096) == ref.flops_per_token(4096)
    assert [dataclasses.astuple(s) for s in cfg.group_spec()] == \
        [dataclasses.astuple(s) for s in ref.group_spec()]
    assert cfg.stages()[0][1] == ref.stages()[0][1]
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(ref_reduced(ref))
    assert [dataclasses.astuple(s) for s in input_shapes(arch)] == \
        [dataclasses.astuple(s) for s in ref_input_shapes(arch)]


def test_param_count_matches_advertised():
    expect = {"mistral-large-123b": 123e9, "glm4-9b": 9.4e9,
              "qwen2.5-14b": 14.8e9, "gemma3-12b": 12.8e9,
              "arctic-480b": 480e9, "granite-moe-1b-a400m": 1.3e9,
              "rwkv6-3b": 3.8e9, "musicgen-large": 3.3e9,
              "chameleon-34b": 34e9, "jamba-1.5-large-398b": 398e9}
    for arch, n in expect.items():
        got = get_config(arch).param_count()
        assert abs(got - n) / n < 0.12, (arch, got, n)

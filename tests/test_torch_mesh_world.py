"""The port's meshes in worlds of several ranks: spawned gloo worlds on
the CPU (`tests/_torch_mesh_world.py`), held to the JAX reference
computed here.

Two worlds of 4 ranks (the layouts, the reference archs' training and
resharding; then the variants below and serving) run on the (2, 2)
("data", "model") and (2, 1, 2) ("pod", "data", "model") meshes,
where each layer runs
on its parameters' "model" shards and partitions its activations over
"model" (heads, MLP hidden, experts, RWKV6 heads, Mamba channels,
vocabulary):
  * layouts: every rank's local block of every parameter of reduced
    rwkv6-3b and granite-moe-1b-a400m (32 experts) is the block the
    reference's sanitized spec gives it (`param_spec`, `sanitize` on a
    `jax.sharding.AbstractMesh` of the same shape), bitwise, and the
    blocks gather back to the whole; the bytes of state a rank holds
    are printed;
  * training: 3 float32 steps, accum 2, remat, AdamW and 8-bit AdamW,
    from the reference's parameters (`convert.model_params`, then
    `distribute_params`), held to the reference's unsharded
    `train_step` at tests/test_torch_train.py's `check_train_step`
    bounds (loss and lr within 1e-5 relative, grad_norm within
    max(1e-5, twice the reference's own 1-ulp spread), every parameter
    within atol 1e-6 + rtol 1e-4).  granite's batch is 8 x 128 tokens,
    so that a rank's 256 tokens of a microbatch make whole routing
    groups of 256.  On (2, 2) with AdamW also: reduced glm4-9b with
    glm4's GQA at 16 "model" ranks (4 q heads on 1 KV head: a rank's 2
    q heads read one KV head), with and without `seq_parallel`; 6 q
    heads on 3 KV heads (a rank's 3 q heads span a KV-head boundary); 3
    q heads (they do not divide the ranks: scores split by key
    position); and granite at 4 x 64 tokens, whose routing groups span
    the data-parallel ranks;
  * serving: float32 `prefill` logits and three `decode_step`s on (2,
    2) (the cache split by sequence over "model"), against the
    reference's unsharded `prefill` / `decode_step`, within 1e-5
    (rtol = atol), for the GQA glm4, the 3-head glm4, granite (decode
    groups spanning ranks), rwkv6-3b and one period of Jamba with its
    experts;
  * elastic: `reshard_state` from (2, 2) to `make_mesh_for(4,
    model_parallel=1)` puts each block where the rules say, bitwise.
A second world of 2 ranks restores the 4-rank run's checkpoint (after 2
steps) on `make_mesh_for(2, model_parallel=2)` with `shardings=` and
takes the third step, held at the same bounds to the uninterrupted
reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dataclasses

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.launch import sharding as RSH
from repro.models import transformer as RTF
from repro.optim import adamw_init as ref_adamw_init
from repro.optim.adamw8bit import adamw8_init as ref_adamw8_init
from repro.train import step as RS
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from _torch_mesh_world import run_world, world2, world4, world4_tp
from test_torch_train import REL, _model, _rel, _tokens
from _torch_parity import one_thread as _one_thread  # noqa: F401

ARCHS = ("rwkv6-3b", "granite-moe-1b-a400m")
# variants: (config, reduced() arguments, fields replaced in both
# packages' configs, fields replaced in the port's alone)
GLM = dict(n_layers=2, d_model=96, d_ff=128, vocab=128)
VARIANTS = {
    "glm4-9b:gqa": ("glm4-9b", dict(GLM, n_heads=4), {}, {}),
    "glm4-9b:gqa+sp": ("glm4-9b", dict(GLM, n_heads=4), {},
                       {"seq_parallel": True}),
    "glm4-9b:kv-span": ("glm4-9b", dict(GLM, n_heads=6),
                        {"n_kv_heads": 3}, {}),
    "glm4-9b:by-keys": ("glm4-9b", dict(GLM, n_heads=3), {}, {}),
    "granite-moe-1b-a400m:span": ("granite-moe-1b-a400m",
                                  {"n_experts": 32}, {}, {}),
    "jamba-1.5-large-398b+experts": ("jamba-1.5-large-398b",
                                     {"n_layers": 8}, {}, {}),
}
TOKENS = {"rwkv6-3b": (4, 33), "granite-moe-1b-a400m": (8, 129),
          "granite-moe-1b-a400m:span": (4, 65)}
OPTS = ("adamw", "adamw8bit")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
TP_ARCHS = ("glm4-9b:gqa", "glm4-9b:gqa+sp", "glm4-9b:kv-span",
            "glm4-9b:by-keys", "granite-moe-1b-a400m:span")
BASE_RUNS = [(m, a, o) for m in MESHES for a in ARCHS for o in OPTS]
TP_RUNS = [("2x2", a, "adamw") for a in TP_ARCHS]
RUNS = BASE_RUNS + TP_RUNS
SERVE = ("glm4-9b:gqa", "glm4-9b:by-keys", "granite-moe-1b-a400m",
         "rwkv6-3b", "jamba-1.5-large-398b+experts")
PROMPT, DECODES, MAX_LEN = 32, 3, 48
CKPT_RUN = ("2x2", "rwkv6-3b", "adamw")


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """Both configs, the reference's parameters and their 1-ulp
    grad_norm spread (`test_torch_train._model`) of a test arch."""
    if arch in ARCHS:
        return _model(arch)
    name, red, both, port_only = VARIANTS[arch]
    if arch.partition(":")[2] == "gqa+sp":
        cfg, _, params, spread = _arch("glm4-9b:gqa")
        return cfg, dataclasses.replace(_arch("glm4-9b:gqa")[1],
                                        **port_only), params, spread
    if arch == "granite-moe-1b-a400m:span":
        return _model("granite-moe-1b-a400m")
    cfg = dataclasses.replace(ref_reduced(ref_get_config(name), **red),
                              **both)
    pcfg = dataclasses.replace(reduced(get_config(name), **red), **both)
    params = RTF.init_params(jax.random.PRNGKey(0), cfg)
    if arch not in TP_ARCHS:                    # served only: no spread
        return cfg, pcfg, params, None
    toks = _tokens(cfg, 10)
    grad = jax.jit(jax.grad(lambda p: RTF.loss_fn(
        p, toks[:, :-1], toks[:, 1:], cfg, dtype=jnp.float32)))

    def norm(g):
        return float(jnp.sqrt(sum(jnp.sum(x * x)
                                  for x in jax.tree.leaves(g))))
    g0 = norm(grad(params))
    spread = 0.0
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        noisy = jax.tree.map(lambda x: x * (1 + 2.0 ** -23 * rng.choice(
            [-1, 0, 1], size=x.shape).astype(np.float32)), params)
        spread = max(spread, abs(norm(grad(noisy)) / g0 - 1))
    return cfg, pcfg, params, spread


def _ref_specs(cfg, params, mesh_name) -> dict:
    amesh = jax.sharding.AbstractMesh(*MESHES[mesh_name])
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = RSH._path_str(path)
        spec = RSH.param_spec(name, leaf.ndim, amesh, cfg)
        out[name] = tuple(RSH.sanitize(spec, leaf.shape, amesh))
    return out


def _ref_key(arch):
    """The reference's run an arch is held to (`seq_parallel` changes
    nothing without a mesh)."""
    return "glm4-9b:gqa" if arch == "glm4-9b:gqa+sp" else arch


@functools.lru_cache(maxsize=None)
def _ref_run(arch, opt):
    """The reference's 3 unsharded float32 steps: metrics and params."""
    cfg, _, params, _ = _arch(arch)
    rt = RS.TrainConfig(accum_steps=2, optimizer=opt, dtype=jnp.float32)
    step = jax.jit(lambda p, o, b: RS.train_step(p, o, b, cfg, rt))
    p, o = params, (ref_adamw8_init if opt == "adamw8bit"
                    else ref_adamw_init)(params)
    metrics = []
    for i in range(3):
        toks = _tokens(cfg, 10 + i, TOKENS.get(arch, (4, 33)))
        p, o, m = step(p, o, {"tokens": jnp.asarray(toks[:, :-1]),
                              "targets": jnp.asarray(toks[:, 1:])})
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {RSH._path_str(path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(p)[0]}
    return metrics, flat


@functools.lru_cache(maxsize=None)
def _ref_serve(arch):
    """The reference's unsharded float32 prefill of PROMPT tokens and
    DECODES steps: its tokens and the logits of each call."""
    cfg, _, params, _ = _arch(arch)
    toks = _tokens(cfg, 20, (4, PROMPT + DECODES))
    lg, cache = RTF.prefill(params, jnp.asarray(toks[:, :PROMPT]), cfg,
                            max_len=MAX_LEN, dtype=jnp.float32)
    out = [np.asarray(lg)]
    for i in range(DECODES):
        lg, cache = RTF.decode_step(
            params, cache, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
            jnp.int32(PROMPT + i), dataclasses.replace(cfg,
                                                       max_seq_len=MAX_LEN),
            dtype=jnp.float32)
        out.append(np.asarray(lg))
    return toks, out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_world")
    archs, specs = {}, {m: {} for m in MESHES}
    for arch in sorted({a for _, a, _ in RUNS} | set(SERVE)):
        cfg, pcfg, params, _ = _arch(arch)
        archs[arch] = {"cfg": pcfg,
                       "params": jax.tree.map(np.asarray, params),
                       "tokens": [_tokens(cfg, 10 + i,
                                          TOKENS.get(arch, (4, 33)))
                                  for i in range(3)]}
        if arch in SERVE:
            archs[arch]["serve_tokens"] = _ref_serve(arch)[0]
    for arch in ARCHS:
        cfg, _, params, _ = _arch(arch)
        for m in MESHES:
            specs[m][arch] = _ref_specs(cfg, params, m)
    payload = {"archs": archs, "specs": specs, "runs": BASE_RUNS,
               "tp_runs": TP_RUNS,
               "serve": SERVE, "serve_shape": (PROMPT, DECODES, MAX_LEN),
               "ckpt": str(tmp / "ckpt"), "ckpt_run": CKPT_RUN,
               "reshard_arch": "granite-moe-1b-a400m"}
    out4 = run_world(4, world4, payload, tmp)[0]
    tp = run_world(4, world4_tp, payload, tmp)[0]
    out4["train"].update(tp["train"])
    out4["serve"] = tp["serve"]
    out2 = run_world(2, world2, payload, tmp)[0]
    return out4, out2


def _hold(arch, opt, metrics, params, first=0):
    """check_train_step's bounds against the reference's steps `first`..
    2 and its final parameters."""
    _, _, _, spread = _arch(arch)
    r_metrics, r_params = _ref_run(_ref_key(arch), opt)
    gaps = []
    for pm, rm in zip(metrics, r_metrics[first:]):
        assert _rel(pm["loss"], rm["loss"]) <= REL, (pm, rm)
        assert _rel(pm["lr"], rm["lr"]) <= REL, (pm, rm)
        gaps.append(_rel(pm["grad_norm"], rm["grad_norm"]))
        assert gaps[-1] <= max(REL, 2 * spread), (pm, rm, spread)
    for name, want in r_params.items():
        np.testing.assert_allclose(params[name], want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    return gaps, spread


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_block_is_the_references(worlds, mesh, arch):
    """Each rank's block of each leaf is the one the reference's spec
    gives it, and the blocks gather back to the whole."""
    out4, _ = worlds
    assert out4["layout"][(mesh, arch)] == []
    b = out4["bytes"][(mesh, arch)]
    print(f"{arch} on {mesh}: state per rank (params + moments) "
          f"{b['adamw']} B with AdamW, {b['adamw8bit']} B with 8-bit AdamW")


@pytest.mark.parametrize("mesh,arch,opt", [r for r in RUNS if r[1] !=
                                           "granite-moe-1b-a400m:span"])
def test_mesh_training_matches_reference(worlds, mesh, arch, opt):
    out4, _ = worlds
    run = out4["train"][(mesh, arch, opt)]
    assert run["step"] == 3
    gaps, spread = _hold(arch, opt, run["metrics"], run["params"])
    print(f"{arch} {opt} on {mesh}: grad_norm gaps "
          f"{[f'{g:.2e}' for g in gaps]} (reference's 1-ulp spread "
          f"{spread:.2e})")


def test_reshard_places_every_block(worlds):
    out4, _ = worlds
    assert out4["reshard"] == {"mesh": (4, 1), "bad": []}


def test_moe_groups_spanning_ranks_match_reference(worlds):
    """granite at 4 x 64 tokens: a microbatch's 128 tokens make one
    routing group across the two data-parallel ranks' 64 each; the
    ranks gather the group, route it and keep their rows, and the run
    is held to the reference's step."""
    out4, _ = worlds
    run = out4["train"][("2x2", "granite-moe-1b-a400m:span", "adamw")]
    assert run["step"] == 3 and run["spans"]
    gaps, spread = _hold("granite-moe-1b-a400m:span", "adamw",
                         run["metrics"], run["params"])
    print(f"granite groups spanning ranks on 2x2: grad_norm gaps "
          f"{[f'{g:.2e}' for g in gaps]} (spread {spread:.2e})")


@pytest.mark.parametrize("arch", SERVE)
def test_mesh_serving_matches_reference(worlds, arch):
    """float32 prefill logits and three decode steps on (2, 2), the
    decode cache split by sequence over "model", within 1e-5 of the
    reference's unsharded calls."""
    out4, _ = worlds
    got = out4["serve"][arch]
    _, want = _ref_serve(arch)
    assert len(got["logits"]) == len(want) == DECODES + 1
    worst = 0.0
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{arch} call {i}")
        worst = max(worst, float(np.max(np.abs(g - w))))
    assert got["cache_seq_block"] in (None, MAX_LEN // 2)
    print(f"{arch} serving on 2x2: max |logit gap| {worst:.2e}; a rank's "
          f"cache block {got['cache_seq_block']} of {MAX_LEN} positions")


def test_checkpoint_restores_on_a_smaller_world(worlds):
    """The 4-rank run's checkpoint after 2 steps, restored on 2 ranks'
    (1, 2) mesh, takes the third step within the bounds of the
    uninterrupted reference."""
    _, out2 = worlds
    assert out2["mesh"] == {"data": 1, "model": 2}
    assert out2["step"] == 3 and len(out2["metrics"]) == 1
    _, arch, opt = CKPT_RUN
    _hold(arch, opt, out2["metrics"], out2["params"], first=2)

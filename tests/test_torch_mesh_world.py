"""The port's meshes in worlds of several ranks: spawned gloo worlds on
the CPU (`tests/_torch_mesh_world.py`), held to the JAX reference
computed here.

One world of 4 ranks runs everything on the (2, 2) ("data", "model")
and (2, 1, 2) ("pod", "data", "model") meshes:
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
    groups of 256;
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

from repro.launch import sharding as RSH
from repro.optim import adamw_init as ref_adamw_init
from repro.optim.adamw8bit import adamw8_init as ref_adamw8_init
from repro.train import step as RS
from _torch_mesh_world import run_world, world2, world4
from test_torch_train import REL, _model, _rel, _tokens
from _torch_parity import one_thread as _one_thread  # noqa: F401

ARCHS = ("rwkv6-3b", "granite-moe-1b-a400m")
TOKENS = {"rwkv6-3b": (4, 33), "granite-moe-1b-a400m": (8, 129)}
OPTS = ("adamw", "adamw8bit")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
RUNS = [(m, a, o) for m in MESHES for a in ARCHS for o in OPTS]
CKPT_RUN = ("2x2", "rwkv6-3b", "adamw")


def _ref_specs(cfg, params, mesh_name) -> dict:
    amesh = jax.sharding.AbstractMesh(*MESHES[mesh_name])
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = RSH._path_str(path)
        spec = RSH.param_spec(name, leaf.ndim, amesh, cfg)
        out[name] = tuple(RSH.sanitize(spec, leaf.shape, amesh))
    return out


@functools.lru_cache(maxsize=None)
def _ref_run(arch, opt):
    """The reference's 3 unsharded float32 steps: metrics and params."""
    cfg, _, params, _ = _model(arch)
    rt = RS.TrainConfig(accum_steps=2, optimizer=opt, dtype=jnp.float32)
    step = jax.jit(lambda p, o, b: RS.train_step(p, o, b, cfg, rt))
    p, o = params, (ref_adamw8_init if opt == "adamw8bit"
                    else ref_adamw_init)(params)
    metrics = []
    for i in range(3):
        toks = _tokens(cfg, 10 + i, TOKENS[arch])
        p, o, m = step(p, o, {"tokens": jnp.asarray(toks[:, :-1]),
                              "targets": jnp.asarray(toks[:, 1:])})
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {RSH._path_str(path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(p)[0]}
    return metrics, flat


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_world")
    archs, specs = {}, {m: {} for m in MESHES}
    for arch in ARCHS:
        cfg, pcfg, params, _ = _model(arch)
        archs[arch] = {"cfg": pcfg,
                       "params": jax.tree.map(np.asarray, params),
                       "tokens": [_tokens(cfg, 10 + i, TOKENS[arch])
                                  for i in range(3)]}
        for m in MESHES:
            specs[m][arch] = _ref_specs(cfg, params, m)
    payload = {"archs": archs, "specs": specs, "runs": RUNS,
               "ckpt": str(tmp / "ckpt"), "ckpt_run": CKPT_RUN,
               "reshard_arch": "granite-moe-1b-a400m"}
    out4 = run_world(4, world4, payload, tmp)[0]
    out2 = run_world(2, world2, payload, tmp)[0]
    return out4, out2


def _hold(arch, opt, metrics, params, first=0):
    """check_train_step's bounds against the reference's steps `first`..
    2 and its final parameters."""
    _, _, _, spread = _model(arch)
    r_metrics, r_params = _ref_run(arch, opt)
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


@pytest.mark.parametrize("mesh,arch,opt", RUNS)
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


def test_moe_group_spanning_ranks_raises(worlds):
    """Half a routing group on each of 2 data-parallel ranks would make
    one group across them: `moe_apply` refuses, naming the item."""
    out4, _ = worlds
    assert "9.3b" in (out4["moe_refusal"] or "")


def test_checkpoint_restores_on_a_smaller_world(worlds):
    """The 4-rank run's checkpoint after 2 steps, restored on 2 ranks'
    (1, 2) mesh, takes the third step within the bounds of the
    uninterrupted reference."""
    _, out2 = worlds
    assert out2["mesh"] == {"data": 1, "model": 2}
    assert out2["step"] == 3 and len(out2["metrics"]) == 1
    _, arch, opt = CKPT_RUN
    _hold(arch, opt, out2["metrics"], out2["params"], first=2)

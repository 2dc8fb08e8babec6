"""The model half of the port's meshes on the CPU, held to the JAX
reference computed in each test: the sharding rules (`param_spec`,
`sanitize`, `cache_shardings`) of all ten configs at full width on both
production meshes, `elastic.plan_mesh`, `pspec`, the gradient
compressors, and, in a world of one rank (a gloo process group that a
fixture destroys), `Trainer(mesh=)` bitwise `Trainer(mesh=None)` and a
checkpoint restored with `shardings=`.  Worlds of several ranks are in
tests/test_torch_mesh_world.py.

The production meshes need 256 and 512 ranks, so the rules are compared
on `AbstractMesh`es (`jax.sharding.AbstractMesh` on the reference's
side), leaf for leaf, on the shapes of `init_params(..., device="meta")`
and `jax.eval_shape`.  Compressor inputs are seeded trees of multiples
of 1/8 in [-1/2, 1/2] (many equal |g| of both signs, and zeros): top-k's
sent values and residual bit for bit (ties to the lower index, as
`lax.top_k`), int8 codes and scales bit for bit.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro import pspec as RP
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as RSH
from repro.models import transformer as RTF
from repro.runtime import compression as RC
from repro.runtime.elastic import plan_mesh as ref_plan_mesh
from repro_torch import pspec
from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (AbstractMesh, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.runtime import compression as C
from repro_torch.runtime.elastic import make_mesh_for, plan_mesh
from repro_torch.train.step import TrainConfig, train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train import _cfgs
from _torch_parity import one_thread as _one_thread  # noqa: F401

PRODUCTION = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _no_process_group_left():
    """The world of one that `make_smoke_mesh` starts in this process is
    destroyed after the module, so no later test inherits it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _meshes(name):
    shape, axes = PRODUCTION[name]
    return jax.sharding.AbstractMesh(shape, axes), AbstractMesh(shape, axes)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_are_the_references(arch, mesh):
    """Every leaf of the full-width config: the raw spec and the
    sanitized spec equal the reference's, and `param_shardings` carries
    the sanitized one."""
    ref_mesh, port_mesh = _meshes(mesh)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref_shapes = jax.eval_shape(functools.partial(RTF.init_params,
                                                  cfg=rcfg),
                                jax.random.PRNGKey(0))
    ref = {RSH._path_str(p): leaf for p, leaf in
           jax.tree_util.tree_flatten_with_path(ref_shapes)[0]}
    ref_sh = {RSH._path_str(p): tuple(s.spec) for p, s in
              jax.tree_util.tree_flatten_with_path(
                  RSH.param_shardings(rcfg, ref_mesh, ref_shapes))[0]}
    params = TF.init_params(torch.Generator(), cfg, device="meta")
    sh = SH.param_shardings(cfg, port_mesh, params)
    seen = 0
    for path, leaf in _paths(params):
        name = SH.path_str(path)
        r = ref[name]
        assert tuple(leaf.shape) == tuple(r.shape), name
        want = RSH.param_spec(name, r.ndim, ref_mesh, rcfg)
        got = SH.param_spec(name, leaf.dim(), port_mesh, cfg)
        assert got == tuple(want), (name, got, want)
        want_s = tuple(RSH.sanitize(want, r.shape, ref_mesh))
        assert SH.sanitize(got, tuple(leaf.shape), port_mesh) == want_s, name
        assert SH.at(sh, path).spec == want_s == ref_sh[name], name
        seen += 1
    assert seen == len(ref)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shardings_are_the_references(arch):
    """Decode caches of 4096 positions, batch 1 and batches that divide
    the data-parallel size, on both production meshes."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for mesh in PRODUCTION:
        ref_mesh, port_mesh = _meshes(mesh)
        dp = 32 if mesh == "multipod" else 16
        for batch in (1, dp, 2 * dp):
            ref_shape = jax.eval_shape(functools.partial(
                RTF.init_cache, rcfg, batch, 4096))
            ref = {RSH._path_str(p): tuple(s.spec) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       RSH.cache_shardings(rcfg, ref_mesh, ref_shape,
                                           batch))[0]}
            cache = TF.init_cache(cfg, batch, 4096, device="meta")
            got = SH.cache_shardings(cfg, port_mesh, cache, batch)
            assert {SH.path_str(p): s.spec for p, s in _paths(got)} == ref, \
                (mesh, batch)


@pytest.mark.parametrize("pod_size", [None, 256])
def test_plan_mesh_is_the_references(pod_size):
    for n in range(1, 601):
        assert plan_mesh(n, 16, pod_size) == ref_plan_mesh(n, 16, pod_size), n


def test_production_meshes_need_their_ranks():
    """In a world of one the production meshes raise, naming the ranks
    they need (as `jax.make_mesh` raises on too few devices); the smoke
    mesh is (1, 1)."""
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    mesh = make_smoke_mesh("cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)


# ----------------------------------------------------------------- pspec
SPECS = [("dp", None), ("dp", "model"), (("pod", "data"), "model"),
         ("pod", None), ("model", "dp", None), (("data",), None), (None,),
         ("dp", None, "model", None)]


def test_pspec_is_the_references():
    """`resolve`, `dp_axes` and `axis_size` on a (1, 1) mesh and
    without a mesh; `constrain` is the identity on a plain tensor and
    redistributes a `DTensor` to the resolved spec, values unchanged, as
    the reference's keeps them."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    # Auto axes: under this jax's default Explicit ones the reference's
    # `with_sharding_constraint` asserts the input's sharding instead
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    for ref_ctx, ctx in ((RP.set_mesh(ref_mesh),
                          pspec.set_mesh(make_smoke_mesh("cpu"))),
                         (None, None)):
        with (ref_ctx or contextlib.nullcontext()), \
                (ctx or contextlib.nullcontext()):
            assert pspec.dp_axes() == RP.dp_axes()
            for a in ("pod", "data", "model"):
                assert pspec.axis_size(a) == RP.axis_size(a)
            for spec in SPECS:
                assert pspec.resolve(*spec) == tuple(RP.resolve(*spec)), spec
            t = torch.tensor(x)
            assert pspec.constrain(t, "dp", "model") is t
            want = np.asarray(jax.jit(lambda a: RP.constrain(
                a, "dp", "model"))(jnp.asarray(x)))
            if ctx is not None:
                mesh = pspec.active_mesh()
                dt = SH.distribute(t, mesh, SH.placements(mesh, ()))
                got = pspec.constrain(dt, "dp", "model")
                assert got.placements == (Shard(0), Shard(1))
                np.testing.assert_array_equal(got.full_tensor().numpy(),
                                              want)
    assert pspec.active_mesh() is None


# ----------------------------------------------------------- compressors
def _grad_tree(seed):
    rng = np.random.default_rng(seed)

    def tied(*shape):
        return (rng.integers(-4, 5, shape) / 8).astype(np.float32)

    return {"a": tied(37), "b": {"c": tied(8, 64), "d": tied(3, 5, 7)},
            "e": tied(300),
            "f": rng.standard_normal(130).astype(np.float32)}


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_compress_is_the_references(ratio):
    """Two rounds of error feedback: `sent` and the residual bit for bit
    (sign of zero included), `sent + residual == g + r` exactly, the
    wire bytes equal."""
    ref_state = port_state = None
    for seed in (0, 1):
        g = _grad_tree(seed)
        rg = jax.tree.map(jnp.asarray, g)
        pg = jax.tree.map(torch.tensor, g)
        if ref_state is None:
            ref_state, port_state = RC.topk_init(rg), C.topk_init(pg)
        r_prev = port_state.residual
        r_sent, ref_state = RC.topk_compress(rg, ref_state, ratio)
        p_sent, port_state = C.topk_compress(pg, port_state, ratio)
        for a, b in zip(jax.tree.leaves((p_sent, port_state.residual)),
                        jax.tree.leaves((r_sent, ref_state.residual))):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        for s, r, gi, ri in zip(jax.tree.leaves(p_sent),
                                jax.tree.leaves(port_state.residual),
                                jax.tree.leaves(pg), jax.tree.leaves(r_prev)):
            assert torch.equal(s + r, gi + ri)
        assert C.topk_wire_bytes(pg, ratio) == RC.topk_wire_bytes(rg, ratio)


@pytest.mark.parametrize("block", [256, 64])
def test_int8_compress_is_the_references(block):
    """Codes and scales bit for bit, shape and padding equal; the round
    trip bit for bit the reference's and within `int8_error_bound`."""
    g = _grad_tree(2)
    g["f"] = g["f"] * 1e3
    rg = jax.tree.map(jnp.asarray, g)
    pg = jax.tree.map(torch.tensor, g)
    rc, pc = RC.int8_compress(rg, block), C.int8_compress(pg, block)
    leaves = jax.tree.leaves(pg)
    for (q, s, shape, pad), (rq, rs, rshape, rpad), gi in zip(
            jax.tree.leaves(pc, is_leaf=lambda t: isinstance(t, tuple)),
            jax.tree.leaves(rc, is_leaf=lambda t: isinstance(t, tuple)),
            leaves):
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(rs))
        assert (tuple(shape), pad) == (tuple(rshape), rpad)
        assert C.int8_error_bound(gi, block) == RC.int8_error_bound(
            jnp.asarray(gi.numpy()), block)
    back, rback = C.int8_decompress(pc), RC.int8_decompress(rc)
    for b, rb, gi in zip(jax.tree.leaves(back), jax.tree.leaves(rback),
                         leaves):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(rb))
        assert float((b - gi).abs().max()) <= C.int8_error_bound(gi, block)


# ------------------------------------------------------ a world of one
TRAINERS = ["glm4-9b", "rwkv6-3b", "granite-moe-1b-a400m"]


def _leaves(tree):
    return SH.tree_leaves(tree)


def _flat(tree, path=()) -> dict:
    """{path: leaf} of nested dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {k: v for key, sub in items
            for k, v in _flat(sub, path + (key,)).items()}


def _equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(SH.gather(fa[k]), SH.gather(fb[k])) for k in fa)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("arch", TRAINERS)
def test_mesh_trainer_is_the_mesh_free_one(arch, opt, accum):
    """On the (1, 1) mesh of a world of one: the same draw, then losses,
    metrics, parameters and optimizer state bit for bit the mesh-free
    trainer's after 3 steps; every leaf a `DTensor` on the mesh."""
    _, cfg = _cfgs(arch)
    tc = TrainerConfig(steps=3, global_batch=4, seq_len=16,
                       train=TrainConfig(accum_steps=accum, optimizer=opt,
                                         dtype=torch.float32))
    free = Trainer(cfg, tc, device="cpu")
    meshed = Trainer(cfg, tc, mesh=make_smoke_mesh("cpu"))
    assert meshed.device == torch.device("cpu")
    assert _equal(free.params, meshed.params)
    assert free.run()["losses"] == meshed.run()["losses"]
    assert free.metrics == meshed.metrics
    assert all(isinstance(x, DTensor) for x in _leaves(meshed.params))
    assert all(isinstance(x, DTensor)
               for x in _leaves((meshed.opt.m, meshed.opt.v)))
    assert _equal(free.params, meshed.params)
    assert _equal((free.opt.m, free.opt.v), (meshed.opt.m, meshed.opt.v))
    assert int(free.opt.step) == int(meshed.opt.step) == 3


def test_train_step_takes_grad_shardings_and_a_placed_batch():
    """`train_step(grad_shardings=)` on a batch placed by `shard_batch(
    batch, batch_sharding(mesh))` gives the mesh-free step's values bit
    for bit; a `device` that disagrees with the mesh raises."""
    _, cfg = _cfgs("rwkv6-3b")
    mesh = make_smoke_mesh("cpu")
    raw = SyntheticLM(cfg.vocab_size, 16, 4, seed=3).batch_at(0)
    tcfg = TrainConfig(accum_steps=2, dtype=torch.float32)
    p0 = TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    p_sh = SH.param_shardings(cfg, mesh, p0)
    placed = SH.distribute_params(jax.tree.map(torch.clone, p0), cfg, mesh)
    batch = shard_batch(raw, SH.batch_sharding(mesh))
    assert isinstance(batch["tokens"], DTensor)
    p1, o1, m1 = train_step(p0, adamw_init(p0), shard_batch(raw, "cpu"), cfg,
                            tcfg)
    p2, o2, m2 = train_step(placed, adamw_init(placed), batch, cfg, tcfg,
                            grad_shardings=p_sh)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert _equal(p1, p2) and _equal((o1.m, o1.v), (o2.m, o2.v))
    with pytest.raises(ValueError, match="disagrees"):
        Trainer(cfg, TrainerConfig(steps=1), mesh=mesh, device="cuda")


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_checkpoint_from_a_mesh_restores_with_shardings(opt, tmp_path):
    """A mesh trainer's checkpoint, restored with `shardings=` onto
    `make_mesh_for(1, model_parallel=1)`, is its state bit for bit, every
    leaf placed; `Trainer.resume` on a fresh mesh trainer gives it too."""
    _, cfg = _cfgs("rwkv6-3b")
    tc = TrainerConfig(steps=2, global_batch=2, seq_len=16,
                       ckpt_dir=str(tmp_path), ckpt_every=1,
                       train=TrainConfig(optimizer=opt, dtype=torch.float32))
    tr = Trainer(cfg, tc, mesh=make_smoke_mesh("cpu"))
    tr.run()
    mesh = make_mesh_for(1, model_parallel=1, device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    like = {"params": tr.params, "opt": tr.opt}
    p_sh = SH.param_shardings(cfg, mesh, tr.params)
    tree, step = load_checkpoint(str(tmp_path), like, shardings={
        "params": p_sh, "opt": SH.opt_shardings(p_sh, tr.opt)})
    assert step == 2 and _equal(tree, like)
    assert all(isinstance(x, DTensor) and x.device_mesh == mesh
               for x in _leaves((tree["params"], tree["opt"].m)))
    fresh = Trainer(cfg, tc, mesh=make_smoke_mesh("cpu"))
    assert fresh.resume() == 2
    assert _equal({"params": fresh.params, "opt": fresh.opt}, like)
    assert isinstance(CheckpointManager(str(tmp_path)).restore(
        like)[0]["params"]["embed"], DTensor)

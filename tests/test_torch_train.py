"""Parity of the port's training half with the JAX reference on the CPU:
`data.pipeline.SyntheticLM`, `train.step.train_step` (accumulation,
remat, AdamW and 8-bit AdamW) on reduced glm4-9b, rwkv6-3b and the
expert-free Jamba, tests/test_train.py's loss-decrease,
accumulation-equivalence and checkpoint-resume tests, the `Trainer` and
the launcher.  Each test runs the reference on the same numpy inputs and
the reference's parameters (carried across with `repro_torch.convert`).

Bounds, float32 throughout: loss and lr within 1e-5 relative, every
parameter leaf within atol 1e-6 + rtol 1e-4 after 3 steps; grad_norm
within 1e-5 relative, or within twice what one float32 ulp of noise on
the reference's parameters moves the reference's own grad_norm (the
largest of three draws), where that is larger.  It is on reduced
rwkv6-3b: its gradient flows into the embedding through a norm of
0.02-scale inputs that amplifies last-bit differences, so the
reference's own grad_norm moves by 2e-5-1e-4 under such noise, and the
port sits 3e-5-7e-5 from it (measured in the test and printed; ROADMAP
queue C)."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import transformer as RTF
from repro.optim import adamw_init as ref_adamw_init
from repro.optim.adamw8bit import adamw8_init as ref_adamw8_init
from repro.train import step as RS
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import (AdaptivePrefetcher, SyntheticLM,
                                       shard_batch)
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw8bit import adamw8_init
from repro_torch.train.step import TrainConfig, train_step
from _torch_parity import one_thread as _one_thread  # noqa: F401

REL = 1e-5
NO_EXPERTS = {"n_experts": 0, "top_k": 0}
# tests/test_train.py's tiny glm4; the others at `reduced`'s defaults
ARCHS = {"glm4-9b": dict(n_layers=2, d_model=64, n_heads=2, d_ff=128,
                         vocab=128),
         "rwkv6-3b": {}, "jamba-1.5-large-398b": {}}


def _cfgs(arch):
    ref = ref_reduced(ref_get_config(arch), **ARCHS[arch])
    port = reduced(get_config(arch), **ARCHS[arch])
    if ref.n_experts:
        ref = dataclasses.replace(ref, **NO_EXPERTS)
        port = dataclasses.replace(port, **NO_EXPERTS)
    return ref, port


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Both configs, the reference's parameters and what one float32 ulp
    of noise on them moves its grad_norm by (the largest of three
    draws)."""
    cfg, pcfg = _cfgs(arch)
    params = RTF.init_params(jax.random.PRNGKey(0), cfg)
    toks = _tokens(cfg, 10)               # the step test's first batch
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


def _tokens(cfg, seed, shape=(4, 33)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batch(toks, torch_=False):
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return ({k: torch.tensor(v) for k, v in b.items()} if torch_
            else {k: jnp.asarray(v) for k, v in b.items()})


def _port(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_pairs(port_tree, ref_tree):
    for path, r in jax.tree_util.tree_leaves_with_path(ref_tree):
        node = port_tree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), node, np.asarray(r)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 16, 2, 0), (512, 33, 4, 3), (65536, 64, 2, 1)])
def test_synthetic_lm_batches_are_the_reference_bits(vocab, seq, batch, seed):
    ref, port = (cls(vocab, seq, batch, seed)
                 for cls in (RefSyntheticLM, SyntheticLM))
    for step in (0, 1, 7, 1000):
        a, b = port.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            assert np.array_equal(a[k], b[k])
    it_p, it_r = iter(port), iter(ref)
    for _ in range(3):
        assert np.array_equal(next(it_p)["tokens"], next(it_r)["tokens"])
    moved = shard_batch(port.batch_at(0), "cpu")
    assert moved["tokens"].dtype == torch.int32
    assert np.array_equal(moved["targets"].numpy(),
                          ref.batch_at(0)["targets"])


def test_adaptive_prefetcher_yields_the_stream_in_order():
    """The port's prefetcher hands out the reference's batches in order
    and sizes its queue from the profiled table (1..16)."""
    data = SyntheticLM(128, 8, 2, seed=5)
    ref = RefSyntheticLM(128, 8, 2, seed=5)
    pf = AdaptivePrefetcher(iter(data), step_time_s=1.0)
    try:
        for step in range(70):
            assert np.array_equal(pf.get()["tokens"],
                                  ref.batch_at(step)["tokens"])
        pf.refit()
        assert 1 <= pf.depth <= 16
    finally:
        pf.stop()


# ------------------------------------------------------------ train step
COMBOS = [(1, True, "adamw"), (2, False, "adamw"),
          (1, False, "adamw8bit"), (2, True, "adamw8bit")]


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b"])
@pytest.mark.parametrize("accum,remat,opt", COMBOS)
def test_train_step_matches_reference(arch, accum, remat, opt):
    """Three float32 steps from the reference's parameters and optimizer
    state on the same batches (the expert-free Jamba's in
    tests/test_torch_train_jamba.py)."""
    check_train_step(arch, accum, remat, opt)


def check_train_step(arch, accum, remat, opt):
    cfg, pcfg, params, spread = _model(arch)
    rt = RS.TrainConfig(accum_steps=accum, remat=remat, optimizer=opt,
                        dtype=jnp.float32)
    pt = TrainConfig(accum_steps=accum, remat=remat, optimizer=opt,
                     dtype=torch.float32)
    r_init, p_init = ((ref_adamw8_init, adamw8_init) if opt == "adamw8bit"
                      else (ref_adamw_init, adamw_init))
    r_p, r_o = params, r_init(params)
    p_p = convert.model_params(_port(params), pcfg, device="cpu")
    p_o = p_init(p_p)
    step = jax.jit(lambda p, o, b: RS.train_step(p, o, b, cfg, rt))
    gn_bound = max(REL, 2 * spread)
    gaps = []
    for i in range(3):
        toks = _tokens(cfg, 10 + i)
        r_p, r_o, rm = step(r_p, r_o, _batch(toks))
        p_p, p_o, pm = train_step(p_p, p_o, _batch(toks, True), pcfg, pt)
        assert _rel(pm["loss"], rm["loss"]) <= REL, (i, pm, rm)
        assert _rel(pm["lr"], rm["lr"]) <= REL, (i, pm, rm)
        gaps.append(_rel(pm["grad_norm"], rm["grad_norm"]))
        assert gaps[-1] <= gn_bound, (i, pm, rm, gn_bound)
    print(f"{arch} accum {accum} remat {remat} {opt}: grad_norm gaps "
          f"{[f'{g:.2e}' for g in gaps]} (reference's own 1-ulp spread "
          f"{spread:.2e})")
    for name, got, want in _leaf_pairs(p_p, r_p):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert int(p_o.step) == int(r_o.step) == 3


def test_bf16_grad_buffers_match_reference(tiny):
    """grad_dtype=bfloat16 with accumulation: each microbatch's float32
    gradients are rounded into bf16 buffers, as the reference's scan
    carry.  Loss within 1e-5; grad_norm (a bf16 sum in both) within two
    bf16 ulps; parameters within atol 1e-6 + rtol 1e-4."""
    cfg, pcfg, params = tiny
    toks = _tokens(cfg, 6, (4, 17))
    rt = RS.TrainConfig(accum_steps=2, dtype=jnp.float32,
                        grad_dtype=jnp.bfloat16)
    pt = TrainConfig(accum_steps=2, dtype=torch.float32,
                     grad_dtype=torch.bfloat16)
    r_p, _, rm = RS.train_step(params, ref_adamw_init(params), _batch(toks),
                               cfg, rt)
    p0 = convert.model_params(_port(params), pcfg, device="cpu")
    p_p, _, pm = train_step(p0, adamw_init(p0), _batch(toks, True), pcfg, pt)
    assert pm["grad_norm"].dtype == torch.bfloat16
    assert _rel(pm["loss"], rm["loss"]) <= REL
    assert _rel(pm["grad_norm"], rm["grad_norm"]) <= 2 * 2.0 ** -7
    for name, got, want in _leaf_pairs(p_p, r_p):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_train_step_functional_and_inplace_agree():
    """`inplace=True` (the Trainer's) gives the functional step's values
    bit for bit, and the functional step leaves its arguments alone."""
    _, pcfg, params, _ = _model("rwkv6-3b")
    tcfg = TrainConfig(accum_steps=2, dtype=torch.float32)
    p0 = convert.model_params(_port(params), pcfg, device="cpu")
    o0 = adamw_init(p0)
    keep = jax.tree.map(torch.clone, p0)
    batch = _batch(_tokens(pcfg, 3), True)
    p1, o1, m1 = train_step(p0, o0, batch, pcfg, tcfg)
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(keep)):
        assert torch.equal(a, b)
    assert int(o0.step) == 0
    p2, o2, m2 = train_step(p0, o0, batch, pcfg, tcfg, inplace=True)
    assert p2 is p0 and o2.m is o0.m
    for a, b in zip(jax.tree.leaves((p1, o1.m, o1.v)),
                    jax.tree.leaves((p2, o2.m, o2.v))):
        assert torch.equal(a, b)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_train_step_times_its_halves():
    """With a `times` list the step appends the seconds of its gradients
    and of its optimizer, and its values are those of the untimed step,
    bit for bit; `Trainer.run` passes the list on, one entry a step."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _, pcfg, params, _ = _model("rwkv6-3b")
    tcfg = TrainConfig(accum_steps=2, dtype=torch.float32)
    p0 = convert.model_params(_port(params), pcfg, device="cpu")
    batch = _batch(_tokens(pcfg, 3), True)
    times = []
    p1, o1, m1 = train_step(p0, adamw_init(p0), batch, pcfg, tcfg)
    p2, o2, m2 = train_step(p0, adamw_init(p0), batch, pcfg, tcfg,
                            times=times)
    assert [sorted(t) for t in times] == [["grads_s", "update_s"]]
    assert all(v >= 0.0 for v in times[0].values())
    for a, b in zip(jax.tree.leaves((p1, o1.m, o1.v)),
                    jax.tree.leaves((p2, o2.m, o2.v))):
        assert torch.equal(a, b)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    tc = TrainerConfig(steps=2, global_batch=2, seq_len=16,
                       train=TrainConfig(dtype=torch.float32))
    trainer, steps = Trainer(pcfg, tc, device="cpu"), []
    trainer.run(times=steps)
    assert len(steps) == 2 and len(trainer.metrics) == 2


def test_remat_and_loss_fn_match_reference():
    """`apply(remat=True)` recomputes each layer group in the backward
    pass: the same loss and gradients as without remat, bit for bit;
    `loss_fn` equal to the reference's within 1e-5."""
    cfg, pcfg, params, _ = _model("rwkv6-3b")
    toks = _tokens(cfg, 4)
    want = float(RTF.loss_fn(params, toks[:, :-1], toks[:, 1:], cfg,
                             dtype=jnp.float32))
    grads = []
    for remat in (True, False):
        p = convert.model_params(_port(params), pcfg, device="cpu")
        leaves = jax.tree.leaves(p)
        for x in leaves:
            x.requires_grad_()
        loss = TF.loss_fn(p, torch.tensor(toks[:, :-1]),
                          torch.tensor(toks[:, 1:]), pcfg,
                          dtype=torch.float32, remat=remat)
        assert _rel(loss, want) <= REL
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------- tests/test_train.py on the port
@pytest.fixture(scope="module")
def tiny():
    cfg, pcfg = _cfgs("glm4-9b")
    params = RTF.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, pcfg, params


def test_loss_decreases(tiny):
    """Memorise one batch for 30 steps: the loss falls below 0.7 of its
    start on both, step for step within 1e-4 relative (lr 3e-3 lets
    last-bit differences grow over the steps)."""
    cfg, pcfg, params = tiny
    rt = RS.TrainConfig(accum_steps=1, peak_lr=3e-3, warmup=5,
                        total_steps=40, dtype=jnp.float32)
    pt = TrainConfig(accum_steps=1, peak_lr=3e-3, warmup=5, total_steps=40,
                     dtype=torch.float32)
    toks = _tokens(cfg, 1, (4, 33))
    step = jax.jit(lambda p, o, b: RS.train_step(p, o, b, cfg, rt))
    r_p, r_o = params, ref_adamw_init(params)
    p_p = convert.model_params(_port(params), pcfg, device="cpu")
    p_o = adamw_init(p_p)
    lr_, lp_ = [], []
    for _ in range(30):
        r_p, r_o, rm = step(r_p, r_o, _batch(toks))
        p_p, p_o, pm = train_step(p_p, p_o, _batch(toks, True), pcfg, pt,
                                  inplace=True)
        lr_.append(float(rm["loss"]))
        lp_.append(float(pm["loss"]))
    assert lp_[-1] < lp_[0] * 0.7, lp_[::6]
    np.testing.assert_allclose(lp_, lr_, rtol=1e-4)


def test_grad_accum_equivalence(tiny):
    """accum_steps=4 equals accum_steps=1 on the same global batch (the
    reference test's bounds), and each equals the reference's step."""
    cfg, pcfg, params = tiny
    toks = _tokens(cfg, 2, (8, 17))
    outs = []
    for a in (1, 4):
        rt = RS.TrainConfig(accum_steps=a, dtype=jnp.float32, remat=False)
        pt = TrainConfig(accum_steps=a, dtype=torch.float32, remat=False)
        r_p, _, rm = RS.train_step(params, ref_adamw_init(params),
                                   _batch(toks), cfg, rt)
        p0 = convert.model_params(_port(params), pcfg, device="cpu")
        p2, _, pm = train_step(p0, adamw_init(p0), _batch(toks, True),
                               pcfg, pt)
        assert _rel(pm["loss"], rm["loss"]) <= REL
        for name, got, want in _leaf_pairs(p2, r_p):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        outs.append((p2, float(pm["loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 1e-4
    for l1, l2 in zip(jax.tree.leaves(outs[0][0]), jax.tree.leaves(
            outs[1][0])):
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=5e-4,
                                   atol=5e-4)


def test_trainer_checkpoint_resume(tmp_path):
    """An interrupted port run resumed from its checkpoint equals the
    uninterrupted run bit for bit, and the port's Trainer started from the
    reference Trainer's parameters gives the reference's losses on the
    same synthetic stream."""
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefTrainerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, pcfg = _cfgs("glm4-9b")
    tc = TrainerConfig(steps=6, global_batch=2, seq_len=16,
                       ckpt_dir=str(tmp_path / "a"), ckpt_every=3,
                       train=TrainConfig(dtype=torch.float32))
    t1 = Trainer(cfg=pcfg, tcfg=tc, device="cpu")
    t1.run()
    tc2 = dataclasses.replace(tc, ckpt_dir=str(tmp_path / "b"), steps=3)
    Trainer(pcfg, tc2, device="cpu").run()
    t3 = Trainer(pcfg, dataclasses.replace(tc2, steps=6), device="cpu")
    start = t3.resume()
    assert start == 3
    t3.run(start_step=start)
    for a, b in zip(jax.tree.leaves(t1.params), jax.tree.leaves(t3.params)):
        assert torch.equal(a, b)
    assert [m["loss"] for m in t3.metrics] == [m["loss"] for m in
                                                t1.metrics][3:]

    ref = RefTrainer(cfg, RefTrainerConfig(
        steps=4, global_batch=2, seq_len=16,
        train=RS.TrainConfig(dtype=jnp.float32)))
    port = Trainer(pcfg, dataclasses.replace(tc, steps=4, ckpt_dir=None),
                   device="cpu")
    port.params = convert.model_params(_port(ref.params), pcfg,
                                       device="cpu")
    port.opt = convert.optimizer_state(_port(ref.opt), "cpu")
    r_losses = ref.run()["losses"]
    p_losses = port.run()["losses"]
    assert all(_rel(p, r) <= REL for p, r in zip(p_losses, r_losses)), (
        p_losses, r_losses)


def test_trainer_adamw8bit_matches_reference_steps():
    """The port's `Trainer` with `TrainConfig(optimizer="adamw8bit")` on
    the 2-layer dense config builds `adamw8_init` state; from the
    reference's parameters and `adamw8_init` state it takes the
    reference's `train_step`, driven by hand on the same `SyntheticLM`
    batches, for 3 steps.  (The reference's own `Trainer` always builds
    AdamW state, so its 8-bit run raises in `_dequant`.)  Bounds, those
    of `check_train_step`: loss and lr within 1e-5 relative, grad_norm
    within 1e-5 or twice the reference's own 1-ulp spread, every
    parameter within atol 1e-6 + rtol 1e-4; the moments' codes within
    one code of the reference's, at most 2e-4 of them moved, the scales
    within 2e-5 relative (about five times the 7 of 180,864 codes and
    4.6e-6 measured on the CPU); the step counter 3."""
    from repro_torch.optim.adamw8bit import AdamW8State, QTensor
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, pcfg, params, spread = _model("glm4-9b")
    tc = TrainerConfig(steps=3, global_batch=2, seq_len=16,
                       train=TrainConfig(optimizer="adamw8bit",
                                         dtype=torch.float32))
    port = Trainer(pcfg, tc, device="cpu")
    assert isinstance(port.opt, AdamW8State)
    r_p, r_o = params, ref_adamw8_init(params)
    port.params = convert.model_params(_port(r_p), pcfg, device="cpu")
    port.opt = convert.optimizer_state(_port(r_o), "cpu")
    rt = RS.TrainConfig(optimizer="adamw8bit", dtype=jnp.float32)
    step = jax.jit(lambda p, o, b: RS.train_step(p, o, b, cfg, rt))
    data = RefSyntheticLM(cfg.vocab_size, tc.seq_len, tc.global_batch,
                          tc.seed)
    want = []
    for i in range(tc.steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
        r_p, r_o, rm = step(r_p, r_o, batch)
        want.append({k: float(v) for k, v in rm.items()})
    port.run()
    gn_bound = max(REL, 2 * spread)
    for pm, rm in zip(port.metrics, want, strict=True):
        assert _rel(pm["loss"], rm["loss"]) <= REL, (pm, rm)
        assert _rel(pm["lr"], rm["lr"]) <= REL, (pm, rm)
        assert _rel(pm["grad_norm"], rm["grad_norm"]) <= gn_bound, (
            pm, rm, gn_bound)
    for name, got, wnt in _leaf_pairs(port.params, r_p):
        np.testing.assert_allclose(got.numpy(), wnt, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    flips, n_codes, scale_gap = 0, 0, 0.0
    for moment in ("m", "v"):
        for path, rq in jax.tree_util.tree_leaves_with_path(
                getattr(r_o, moment), is_leaf=lambda x: hasattr(x, "q")):
            node = getattr(port.opt, moment)
            for p in path:
                node = node[p.key]
            assert isinstance(node, QTensor)
            d = node.q.numpy().astype(np.int32) - np.asarray(rq.q).astype(
                np.int32)
            assert np.abs(d).max() <= 1, (moment, path)
            flips += int((d != 0).sum())
            n_codes += d.size
            rs = np.asarray(rq.scale)
            scale_gap = max(scale_gap, float(np.max(
                np.abs(node.scale.numpy() - rs) / np.maximum(rs, 1e-30))))
    print(f"Trainer adamw8bit: {flips} of {n_codes} codes moved by one, "
          f"scales within {scale_gap:.2e} relative after {tc.steps} steps")
    assert flips <= 2e-4 * n_codes
    assert scale_gap <= 2e-5
    assert int(port.opt.step) == int(r_o.step) == tc.steps


# ----------------------------------------------------------------- launcher
LOSS_LINE = r"^{}: loss \d+\.\d{{3}} -> \d+\.\d{{3}} in \d+s on \d+ device\(s\)$"


def test_launcher_on_the_cpu(capsys, monkeypatch):
    """`python -m repro_torch.launch.train --device cpu` prints the
    reference launcher's loss line; both run 3 steps of reduced
    rwkv6-3b."""
    from repro.launch import train as ref_launch
    from repro_torch.launch import train as port_launch
    arch = "rwkv6-3b"
    port_launch.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["train", "--arch", arch, "--steps",
                                     "3"])
    ref_launch.main()
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    for line in (port_line, ref_line):
        assert re.match(LOSS_LINE.format(re.escape(arch)), line), line
    print(port_line, "|", ref_line)


def test_refusals():
    """What waits for ROADMAP queue A's LLM item raises, naming it."""
    from repro_torch.launch import train as port_launch
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, pcfg = _cfgs("glm4-9b")
    with pytest.raises(NotImplementedError, match="LLM scaffold"):
        Trainer(pcfg, TrainerConfig(steps=1), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="LLM scaffold"):
        port_launch.main(["--arch", "glm4-9b", "--mesh", "pod",
                          "--device", "cpu"])
    p = TF.init_params(torch.Generator().manual_seed(0), pcfg, "cpu")
    with pytest.raises(NotImplementedError, match="sharding"):
        train_step(p, adamw_init(p), _batch(_tokens(cfg, 0), True), pcfg,
                   TrainConfig(dtype=torch.float32), grad_shardings={})
    moe = reduced(get_config("granite-moe-1b-a400m"))
    with pytest.raises(NotImplementedError, match="MoE"):
        Trainer(moe, TrainerConfig(steps=1), device="cpu")


def test_entry_points_default_to_the_card():
    """`Trainer`, `shard_batch` and the launcher default to the card: without
    one they raise, naming device='cpu'; they never fall back."""
    from repro_torch.launch import train as port_launch
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _, pcfg = _cfgs("glm4-9b")
    tc = TrainerConfig(steps=1, global_batch=2, seq_len=8)
    batch = SyntheticLM(128, 8, 2).batch_at(0)
    if torch.cuda.is_available():
        assert Trainer(pcfg, tc).params["embed"].device.type == "cuda"
        assert shard_batch(batch)["tokens"].device.type == "cuda"
        return
    for fn in (lambda: Trainer(pcfg, tc), lambda: shard_batch(batch),
               lambda: port_launch.main(["--arch", "glm4-9b", "--steps",
                                         "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()

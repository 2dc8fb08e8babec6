"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU, held to
the JAX reference computed in the test:
  * inputs: in spawned processes holding fake worlds of 256 (16x16) and
    512 (2x16x16) ranks, the bytes of one rank's local shards of every
    input of every arch on train_4k and decode_32k equal the sum of the
    shard bytes of the reference's own `input_specs` on a
    `jax.sharding.AbstractMesh` of the same shape (no 512-device
    process);
  * the reference test's own cell, granite-moe-1b-a400m on decode_32k
    on the 16x16 mesh, runs whole at full width and is ok;
  * on reduced rwkv6-3b and reduced Jamba with its experts, a training
    step's counts on fake tensors equal the same step's counts on real
    CPU tensors in a world of one (no process group), flops, HBM bytes
    and collectives exactly, and a step traced at 2 and 3 microbatches
    and multiplied out equals the whole trace of 4;
  * the compute is split over "model": a reduced dense arch's training
    step counts at most 0.4 of its flops per rank on a (1, 4) mesh of
    what it counts on (1, 1), and less of its temporary bytes;
  * at full width on 16x16: glm4-9b's train_4k and prefill_32k cells
    peak below 80 GB a rank, and a `seq_parallel` cell (glm4-9b
    prefill_32k) runs and is ok;
  * a long_500k cell of a full-attention arch is the reference's skip
    record.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import param_shardings
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.train.step import TrainConfig, train_step
from _torch_dryrun_world import (fake_world_cells, full_cell, run_fake,
                                 sharded_compute)
from _torch_parity import one_thread as _one_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ("train_4k", "decode_32k")
# full-width cells on 16x16: (arch, shape, seq_parallel)
CELLS = [("glm4-9b", "train_4k", False), ("glm4-9b", "prefill_32k", False),
         ("glm4-9b", "prefill_32k", True)]
# a reduced dense arch whose heads, MLP hidden and vocabulary divide 4
DENSE = dict(n_layers=2, d_model=512, n_heads=8, d_ff=2048, vocab=512)
# (1, 4)'s temporary bytes over (1, 1)'s in that step: 0.3716 measured
# (torch 2.13 on the CPU, fake tensors), held below 0.4: the
# activations of the split layers shrink, the embedding, the whole
# logits and the norms' do not
TEMP_RATIO = 0.4


def _ref_dryrun():
    """The reference's driver module; importing it sets XLA_FLAGS for a
    512-device process, which this process must not keep."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


@pytest.fixture(scope="module")
def worlds():
    """Each mesh's fake world, the full-width `CELLS` and the sharded
    compute's two worlds, each in a spawned process of its own."""
    pod, multipod, *cells, split = run_fake(
        [(fake_world_cells, False), (fake_world_cells, True)]
        + [(full_cell, c) for c in CELLS]
        + [(sharded_compute, reduced(get_config("glm4-9b"), **DENSE))])
    return {"16x16": pod, "2x16x16": multipod,
            "cells": dict(zip(CELLS, cells)), "split": split}


def _ref_arg_bytes(arch, shape, mesh_name) -> int:
    specs = _ref_dryrun().input_specs(
        arch, shape, jax.sharding.AbstractMesh(*MESHES[mesh_name]))
    total = 0
    for key, tree in specs.items():
        if key.startswith("_"):
            continue
        for leaf in jax.tree.leaves(tree):
            total += math.prod(leaf.sharding.shard_shape(leaf.shape)) \
                * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_are_the_references_shards(worlds, arch, shape, mesh):
    got = worlds[mesh]["arg_bytes"][(arch, shape)]
    assert got == _ref_arg_bytes(arch, shape, mesh), (arch, shape, mesh)


def test_reference_cell_runs_in_a_fake_world(worlds):
    rec = worlds["16x16"]["granite"]
    assert rec["ok"] and rec["mesh"] == "16x16"
    assert rec["cost"]["flops"] > 0 and rec["cost"]["hbm_bytes"] > 0
    # each layer gathers its bf16 parameters over "data" where it runs
    # and keeps their "model" shards: all-gather bytes at least those
    # shards' of every leaf split over "data", and below the whole
    # model's
    cfg = get_config("granite-moe-1b-a400m")
    shapes = TF.init_params(torch.Generator(), cfg, device="meta")
    sh = param_shardings(cfg, AbstractMesh((16, 16), ("data", "model")),
                         shapes)
    shards, whole = 0, 0
    for x, s in zip(_leaves(shapes), _leaves(sh)):
        whole += 2 * x.numel()
        axes = [a for e in s.spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        if "data" in axes:
            shards += 2 * x.numel() // (16 if "model" in axes else 1)
    assert shards <= rec["collectives"]["all-gather"] < whole
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["generated_code_bytes"] is None and "trace_s" in rec


# reduced rwkv6-3b, and one period of reduced Jamba with its experts (7
# Mamba layers, MoE on every second layer)
TRAIN = {"rwkv6-3b": {}, "jamba-1.5-large-398b": {"n_layers": 8}}
ROWS, SEQ = 4, 32


def _real_step(cfg, tcfg, rows):
    params = TF.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = SyntheticLM(cfg.vocab_size, SEQ, rows, 0).batch_at(0)
    batch = {k: torch.as_tensor(v) for k, v in toks.items()}
    _, mode, _ = hlo_cost.count(train_step, params, adamw_init(params),
                                batch, cfg, tcfg, inplace=True)
    return mode.costs


@pytest.mark.parametrize("arch", list(TRAIN))
def test_fake_step_counts_the_real_steps_ops(arch):
    cfg = reduced(get_config(arch), **TRAIN[arch])
    tcfg = TrainConfig(accum_steps=2)
    specs = dryrun.fake_inputs(cfg, "train", ROWS, SEQ)
    fake, _ = dryrun.count_step("train", cfg, specs, tcfg)
    real = _real_step(cfg, tcfg, ROWS)
    assert fake.costs.flops == real.flops > 0
    assert fake.costs.hbm_bytes == real.hbm_bytes > 0
    assert fake.costs.collectives == real.collectives == {}


@pytest.mark.parametrize("arch", list(TRAIN))
def test_multiplied_microbatches_equal_the_whole_trace(arch):
    cfg = reduced(get_config(arch), **TRAIN[arch])
    accum, rows = 4, 2
    specs = dryrun.fake_inputs(cfg, "train", accum * rows, SEQ)
    whole, _, was = dryrun.count_train(cfg, specs, accum * rows, SEQ, accum,
                                       None, multiply=False)
    prod, mem, multiplied = dryrun.count_train(cfg, specs, accum * rows, SEQ,
                                               accum, None)
    assert multiplied and not was
    assert prod.flops == whole.flops and prod.hbm_bytes == whole.hbm_bytes
    assert prod.collectives == whole.collectives
    assert mem["argument_bytes"] == dryrun.argument_bytes(specs)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_seq_parallel_cell_runs(worlds):
    """glm4-9b prefill_32k with the residual stream split by sequence
    over "model" between layer groups, at full width on 16x16."""
    rec = worlds["cells"][("glm4-9b", "prefill_32k", True)]
    plain = worlds["cells"][("glm4-9b", "prefill_32k", False)]
    assert rec["ok"] and rec["seq_parallel"] is True, rec
    assert rec["cost"]["flops"] > 0
    print(f"glm4-9b prefill_32k on 16x16: peak "
          f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB with "
          f"seq_parallel, {plain['memory']['peak_bytes'] / 2**30:.2f} "
          f"without")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_cells_fit_one_card(worlds, shape):
    """glm4-9b's cells, the cheapest above 80 GB a rank before the
    activations were split over "model", peak below it."""
    rec = worlds["cells"][("glm4-9b", shape, False)]
    assert rec["ok"], rec
    peak = rec["memory"]["peak_bytes"]
    print(f"glm4-9b {shape} on 16x16: peak {peak / 2**30:.2f} GiB a rank")
    assert peak < 80e9


def test_compute_is_split_over_model(worlds):
    """A reduced dense arch's training step: per rank on (1, 4) at most
    0.4 of the flops of (1, 1), and at most TEMP_RATIO of its temporary
    bytes."""
    split = worlds["split"]
    (f1, t1), (f4, t4) = split[1], split[4]
    print(f"reduced dense train step: flops per rank (1, 4) / (1, 1) = "
          f"{f4 / f1:.4f}, temporary bytes {t4 / t1:.4f}")
    assert f4 <= 0.4 * f1
    assert t4 <= TEMP_RATIO * t1


@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_context_skip_is_the_references_record(monkeypatch, multi_pod):
    ref = _ref_dryrun()

    class Mesh:                     # what the reference reads of its mesh
        devices = np.empty((2, 16, 16) if multi_pod else (16, 16))

    monkeypatch.setattr(ref, "make_production_mesh", lambda **kw: Mesh())
    want = ref.run_cell("glm4-9b", "long_500k", multi_pod)
    assert want.get("skipped")
    assert dryrun.run_cell("glm4-9b", "long_500k", multi_pod) == want

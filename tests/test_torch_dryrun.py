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
  * `seq_parallel` raises, naming the queue item it waits for, and a
    long_500k cell of a full-attention arch is the reference's skip
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
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.train.step import TrainConfig, train_step
from _torch_dryrun_world import fake_world_cells, run_fake
from _torch_parity import one_thread as _one_thread  # noqa: F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ("train_4k", "decode_32k")


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
    """Each mesh's fake world, in a spawned process of its own."""
    pod, multipod = run_fake([(fake_world_cells, False),
                              (fake_world_cells, True)])
    return {"16x16": pod, "2x16x16": multipod}


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
    # ZeRO-3 serving gathers the bf16 parameters: all-gather bytes at
    # least the whole model's
    n = sum(x.numel() for x in hlo_cost._tensors(TF.init_params(
        torch.Generator(), get_config("granite-moe-1b-a400m"),
        device="meta")))
    assert rec["collectives"]["all-gather"] >= 2 * n
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


def test_seq_parallel_waits_for_its_queue_item():
    with pytest.raises(NotImplementedError,
                       match="LLM scaffold, what PR 16-17 left.*9.3b"):
        dryrun.run_cell("glm4-9b", "train_4k", False, seq_parallel=True)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_context_skip_is_the_references_record(monkeypatch, multi_pod):
    ref = _ref_dryrun()

    class Mesh:                     # what the reference reads of its mesh
        devices = np.empty((2, 16, 16) if multi_pod else (16, 16))

    monkeypatch.setattr(ref, "make_production_mesh", lambda **kw: Mesh())
    want = ref.run_cell("glm4-9b", "long_500k", multi_pod)
    assert want.get("skipped")
    assert dryrun.run_cell("glm4-9b", "long_500k", multi_pod) == want

"""High-level trainer of the port (`repro.train.trainer`): seeded
parameters on the device, the synthetic data, the step and
checkpointing of {"params", "opt"}, on one device or under a mesh
(`launch.mesh`): the parameters are drawn whole, as without one, then
placed by `launch.sharding.param_shardings` with the optimizer state
beside them, and each batch by `batch_sharding`."""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw8bit import adamw8_init
from repro_torch.train.step import TrainConfig, train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    seed: int = 0
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class Trainer:
    """Parameters drawn from `torch.Generator(device).manual_seed(seed)`
    (`transformer.init_params`), float32; the optimizer state the
    config's optimizer needs; the step updates both in place.  With a
    `DeviceMesh` the device is the mesh's (a `device` naming another
    type raises); without one it defaults to the card."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, mesh=None,
                 device: str | torch.device | None = None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"Trainer: mesh must be a DeviceMesh "
                            f"(launch.mesh), got {type(mesh).__name__}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device("cuda" if device is None
                                         else device)
        else:
            self.device = mesh_device(mesh)
            if device is not None and \
                    torch.device(device).type != self.device.type:
                raise ValueError(f"Trainer: device {str(device)!r} "
                                 f"disagrees with the {mesh.device_type} "
                                 "mesh")
        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        self.params = TF.init_params(gen, cfg, device=self.device)
        if mesh is not None:
            self.params = SH.distribute_params(self.params, cfg, mesh)
        init = (adamw8_init if tcfg.train.optimizer == "adamw8bit"
                else adamw_init)
        self.opt = init(self.params)
        self.data = SyntheticLM(cfg.vocab_size, tcfg.seq_len,
                                tcfg.global_batch, tcfg.seed)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, every=tcfg.ckpt_every)
                     if tcfg.ckpt_dir else None)
        self._step = functools.partial(train_step, cfg=cfg, tcfg=tcfg.train,
                                       inplace=True)
        self.metrics: list[dict[str, float]] = []

    def _place(self, batch):
        if self.mesh is None:
            return shard_batch(batch, self.device)
        return shard_batch(batch, SH.batch_sharding(self.mesh))

    def run(self, start_step: int = 0,
            times: list | None = None) -> dict[str, Any]:
        """Steps `start_step` .. `steps - 1`; with a list `times` each
        step appends its seconds (`train_step`'s `times`)."""
        t0 = time.time()
        for step in range(start_step, self.tcfg.steps):
            batch = self._place(self.data.batch_at(step))
            self.params, self.opt, m = self._step(self.params, self.opt,
                                                  batch, times=times)
            self.metrics.append(
                {k: float(v) for k, v in m.items()} | {"step": step})
            if self.ckpt:
                self.ckpt.maybe_save(
                    step + 1, {"params": self.params, "opt": self.opt})
        if self.ckpt:
            self.ckpt.wait()
        return {"losses": [m["loss"] for m in self.metrics],
                "wall_s": time.time() - t0}

    def resume(self) -> int:
        """Restore the latest checkpoint, under the placements of the
        current state (on a mesh, whatever mesh saved it); returns its
        step."""
        if self.ckpt is None:
            raise ValueError("Trainer.resume: no ckpt_dir configured")
        like = {"params": self.params, "opt": self.opt}
        state, step = self.ckpt.restore(like)
        self.params, self.opt = state["params"], state["opt"]
        return step

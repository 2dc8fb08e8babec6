"""High-level trainer of the port (`repro.train.trainer`): seeded
parameters on the device, the synthetic data, the step and
checkpointing of {"params", "opt"}.  One device: a mesh raises (the
model half of sharding waits for ROADMAP queue A, "LLM scaffold, what PR
16-17 left")."""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.device import resolve_device
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
    config's optimizer needs; the step updates both in place."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, mesh=None,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer: a mesh needs the model half of launch/mesh.py "
                "and launch/sharding.py (ROADMAP queue A, \"LLM scaffold, "
                "what PR 16-17 left\")")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = None
        self.device = resolve_device(device)
        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        self.params = TF.init_params(gen, cfg, device=self.device)
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
        return shard_batch(batch, self.device)

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
        """Restore the latest checkpoint; returns its step."""
        if self.ckpt is None:
            raise ValueError("Trainer.resume: no ckpt_dir configured")
        like = {"params": self.params, "opt": self.opt}
        state, step = self.ckpt.restore(like)
        self.params, self.opt = state["params"], state["opt"]
        return step

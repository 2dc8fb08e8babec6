"""End-to-end training example of the PyTorch/CUDA port (the counterpart
of `train_e2e.py`): a ~100M-parameter dense LM trained on synthetic
data through the port's `Trainer` (grad accumulation, AdamW +
warmup-cosine, asynchronous checkpointing).

Defaults are scaled for a quick run; pass --full for the 100M x
few-hundred-steps configuration.

    PYTHONPATH=src python examples/port_train_e2e.py [--full] [--steps N] \\
        [--device cuda|cpu] [--ckpt DIR]

`--device` defaults to cuda (no card: it raises; pass `--device cpu`
for the plain PyTorch versions); `--ckpt` defaults to a directory under
the system's temporary directory.  With 30 steps or more the run must
reduce the loss.
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.train.step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

LM_100M = ModelConfig(
    name="repro-100m", family="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
    d_ff=2560, vocab_size=32768, rope_theta=1e4,
).validate()

LM_TINY = dataclasses.replace(
    LM_100M, name="repro-tiny", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=1024, vocab_size=2048)


def trainer_config(full: bool, steps: int, ckpt: str | None
                   ) -> TrainerConfig:
    """The run's `TrainerConfig`, as the reference example sets it
    (float32 compute)."""
    return TrainerConfig(
        steps=steps,
        global_batch=16 if full else 4,
        seq_len=512 if full else 128,
        ckpt_dir=ckpt, ckpt_every=max(steps // 5, 10),
        train=TrainConfig(accum_steps=2, peak_lr=6e-4,
                          warmup=max(steps // 10, 5), total_steps=steps,
                          dtype=torch.float32))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="100M params, batch 16 x 512 tokens")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = LM_100M if args.full else LM_TINY
    steps = args.steps or (300 if args.full else 30)
    tcfg = trainer_config(args.full, steps, args.ckpt)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.0f}M params), "
          f"{steps} steps on {args.device}")
    trainer = Trainer(cfg, tcfg, device=args.device)
    out = trainer.run()
    losses = out["losses"]
    head = sum(losses[:5]) / min(len(losses), 5)
    tail = sum(losses[-5:]) / min(len(losses), 5)
    print(f"loss: {head:.3f} -> {tail:.3f} "
          f"({out['wall_s']:.0f}s; ckpt at {args.ckpt})")
    if steps >= 30:
        assert tail < head, "training must reduce the loss"
    else:
        print("(fewer than 30 steps: loss-decrease check skipped)")
    return out


if __name__ == "__main__":
    main()

"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> ...`` (the reference's `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        [--steps 20] [--device cuda|cpu]

Runs a reduced config (`--full-config` for the full architecture) in
float32 through `Trainer` on one device; `--device` defaults to cuda (no
card: it raises; pass `--device cpu` for the plain PyTorch versions).
On the card every RWKV6 layer trains through the WKV kernel and its
backward kernel; attention trains through the plain attention.  Mamba
layers raise on the card (the selective-scan kernel has no backward),
MoE configs raise everywhere (`models/moe.py` is not ported), and so do
`--mesh pod|multipod`.  Prints the reference's loss line.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import reduced
from repro_torch.train.step import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", choices=("none", "pod", "multipod"),
                    default="none")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes need the model "
            "half of launch/mesh.py and launch/sharding.py (ROADMAP queue "
            "A, \"LLM scaffold, what PR 16-17 left\")")
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    tcfg = TrainerConfig(
        steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt,
        train=TrainConfig(accum_steps=args.accum, dtype=torch.float32))
    trainer = Trainer(cfg, tcfg, device=args.device)
    out = trainer.run()
    print(f"{args.arch}: loss {out['losses'][0]:.3f} -> "
          f"{out['losses'][-1]:.3f} in {out['wall_s']:.0f}s on 1 device(s)")


if __name__ == "__main__":
    main()

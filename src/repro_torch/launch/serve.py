"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id>`` — batched greedy decoding over the continuous-batching
engine on a reduced config in float32, as the reference's launcher
(`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        [--device cuda|cpu]

`--device` defaults to cuda (no card: it raises; pass `--device cpu`
for the plain PyTorch versions).  On the card every prefill goes through
the flash attention kernel (attention layers), the WKV kernel (RWKV6,
e.g. `--arch rwkv6-3b`) and the selective-scan kernel (Mamba); MoE FFNs
(granite, arctic, jamba) run in plain torch on either device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = TF.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    engine = ServeEngine(params, cfg, batch_slots=args.slots, max_len=128,
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, 8 + i).astype(np.int32),
        max_new_tokens=args.new_tokens) for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    for r in done:
        print(f"req {r.rid}: {list(r.out)}")


if __name__ == "__main__":
    main()

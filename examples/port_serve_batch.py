"""Batched serving example of the PyTorch/CUDA port: the continuous-
batching engine over a small decoder, several concurrent requests with
different prompt lengths (the port's counterpart of `serve_batch.py`).

    PYTHONPATH=src python examples/port_serve_batch.py [--device cpu]

`--device` defaults to cuda (no card: it raises); weights are drawn
from a seeded `torch.Generator` on that device.  `main(params=...)`
serves given weights instead (e.g. the reference's, through
`repro_torch.convert.model_params`).
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import Request, ServeEngine


def config():
    return dataclasses.replace(reduced(get_config("glm4-9b")),
                               max_seq_len=256)


def main(argv=None, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    if params is None:
        params = TF.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                dev)
    engine = ServeEngine(params, cfg, batch_slots=4, max_len=128,
                         dtype=torch.float32, device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        8 + 4 * i).astype(np.int32),
                    max_new_tokens=12)
            for i in range(6)]
    for r in reqs:
        engine.submit(r)

    ticks = 0
    while engine.waiting or any(engine.active):
        engine.step()
        ticks += 1
    done = {r.rid: r for r in engine.drain_retired()}
    for rid in sorted(done):
        r = done[rid]
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    print(f"served {len(done)} requests in {ticks} engine ticks "
          f"(batched decode, {engine.slots} slots)")


if __name__ == "__main__":
    main()

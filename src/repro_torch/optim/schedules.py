"""Learning-rate schedules (port of `repro.optim.schedules`)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, peak_lr: float = 3e-4, warmup: int = 200,
                  total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `peak_lr`, then a cosine down to `floor` times
    it at `total`; a float32 tensor on `step`'s device (the CPU for a
    Python number), in the reference's order of operations."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / warmup, max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)

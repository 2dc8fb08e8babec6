"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`torch.device(device)`, refusing a CUDA device when no card is
    present: the port never falls back to the CPU on its own — callers
    that want the plain PyTorch versions pass `device="cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev

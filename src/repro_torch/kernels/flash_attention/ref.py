"""Plain PyTorch version of the flash attention kernel: the reference GQA
attention of `repro_torch.models.layers` with no query blocking (the
same math, scores materialised), as the reference's oracle
(`repro.kernels.flash_attention.ref`)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import sdpa_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] -> [B, Sq, Hq, D]."""
    return sdpa_ref(q, k, v, causal=causal, window=window, q_block=1 << 30)

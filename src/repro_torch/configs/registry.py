"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus the
assigned input-shape sets (seq_len x global_batch) for every arch; the
port's own copy of `repro.configs.registry`."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, str] = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic context handling: run only for SSM /
# hybrid / sliding-window archs (see DESIGN.md §5 shape policy).
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "jamba-1.5-large-398b", "gemma3-12b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def input_shapes(arch: str) -> list[InputShape]:
    """The assigned shape cells for one architecture."""
    shapes = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in LONG_CONTEXT_ARCHS:
        shapes.append(SHAPES["long_500k"])
    return shapes


def all_cells() -> list[tuple[str, InputShape]]:
    """Every (arch x shape) dry-run cell, including long_500k skips noted
    as absent (they are recorded as 'skipped' rows by the dry-run driver)."""
    return [(a, s) for a in ARCHS for s in input_shapes(a)]

"""Architecture registry: --arch <id> -> ArchConfig (assigned pool).

A copy of repro/configs (plain dataclasses) with its imports re-pointed."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      cell_applicable)

_MODULES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "internlm2-1.8b": "internlm2_1p8b",
    "minitron-4b": "minitron_4b",
    "llama3-405b": "llama3_405b",
    "mistral-large-123b": "mistral_large_123b",
    "mixtral-8x22b": "mixtral_8x22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "musicgen-large": "musicgen_large",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-76b": "internvl2_76b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_cells():
    """Every applicable (arch, shape) cell plus skip records."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            ok, why = cell_applicable(cfg, shape)
            yield arch_id, shape.name, ok, why


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
           "all_cells", "cell_applicable"]

"""Config registry: ``get_config('<arch-id>')`` / ``--arch <arch-id>``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, FactConfig, ShapeConfig,
                                      SHAPES, applicable_shapes)

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "yi-9b": "yi_9b",
    "granite-34b": "granite_34b",
    "glm4-9b": "glm4_9b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "chameleon-34b": "chameleon_34b",
    "hymba-1.5b": "hymba_1_5b",
    "paper-tiny": "paper_tiny",
}

ARCH_IDS = [k for k in _MODULES if k != "paper-tiny"]


def get_config(name: str) -> ArchConfig:
    try:
        mod = _MODULES[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; available: {sorted(_MODULES)}") from None
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = ["ArchConfig", "FactConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
           "applicable_shapes", "get_config"]

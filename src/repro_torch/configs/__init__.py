"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

The port's copy of ``src/repro/configs``: the 10 assigned architectures,
with their published widths and sources, under the assignment's
hyphenated ids.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import SHAPES, LayerDesc, ModelConfig, ShapeSpec, shape_applicable

_MODULES: Dict[str, str] = {
    "llama3-405b": "llama3_405b",
    "minitron-8b": "minitron_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "gemma2-2b": "gemma2_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "dbrx-132b": "dbrx_132b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-370m": "mamba2_370m",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_MODULES)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = [
    "ARCH_IDS", "SHAPES", "LayerDesc", "ModelConfig", "ShapeSpec",
    "get_config", "get_smoke_config", "shape_applicable",
]

"""Architecture registry of the port: every config the JAX package serves,
with its smoke reduction, and the dry run's shape table."""
from __future__ import annotations

from . import (
    gemma_7b,
    granite_moe_3b_a800m,
    internvl2_76b,
    mamba2_1_3b,
    mixtral_8x7b,
    musicgen_medium,
    qwen1_5_4b,
    qwen2_5_14b,
    qwen3_32b,
    zamba2_1_2b,
)
from .base import (
    MOE_BACKENDS,
    SHAPES,
    ModelConfig,
    ShapeSpec,
    shape_applicable,
)

_MODULES = {
    "musicgen-medium": musicgen_medium,
    "mamba2-1.3b": mamba2_1_3b,
    "internvl2-76b": internvl2_76b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen3-32b": qwen3_32b,
    "qwen1.5-4b": qwen1_5_4b,
    "gemma-7b": gemma_7b,
    "qwen2.5-14b": qwen2_5_14b,
    "zamba2-1.2b": zamba2_1_2b,
}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].smoke()


__all__ = [
    "ARCHS",
    "MOE_BACKENDS",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "get_smoke_config",
    "shape_applicable",
]

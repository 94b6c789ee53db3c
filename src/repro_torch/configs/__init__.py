"""Architecture registry of the port: the configs this slice serves."""
from __future__ import annotations

from . import granite_moe_3b_a800m
from .base import ModelConfig

_MODULES = {"granite-moe-3b-a800m": granite_moe_3b_a800m}

ARCHS: dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].smoke()


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]

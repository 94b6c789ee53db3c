"""Weights from the JAX package's layout into the port's.

The JAX ``init_params`` pytree, handed over as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), has the same nesting and the same
array layouts as the port's parameter dict (:mod:`repro_torch.models.
model`), so the conversion is a copy of every leaf. This module imports no
JAX: numpy is the only common ground between the two packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs.base import ModelConfig

__all__ = ["params_from_numpy"]

_EXPECTED = ("embed", "final_norm", "blocks")


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    # bfloat16 has no numpy type here: go through float32
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device, dtype=dtype)


def params_from_numpy(tree: dict[str, Any], config: ModelConfig, device,
                      dtype=torch.float32):
    """Nested dict of numpy arrays (the JAX layout) → the port's params."""
    missing = [k for k in _EXPECTED if k not in tree]
    if missing:
        raise KeyError(f"params tree lacks {missing}")
    if not config.tie_embeddings and "lm_head" not in tree:
        raise KeyError("untied config but params tree has no 'lm_head'")
    V, D = np.shape(tree["embed"])
    if (V, D) != (config.padded_vocab, config.d_model):
        raise ValueError(
            f"embed {(V, D)} does not match {config.name}: "
            f"({config.padded_vocab}, {config.d_model})"
        )
    return _convert(tree, torch.device(device), dtype)

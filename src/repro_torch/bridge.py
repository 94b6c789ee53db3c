"""Weights and train states between the JAX package's layout and the
port's.

The JAX ``init_params`` pytree, handed over as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), has the same nesting and the same
array layouts as the port's parameter dict (:mod:`repro_torch.models.
model`), so the conversion is a copy of every leaf. The train state
(``{"params", "opt": {"mu", "nu", "step"}, ["ef_residual"]}``) has the
same nesting in both packages too: :func:`state_to_numpy` and
:func:`state_from_numpy` move it whole, each leaf in its own dtype. This
module imports no JAX: numpy is the only common ground between the two
packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs.base import ModelConfig

__all__ = ["params_from_numpy", "state_to_numpy", "state_from_numpy"]

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


def _leaf_to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()  # exact: every bf16 value is an fp32 one
    return t.numpy().copy()


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (or its 2-byte void form): the bits as they are
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def state_to_numpy(state) -> dict[str, Any]:
    """A train state (or any nested dict of tensors) → the same nesting of
    numpy arrays, each leaf in its dtype; bfloat16 leaves become float32
    (exactly), since numpy has no bfloat16 of its own."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return None if state is None else _leaf_to_numpy(state)


def state_from_numpy(tree, device) -> dict[str, Any]:
    """A JAX train state as numpy arrays (``jax.tree.map(np.asarray,
    state)``) → the port's, each leaf in its own dtype on ``device`` (a
    bfloat16 leaf bit for bit), except the optimizer's step count, which
    the port keeps on the host (:mod:`repro_torch.training.optimizer`)."""
    device = torch.device(device)

    def convert(t, path):
        if isinstance(t, dict):
            return {k: convert(v, path + (k,)) for k, v in t.items()}
        if t is None:
            return None
        on = torch.device("cpu") if path == ("opt", "step") else device
        return _leaf_from_numpy(t, on)

    return convert(tree, ())

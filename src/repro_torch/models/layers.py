"""Shared model layers: RMSNorm, RoPE, vocab embedding and logits.

Plain functions on tensors, in the JAX package's layouts (``repro/models/
layers.py``), so that both packages run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["rms_norm", "rope", "apply_rope", "embed_tokens", "lm_logits"]


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32 with a ``1 + scale`` gain, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(positions, head_dim: int, theta: float):
    """Rotary tables: positions (…,) → cos/sin (…, head_dim/2), fp32."""
    freqs = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )
    freqs_t = torch.from_numpy(np.asarray(freqs, np.float32)).to(positions.device)
    angles = positions.float()[..., None] * freqs_t
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd) with cos/sin (..., S, hd/2), halves rotated."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def embed_tokens(ids, table, config: ModelConfig):
    """ids (B, S) → (B, S, D). The JAX tied path is a one-hot matmul; that
    is an exact row lookup, so plain indexing gives the same numbers."""
    del config
    return table[ids.long()]


def lm_logits(x, params, config: ModelConfig):
    """x (B, S, D) → logits (B, S, V_pad) fp32, pad-vocab entries −1e30."""
    if config.tie_embeddings:
        logits = torch.matmul(x, params["embed"].t())
    else:
        logits = torch.matmul(x, params["lm_head"])
    logits = logits.float()
    if config.padded_vocab != config.vocab_size:
        logits[..., config.vocab_size:] = -1e30
    return logits

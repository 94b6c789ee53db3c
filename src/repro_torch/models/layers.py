"""Shared model layers: RMSNorm, RoPE, gated MLPs, vocab embedding and
logits, and the seeded weight draw every ``init_*`` uses.

Plain functions on tensors, in the JAX package's layouts (``repro/models/
layers.py``), so that both packages run the same weights.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = [
    "rms_norm",
    "rope",
    "apply_rope",
    "gated_mlp",
    "init_gated_mlp",
    "embed_tokens",
    "lm_logits",
    "cross_entropy_loss",
    "token_nll",
    "normal_init",
]

# a stacked weight whose fp32 draw takes more bytes than this is drawn one
# layer at a time (Mixtral's experts: a 30 GB fp32 draw whole)
WHOLE_DRAW_BYTES = 8 << 30


def normal_init(shape, scale: float, *, dtype, device,
                generator: torch.Generator, keep: slice | None = None):
    """``N(0, 1) · scale`` in ``dtype``, drawn in fp32 from ``generator``.

    A weight whose fp32 draw fits in :data:`WHOLE_DRAW_BYTES` is drawn
    whole and cast, the way every weight was drawn before (granite's keep
    their bits). A larger stack is drawn one leading slice at a time into
    the ``dtype`` tensor, so no fp32 copy of the whole stack exists. On the
    CPU the two give the same values when a slice holds a multiple of 16
    elements; on the card the draws differ (the generator's offsets follow
    each call's size). ``keep``, a slice of dim 1, keeps only those rows
    of the same draw (a rank's expert slots), drawn a leading slice at a
    time whatever the size, so that no rank holds a whole stack. On the
    meta device nothing is drawn (no generator can draw there): the result
    is an empty meta tensor of the shape (after ``keep``) and ``dtype``,
    and ``generator`` may be None."""
    kept = tuple(shape)
    if keep is not None:
        kept = (shape[0], len(range(shape[1])[keep]), *shape[2:])
    if torch.device(device).type == "meta":
        return torch.empty(kept, dtype=dtype, device=device)
    numel = int(np.prod(shape))
    if keep is None and numel * 4 <= WHOLE_DRAW_BYTES:
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)
    out = torch.empty(kept, dtype=dtype, device=device)
    for i in range(shape[0]):
        w = torch.randn(shape[1:], generator=generator, device=device,
                        dtype=torch.float32)
        out[i].copy_((w if keep is None else w[keep]).mul_(scale))
    return out


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in fp32 with a ``1 + scale`` gain, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """RoPE's frequencies on ``device``, made once: the decode step reads
    them without a host copy (a copy in a captured step would be baked
    into the graph). numpy computes them, as the JAX package does."""
    freqs = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(positions, head_dim: int, theta: float):
    """Rotary tables: positions (…,) → cos/sin (…, head_dim/2), fp32."""
    freqs_t = _inv_freq(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs_t
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd) with cos/sin (..., S, hd/2), halves rotated."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def init_gated_mlp(d_model: int, d_ff: int, *, num_layers: int, dtype, device,
                   generator: torch.Generator):
    def normal(shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator)

    scale_in = float(1.0 / np.sqrt(d_model))
    scale_out = float(1.0 / np.sqrt(d_ff))
    return {
        "w_gate": normal((num_layers, d_model, d_ff), scale_in),
        "w_up": normal((num_layers, d_model, d_ff), scale_in),
        "w_down": normal((num_layers, d_ff, d_model), scale_out),
    }


def gated_mlp(x, p, *, activation: str):
    """x (B, S, D) → (B, S, D): ``(act(x·W_gate) ⊙ x·W_up)·W_down`` with
    SwiGLU (``silu``) or GeGLU (the tanh-approximated ``gelu``, as
    ``jax.nn.gelu(approximate=True)``), in x's dtype."""
    h_gate = torch.matmul(x, p["w_gate"])
    h_up = torch.matmul(x, p["w_up"])
    if activation == "swiglu":
        h = torch.nn.functional.silu(h_gate) * h_up
    elif activation == "geglu":
        h = torch.nn.functional.gelu(h_gate, approximate="tanh") * h_up
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return torch.matmul(h, p["w_down"])


def embed_tokens(ids, table, config: ModelConfig):
    """ids (B, S) → (B, S, D). The JAX tied path is a one-hot matmul; that
    is an exact row lookup, so plain indexing gives the same numbers."""
    del config
    return table[ids.long()]


def lm_logits(x, params, config: ModelConfig):
    """x (B, S, D) → logits (B, S, V_pad) fp32, pad-vocab entries −1e30.

    The JAX train and decode modes differ only in their sharding, so one
    function serves both. The pad entries are written in place, which
    gives them a zero gradient, as ``jnp.where`` does."""
    if config.tie_embeddings:
        logits = torch.matmul(x, params["embed"].t())
    else:
        logits = torch.matmul(x, params["lm_head"])
    logits = logits.float()
    if config.padded_vocab != config.vocab_size:
        logits[..., config.vocab_size:] = -1e30
    return logits


def token_nll(logits, labels):
    """(B, S) negative log-likelihood of each label under fp32 ``logits``
    (B, S, V), as :func:`cross_entropy_loss` computes it before its
    mean."""
    vmax = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - vmax.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + vmax[..., 0]
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - label_logit


def cross_entropy_loss(logits, labels, *, mask=None):
    """Mean token NLL: logits (B, S, V) fp32, labels (B, S); ``mask``
    (B, S) optional 0/1 validity (the vision patch positions are 0).

    Written as the JAX version is: the max is detached where it shifts
    the logits and not where it is added back, so the gradient carries
    the max's (one-hot, split between ties) term as the reference's does
    (``torch.amax`` splits it between ties as ``jnp.max`` does)."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

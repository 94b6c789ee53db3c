"""Shared model layers: RMSNorm, RoPE, gated MLPs, vocab embedding and
logits, and the seeded weight draw every ``init_*`` uses.

Plain functions on tensors, in the JAX package's layouts (``repro/models/
layers.py``), so that both packages run the same weights.

Under a policy whose model axis is wider than one rank
(:func:`~repro_torch.sharding.model_axis`) the weights are the rank's
shards (:func:`~repro_torch.sharding.param_specs`): the embedding looks up
its vocabulary rows (or ``d_model`` columns, untied), the logits are its
vocabulary slice gathered (or, in training, its rows against the gathered
head), and the gated MLP is column-parallel in and row-parallel out in
decode, with its weights gathered in prefill and training.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.sharded import (
    gather_cat,
    rows_linear,
    scale_rows,
    sum_over,
)
from ..sharding.policy import model_axis

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
    "mean_nll",
    "normal_init",
]

# a stacked weight whose fp32 draw takes more bytes than this is drawn one
# layer at a time (Mixtral's experts: a 30 GB fp32 draw whole)
WHOLE_DRAW_BYTES = 8 << 30


def normal_init(shape, scale: float, *, dtype, device,
                generator: torch.Generator, keep=None, shard=None):
    """``N(0, 1) · scale`` in ``dtype``, drawn in fp32 from ``generator``.

    A weight whose fp32 draw fits in :data:`WHOLE_DRAW_BYTES` is drawn
    whole and cast, the way every weight was drawn before (granite's keep
    their bits). A larger stack is drawn one leading slice at a time into
    the ``dtype`` tensor, so no fp32 copy of the whole stack exists. On the
    CPU the two give the same values when a slice holds a multiple of 16
    elements; on the card the draws differ (the generator's offsets follow
    each call's size). ``keep``, a function of one leading slice's draw
    that returns the rank's block of it (its expert slots, and under FSDP
    its block of ``d_model``), keeps only that of each slice, drawn a
    leading slice at a time whatever the size, so that no rank holds a
    whole stack. On the meta device nothing is drawn (no generator can
    draw there): the result is an empty meta tensor of the shape (after
    ``keep``) and ``dtype``, and ``generator`` may be None. ``shard``, a
    function of the drawn tensor, keeps a rank's block of it after the
    draw (a contiguous copy, so that the whole draw is freed): the values
    are the one-device draw's."""
    if shard is not None:
        w = normal_init(shape, scale, dtype=dtype, device=device,
                        generator=generator, keep=keep)
        return shard(w).contiguous()
    kept = tuple(shape)
    if keep is not None:
        kept = (shape[0], *keep(torch.empty(shape[1:], device="meta")).shape)
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
        out[i].copy_((w if keep is None else keep(w)).mul_(scale))
    return out


def rms_norm(x, scale, eps: float = 1e-6, *, rows=None):
    """RMSNorm in fp32 with a ``1 + scale`` gain, cast back to x's dtype.
    ``rows``, a ``(mesh, axis)`` pair, says that x is the rank's block of
    a sequence sharded over ``axis`` (dim 1): the scale's gradient then
    sums every rank's rows (:func:`~repro_torch.kernels.sharded.
    scale_rows`)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if rows is not None:
        return scale_rows(out, scale, *rows).to(x.dtype)
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
                   generator: torch.Generator, shard=None):
    """Random gate, up and down projections; ``shard`` as
    :func:`~repro_torch.models.attention.init_attention` takes it."""
    shard = shard or (lambda name: None)

    def normal(name, shape, scale):
        return normal_init(shape, scale, dtype=dtype, device=device,
                           generator=generator, shard=shard(name))

    scale_in = float(1.0 / np.sqrt(d_model))
    scale_out = float(1.0 / np.sqrt(d_ff))
    return {
        "w_gate": normal("w_gate", (num_layers, d_model, d_ff), scale_in),
        "w_up": normal("w_up", (num_layers, d_model, d_ff), scale_in),
        "w_down": normal("w_down", (num_layers, d_ff, d_model), scale_out),
    }


def _act(h_gate, activation: str):
    if activation == "swiglu":
        return torch.nn.functional.silu(h_gate)
    if activation == "geglu":
        return torch.nn.functional.gelu(h_gate, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def _mlp(x, p, activation: str):
    h_gate = torch.matmul(x, p["w_gate"])
    h_up = torch.matmul(x, p["w_up"])
    return torch.matmul(_act(h_gate, activation) * h_up, p["w_down"])


def gated_mlp(x, p, *, activation: str, policy=None,
              rows: str | None = None):
    """x (B, S, D) → (B, S, D): ``(act(x·W_gate) ⊙ x·W_up)·W_down`` with
    SwiGLU (``silu``) or GeGLU (the tanh-approximated ``gelu``, as
    ``jax.nn.gelu(approximate=True)``), in x's dtype.

    Under a ``policy`` with a model axis the weights are the rank's F
    columns of gate and up and F rows of down. In decode (``rows=None``,
    every rank holding every row) the MLP is tensor-parallel: each rank
    computes a partial output over its F in fp32, summed over the axis in
    rank order and rounded once to x's dtype. In prefill and training the
    weights are gathered whole: ``rows="block"`` (x the rank's block of a
    sequence-parallel sequence) through
    :func:`~repro_torch.kernels.sharded.rows_linear`, whose gradients sum
    every rank's rows; ``rows="all"`` (every rank running every row alike)
    through a gather whose adjoint keeps the rank's block."""
    axis = model_axis(policy)
    if axis is None:
        return _mlp(x, p, activation)
    mesh = policy.mesh
    if rows == "block":
        def linear(h, name, wdim):
            return rows_linear(h, p[name], None, mesh, axis, wdim=wdim)

        h = _act(linear(x, "w_gate", 1), activation) * linear(x, "w_up", 1)
        return linear(h, "w_down", 0)
    if rows == "all":
        whole = {name: gather_cat(p[name], mesh, axis,
                                  0 if name == "w_down" else 1)
                 for name in ("w_gate", "w_up", "w_down")}
        return _mlp(x, whole, activation)
    if rows is not None:
        raise ValueError(f"rows {rows!r} not in (None, 'block', 'all')")
    h = _act(torch.matmul(x, p["w_gate"]), activation) * torch.matmul(
        x, p["w_up"])
    part = torch.matmul(h.float(), p["w_down"].float())
    return sum_over(part, mesh, axis).to(x.dtype)


def embed_tokens(ids, table, config: ModelConfig, policy=None):
    """ids (B, S) → (B, S, D). The JAX tied path is a one-hot matmul; that
    is an exact row lookup, so plain indexing gives the same numbers.

    Under a ``policy`` with a model axis a tied table holds the rank's
    vocabulary rows: each rank looks up the ids it holds, writes zeros for
    the others, and the parts are summed over the axis (one non-zero term
    and zeros: the whole lookup, bit for bit). An untied table holds the
    rank's ``d_model`` columns, gathered. Every rank returns the whole
    (B, S, D)."""
    axis = model_axis(policy)
    if axis is None:
        return table[ids.long()]
    mesh = policy.mesh
    if not config.tie_embeddings:
        return gather_cat(table[ids.long()], mesh, axis, -1)
    n = table.shape[0]
    local = ids.long() - mesh.index(axis) * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    part = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return sum_over(part, mesh, axis)


def _mask_pad(logits, config: ModelConfig):
    if config.padded_vocab != config.vocab_size:
        logits[..., config.vocab_size:] = -1e30
    return logits


def lm_logits(x, params, config: ModelConfig, policy=None, *,
              mode: str = "decode", seq_sharded: bool = False):
    """x (B, S, D) → logits (B, S, V_pad) fp32, pad-vocab entries −1e30.

    Without a model axis the JAX train and decode modes differ only in their
    sharding, so both compute the whole product. Under a ``policy`` with
    one, as JAX: ``"decode"`` multiplies by the rank's vocabulary slice of
    the head and gathers the logits; ``"train"`` gathers the head and gives
    the rows' logits over the whole vocabulary (with ``seq_sharded``, the
    rank's block of the sequence:
    :func:`~repro_torch.kernels.sharded.rows_linear`; else every row, the
    gather's cotangent kept as the rank's slice). The pad entries are
    written in place, which gives them a zero gradient, as ``jnp.where``
    does."""
    tied = config.tie_embeddings
    w = params["embed"] if tied else params["lm_head"]
    axis = model_axis(policy)
    if mode not in ("train", "decode"):
        raise ValueError(f"mode {mode!r} not in ('train', 'decode')")
    if axis is not None and mode == "train" and seq_sharded:
        logits = rows_linear(x, w, None, policy.mesh, axis,
                             wdim=0 if tied else 1, transpose=tied)
        return _mask_pad(logits.float(), config)
    if axis is not None and mode == "train":
        w = gather_cat(w, policy.mesh, axis, 0 if tied else 1)
    logits = torch.matmul(x, w.t() if tied else w)
    if axis is not None and mode == "decode":
        logits = gather_cat(logits, policy.mesh, axis, -1)
    return _mask_pad(logits.float(), config)


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
    return mean_nll(token_nll(logits, labels), mask)


def mean_nll(nll, mask=None):
    """:func:`cross_entropy_loss`'s mean of the token losses (B, S)."""
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

"""AdamW and int8 gradient compression, the JAX package's formulas on
tensors (port of ``repro/training/optimizer.py``).

``torch.optim.AdamW`` has another schedule and another clip, so the update
is written out: warm-up then cosine decay to ``min_lr_ratio`` of the peak
rate, a clip by the global norm of every gradient, bias-corrected moments
in fp32, decoupled weight decay, and the step taken in fp32 and cast back
to the parameter's dtype.

The update works **in place**, one leaf at a time: the moments with
``mul_``/``add_``/``addcmul_`` and the parameter with ``copy_``. At full
granite the stacked expert weights are one leaf of about 1.0 G values (4 GB
per fp32 temporary), so the step holds two fp32 temporaries of the leaf it
is on and no copy of the others. The schedule's step count stays on the
host (a 0-d int32 CPU tensor, ``opt["step"]``), so a step reads nothing
back from the card.

**Under a mesh** each rank holds its leaves in the parameters' layout
(:func:`adamw_state_specs`: the moments are shaped like the rank's own
parameters), and ``policy`` with the tree's ``specs``
(:func:`repro_torch.sharding.param_specs`) makes the two global values
GSPMD computes: the gradient norm (each leaf's squares counted once) and
each leaf's compression scale (the max of |g| over its axes). The norm
sums each leaf's squares slice by slice along the dim a model axis may
shard (:func:`~repro_torch.sharding.model_dim`), and the slices' sums
in order: a rank computes its block of them and the blocks are gathered,
so that the norm has the same bits on every rank and on one device,
whatever the model axis. Under FSDP a slice's square is first summed over
``data`` from the ranks' partials, in rank order (the same bits on every
rank; one device's order no longer). The max runs over the axes
(:meth:`repro_torch.launch.mesh.Mesh.all_reduce`): every rank takes the
same step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..sharding.policy import model_dim, spec_axes
from ..tree import leaf_paths, leaves, leaves_along, tree_map, unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_state_specs",
           "compress_grads"]

_F32 = np.float32
# the dtypes JAX's ``p.dtype.kind == "f"`` takes: bfloat16 is kind "V" in
# numpy (ml_dtypes), so the reference leaves bf16 parameters undecayed
_DECAYED = (torch.float16, torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # gradient compression (error feedback int8)
    compress: bool = False
    compress_bits: int = 8


def _lr(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (1-based), in float32 as JAX computes
    it."""
    step = _F32(step)
    warm = np.minimum(step / _F32(max(cfg.warmup_steps, 1)), _F32(1.0))
    progress = np.clip(
        (step - _F32(cfg.warmup_steps))
        / _F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
        _F32(0.0), _F32(1.0),
    )
    cosine = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * progress))
    scale = _F32(cfg.min_lr_ratio) + (_F32(1.0) - _F32(cfg.min_lr_ratio)) * cosine
    return float(_F32(cfg.learning_rate) * warm * scale)


def adamw_init(params) -> dict[str, Any]:
    """fp32 zero moments shaped like ``params`` and a step count of 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def adamw_state_specs(param_specs):
    """The optimizer state's specs, mirroring the parameters' (the moments
    live wherever the parameter shard lives; the step count is whole)."""
    return {"mu": param_specs, "nu": param_specs, "step": ()}


def _reduce_sharded(values: list, flat_specs: list, policy, op: str) -> list:
    """``values`` (one 0-d tensor a leaf) with each sharded leaf's value
    reduced by ``op`` over its spec's axes: one collective a set of axes."""
    if policy is None or policy.mesh is None:
        return values
    values = list(values)
    by_axes: dict[tuple, list[int]] = {}
    for i, spec in enumerate(flat_specs):
        axes = spec_axes(spec)
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        packed = policy.mesh.all_reduce(torch.stack([values[i] for i in idx]),
                                        axes, op)
        for j, i in enumerate(idx):
            values[i] = packed[j]
    return values


def _squares(grads, specs, policy) -> list:
    """Each leaf's sum of squares (a 0-d fp32 tensor), the same bits on
    every rank: per slice along the leaf's
    :func:`~repro_torch.sharding.model_dim` (the squared norm of each
    slice), the slices' values gathered whole where the leaf is sharded
    there, then summed in order. A leaf also stored over other axes
    (FSDP's ``data``, on another dim) has each slice's partial square on
    each rank: the partials are summed over those axes first, in rank
    order. Without such axes the bits are one device's."""
    tied = "lm_head" not in grads
    flat = leaves(grads)
    mesh = None if policy is None else policy.mesh
    parts: list = [None] * len(flat)
    along: list = [None] * len(flat)  # the slices' axes, where sharded
    partial: dict = {}  # the axes a leaf's partials sum over → leaves
    for i, (path, g, spec) in enumerate(zip(leaf_paths(grads), flat,
                                            leaves_along(grads, specs))):
        dim = model_dim(path, g.dim(), tied=tied)
        if dim is None:
            parts[i] = torch.square(torch.linalg.vector_norm(
                g, dtype=torch.float32)).reshape(1)
        else:
            others = [d for d in range(g.dim()) if d != dim]
            parts[i] = torch.square(torch.linalg.vector_norm(
                g, dim=others, dtype=torch.float32))
            along[i] = None if spec is None else spec[dim]
        if mesh is None:
            continue
        rest = tuple(a for d, entry in enumerate(spec or ())
                     if d != dim and entry is not None
                     for a in spec_axes((entry,)))
        if rest:
            partial.setdefault(rest, []).append(i)
    for axes, idx in partial.items():
        summed = mesh.all_reduce(torch.cat([parts[i] for i in idx]), axes)
        lo = 0
        for i in idx:
            n = parts[i].numel()
            parts[i] = summed[lo:lo + n]
            lo += n
    out: list = [None] * len(flat)
    by_axes: dict = {}
    for i, part in enumerate(parts):
        if along[i] is None or mesh is None:
            out[i] = torch.sum(part)
        else:
            by_axes.setdefault(along[i], []).append((i, part))
    for axes, items in by_axes.items():
        gathered = mesh.all_gather(torch.cat([p for _, p in items]), axes)
        lo = 0
        for i, part in items:
            n = part.numel()
            out[i] = torch.sum(gathered[:, lo:lo + n].reshape(-1))
            lo += n
    return out


def compress_grads(grads, residual, bits: int = 8, *, policy=None,
                   specs=None):
    """Error-feedback quantization: returns (dequantized fp32 grads, the
    residual).

    Each leaf plus its residual is quantized to ``bits`` signed levels
    around its max-abs scale; the quantization error is written into
    ``residual`` in place (and it is returned) to be added back next step.
    Under a ``policy`` with a mesh, a leaf sharded by its entry of
    ``specs`` takes the max over its axes, the whole leaf's scale."""
    levels = 2.0 ** (bits - 1) - 1
    pairs = list(zip(leaves(grads), leaves(residual)))
    # the scales first (each leaf's fp32 sum is made again below, so that
    # no more than one exists at a time)
    amax = _reduce_sharded(
        [torch.amax(torch.abs(g.float() + r)) for g, r in pairs],
        leaves_along(grads, specs), policy, "max")
    out = []
    for (g, r), m in zip(pairs, amax):
        g = g.float() + r
        scale = torch.clamp(m, min=1e-12) / levels
        deq = torch.round(g / scale) * scale
        r.copy_(g - deq)
        out.append(deq)
    return unflatten(grads, out), residual


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, policy=None,
                 specs=None):
    """One AdamW step, in place. Returns (params, state, metrics), the
    tensors given, updated, and ``{"grad_norm", "lr"}`` (a device scalar
    and a float). Under a ``policy`` with a mesh, ``specs`` (the tree's
    :func:`~repro_torch.sharding.param_specs`) names the sharded leaves,
    whose slices' sums of squares are gathered over their axes
    (:func:`_squares`): ``grad_norm`` and the clip are the global ones."""
    step = state["step"] + 1
    n = int(step)
    flat_g = leaves(grads)
    gnorm = torch.sqrt(sum(_squares(grads, specs, policy)))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _lr(cfg, n)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(_F32(1.0) - _F32(b1) ** _F32(n))
    bc2 = float(_F32(1.0) - _F32(b2) ** _F32(n))
    for p, g, mu, nu in zip(leaves(params), flat_g, leaves(state["mu"]),
                            leaves(state["nu"])):
        g32 = g.to(torch.float32, copy=True).mul_(clip)
        mu.mul_(b1).add_(g32, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        denom = torch.div(nu, bc2).sqrt_().add_(cfg.eps)
        delta = torch.div(mu, bc1, out=g32).div_(denom)
        del denom
        if p.dtype in _DECAYED and cfg.weight_decay > 0:
            delta.add_(p, alpha=cfg.weight_decay)
        p.copy_(delta.mul_(-lr).add_(p))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

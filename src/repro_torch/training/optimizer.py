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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..tree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_grads"]

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


def compress_grads(grads, residual, bits: int = 8):
    """Error-feedback quantization: returns (dequantized fp32 grads, the
    residual).

    Each leaf plus its residual is quantized to ``bits`` signed levels
    around its max-abs scale; the quantization error is written into
    ``residual`` in place (and it is returned) to be added back next step.
    """
    levels = 2.0 ** (bits - 1) - 1

    def q(g, r):
        g = g.float() + r
        scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / levels
        deq = torch.round(g / scale) * scale
        r.copy_(g - deq)
        return deq

    return tree_map(q, grads, residual), residual


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place. Returns (params, state, metrics), the
    tensors given, updated, and ``{"grad_norm", "lr"}`` (a device scalar
    and a float)."""
    step = state["step"] + 1
    n = int(step)
    flat_g = leaves(grads)
    gnorm = torch.sqrt(sum(
        torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
        for g in flat_g
    ))
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

"""Device dispatch for the two kernels, and their launch counts.

A tensor on a CUDA device always reaches the hand-written kernel: the
wrapper launches it or raises, and never falls back to the plain version.
A tensor on the CPU takes the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, which is how the tests run here. This
replaces ``repro/kernels/ops.py`` and the single-device branch of
``repro/kernels/sharded.py`` (no capacity or F padding: the kernels mask
ragged shapes themselves). When an input requires a gradient, the call
goes through the ``torch.autograd.Function``s of
:mod:`repro_torch.kernels.autograd`, which run the same kernel forward and
the reference's backward; otherwise (serving) the wrapper is called
directly.
"""
from __future__ import annotations

import torch

from . import launches
from .autograd import MoEFFN, TopKRouter
from .moe_gemm import moe_ffn_cuda
from .ref import moe_ffn_ref, topk_router_ref
from .topk_router import topk_router_cuda

__all__ = [
    "moe_ffn",
    "topk_router",
    "moe_ffn_ref",
    "topk_router_ref",
    "launch_counts",
    "reset_launch_counts",
]


def _on_cpu(t, what: str) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"{what}: unsupported device {t.device}")


def moe_ffn(x_e, w_gate, w_up, w_down):
    """x_e (S, C, D), w_gate/w_up (S, D, F), w_down (S, F, D) → (S, C, D)."""
    on_cpu = _on_cpu(x_e, "moe_ffn")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_e, w_gate, w_up, w_down)):
        return MoEFFN.apply(x_e, w_gate, w_up, w_down)
    if on_cpu:
        return moe_ffn_ref(x_e, w_gate, w_up, w_down)
    return moe_ffn_cuda(x_e, w_gate, w_up, w_down)


def topk_router(logits, k: int, *, with_stats: bool = False):
    """logits (T, E) f32 → (gates, ids[, probs_sum, counts])."""
    on_cpu = _on_cpu(logits, "topk_router")
    if torch.is_grad_enabled() and logits.requires_grad:
        if not with_stats:
            # as in the reference, only the router with its statistics
            # (the one training runs) has a backward
            raise NotImplementedError(
                "topk_router: no backward without with_stats=True")
        return TopKRouter.apply(logits, k)
    if on_cpu:
        return topk_router_ref(logits, k, with_stats=with_stats)
    return topk_router_cuda(logits, k, with_stats=with_stats)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset, each replay of a
    captured CUDA graph counted as the launches it runs."""
    return dict(launches.LAUNCHES)


def reset_launch_counts() -> None:
    launches.reset()

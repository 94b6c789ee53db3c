"""Device dispatch for the two kernels, and their launch counts.

A tensor on a CUDA device always reaches the hand-written kernel: the
wrapper launches it or raises, and never falls back to the plain version.
A tensor on the CPU takes the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, which is how the tests run here. This
replaces ``repro/kernels/ops.py`` and the single-device branch of
``repro/kernels/sharded.py`` (no capacity or F padding: the kernels mask
ragged shapes themselves).
"""
from __future__ import annotations

from . import moe_gemm, topk_router as _router
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
    if _on_cpu(x_e, "moe_ffn"):
        return moe_ffn_ref(x_e, w_gate, w_up, w_down)
    return moe_ffn_cuda(x_e, w_gate, w_up, w_down)


def topk_router(logits, k: int, *, with_stats: bool = False):
    """logits (T, E) f32 → (gates, ids[, probs_sum, counts])."""
    if _on_cpu(logits, "topk_router"):
        return topk_router_ref(logits, k, with_stats=with_stats)
    return topk_router_cuda(logits, k, with_stats=with_stats)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {**moe_gemm.LAUNCHES, **_router.LAUNCHES}


def reset_launch_counts() -> None:
    for table in (moe_gemm.LAUNCHES, _router.LAUNCHES):
        for name in table:
            table[name] = 0

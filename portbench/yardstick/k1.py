"""K1's work (the grouped SwiGLU expert FFN): what its inputs need, not
what a padded launch computes.

A routed (token, slot) assignment needs the gate, up and down products of
one virtual expert: 2·3·D·F_v operations. A launch reads the three weight
matrices of every slot that received an assignment once, and each
assignment's token row once, and writes each output row once. The hidden
activations between the products are the kernel's own scratch and are
not counted. With every slot full (S·C assignments on S slots) the count
is the bound of ``PERF.md``'s kernel table at that shape."""
from __future__ import annotations

from .peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S


def flops(assignments: int, d_model: int, f_v: int) -> float:
    return 2.0 * 3.0 * d_model * f_v * assignments


def nbytes(assignments: int, active_slots: int, d_model: int, f_v: int,
           dtype_bytes: int = 2) -> float:
    weights = active_slots * 3.0 * d_model * f_v * dtype_bytes
    rows = 2.0 * assignments * d_model * dtype_bytes
    return weights + rows


def bound_s(assignments: int, active_slots: int, d_model: int, f_v: int,
            dtype_bytes: int = 2) -> float:
    """The least time the card could take for one launch: the larger of
    its operations over the bf16 peak and its bytes over HBM's."""
    return max(flops(assignments, d_model, f_v) / BF16_FLOPS_PER_S,
               nbytes(assignments, active_slots, d_model, f_v, dtype_bytes)
               / HBM_BYTES_PER_S)

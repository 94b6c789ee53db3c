"""Plain PyTorch versions of the two hand-written kernels.

They are what :mod:`repro_torch.kernels.ops` runs for tensors on the CPU,
and the ground truth every kernel is held against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["moe_ffn_ref", "topk_router_ref"]


def moe_ffn_ref(x_e, w_gate, w_up, w_down):
    """Grouped SwiGLU expert FFN.

    x_e (S, C, D) capacity-grouped tokens; w_gate/w_up (S, D, F);
    w_down (S, F, D) → (S, C, D). fp32 accumulation; the hidden ``h`` is
    cast to the input dtype before the down product, as the TPU kernel
    does, and the output is cast back to the input dtype.
    """
    xf = x_e.float()
    h_gate = torch.bmm(xf, w_gate.float())
    h_up = torch.bmm(xf, w_up.float())
    h = (torch.nn.functional.silu(h_gate) * h_up).to(x_e.dtype)
    y = torch.bmm(h.float(), w_down.float())
    return y.to(x_e.dtype)


def topk_router_ref(logits, k: int, *, with_stats: bool = False):
    """Softmax → top-k ids + renormalised gates (+ aux statistics).

    logits (T, E) → gates (T, k) f32, ids (T, k) i32, sorted by descending
    probability with ties going to the lowest expert id (a stable sort:
    ``torch.topk`` does not promise that order). With ``with_stats`` also
    probs_sum (E,) f32, the per-expert sum of probabilities over the rows,
    and counts (E,) i32, the per-expert top-k selections.
    """
    lf = logits.float()
    m = lf.max(dim=-1, keepdim=True).values
    e = torch.exp(lf - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = vals[:, :k]
    gates = top / top.sum(dim=-1, keepdim=True)
    ids = order[:, :k].to(torch.int32)
    if not with_stats:
        return gates, ids
    E = logits.shape[-1]
    probs_sum = probs.sum(dim=0)
    counts = torch.bincount(ids.reshape(-1).long(), minlength=E).to(torch.int32)
    return gates, ids, probs_sum, counts

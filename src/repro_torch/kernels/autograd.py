"""Gradients through the two hand-written kernels.

The port's counterpart of the ``jax.custom_vjp``s in
``repro/kernels/sharded.py``: each kernel runs the forward, and the
backward is the reference's plain math written in torch ops (there is no
backward kernel in either package).

* :class:`MoEFFN` — the grouped SwiGLU expert FFN (K1). The backward
  recomputes the hidden activations in fp32 and returns dx, dWg, dWu, dWd
  in each input's dtype (``sharded.py:159-182``).
* :class:`TopKRouter` — softmax → top-k with the aux statistics (K2). The
  backward carries the gates' cotangent through the renorm and the top-k
  gather, adds the ``probs_sum`` cotangent to every row and applies the
  softmax's Jacobian (``sharded.py:243-263``). ``ids`` and ``counts`` are
  integers and carry no gradient.

A CUDA tensor runs the kernel and a CPU tensor its plain version
(:mod:`repro_torch.kernels.ref`), so on the CPU the same Functions run and
their backwards can be held against the JAX ones. Callers go through
:func:`repro_torch.kernels.ops.moe_ffn` and ``ops.topk_router``, which take
these Functions only when an input requires a gradient; serving never does.
"""
from __future__ import annotations

import torch

from .moe_gemm import moe_ffn_cuda
from .ref import moe_ffn_ref, topk_router_ref
from .topk_router import topk_router_cuda

__all__ = ["MoEFFN", "TopKRouter"]


class MoEFFN(torch.autograd.Function):
    """x_e (S, C, D), w_gate/w_up (S, D, F), w_down (S, F, D) → (S, C, D)."""

    @staticmethod
    def forward(ctx, x_e, w_gate, w_up, w_down):
        ctx.save_for_backward(x_e, w_gate, w_up, w_down)
        if x_e.is_cuda:
            return moe_ffn_cuda(x_e, w_gate, w_up, w_down)
        return moe_ffn_ref(x_e, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, g):
        # y = (silu(x·Wg) ⊙ x·Wu)·Wd, the hidden activations recomputed
        x, wg, wu, wd = ctx.saved_tensors
        xf = x.float()
        wgf, wuf, wdf = wg.float(), wu.float(), wd.float()
        h1 = torch.bmm(xf, wgf)
        h2 = torch.bmm(xf, wuf)
        sig = torch.sigmoid(h1)
        s = h1 * sig  # silu
        gf = g.float()
        dh = torch.bmm(gf, wdf.transpose(1, 2))
        dwd = torch.bmm((s * h2).transpose(1, 2), gf)
        dh2 = dh * s
        dh1 = dh * h2 * (sig * (1.0 + h1 * (1.0 - sig)))  # silu'
        dx = (torch.bmm(dh1, wgf.transpose(1, 2))
              + torch.bmm(dh2, wuf.transpose(1, 2)))
        xt = xf.transpose(1, 2)
        dwg = torch.bmm(xt, dh1)
        dwu = torch.bmm(xt, dh2)
        return (dx.to(x.dtype), dwg.to(wg.dtype), dwu.to(wu.dtype),
                dwd.to(wd.dtype))


class TopKRouter(torch.autograd.Function):
    """logits (T, E) f32 → gates (T, k) f32, ids (T, k) i32, probs_sum (E,)
    f32, counts (E,) i32: the router with its statistics."""

    @staticmethod
    def forward(ctx, logits, k: int):
        if logits.is_cuda:
            out = topk_router_cuda(logits, k, with_stats=True)
        else:
            out = topk_router_ref(logits, k, with_stats=True)
        # the kernel's outputs are views of one buffer: each output gets
        # storage of its own, so that autograd sees four unrelated tensors
        gates, ids, probs_sum, counts = (t.clone() for t in out)
        ctx.mark_non_differentiable(ids, counts)
        ctx.save_for_backward(logits, ids)
        return gates, ids, probs_sum, counts

    @staticmethod
    def backward(ctx, dgates, _dids, dpsum, _dcounts):
        lg, ids = ctx.saved_tensors
        ids = ids.long()
        probs = torch.softmax(lg.float(), dim=-1)  # (T, E)
        pick = torch.gather(probs, -1, ids)  # (T, k)
        ssum = pick.sum(dim=-1, keepdim=True)
        dgates = dgates.float()
        # gates = pick / Σpick ⇒ dpick_i = dgates_i/Σ − (Σ_j dgates_j·pick_j)/Σ²
        dot = torch.sum(dgates * pick, dim=-1, keepdim=True)
        dpick = dgates / ssum - dot / (ssum * ssum)
        dprobs = torch.zeros_like(probs).scatter_add_(-1, ids, dpick)
        dprobs = dprobs + dpsum.float()[None, :]
        dlg = probs * (dprobs - torch.sum(dprobs * probs, dim=-1, keepdim=True))
        return dlg.to(lg.dtype), None

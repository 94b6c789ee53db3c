"""Per-rank entry points of the two kernels on a mesh (port of
``repro/kernels/sharded.py``).

The JAX package runs its Pallas kernels under ``shard_map``, so that each
device computes on its local shard; here each rank is a process, runs the
kernel on its own shard and moves what the others need with the mesh's
collectives (:mod:`repro_torch.launch.mesh`):

* :func:`moe_ffn_sharded` — K1, the grouped expert FFN, on the rank's
  ``(G, E_v/m, C, D)`` buffer against its ``(E_v/m, D, F)`` weights; the
  outputs are all-gathered over the model axis back into the full expert
  dim, which the combine reads.
* :func:`topk_router_sharded` — K2, top-k with its statistics, on the
  rank's ``(G, Ng, E)`` logits; the ``(E,)`` partial ``probs_sum`` and
  ``counts`` are all-gathered over the data axis and summed in rank order,
  as JAX sums its per-shard partials over axis 0, so ``counts`` are exact
  on every rank.

Spec arguments come from :meth:`~repro_torch.sharding.ShardingPolicy.
moe_shard_spec`. ``mesh=None`` is the direct single-device call. The
Pallas tile clamp ``effective_block_c`` does not carry over: the CUDA
kernels mask ragged capacities and widths themselves, so no shape is
padded to a tile here.

**Gradients under a mesh** (the reference's two ``custom_vjp``s, which
training through a mesh differentiates). Every rank runs the backward of
its own loss, and the gradients of a leaf held on several ranks are
summed over them once a step (:mod:`repro_torch.training.train_step`).
A value every rank of an axis holds alike (the gathered FFN outputs, the
summed statistics, the loss) carries the whole cotangent on every rank.
So the adjoint of a gather keeps the rank's own slice of it and sends
nothing (:func:`gather_over`), and the adjoint of a sum over ranks is the
identity (:func:`sum_over`): summing the gradients over the axis then
counts each term once. K1's backward is the exception: its input buffer
is whole on every rank of the model axis, which computes only its
experts' rows of it, and everything upstream runs alike on those ranks;
so the rows' cotangents are all-gathered over the axis there, and every
rank gets the whole ``dx``. Its weight gradients stay on the rank (only
its rows of a whole-stored stack are non-zero).
"""
from __future__ import annotations

import torch

from . import autograd as _ag
from .ops import moe_ffn, topk_router

__all__ = ["moe_ffn_sharded", "topk_router_sharded", "gather_over",
           "sum_over"]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.me = mesh.index(axis)
        return mesh.all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.me], None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_over(t, mesh, axis):
    """``mesh.all_gather(t, axis)`` ((n, *t.shape), in axis order) whose
    backward keeps this rank's slice of the cotangent."""
    return _GatherOver.apply(t, mesh, axis)


def sum_over(t, mesh, axis):
    """``mesh.all_reduce(t, axis)`` (the sum in rank order) whose backward
    passes the cotangent through unchanged."""
    return _SumOver.apply(t, mesh, axis)


def _ffn_groups(x, wg, wu, wd):
    """K1 once per dispatch group: x (G, S, C, D) → (G, S, C, D)."""
    return torch.stack([moe_ffn(x[g], wg, wu, wd) for g in range(x.shape[0])])


def _ffn_rank(x_e, ws, mesh, axis, lo, live, per):
    """This rank's slots ``[lo, lo + live)`` of every group through K1,
    zero-padded to ``per`` slots and all-gathered over ``axis``:
    (m, G, per, C, D)."""
    G, _, C, D = x_e.shape
    y = x_e.new_zeros((G, per, C, D))
    if live:
        y[:, :live] = _ffn_groups(x_e[:, lo:lo + live], *ws)
    return mesh.all_gather(y, axis)


class _ShardedFFN(torch.autograd.Function):
    """K1 on the rank's live slots with the outputs gathered over the
    model axis; the backward of ``repro/kernels/sharded.py:152-184`` on
    those slots, ``dx`` gathered over the axis."""

    @staticmethod
    def forward(ctx, x_e, wg, wu, wd, mesh, axis, lo, live, per):
        # only the rows this rank computes are kept for the backward
        ctx.save_for_backward(x_e[:, lo:lo + live].contiguous(), wg, wu, wd)
        ctx.mesh, ctx.axis, ctx.live, ctx.per = mesh, axis, live, per
        ctx.num_slots = x_e.shape[1]
        return _ffn_rank(x_e, (wg, wu, wd), mesh, axis, lo, live, per)

    @staticmethod
    def backward(ctx, g):
        x_mine, wg, wu, wd = ctx.saved_tensors
        mesh, live, per = ctx.mesh, ctx.live, ctx.per
        G, _, C, D = x_mine.shape
        # this rank's slice of the gathered cotangent: its own slots'
        gy = g[mesh.index(ctx.axis), :, :live]
        dx = x_mine.new_zeros((G, per, C, D))
        dws = [torch.zeros_like(w) for w in (wg, wu, wd)]
        if live:
            # the groups side by side on the row dim: dx is row-wise, and
            # the weight gradients sum over groups and rows alike
            def rows(t):
                return t.transpose(0, 1).reshape(live, G * C, D)

            ddx, *dws = _ag.ffn_backward(rows(x_mine), wg, wu, wd, rows(gy))
            dx[:, :live] = ddx.reshape(live, G, C, D).transpose(0, 1)
        full = mesh.all_gather(dx, ctx.axis)  # (m, G, per, C, D)
        dx = full.transpose(0, 1).reshape(G, -1, C, D)[:, :ctx.num_slots]
        return (dx, *dws, None, None, None, None, None)


def moe_ffn_sharded(x_e, w_gate, w_up, w_down, *, mesh, data_spec,
                    expert_spec, pad_expert_to: int | None = None):
    """(G, E_v, C, D) expert buffers → (G, E_v, C, D) FFN outputs.

    ``x_e`` holds this rank's dispatch groups (the groups of its data
    shard when ``data_spec`` names the batch axes, else all of them) with
    every expert's buffer. The weights are the rank's stored rows: its
    ``(E_v/m, …)`` shard of the slot dim, or the whole ``(E_v, …)`` stack
    (a pool the model axis does not divide is stored whole, as JAX
    replicates it).

    With ``expert_spec`` (the model axis) the rank computes only its
    experts ``[d·E/m, (d+1)·E/m)`` — one K1 launch a group — and the
    outputs are all-gathered over the axis. ``pad_expert_to`` (from
    :meth:`~repro_torch.sharding.ShardingPolicy.moe_expert_pad`) handles an
    E_v the axis does not divide: the expert dim pads to E_pad with dead
    slots, zero rows whose output is zero and is sliced back off, so every
    rank still computes only its share. With ``expert_spec=None`` (no
    mesh, or an indivisible pool without a pad) the rank computes every
    expert.

    Differentiable: the backward (``_ShardedFFN``) gives the whole ``dx``
    on every rank and the weight gradients of the rank's live rows only;
    dead rows, and the other ranks' rows of a whole-stored stack, get
    zeros.

    A 5-D ``x_e`` carries a stacked leading layer dim: (L, G, E_v, C, D)
    buffers with (L, E, D, F) weights loop the per-layer call over L.
    """
    if x_e.dim() == 5:
        return torch.stack([
            moe_ffn_sharded(x_e[i], w_gate[i], w_up[i], w_down[i], mesh=mesh,
                            data_spec=data_spec, expert_spec=expert_spec,
                            pad_expert_to=pad_expert_to)
            for i in range(x_e.shape[0])
        ])
    G, Ev, C, D = x_e.shape
    if mesh is None or expert_spec is None:
        return _ffn_groups(x_e, w_gate, w_up, w_down)
    Ep = max(Ev, pad_expert_to or 0)
    m = mesh.size(expert_spec)
    if Ep % m:
        raise ValueError(f"{Ep} expert slots do not shard over {m} ranks")
    per = Ep // m
    lo = mesh.index(expert_spec) * per
    live = max(min(per, Ev - lo), 0)  # this rank's slots below E_v
    ws = (w_gate, w_up, w_down)
    if w_gate.shape[0] != per or per == Ev:  # the whole stack: take ours
        ws = tuple(w[lo:lo + live] for w in ws)
    elif live < per:  # a stored shard that ends in dead slots
        ws = tuple(w[:live] for w in ws)
    args = (x_e, *ws, mesh, expert_spec, lo, live, per)
    if _needs_grad(x_e, *ws):
        full = _ShardedFFN.apply(*args)
    else:
        full = _ffn_rank(x_e, ws, mesh, expert_spec, lo, live, per)
    # (m, G, per, C, D) → (G, E_pad, C, D) → the E_v live slots
    return full.transpose(0, 1).reshape(G, Ep, C, D)[:, :Ev]


def _sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _router_rank(logits, k, mesh, data_spec):
    G, Ng, E = logits.shape
    gates, ids, psum, cnt = topk_router(logits.reshape(G * Ng, E), k,
                                        with_stats=True)
    gates, ids = gates.reshape(G, Ng, k), ids.reshape(G, Ng, k)
    if mesh is not None and data_spec is not None and mesh.size(data_spec) > 1:
        packed = torch.cat([psum.float(), cnt.to(torch.int32).view(torch.float32)])
        parts = mesh.all_gather(packed, data_spec)  # (d, 2E)
        psum = _sum_in_rank_order(parts[:, :E])
        cnt = _sum_in_rank_order(parts[:, E:].contiguous().view(torch.int32))
    return gates, ids, psum, cnt


class _ShardedRouter(torch.autograd.Function):
    """K2 on the rank's groups with the statistics summed over the data
    axis; the backward of ``repro/kernels/sharded.py:243-263`` on the
    rank's rows."""

    @staticmethod
    def forward(ctx, logits, k, mesh, data_spec):
        # each output gets storage of its own (the kernel's are views of
        # one buffer), so that autograd sees four unrelated tensors
        gates, ids, psum, cnt = (t.clone() for t in _router_rank(
            logits, k, mesh, data_spec))
        ctx.mark_non_differentiable(ids, cnt)
        ctx.save_for_backward(logits, ids)
        return gates, ids, psum, cnt

    @staticmethod
    def backward(ctx, dgates, _dids, dpsum, _dcounts):
        # ``dpsum`` is the cotangent of the summed statistics, alike on
        # every data rank: this rank's share of the gather's adjoint is
        # all of it, broadcast onto its own rows only
        logits, ids = ctx.saved_tensors
        return (_ag.router_backward(logits, ids, dgates, dpsum),
                None, None, None)


def topk_router_sharded(logits, k: int, *, mesh, data_spec):
    """logits (G, Ng, E) → (gates (G, Ng, k), ids (G, Ng, k),
    probs_sum (E,), counts (E,)).

    K2 with its statistics on this rank's groups; under a mesh with
    ``data_spec`` the partial statistics of every data shard are gathered
    and summed in rank order (one all-gather of both, packed as 2·E
    32-bit words), so the returned ``probs_sum`` and ``counts`` are the
    global sums on every rank. Differentiable in ``gates`` and
    ``probs_sum`` (``_ShardedRouter`` under a mesh)."""
    if mesh is not None and _needs_grad(logits):
        return _ShardedRouter.apply(logits, k, mesh, data_spec)
    return _router_rank(logits, k, mesh, data_spec)

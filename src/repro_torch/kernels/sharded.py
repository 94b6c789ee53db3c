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

**The model axis's layout** (the projections, the vocabulary and the
sequence sharded over ``model``) adds these, each with its adjoint:

* :func:`gather_cat` concatenates every rank's block along a dim; the
  ranks then compute alike on the whole (a replicated region: the gathered
  weights where every rank runs every row, the MoE layer's rows, the
  rows' token losses), each gets the whole cotangent and keeps its block.
* :func:`take_block` keeps the rank's block of a value every rank holds
  alike; its adjoint gathers the cotangent's blocks over the axis, so
  that the region before it gets the whole cotangent on every rank. A
  plain slice there would leave the region's leaves (the router, the
  experts) with the rank's rows' share only.
* :func:`rows_linear` is a product of the rank's block of rows with a
  weight gathered whole from its shards (a sequence-parallel projection):
  each rank uses the gathered weight for its own rows only, so the
  adjoint of the gather is the ranks' shares summed, each keeping its
  block. The sum is taken as one product over every rank's rows (their
  inputs and cotangents gathered in sequence order): the same terms as
  one device's product, in its order. Likewise :func:`scale_rows` (a
  whole norm scale applied to the rank's rows, whose gradient would
  otherwise hold those rows' share only) and :func:`rows_attention` (the
  rank's queries against the gathered K/V) sum their gradients over every
  rank's rows in one device's order: a sequence-parallel step's gradients
  are one device's, bit for bit, wherever the forward's are.

**The SSD heads over the model axis** (the SSM and hybrid families: each
rank runs its heads over every row, the B/C projections and convolutions
whole and alike on every rank) add two:

* :func:`sum_grads_over` marks a value every rank of the axis holds alike
  as the input of a region where each rank computes only its part (its
  heads): the identity forward, its adjoint sums the parts' cotangents
  over the axis (fp32, rank order), so that the value's gradient is
  complete and the same on every rank. The B/C activations enter the
  heads through it in fp32, so the B/C convolutions and projections take
  one complete cotangent, rounded once, and their weights' gradients are
  whole and alike on every rank, as a whole leaf's;
* :func:`scatter_sum` is the sequence-parallel out-projection: each
  rank's fp32 partial of the whole sequence is summed over the axis in
  rank order and the rank keeps its block of rows (a reduce-scatter,
  rounded once); its adjoint gathers the cotangent's blocks, so every
  rank's partial gets the whole cotangent. The block's entry is
  :func:`gather_fsdp` on the rank's normalised rows for the heads'
  projections (the adjoint sums the ranks' partial cotangents and keeps
  the rank's block), and :func:`rows_linear` of the whole B/C weights on
  the rank's rows, gathered with :func:`gather_cat`.

**The data axis's layout** (ZeRO-3, a policy with ``fsdp``) adds
:func:`gather_fsdp`: a layer's block of a leaf stored over ``data`` is
gathered whole along its data dim just before the layer uses it, and
each data rank uses the gathered weight for its own rows (or, in
replicated-activation decode, for every row alike, with no gradient). Its
adjoint is a reduce-scatter
(:meth:`~repro_torch.launch.mesh.Mesh.reduce_scatter`): each rank
receives every data rank's gradient of its block of the gathered weight
and sums them in fp32 in rank order, as
:meth:`~repro_torch.launch.mesh.Mesh.all_reduce` sums, at 1/d of the
bytes an ``all_reduce`` and a slice would receive. A leaf's gradient so
leaves the backward complete over ``data`` and sharded as the leaf is;
the model-axis code above runs on the gathered layer unchanged.
"""
from __future__ import annotations

import torch

from . import autograd as _ag
from .ops import moe_ffn, topk_router

__all__ = ["moe_ffn_sharded", "topk_router_sharded", "gather_over",
           "sum_over", "gather_cat", "gather_fsdp", "take_block",
           "rows_linear", "scale_rows", "rows_attention", "scatter_sum",
           "sum_grads_over"]


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


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.block = t.shape[dim]
        return _cat(mesh.all_gather(t, axis), dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.index(ctx.axis) * ctx.block
        return g.narrow(ctx.dim, lo, ctx.block), None, None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = mesh.size(axis)
        per = t.shape[dim] // n
        return t.narrow(dim, mesh.index(axis) * per, per).clone()

    @staticmethod
    def backward(ctx, g):
        return _cat(ctx.mesh.all_gather(g, ctx.axis), ctx.dim), None, None, None


def _rows_forward(x, w, b, mesh, axis, wdim, transpose):
    w_all = w if wdim is None else _cat(mesh.all_gather(w, axis), wdim)
    y = torch.matmul(x, w_all.t() if transpose else w_all)
    if b is not None:
        y = y + _cat(mesh.all_gather(b, axis), 0)
    return y, w_all


class _RowsLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, mesh, axis, wdim, transpose):
        y, w_all = _rows_forward(x, w, b, mesh, axis, wdim, transpose)
        ctx.save_for_backward(x, w_all)
        ctx.mesh, ctx.axis, ctx.wdim = mesh, axis, wdim
        ctx.transpose = transpose
        ctx.block = None if wdim is None else w.shape[wdim]
        ctx.bias = b is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_all = ctx.saved_tensors
        mesh, axis, wdim, block = ctx.mesh, ctx.axis, ctx.wdim, ctx.block
        w = w_all.t() if ctx.transpose else w_all  # (in, out)
        # folded to 2-D as one device's matmul backward folds it (a
        # strided cotangent would otherwise go through a batched product)
        dx = g.reshape(-1, g.shape[-1]).mm(w.t()).view(*g.shape[:-1], -1)
        # every rank's rows in sequence order: (B, S/m, ·) blocks on dim 1,
        # folded as one device's matmul folds them
        xs = _cat(mesh.all_gather(x, axis), 1)
        gs = _cat(mesh.all_gather(g.contiguous(), axis), 1)
        x2, g2 = xs.reshape(-1, xs.shape[-1]), gs.reshape(-1, gs.shape[-1])
        dw = x2.t().mm(g2)
        dw = dw.t() if ctx.transpose else dw
        db = None
        if wdim is not None:  # the rank's block of a gathered weight
            lo = mesh.index(axis) * block
            dw = dw.narrow(wdim, lo, block)
            if ctx.bias:
                db = gs.sum_to_size(gs.shape[-1]).narrow(0, lo, block)
        return (dx, dw, db, None, None, None, None)


def rows_linear(x, w, b, mesh, axis, *, wdim: int | None,
                transpose: bool = False):
    """``x · W (+ b)`` for x the rank's block of rows (B, S/m, ·) and W
    gathered whole over ``axis`` from the rank's shard ``w`` along
    ``wdim`` (0: its rows of the input dim, 1: its columns of the output
    dim, with ``b`` the bias's block; None: ``w`` is whole on every rank
    and nothing is gathered); with ``transpose`` the gathered weight is
    stored (out, in) and used transposed (the tied embedding as the
    head). Backward: ``dx`` from the whole weight; W's and b's gradients
    over every rank's rows, the rank's block kept (all of a whole W)."""
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in (x, w, b))):
        return _rows_forward(x, w, b, mesh, axis, wdim, transpose)[0]
    return _RowsLinear.apply(x, w, b, mesh, axis, wdim, transpose)


class _ScaleRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, scale, mesh, axis):
        gain = 1.0 + scale.float()
        ctx.save_for_backward(xn, gain)
        ctx.mesh, ctx.axis, ctx.dtype = mesh, axis, scale.dtype
        return xn * gain

    @staticmethod
    def backward(ctx, g):
        xn, gain = ctx.saved_tensors
        rows = _cat(ctx.mesh.all_gather((g * xn).contiguous(), ctx.axis), 1)
        dscale = rows.sum_to_size(gain.shape).to(ctx.dtype)
        return g * gain, dscale, None, None


def scale_rows(xn, scale, mesh, axis):
    """``xn · (1 + scale)`` (fp32) for ``xn`` the rank's block of rows
    (B, S/m, …, D) of a normalised activation and ``scale`` a whole leaf:
    the scale's gradient sums every rank's rows (gathered in sequence
    order) as one device sums them, the same on every rank."""
    if not (torch.is_grad_enabled() and scale.requires_grad):
        return xn * (1.0 + scale.float())
    return _ScaleRows.apply(xn, scale, mesh, axis)


class _RowsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, core):
        k_all = _cat(mesh.all_gather(k, axis), 1)
        v_all = _cat(mesh.all_gather(v, axis), 1)
        base = mesh.index(axis) * q.shape[1]
        ctx.save_for_backward(q, k_all, v_all)
        ctx.mesh, ctx.axis, ctx.core, ctx.base = mesh, axis, core, base
        return core(q, k_all, v_all, base)

    @staticmethod
    def backward(ctx, g):
        q, k_all, v_all = ctx.saved_tensors
        mesh, axis, base, n = ctx.mesh, ctx.axis, ctx.base, q.shape[1]
        q_all = _cat(mesh.all_gather(q, axis), 1)
        g_all = _cat(mesh.all_gather(g.contiguous(), axis), 1)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (q_all, k_all, v_all)]
            out = ctx.core(*leaves, 0)
            grads = torch.autograd.grad(out, leaves, g_all)
        return (*(d.narrow(1, base, n) for d in grads), None, None, None)


def rows_attention(q, k, v, mesh, axis, core):
    """Sequence-parallel attention: q, k, v (B, S/m, ·, hd) the rank's
    block of rows; K and V are gathered over ``axis`` in sequence order
    and ``core(q, k_all, v_all, base)`` attends the rank's queries (at
    global positions base…) against them. Backward: the rows' queries and
    output cotangents are gathered and the whole attention differentiated
    on each rank (the whole score block, transiently), so that each K/V
    gradient sums its queries' terms in one device's order; the rank
    keeps its block of dq, dk and dv."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        k_all = _cat(mesh.all_gather(k, axis), 1)
        v_all = _cat(mesh.all_gather(v, axis), 1)
        return core(q, k_all, v_all, mesh.index(axis) * q.shape[1])
    return _RowsAttention.apply(q, k, v, mesh, axis, core)


def _cat(parts, dim):
    """(n, …) gathered blocks → one tensor, the blocks side by side along
    ``dim`` in axis order."""
    return torch.cat(list(parts.unbind(0)), dim=dim)


def gather_cat(t, mesh, axis, dim: int):
    """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in axis
    order; the backward keeps the rank's block of the cotangent (the
    ranks compute alike on the result)."""
    dim = dim % t.dim()
    if not (torch.is_grad_enabled() and t.requires_grad):
        return _cat(mesh.all_gather(t, axis), dim)
    return _GatherCat.apply(t, mesh, axis, dim)


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.block = t.shape[dim]
        return _cat(mesh.all_gather(t, axis), dim)

    @staticmethod
    def backward(ctx, g):
        mine = ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim,
                                       dtype=torch.float32)
        return mine.to(g.dtype), None, None, None


def gather_fsdp(t, mesh, axis, dim: int):
    """A layer's block ``t`` of a leaf stored over ``axis`` (FSDP's
    ``data``), gathered whole along ``dim`` in axis order. Backward: the
    reduce-scatter, every rank's gradient of the whole summed in fp32 in
    rank order and the rank's block kept, in ``t``'s dtype. The SSD block
    gathers its sequence-parallel input rows with it too: each rank's
    heads give a part of the whole input's cotangent."""
    dim = dim % t.dim()
    if not (torch.is_grad_enabled() and t.requires_grad):
        return _cat(mesh.all_gather(t, axis), dim)
    return _GatherFSDP.apply(t, mesh, axis, dim)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim, dtype):
        ctx.mesh, ctx.axis, ctx.dim, ctx.dtype = mesh, axis, dim, t.dtype
        return mesh.reduce_scatter(t, axis, dim, dtype=torch.float32).to(
            dtype)

    @staticmethod
    def backward(ctx, g):
        whole = _cat(ctx.mesh.all_gather(g.contiguous(), ctx.axis), ctx.dim)
        return whole.to(ctx.dtype), None, None, None, None


def scatter_sum(t, mesh, axis, dim: int, dtype):
    """The rank's block along ``dim`` of every rank's ``t`` summed over
    ``axis`` (fp32, in rank order: :meth:`~repro_torch.launch.mesh.Mesh.
    reduce_scatter`), cast once to ``dtype``. Backward: the cotangent's
    blocks gathered whole, so that each rank's ``t`` gets all of it."""
    dim = dim % t.dim()
    if not (torch.is_grad_enabled() and t.requires_grad):
        return mesh.reduce_scatter(t, axis, dim, dtype=torch.float32).to(
            dtype)
    return _ScatterSum.apply(t, mesh, axis, dim, dtype)


class _SumGradsOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_reduce(g, ctx.axis, dtype=torch.float32).to(
            g.dtype), None, None)


def sum_grads_over(t, mesh, axis):
    """``t`` (the same on every rank of ``axis``), whose backward sums the
    ranks' cotangents over the axis in fp32 in rank order: the entry of a
    region where each rank computes its own part."""
    if not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _SumGradsOver.apply(t, mesh, axis)


def take_block(t, mesh, axis, dim: int):
    """The rank's block of ``t`` along ``dim`` (one of ``mesh.size(axis)``
    in axis order), of a value every rank of the axis holds alike; the
    backward gathers the cotangent's blocks over the axis."""
    dim = dim % t.dim()
    if not (torch.is_grad_enabled() and t.requires_grad):
        per = t.shape[dim] // mesh.size(axis)
        return t.narrow(dim, mesh.index(axis) * per, per)
    return _TakeBlock.apply(t, mesh, axis, dim)


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

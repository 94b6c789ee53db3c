"""Staged MoE dispatch plane: route → build_dispatch → expert_compute → combine.

The port of ``repro/models/dispatch.py``. The stages pass small dataclasses
of tensors, as in the JAX package:

* :func:`route` → :class:`RouterOutput` — router logits (model dtype, cast
  to fp32) → top-k gates/ids plus the statistics GEM's control plane reads
  (``expert_counts`` is the Step-1 trace). The router runs through
  :func:`repro_torch.kernels.ops.topk_router`: the CUDA kernel on the card,
  its plain version on the CPU.
* :func:`build_dispatch` → :class:`DispatchPlan` — virtual-expert ids →
  physical slots through the (E_v,) placement table, stable-sort ranking
  within each slot, the capacity drop, and the (Gd, S, C) gather indices
  and gates; with an (E_v, P) replica table, the replica split first and
  the capacity-overflow shed pass after the drop.
* :func:`expert_compute` — gather tokens into (Gd, S, C, D) buffers and
  run the grouped FFN through :func:`repro_torch.kernels.ops.moe_ffn`.
  The gather's backward adds each token's up to ``k · expert_tp`` slot
  cotangents in fp32 and rounds once to the input's dtype
  (:class:`_GatherRows`): ``scatter_add_`` in bf16 on CUDA rounds at
  every atomic add, in an order that changes from run to run.
* :func:`combine` — a gather, not a scatter-add: each token sums its
  ``k · expert_tp`` assignment rows, laid out in (k, tp) order, with one
  fixed-shape reduction; dropped rows read a zero sink row. ``index_add_``
  on CUDA adds with float atomics in an order that changes from run to
  run; the gather is deterministic, and since each token sums the same
  values in the same layout whatever slot they sit in, the output is
  bit-identical under any placement.

:func:`dense_mix` is the capacity-free oracle (``moe_backend=
"dense_ref"``): it replaces the last three stages, and its kernel is K2,
through :func:`route`. Dropped assignments never use
out-of-range indices (torch raises where JAX drops): they scatter into a
sink slot that is sliced off, which changes no count.

**Under a policy with a mesh** (:mod:`repro_torch.sharding`) each rank
holds the dispatch groups of its data shard: ``groups`` (keyword) is the
group count Gd over all data ranks, and ``xg`` holds this rank's ``Gd/d`` of them
when the policy's ``moe_shard_spec`` shards the groups, or all of them
when it does not (the batch collapsed to one group). :func:`route` runs
K2 through :func:`~repro_torch.kernels.sharded.topk_router_sharded`, so its
statistics are global; :func:`build_dispatch` sums its drop, overflow and
shed counts over the data ranks, so they are the JAX plan's totals;
:func:`expert_compute` runs K1 on the rank's slice of the expert dim
through :func:`~repro_torch.kernels.sharded.moe_ffn_sharded`, which
gathers the outputs over the model axis, so :func:`combine` is unchanged.
Capacity is per group, so drops and sheds depend on ``d`` exactly as in
JAX.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.sharded import (
    moe_ffn_sharded,
    sum_grads_over,
    sum_over,
    topk_router_sharded,
)
from ..sharding.policy import model_axis

__all__ = [
    "RouterOutput",
    "DispatchPlan",
    "MoEAux",
    "route",
    "slot_capacity",
    "build_dispatch",
    "expert_compute",
    "combine",
    "dense_mix",
]


def slot_capacity(num_tokens: int, config: ModelConfig, *,
                  capacity_factor: float, num_slots: int,
                  replicated: bool) -> int:
    """Per-slot row capacity C = ⌈Ng·k/E · cf⌉ (E real experts, not E_v);
    with a replica table and S > E_v slots, cf shrinks by E_v/S."""
    E = config.num_experts
    Ev = E * config.expert_tp
    cf = capacity_factor
    if replicated and num_slots > Ev:
        cf = capacity_factor * Ev / num_slots
    return max(int(np.ceil(num_tokens * config.experts_per_token / E * cf)), 1)


@dataclasses.dataclass(frozen=True)
class RouterOutput:
    """gates/ids (Gd, Ng, k); global ``expert_counts`` (E,) i32,
    ``density``/``probs_mean`` (E,) f32 and the Switch ``aux_loss``."""

    gates: torch.Tensor
    ids: torch.Tensor
    expert_counts: torch.Tensor
    density: torch.Tensor
    probs_mean: torch.Tensor
    aux_loss: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Where every kept assignment lands.

    ``dispatch_idx`` (Gd, S, C) i32: token index (within its group) held by
    each capacity row, ``Ng`` for the zero pad token. ``dispatch_gate``
    (Gd, S, C) f32: the gate of each row (0 for pad). ``assign_row``
    (Gd, Ag) i64, port only: the flat ``slot · C + pos`` row of each of the
    ``Ag = Ng · k · expert_tp`` assignments, ``S · C`` (the sink) when
    dropped — the index :func:`combine` gathers with. ``dropped_tokens``
    counts dropped assignments and ``dropped`` is that over ``Gd · Ag``.
    ``overflow_tokens`` counts the assignments past their slot's capacity,
    ``shed_tokens`` those of them the shed pass re-seated
    (``dropped_tokens = overflow_tokens − shed_tokens``), and
    ``shed_delta`` (S,) the rows each slot received minus those it sent.
    """

    dispatch_idx: torch.Tensor
    dispatch_gate: torch.Tensor
    assign_row: torch.Tensor
    dropped: torch.Tensor
    dropped_tokens: torch.Tensor
    overflow_tokens: torch.Tensor
    shed_tokens: torch.Tensor
    shed_delta: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.dispatch_idx.shape[-1]

    @property
    def num_slots(self) -> int:
        return self.dispatch_idx.shape[1]

    @property
    def flat_idx(self) -> torch.Tensor:
        """(Gd, S·C) gather index view."""
        return self.dispatch_idx.reshape(self.dispatch_idx.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class MoEAux:
    """Per-call aux the layer stack stacks and the engine's Step-1 reads;
    ``aux["expert_counts"]`` indexing works as in the JAX package."""

    expert_counts: torch.Tensor
    aux_loss: torch.Tensor
    dropped: torch.Tensor
    dropped_tokens: torch.Tensor
    overflow_tokens: torch.Tensor
    shed_tokens: torch.Tensor
    shed_delta: torch.Tensor

    def __getitem__(self, key: str):
        return getattr(self, key)


_WARNED: set = set()


def _warn_once(key, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _mesh(policy):
    return None if policy is None else policy.mesh


def route(xg, router_w, config: ModelConfig, policy=None, *,
          groups: int | None = None) -> RouterOutput:
    """xg (G, Ng, D) grouped tokens → :class:`RouterOutput`: gates and ids
    of these groups, statistics over all ``groups`` (default G)."""
    G, Ng, _ = xg.shape
    Gd = G if groups is None else groups
    E = config.num_experts
    k = config.experts_per_token
    N = Gd * Ng
    logits = torch.matmul(xg, router_w).float()
    data_spec = (policy.moe_shard_spec(Gd, config.num_virtual_experts)[0]
                 if policy is not None else None)
    gates, ids, probs_sum, counts = topk_router_sharded(
        logits, k, mesh=_mesh(policy), data_spec=data_spec)
    probs_mean = probs_sum / N
    density = counts.float() / N
    aux_loss = E * torch.sum(density * probs_mean)
    return RouterOutput(
        gates=gates, ids=ids, expert_counts=counts, density=density,
        probs_mean=probs_mean, aux_loss=aux_loss,
    )


def _rank_in_group(slots, num_slots: int):
    """Position of each assignment within its slot group, in assignment
    order (stable sorts), plus the group sizes. slots: (A,) int."""
    A = slots.shape[0]
    slots = slots.long()
    order = torch.argsort(slots, stable=True)
    sorted_slots = slots[order]
    # bincount on CUDA reads the maximum back to the host; a fixed-size
    # scatter of ones gives the same counts without a sync
    group_sizes = torch.zeros(num_slots, dtype=torch.long, device=slots.device)
    group_sizes.scatter_add_(0, slots, torch.ones_like(slots))
    starts = torch.cumsum(group_sizes, dim=0) - group_sizes
    pos_sorted = torch.arange(A, device=slots.device) - starts[sorted_slots]
    inv = torch.argsort(order, stable=True)
    return pos_sorted[inv], group_sizes


def build_dispatch(router: RouterOutput, expert_to_slot, config: ModelConfig,
                   policy=None, *, capacity_factor: float,
                   num_slots: int | None = None, shed_enable=None,
                   groups: int | None = None) -> DispatchPlan:
    """Routing decision → gather plan.

    Virtual assignments ``vid = id · tp + j`` map through the placement
    table to physical slots, rank within their (group, slot) in assignment
    order, and drop beyond the capacity C = ⌈Ng·k/E · cf⌉.

    ``expert_to_slot`` is the (E_v,) single-slot map or an (E_v, P)
    replica-split table: each assignment then ranks within its (group,
    virtual expert) and copy ``table[v, rank % P]`` takes it, and C shrinks
    by E_v/S (:func:`slot_capacity`). ``num_slots`` is the pool's slot
    count S (default E_v).

    **Shed pass** (a 2-D table and ``shed_enable`` given, a 0/1 scalar
    tensor): assignments past their slot's capacity re-seat on the free
    rows of the other live copies of the same virtual expert instead of
    dropping. Overflow assignments rank within their (group, virtual
    expert) by the same stable sort; the copies are ordered least-loaded
    first (slot id breaks ties, duplicate table columns last with no free
    rows), and rank ``r`` takes the ``r``-th free row of that order. Each
    re-seated assignment's ``assign_row`` follows it to its new row.
    ``shed_enable=0`` gives the plan of the pass being absent bit for bit;
    ``None`` leaves the pass out. Nothing here reads a value back to the
    host, so the pass runs inside the captured decode step.

    With data-sharded groups (``groups`` over all ranks, the router
    holding this rank's) the plan's indices and gates are this rank's groups', and
    its counts (``dropped_tokens``, ``overflow_tokens``, ``shed_tokens``,
    ``shed_delta``, ``dropped``) are summed over the data ranks in rank
    order: the totals of JAX's plan over all groups.
    """
    dev = router.ids.device
    table = torch.as_tensor(expert_to_slot, device=dev).long()
    replicated = table.dim() == 2
    Gd, Ng, k = router.ids.shape  # this rank's groups
    Gt = Gd if groups is None else groups  # every data rank's
    E = config.num_experts
    tp = config.expert_tp
    Ev = E * tp
    S = num_slots if num_slots is not None else Ev
    ids = router.ids.long()
    vids = ids[..., None] * tp + torch.arange(tp, device=dev)  # (Gd,Ng,k,tp)
    Ag = Ng * k * tp
    vids_flat = vids.reshape(Gd, Ag)
    group_of = torch.arange(Gd, device=dev)[:, None].expand(Gd, Ag).reshape(-1)
    if replicated:
        # replica split: rank within (group, virtual expert), then rank % P
        # picks the copy through the table's share-interleaved columns
        P = table.shape[1]
        vpos, _ = _rank_in_group(group_of * Ev + vids_flat.reshape(-1),
                                 Gd * Ev)
        slots = table[vids_flat, vpos.reshape(Gd, Ag) % P]  # (Gd, Ag)
    else:
        slots = table[vids_flat]  # (Gd, Ag)
    keyed = group_of * S + slots.reshape(-1)
    pos, slot_sizes = _rank_in_group(keyed, Gd * S)
    pos = pos.reshape(Gd, Ag)
    tok_idx = torch.arange(Ng, device=dev)[:, None].expand(Ng, k * tp)
    tok_idx = tok_idx.reshape(1, Ag).expand(Gd, Ag).to(torch.int32)
    a_gates = router.gates.reshape(Gd, Ng * k, 1).expand(Gd, Ng * k, tp)
    a_gates = a_gates.reshape(Gd, Ag).float()

    C = slot_capacity(Ng, config, capacity_factor=capacity_factor,
                      num_slots=S, replicated=replicated)
    keep = pos < C
    # dropped assignments land in a sink slot S, sliced off below
    slot_safe = torch.where(keep, slots, torch.full_like(slots, S))
    pos_safe = torch.where(keep, pos, torch.zeros_like(pos))
    gidx = torch.arange(Gd, device=dev)[:, None].expand(Gd, Ag)
    dispatch_idx = torch.full((Gd, S + 1, C), Ng, dtype=torch.int32, device=dev)
    dispatch_idx[gidx, slot_safe, pos_safe] = tok_idx
    dispatch_gate = torch.zeros((Gd, S + 1, C), dtype=torch.float32, device=dev)
    dispatch_gate[gidx, slot_safe, pos_safe] = a_gates
    assign_row = torch.where(keep, slots * C + pos, torch.full_like(pos, S * C))

    kept = keep.sum().to(torch.int32)
    total = torch.full((), Gd * Ag, dtype=torch.int32, device=dev)
    overflow_tokens = total - kept
    shed_tokens = torch.zeros((), dtype=torch.int32, device=dev)
    shed_delta = torch.zeros((S,), dtype=torch.int32, device=dev)
    if replicated and shed_enable is not None:
        shed_on = torch.as_tensor(shed_enable, device=dev).to(torch.int32) > 0
        cnt = torch.clamp(slot_sizes.reshape(Gd, S), max=C)  # kept rows
        # a table row may repeat a slot (single-copy experts, rounding):
        # only its first column is a live copy. Column i is a duplicate
        # when an earlier column j < i names the same slot
        cols = torch.arange(P, device=dev)
        earlier = cols[None, :] < cols[:, None]  # (P, P): j < i
        dupe = ((table[:, :, None] == table[:, None, :]) & earlier).any(-1)
        live = ~dupe[None]  # (1, E_v, P)
        cload = cnt[:, table]  # (Gd, E_v, P) kept rows on each copy
        free = torch.where(live, C - cload, torch.zeros_like(cload))
        # waterfall order: least-loaded live copy first, slot id breaks
        # ties, dead duplicates last
        okey = torch.where(live, cload * (S + 1) + table[None],
                           torch.full_like(cload, (C + 1) * (S + 1)))
        order = torch.argsort(okey, dim=-1, stable=True)
        sorted_slot = torch.gather(table[None].expand_as(cload), -1, order)
        cumfree = torch.cumsum(torch.gather(free, -1, order), dim=-1)
        # rank the overflow within (group, virtual expert) by the same
        # stable sort; kept assignments park in a sentinel segment
        rkey = torch.where(keep.reshape(-1),
                           torch.full_like(group_of, Gd * Ev),
                           group_of * Ev + vids_flat.reshape(-1))
        orank, _ = _rank_in_group(rkey, Gd * Ev + 1)
        orank = orank.reshape(Gd, Ag)
        cf_a = cumfree[gidx, vids_flat]  # (Gd, Ag, P)
        copy_idx = (cf_a <= orank[..., None]).sum(-1)
        shed_ok = orank < cf_a[..., P - 1]
        t_slot = torch.gather(sorted_slot[gidx, vids_flat], -1,
                              torch.clamp(copy_idx, max=P - 1)[..., None])[..., 0]
        prev_cum = torch.gather(cf_a, -1,
                                torch.clamp(copy_idx - 1, min=0)[..., None])[..., 0]
        prev_cum = torch.where(copy_idx > 0, prev_cum, torch.zeros_like(prev_cum))
        # rows cnt..C-1 of the target copy are free, and the offset within
        # them is below that copy's free count: kept rows are never hit
        t_pos = cnt[gidx, t_slot] + (orank - prev_cum)
        shed_mask = ~keep & shed_ok & shed_on
        s_slot = torch.where(shed_mask, t_slot, torch.full_like(t_slot, S))
        s_pos = torch.where(shed_mask, t_pos, torch.zeros_like(t_pos))
        dispatch_idx[gidx, s_slot, s_pos] = tok_idx
        dispatch_gate[gidx, s_slot, s_pos] = a_gates
        assign_row = torch.where(shed_mask, t_slot * C + t_pos, assign_row)
        shed_ones = shed_mask.reshape(-1).long()
        recv = torch.zeros(S + 1, dtype=torch.long, device=dev)
        recv.scatter_add_(0, s_slot.reshape(-1), shed_ones)
        sent = torch.zeros(S + 1, dtype=torch.long, device=dev)
        sent.scatter_add_(
            0, torch.where(shed_mask, slots, torch.full_like(slots, S)).reshape(-1),
            shed_ones)
        shed_delta = (recv[:S] - sent[:S]).to(torch.int32)
        shed_tokens = shed_ones.sum().to(torch.int32)
        kept = kept + shed_tokens

    data_spec = (policy.moe_shard_spec(Gt, S)[0]
                 if policy is not None else None)
    if data_spec is not None and policy.mesh.size(data_spec) > 1:
        # the data ranks' counts, summed in rank order: one gather of
        # (kept, overflow, shed, shed_delta)
        mine = torch.cat([torch.stack([kept, overflow_tokens, shed_tokens]),
                          shed_delta])
        parts = policy.mesh.all_gather(mine, data_spec)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        kept, overflow_tokens, shed_tokens = acc[0], acc[1], acc[2]
        shed_delta = acc[3:]
    total = torch.full((), Gt * Ag, dtype=torch.int32, device=dev)
    dropped_tokens = total - kept
    return DispatchPlan(
        dispatch_idx=dispatch_idx[:, :S].contiguous(),
        dispatch_gate=dispatch_gate[:, :S].contiguous(),
        assign_row=assign_row,
        dropped=1.0 - kept.float() / (Gt * Ag),
        dropped_tokens=dropped_tokens,
        overflow_tokens=overflow_tokens,
        shed_tokens=shed_tokens,
        shed_delta=shed_delta,
    )


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.shape = x.shape
        return torch.gather(x, 1, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        out = g.new_zeros(ctx.shape, dtype=torch.float32)
        out.scatter_add_(1, index, g.float())
        return out.to(g.dtype), None


def _gather_rows(x, idx):
    """``x[g, idx[g, m]]`` for x (G, N, D), idx (G, M) → (G, M, D); under
    a gradient each row's cotangents are summed in fp32."""
    index = idx[:, :, None].expand(-1, -1, x.shape[-1])
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.gather(x, 1, index)
    return _GatherRows.apply(x, index)


def expert_compute(xg, plan: DispatchPlan, p, config: ModelConfig,
                   policy=None, *, groups: int | None = None):
    """Gather per-plan into (G, S, C, D) buffers, run the FFN, apply the
    gates. Returns the gate-weighted (G, S, C, D) outputs.

    Under a mesh the FFN is K1 on this rank's slice of the expert dim
    (:func:`~repro_torch.kernels.sharded.moe_ffn_sharded`, outputs gathered
    over the model axis); a slot count the model axis does not divide pads
    the expert dim with dead slots so every rank still computes only its
    share (warned once)."""
    del config
    G, Ng, D = xg.shape
    S, C = plan.num_slots, plan.capacity
    x_pad = torch.cat([xg, xg.new_zeros((G, 1, D))], dim=1)
    x_e = _gather_rows(x_pad, plan.flat_idx.long()).reshape(G, S, C, D)
    mesh = _mesh(policy)
    data_spec = expert_spec = pad_to = None
    if mesh is not None:
        data_spec, expert_spec = policy.moe_shard_spec(
            G if groups is None else groups, S)
        if expert_spec is None and policy.model_axis_size > 1:
            pad_to, expert_spec = policy.moe_expert_pad(S)
            _warn_once(
                ("moe_expert_padded", S, policy.model_axis_size),
                f"moe_layer: E_v={S} does not divide the model-axis size "
                f"{policy.model_axis_size}; padding the expert dim to "
                f"{pad_to} with dead slots so the per-rank kernels stay "
                "sharded (pad rows compute zeros and are sliced off)",
            )
    y_e = moe_ffn_sharded(x_e, p["w_gate"], p["w_up"], p["w_down"], mesh=mesh,
                          data_spec=data_spec, expert_spec=expert_spec,
                          pad_expert_to=pad_to)
    return y_e * plan.dispatch_gate[..., None].to(y_e.dtype)


def combine(y_e, plan: DispatchPlan, out_shape: tuple):
    """(Gd, S, C, D) expert outputs → (B, T, D) token-ordered output.

    Each token gathers its k·tp assignment rows (the sink row, zero, for
    dropped ones) into (k, tp) order and sums them.
    """
    B, T, D = out_shape
    Gd = y_e.shape[0]
    Ng = (B * T) // Gd
    flat = y_e.reshape(Gd, -1, D)
    flat = torch.cat([flat, flat.new_zeros((Gd, 1, D))], dim=1)  # + sink
    rows = plan.assign_row  # (Gd, Ng·k·tp)
    picked = torch.gather(flat, 1, rows[:, :, None].expand(-1, -1, D))
    y = picked.reshape(Gd, Ng, -1, D).sum(dim=2)
    return y.reshape(B, T, D)


def _slot_ffn(xf, wg, wu, wd):
    """Every token through each of the given slots' FFN: xf (N, D) and
    (S', D, F) / (S', F, D) weights → (S', N, D), slot-major. One batched
    product a weight, each slot's rows computed alone (so its bits do not
    depend on where the slot sits); the weights are read in place, never
    gathered into another order."""
    xs = xf.unsqueeze(0).expand(wg.shape[0], -1, -1)
    h = torch.nn.functional.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu)
    return torch.bmm(h, wd)


def dense_mix(xg, p, router: RouterOutput, expert_to_slot,
              config: ModelConfig, policy=None, *,
              num_slots: int | None = None):
    """Capacity-free oracle in place of build_dispatch → expert_compute →
    combine: every expert on every token, mixed by the routing decision.
    Returns (Gd, Ng, D).

    The FFN runs over the pool in slot order (:func:`_slot_ffn`), and each
    token reads the rows of its chosen virtual experts ``id · tp + j``
    through the table, so no weight is copied into virtual order. An
    (E_v, P) replica table reads each expert's first copy (copies are
    equal rows). Each token sums its ``tp`` slices, then its ``k`` gated
    experts, in fp32 in that fixed order, and rounds once to the input's
    dtype: the output's bits do not depend on the placement.

    Under a model axis wider than one rank (``policy`` with a mesh;
    ``num_slots``, the pool's global S, required) the rank runs only its
    share of the slots, ``[d·⌈S/m⌉, …)`` of a pool the axis divides or
    not (a pool it does not divide is stored whole and the rank takes its
    share of the rows), its partial mix counts only the chosen rows it
    holds, and the partials are summed over the axis in fp32 in rank
    order (:func:`~repro_torch.kernels.sharded.sum_over`) and rounded
    once. The tokens and gates enter through
    :func:`~repro_torch.kernels.sharded.sum_grads_over`, so that their
    gradients are complete on every rank; an expert stack's gradient holds
    the rank's rows only, as K1's sharded backward leaves it."""
    Gd, Ng, D = xg.shape
    k, tp = config.experts_per_token, config.expert_tp
    N = Gd * Ng
    dev = xg.device
    table = torch.as_tensor(expert_to_slot, device=dev).long()
    if table.dim() == 2:
        table = table[:, 0]
    xf = xg.reshape(N, D)
    gates = router.gates.reshape(N, k).float()
    vids = (router.ids.reshape(N, k, 1).long() * tp
            + torch.arange(tp, device=dev))
    slots = table[vids]  # (N, k, tp) global slots
    ws = tuple(p[n] for n in ("w_gate", "w_up", "w_down"))
    axis = model_axis(policy)
    if axis is not None:
        mesh = policy.mesh
        S = num_slots
        per = -(-S // mesh.size(axis))
        lo = mesh.index(axis) * per
        live = max(min(per, S - lo), 0)
        if ws[0].shape[0] == S:  # a whole-stored pool: this rank's share
            ws = tuple(w[lo:lo + live] for w in ws)
        else:  # the rank's stored shard, less any dead pad slots
            ws = tuple(w[:live] for w in ws)
        xf = sum_grads_over(xf, mesh, axis)
        gates = sum_grads_over(gates, mesh, axis)
        slots = slots - lo
        mine = (slots >= 0) & (slots < live)
    else:
        live = int(ws[0].shape[0])
        mine = None
    y_all = _slot_ffn(xf, *ws).reshape(live * N, D)
    y_all = torch.cat([y_all, y_all.new_zeros((1, D))])  # + a zero sink row
    rows = slots * N + torch.arange(N, device=dev)[:, None, None]
    if mine is not None:
        rows = torch.where(mine, rows, torch.full_like(rows, live * N))
    picked = y_all.index_select(0, rows.reshape(-1)).reshape(N, k, tp, D)
    y = (picked.float().sum(dim=2) * gates[..., None]).sum(dim=1)
    if axis is not None:
        y = sum_over(y, policy.mesh, axis)
    return y.to(xg.dtype).reshape(Gd, Ng, D)

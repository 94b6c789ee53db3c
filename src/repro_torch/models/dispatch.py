"""Staged MoE dispatch plane: route → build_dispatch → expert_compute → combine.

The port of ``repro/models/dispatch.py`` for one device. The stages pass
small dataclasses of tensors, as in the JAX package:

* :func:`route` → :class:`RouterOutput` — router logits (model dtype, cast
  to fp32) → top-k gates/ids plus the statistics GEM's control plane reads
  (``expert_counts`` is the Step-1 trace). The router runs through
  :func:`repro_torch.kernels.ops.topk_router`: the CUDA kernel on the card,
  its plain version on the CPU.
* :func:`build_dispatch` → :class:`DispatchPlan` — virtual-expert ids →
  physical slots through the (E_v,) placement table, stable-sort ranking
  within each slot, the capacity drop, and the (Gd, S, C) gather indices
  and gates. Only the 1-D table path is ported; the replica split and the
  shed pass raise ``NotImplementedError``.
* :func:`expert_compute` — gather tokens into (Gd, S, C, D) buffers and
  run the grouped FFN through :func:`repro_torch.kernels.ops.moe_ffn`.
* :func:`combine` — a gather, not a scatter-add: each token sums its
  ``k · expert_tp`` assignment rows, laid out in (k, tp) order, with one
  fixed-shape reduction; dropped rows read a zero sink row. ``index_add_``
  on CUDA adds with float atomics in an order that changes from run to
  run; the gather is deterministic, and since each token sums the same
  values in the same layout whatever slot they sit in, the output is
  bit-identical under any placement.

``dense_mix`` is the capacity-free oracle. Dropped assignments never use
out-of-range indices (torch raises where JAX drops): they scatter into a
sink slot that is sliced off, which changes no count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.ops import moe_ffn, topk_router

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
    counts dropped assignments and ``dropped`` is that over ``Gd · Ag``;
    ``overflow_tokens`` equals ``dropped_tokens`` with no shed pass, and
    ``shed_tokens``/``shed_delta`` are zero.
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


def route(xg, router_w, config: ModelConfig) -> RouterOutput:
    """xg (Gd, Ng, D) grouped tokens → :class:`RouterOutput`."""
    Gd, Ng, _ = xg.shape
    E = config.num_experts
    k = config.experts_per_token
    N = Gd * Ng
    logits = torch.matmul(xg, router_w).float()
    gates, ids, probs_sum, counts = topk_router(
        logits.reshape(N, E), k, with_stats=True
    )
    probs_mean = probs_sum / N
    density = counts.float() / N
    aux_loss = E * torch.sum(density * probs_mean)
    return RouterOutput(
        gates=gates.reshape(Gd, Ng, k), ids=ids.reshape(Gd, Ng, k),
        expert_counts=counts, density=density, probs_mean=probs_mean,
        aux_loss=aux_loss,
    )


def _rank_in_group(slots, num_slots: int):
    """Position of each assignment within its slot group, in assignment
    order (stable sorts), plus the group sizes. slots: (A,) int."""
    A = slots.shape[0]
    slots = slots.long()
    order = torch.argsort(slots, stable=True)
    sorted_slots = slots[order]
    group_sizes = torch.bincount(slots, minlength=num_slots)
    starts = torch.cumsum(group_sizes, dim=0) - group_sizes
    pos_sorted = torch.arange(A, device=slots.device) - starts[sorted_slots]
    inv = torch.argsort(order, stable=True)
    return pos_sorted[inv], group_sizes


def build_dispatch(router: RouterOutput, expert_to_slot, config: ModelConfig,
                   *, capacity_factor: float,
                   num_slots: int | None = None) -> DispatchPlan:
    """Routing decision → gather plan (1-D placement table only).

    Virtual assignments ``vid = id · tp + j`` map through the (E_v,) table
    to physical slots, rank within their (group, slot) in assignment order,
    and drop beyond the capacity C = ⌈Ng·k/E · cf⌉. A 2-D replica table
    (and with it the shed pass, which needs one) raises.
    """
    table = torch.as_tensor(expert_to_slot, device=router.ids.device)
    if table.dim() == 2:
        raise NotImplementedError(
            "replica-split (2-D) placement tables and the shed pass land "
            "with the replication slice"
        )
    Gd, Ng, k = router.ids.shape
    E = config.num_experts
    tp = config.expert_tp
    Ev = E * tp
    S = num_slots if num_slots is not None else Ev
    dev = router.ids.device
    ids = router.ids.long()
    vids = ids[..., None] * tp + torch.arange(tp, device=dev)  # (Gd,Ng,k,tp)
    Ag = Ng * k * tp
    vids_flat = vids.reshape(Gd, Ag)
    slots = table.long()[vids_flat]  # (Gd, Ag)
    group_of = torch.arange(Gd, device=dev).repeat_interleave(Ag)
    keyed = group_of * S + slots.reshape(-1)
    pos, _ = _rank_in_group(keyed, Gd * S)
    pos = pos.reshape(Gd, Ag)
    tok_idx = torch.arange(Ng, device=dev).repeat_interleave(k * tp)
    tok_idx = tok_idx.expand(Gd, Ag)
    a_gates = router.gates.reshape(Gd, Ng * k).repeat_interleave(tp, dim=1)

    C = slot_capacity(Ng, config, capacity_factor=capacity_factor,
                      num_slots=S, replicated=False)
    keep = pos < C
    # dropped assignments land in a sink slot S, sliced off below
    slot_safe = torch.where(keep, slots, torch.full_like(slots, S))
    pos_safe = torch.where(keep, pos, torch.zeros_like(pos))
    gidx = torch.arange(Gd, device=dev)[:, None].expand(Gd, Ag)
    dispatch_idx = torch.full((Gd, S + 1, C), Ng, dtype=torch.int32, device=dev)
    dispatch_idx[gidx, slot_safe, pos_safe] = tok_idx.to(torch.int32)
    dispatch_gate = torch.zeros((Gd, S + 1, C), dtype=torch.float32, device=dev)
    dispatch_gate[gidx, slot_safe, pos_safe] = a_gates.float()
    assign_row = torch.where(keep, slots * C + pos, torch.full_like(pos, S * C))

    kept = keep.sum().to(torch.int32)
    total = torch.tensor(Gd * Ag, dtype=torch.int32, device=dev)
    dropped_tokens = total - kept
    return DispatchPlan(
        dispatch_idx=dispatch_idx[:, :S].contiguous(),
        dispatch_gate=dispatch_gate[:, :S].contiguous(),
        assign_row=assign_row,
        dropped=1.0 - kept.float() / (Gd * Ag),
        dropped_tokens=dropped_tokens,
        overflow_tokens=dropped_tokens.clone(),
        shed_tokens=torch.zeros((), dtype=torch.int32, device=dev),
        shed_delta=torch.zeros((S,), dtype=torch.int32, device=dev),
    )


def expert_compute(xg, plan: DispatchPlan, p, config: ModelConfig):
    """Gather per-plan into (Gd, S, C, D) buffers, run the FFN, apply the
    gates. Returns the gate-weighted (Gd, S, C, D) outputs."""
    del config
    Gd, Ng, D = xg.shape
    S, C = plan.num_slots, plan.capacity
    x_pad = torch.cat([xg, xg.new_zeros((Gd, 1, D))], dim=1)
    idx = plan.flat_idx.long()
    x_e = torch.gather(x_pad, 1, idx[:, :, None].expand(Gd, S * C, D))
    x_e = x_e.reshape(Gd, S, C, D)
    y_e = torch.stack([
        moe_ffn(x_e[g], p["w_gate"], p["w_up"], p["w_down"])
        for g in range(Gd)
    ])
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


def dense_mix(xg, p, router: RouterOutput, expert_to_slot,
              config: ModelConfig):
    """Capacity-free oracle: every expert on every token, mixed by the
    routing decision. Weights live in slot order; gather them back to
    virtual order through the table. Returns (Gd, Ng, D)."""
    Gd, Ng, D = xg.shape
    E, tp = config.num_experts, config.expert_tp
    k = config.experts_per_token
    table = torch.as_tensor(expert_to_slot, device=xg.device).long()
    if table.dim() == 2:
        table = table[:, 0]
    wg, wu, wd = (p[n][table] for n in ("w_gate", "w_up", "w_down"))
    xf = xg.reshape(Gd * Ng, D)
    gates = router.gates.reshape(Gd * Ng, k)
    ids = router.ids.reshape(Gd * Ng, k).long()
    h_gate = torch.einsum("nd,edf->nef", xf, wg)
    h_up = torch.einsum("nd,edf->nef", xf, wu)
    h = torch.nn.functional.silu(h_gate) * h_up
    y_all = torch.einsum("nef,efd->ned", h, wd)  # (N, E_v, D)
    y_real = y_all.reshape(xf.shape[0], E, tp, -1).sum(dim=2)  # (N, E, D)
    sel = torch.nn.functional.one_hot(ids, E).to(y_real.dtype) * gates[
        ..., None
    ].to(y_real.dtype)
    return torch.einsum("nke,ned->nd", sel, y_real).reshape(Gd, Ng, D)

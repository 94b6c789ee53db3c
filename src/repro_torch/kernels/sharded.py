"""Per-rank entry points of the two kernels on a mesh (port of the forward of
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
padded to a tile here. The backward of both under a mesh (the reference's
``custom_vjp``s, which training through a mesh differentiates) is not
ported: a call that needs a gradient under a mesh raises.
"""
from __future__ import annotations

import torch

from .ops import moe_ffn, topk_router

__all__ = ["moe_ffn_sharded", "topk_router_sharded"]


def _no_grad_under_mesh(mesh, *tensors) -> None:
    if mesh is not None and torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the sharded kernels have no backward under a mesh yet "
            "(training through a mesh is a later slice of the port)")


def _ffn_groups(x, wg, wu, wd):
    """K1 once per dispatch group: x (G, S, C, D) → (G, S, C, D)."""
    return torch.stack([moe_ffn(x[g], wg, wu, wd) for g in range(x.shape[0])])


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
    _no_grad_under_mesh(mesh, x_e, w_gate, w_up, w_down)
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
    y = x_e.new_zeros((G, per, C, D))
    if live:
        y[:, :live] = _ffn_groups(x_e[:, lo:lo + live], *ws)
    full = mesh.all_gather(y, expert_spec)  # (m, G, per, C, D)
    return full.transpose(0, 1).reshape(G, Ep, C, D)[:, :Ev]


def _sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def topk_router_sharded(logits, k: int, *, mesh, data_spec):
    """logits (G, Ng, E) → (gates (G, Ng, k), ids (G, Ng, k),
    probs_sum (E,), counts (E,)).

    K2 with its statistics on this rank's groups; under a mesh with
    ``data_spec`` the partial statistics of every data shard are gathered
    and summed in rank order (one all-gather of both, packed as 2·E
    32-bit words), so the returned ``probs_sum`` and ``counts`` are the
    global sums on every rank."""
    _no_grad_under_mesh(mesh, logits)
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

"""Replication-aware placement planning.

Three stages, layered on the existing single-copy GEM machinery:

  1. **Copy selection** (:func:`choose_replica_counts`) — under the slot
     budget (``replica_slots`` per device), give extra copies to the
     *consistent* hot experts first (paper §3.1 / HarMoEny: the replication
     win comes from experts whose load is persistently above uniform),
     greedily to the expert with the highest remaining per-copy load; at
     most one copy per device per expert.
  2. **Expanded GEM search** — split each expert's trace counts uniformly
     over its copies ("pseudo-experts"), then run the *unmodified* Alg. 2–4
     search (:func:`repro.core.search.gem_place`) over the expanded slot
     space: S = E_v + G·replica_slots pseudo-experts, S/G slots per device.
     The search's per-step Eq.-1 scoring prices temporal co-activation of
     the copies exactly as it does for real experts.
  3. **Speed-aware refinement** (:func:`refine_replicated`) — the uniform
     split under-values fast devices, so a final hill climb swaps slots
     across devices under the *true* objective
     (:func:`~repro.replication.score.replicated_score`, speed-proportional
     shares recomputed per candidate), until no swap improves it.

At ``replica_slots=0`` the pipeline degenerates to plain ``gem_place`` and
returns the single-copy placement wrapped in a
:class:`~repro.replication.types.ReplicatedPlacement` — same score, same
layout, so the replication plane is a strict superset of the GEM planner.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.classify import classify_experts
from ..core.gem import GEMPlanner
from ..core.search import gem_place
from ..core.types import ExpertTrace, GEMConfig, VariabilityProfile
from .score import replicated_score
from .types import ReplicatedPlacement, ReplicationConfig

__all__ = [
    "ReplicatedSearchResult",
    "choose_replica_counts",
    "expanded_trace",
    "refine_replicated",
    "plan_replicated",
    "plan_replicated_layers",
]


@dataclasses.dataclass
class ReplicatedSearchResult:
    placement: ReplicatedPlacement
    score: float  # speed-proportional replicated Eq.-1 score
    single_copy_score: float  # plain GEM on the same trace/profile
    copy_counts: np.ndarray  # (E,) copies per expert
    refine_swaps: int


def choose_replica_counts(
    trace: ExpertTrace,
    profile: VariabilityProfile,
    budget: int,
    config: ReplicationConfig = ReplicationConfig(),
) -> np.ndarray:
    """(E,) copies per expert: 1 + greedily allocated budget.

    Each extra copy goes to the expert with the highest remaining
    *per-copy* mean load (``util / copies``), restricted to the trace's
    consistent experts while any remain un-saturated (a copy per device is
    the useful maximum — two copies on one device split nothing).
    """
    util = trace.mean_utilization().astype(np.float64)
    E = trace.num_experts
    G = profile.num_devices
    copies = np.ones(E, dtype=np.int64)
    candidates = np.arange(E)
    if config.consistent_only:
        consistent = classify_experts(trace).consistent
        if len(consistent):
            candidates = consistent
    mask = np.zeros(E, dtype=bool)
    mask[candidates] = True
    for _ in range(budget):
        per_copy = np.where(mask & (copies < G), util / copies, -np.inf)
        if not np.isfinite(per_copy).any():
            # consistent set saturated: widen to every expert, then allow
            # over-G copies as a last resort so the budget always fills
            # (the slot count is a structural constant of the layout)
            mask[:] = True
            per_copy = np.where(copies < G, util / copies, -np.inf)
            if not np.isfinite(per_copy).any():
                per_copy = util / copies
        copies[int(np.argmax(per_copy))] += 1
    return copies


def expanded_trace(
    trace: ExpertTrace, copies: np.ndarray
) -> tuple[ExpertTrace, np.ndarray]:
    """Uniform-split pseudo-expert trace for the expanded GEM search.

    Returns ``(trace over S pseudo-experts, owner (S,))`` where pseudo-
    expert ``j`` carries ``counts[:, owner[j]] / copies[owner[j]]`` (integer
    split, remainder to the first copies — deterministic).
    """
    counts = trace.counts
    T, E = counts.shape
    S = int(copies.sum())
    owner = np.repeat(np.arange(E, dtype=np.int32), copies)
    out = np.zeros((T, S), dtype=np.int64)
    j = 0
    for e in range(E):
        m = int(copies[e])
        base = counts[:, e] // m
        rem = counts[:, e] - base * m
        for c in range(m):
            out[:, j] = base + (c < rem)
            j += 1
    return ExpertTrace(out), owner


def _with_shares(
    s2e: np.ndarray,
    num_devices: int,
    num_experts: int,
    profile: VariabilityProfile,
    config: ReplicationConfig,
) -> ReplicatedPlacement:
    rp = ReplicatedPlacement(s2e, num_devices, num_experts)
    rp.compute_speed_shares(profile, config=config)
    return rp


def refine_replicated(
    rp: ReplicatedPlacement,
    trace: ExpertTrace,
    profile: VariabilityProfile,
    config: ReplicationConfig = ReplicationConfig(),
    *,
    tol: float = 1e-3,
) -> tuple[ReplicatedPlacement, float, int]:
    """Best-swap hill climb under the speed-proportional objective.

    Swapping two slots across devices changes the host devices of (up to)
    two experts' copies, so shares are recomputed per candidate — the
    refinement sees exactly the cost the data plane will pay. Returns
    ``(refined placement, score, swaps applied)``.
    """
    G, E = rp.num_devices, rp.num_experts
    layout = rp.slot_layout()
    dev = rp.slot_device()
    cur = replicated_score(
        trace, profile, _with_shares(layout, G, E, profile, config)
    )
    swaps = 0
    S = len(layout)
    while swaps < config.max_refine_swaps:
        best = (None, cur)
        for a in range(S):
            for b in range(a + 1, S):
                if dev[a] == dev[b] or layout[a] == layout[b]:
                    continue
                cand = layout.copy()
                cand[[a, b]] = cand[[b, a]]
                s = replicated_score(
                    trace, profile, _with_shares(cand, G, E, profile, config)
                )
                if s < best[1]:
                    best = ((a, b), s)
        if best[0] is None or best[1] >= cur:
            break
        a, b = best[0]
        layout[[a, b]] = layout[[b, a]]
        drop = cur - best[1]
        prev, cur = cur, best[1]
        swaps += 1
        if drop / max(prev, 1e-30) < tol:
            break
    return _with_shares(layout, G, E, profile, config), cur, swaps


def plan_replicated(
    trace: ExpertTrace,
    profile: VariabilityProfile,
    gem_config: GEMConfig = GEMConfig(),
    config: ReplicationConfig = ReplicationConfig(),
) -> ReplicatedSearchResult:
    """Full pipeline: copy selection → expanded GEM search → refinement."""
    G = profile.num_devices
    single = gem_place(trace, profile, gem_config)
    budget = config.replica_slots * G
    if budget == 0:
        rp = ReplicatedPlacement.from_placement(single.placement)
        rp.compute_speed_shares(profile, config=config)
        score = replicated_score(trace, profile, rp)
        return ReplicatedSearchResult(
            placement=rp, score=score, single_copy_score=single.score,
            copy_counts=np.ones(trace.num_experts, dtype=np.int64),
            refine_swaps=0,
        )
    copies = choose_replica_counts(trace, profile, budget, config)
    exp_trace, owner = expanded_trace(trace, copies)
    res = gem_place(exp_trace, profile, gem_config)
    s2e = owner[res.placement.slot_to_expert()]
    rp = _with_shares(s2e, G, trace.num_experts, profile, config)
    score = replicated_score(trace, profile, rp)
    refine_swaps = 0
    if config.refine:
        rp, score, refine_swaps = refine_replicated(
            rp, trace, profile, config, tol=gem_config.convergence_tol
        )
    # the expanded search is a heuristic: keep the plain GEM placement when
    # replication does not actually help on this trace (never plan worse)
    if score > single.score:
        rp_single = ReplicatedPlacement.from_placement(single.placement)
        rp_single.compute_speed_shares(profile, config=config)
        pad = config.replica_slots
        if pad:
            # structural slot count must match the budget: pad the single-
            # copy layout with per-device local copies (zero-share replicas
            # add no load and move no rows at install time)
            rp_single = _pad_local_copies(rp_single, pad, profile, config)
        s_single = replicated_score(trace, profile, rp_single)
        if s_single <= score:
            rp, score = rp_single, s_single
    return ReplicatedSearchResult(
        placement=rp, score=score, single_copy_score=single.score,
        copy_counts=rp.copy_counts(), refine_swaps=refine_swaps,
    )


def _pad_local_copies(
    rp: ReplicatedPlacement,
    replica_slots: int,
    profile: VariabilityProfile,
    config: ReplicationConfig,
) -> ReplicatedPlacement:
    """Pad each device with copies of its own experts (no cross-device rows)."""
    padded = rp.pad_with_local_copies(replica_slots)
    padded.compute_speed_shares(profile, config=config)
    return padded


def plan_replicated_layers(
    planner: GEMPlanner, config: ReplicationConfig
) -> list[ReplicatedSearchResult]:
    """Per-layer replicated plans from a GEM planner's trace collectors."""
    if planner.profile is None:
        raise RuntimeError("set_profile() must run before plan_replicated_layers()")
    out = []
    for collector in planner.collectors:
        trace = collector.trace(window=planner.config.trace_length)
        out.append(
            plan_replicated(trace, planner.profile, planner.config, config)
        )
    return out

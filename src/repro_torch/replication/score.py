"""Eq. 1 scoring generalized to multi-copy experts.

Under a :class:`~repro.replication.types.ReplicatedPlacement` an expert's
step-``t`` token count ``n_te`` does not land on one device: it splits
across the expert's copies by their (speed-proportional) shares. The
per-device load becomes

    n_g(M, t) = Σ_e  counts[t, e] · W[e, g],      W = rp.share_matrix()

and the straggler score keeps its Eq.-1 form ``Σ_t max_g C_g(n_g)``. At
replica budget 0, ``W`` is the placement one-hot and every function here
reduces exactly to its single-copy counterpart in :mod:`repro.core.score`.

``replica_fetch_rows`` prices a pool (re)install: the number of expert-
weight rows a device must fetch over the interconnect is the per-device
multiset difference between the old and new slot contents — a replica add
is one row broadcast, cheaper than the two row rewrites of a swap.
"""
from __future__ import annotations

import numpy as np

from ..core.types import ExpertTrace, VariabilityProfile
from .types import ReplicatedPlacement

__all__ = [
    "replicated_per_device_tokens",
    "replicated_per_step_latency",
    "replicated_score",
    "replicated_step_token_matrix",
    "replicated_step_cost_matrix",
    "shed_device_deltas",
    "shed_adjusted_step_cost_matrix",
    "replica_slot_loads",
    "simulate_shed_pass",
    "shed_gate_decisions",
    "replica_fetch_rows",
]


def replicated_per_device_tokens(
    counts: np.ndarray, rp: ReplicatedPlacement
) -> np.ndarray:
    """counts (..., E) → (..., G) per-device token loads under the split."""
    return np.asarray(counts, dtype=np.float64) @ rp.share_matrix()


def replicated_per_step_latency(
    trace: ExpertTrace, profile: VariabilityProfile, rp: ReplicatedPlacement
) -> np.ndarray:
    """(T,) straggler latency of each trace step under ``rp``."""
    tokens = replicated_per_device_tokens(trace.counts, rp)  # (T, G)
    return profile.cost_all(tokens).max(axis=1)


def replicated_score(
    trace: ExpertTrace, profile: VariabilityProfile, rp: ReplicatedPlacement
) -> float:
    """S(M) with speed-proportional replica splitting (Eq. 1 generalized)."""
    return float(replicated_per_step_latency(trace, profile, rp).sum())


def replicated_step_token_matrix(
    counts: np.ndarray,
    num_devices: int,
    rplacements: list[ReplicatedPlacement],
) -> np.ndarray:
    """One engine step's (L, G) per-layer per-device token loads under
    the replica share split (telemetry attribution + cost input)."""
    counts = np.asarray(counts, dtype=np.float64)
    L = counts.shape[0]
    if L != len(rplacements):
        raise ValueError("need one replicated placement per MoE layer")
    tokens = np.empty((L, num_devices), dtype=np.float64)
    for layer, rp in enumerate(rplacements):
        tokens[layer] = counts[layer] @ rp.share_matrix()
    return tokens


def replicated_step_cost_matrix(
    counts: np.ndarray,
    profile: VariabilityProfile,
    rplacements: list[ReplicatedPlacement],
) -> np.ndarray:
    """One engine step's (L, G) per-layer per-device MoE latencies.

    The replicated analogue of :func:`repro.core.score.step_cost_matrix`:
    ``counts`` (L, E) per-layer per-expert token counts of a single step.
    """
    tokens = replicated_step_token_matrix(
        counts, profile.num_devices, rplacements
    )
    return profile.cost_all(tokens)


def shed_device_deltas(
    shed_delta: np.ndarray, slots_per_device: int
) -> np.ndarray:
    """(L, S) signed per-slot shed row deltas → (L, G) per-device deltas.

    ``shed_delta`` is the dispatch plane's per-layer shed table
    (:class:`~repro.models.dispatch.DispatchPlan`): +received / −sent
    assignments per physical slot. Slots are device-major (slot ``s``
    lives on device ``s // slots_per_device``), so the device totals are
    a contiguous reshape-sum.
    """
    delta = np.asarray(shed_delta, dtype=np.float64)
    L, S = delta.shape
    if S % slots_per_device:
        raise ValueError("slot count must be a multiple of slots_per_device")
    return delta.reshape(L, S // slots_per_device, slots_per_device).sum(-1)


def shed_adjusted_step_cost_matrix(
    tokens: np.ndarray,
    shed_delta: np.ndarray,
    profile: VariabilityProfile,
    slots_per_device: int,
) -> np.ndarray:
    """Shed-aware (L, G) step cost: the latencies the devices *actually*
    paid after the capacity-overflow pass moved rows between copies.

    ``tokens`` (L, G) is the un-shed per-device load
    (:func:`replicated_step_token_matrix`); ``shed_delta`` (L, S) the
    dispatch plane's measured shed table. The adjustment is applied to
    the *simulated ground-truth* latency only — the controller's drift
    detectors and the regret oracle keep pricing the un-shed matrix, so
    placement replans keep targeting the underlying imbalance instead of
    the symptom shedding just masked (the two mechanisms compose rather
    than compete).
    """
    adjusted = np.maximum(
        np.asarray(tokens, dtype=np.float64)
        + shed_device_deltas(shed_delta, slots_per_device),
        0.0,
    )
    return profile.cost_all(adjusted)


def replica_slot_loads(
    counts_e: np.ndarray, rp: ReplicatedPlacement
) -> np.ndarray:
    """(E_v,) per-expert token counts → (S,) exact per-slot row loads.

    Mirrors the dispatch plane's deterministic copy pick (rank % P over
    the share-interleaved replica table): an expert with T assignments
    sends ``T // P`` full cycles to every column plus one extra to the
    first ``T % P`` columns. Host-side numpy twin of what
    :func:`repro.models.dispatch.build_dispatch` will scatter — the
    shed-gate pricing depends on this being *exact*, not expected-value.
    """
    table = np.asarray(rp.replica_table())  # (E_v, P)
    P = table.shape[1]
    loads = np.zeros(rp.num_slots, dtype=np.int64)
    for e in range(table.shape[0]):
        T = int(counts_e[e])
        full, rem = divmod(T, P)
        if full:
            np.add.at(loads, table[e], full)
        if rem:
            np.add.at(loads, table[e, :rem], 1)
    return loads


def simulate_shed_pass(
    counts_e: np.ndarray, rp: ReplicatedPlacement, capacity: int
) -> dict:
    """Host-side twin of the dispatch plane's capacity-overflow pass.

    Given one layer's (E_v,) per-expert token counts, reproduce what
    :func:`repro.models.dispatch.build_dispatch` will do with the shed
    pass enabled: the deterministic rank-``%P`` split onto slots
    (:func:`replica_slot_loads`), the per-slot clamp at ``capacity``,
    and the least-loaded-live-copy-first waterfall that re-seats each
    expert's overflow onto its other copies' free rows. Returns

    ``delta``     (S,) signed per-slot assignment deltas (+received,
                  −sent) — same convention as ``DispatchPlan.shed_delta``
    ``shed``      total assignments re-seated
    ``overflow``  total assignments past the clamp before shedding
    ``dropped``   overflow that found no free live-copy row
                  (``overflow − shed``; these rows stay dropped)

    Both the gate pricing (:func:`shed_gate_decisions`) and the fig25
    replay are built on this — the gate's profitability verdict is only
    meaningful because this simulation is *exact*, not expected-value.
    """
    rp_table = np.asarray(rp.replica_table())
    loads = replica_slot_loads(counts_e, rp)
    kept = np.minimum(loads, int(capacity))
    over_slot = loads - kept  # (S,) rows past the clamp
    free = int(capacity) - kept
    delta = np.zeros(rp.num_slots, dtype=np.float64)
    shed_total = 0
    for e in range(rp_table.shape[0]):
        copies = list(dict.fromkeys(rp_table[e].tolist()))  # live, deduped
        if len(copies) < 2:
            continue
        o = int(over_slot[copies].sum())
        if o == 0:
            continue
        # waterfall: least-loaded live copy first, slot id ties
        order = sorted(copies, key=lambda s: (kept[s], s))
        moved = 0
        for s in order:
            take = min(int(free[s]), o - moved)
            if take > 0:
                delta[s] += take
                moved += take
            if moved == o:
                break
        if moved == 0:
            continue
        # senders: the moved rows leave the overflowing slots
        # (proportionally when only a prefix could re-seat)
        scale = moved / o
        for s in copies:
            delta[s] -= float(over_slot[s]) * scale
        shed_total += moved
    overflow = int(over_slot.sum())
    return {
        "delta": delta,
        "shed": shed_total,
        "overflow": overflow,
        "dropped": overflow - shed_total,
    }


def shed_gate_decisions(
    counts: np.ndarray,
    rplacements: list[ReplicatedPlacement],
    profile: VariabilityProfile,
    capacity: int,
    *,
    bandwidth: float,
    token_bytes: float,
    min_overflow: int = 1,
    hysteresis: float = 1.0,
    device_scale: np.ndarray | None = None,
    drop_penalty_s: float = 0.0,
) -> np.ndarray:
    """Replica-exact shed-vs-wait gate: (L,) 0/1 enables for the next step.

    Where :func:`repro.core.score.shed_decisions` prices a single
    cheapest receiver (optimistic — the waterfall may land the rows on a
    slower copy), this version *simulates the shed outcome* on the host:
    the exact per-slot loads the dispatch split will produce
    (:func:`replica_slot_loads`), the capacity clamp at ``capacity``,
    the least-loaded-first waterfall over each expert's live copies, and
    the resulting per-device load deltas. Layer ``l`` enables iff

        max_g C_g(adjusted) + cross·token_bytes/bandwidth
            <  max_g C_g(un-shed) / hysteresis + shed·drop_penalty_s

    where ``cross`` counts only the rows that change *device* (a re-seat
    between two slots of the same device never touches the interconnect)
    and ``drop_penalty_s`` credits the quality value of each rescued row
    (un-shed overflow is dropped, not queued — see
    :class:`repro.serving.shed.ShedConfig`). At the default penalty of 0
    this is the pure latency comparison: the step's straggler latency
    must strictly improve after paying the transfer, with
    ``hysteresis`` > 1 demanding a margin. Because
    the pricing loop runs one step behind (step ``t``'s counts price
    ``t+1``'s enables), the hysteresis margin also absorbs step-to-step
    count drift.

    ``device_scale`` (G,) multiplies each device's believed cost before
    the straggler max on *both* sides of the inequality. The serving
    engine passes the variability detector's live observed/predicted
    latency ratios here: believed cost × observed ratio ≈ observed cost,
    so the gate prices the queue-wait a straggler is *actually* imposing
    — sheds start firing within the ratio EWMA's horizon, steps before
    the detector crosses its threshold and the placement replan lands.
    This is what lets shedding bridge the stale-beliefs window (a
    believed-fast device slowing mid-run still carries its planned
    share) instead of competing with the replan that ultimately fixes it.
    """
    counts = np.asarray(counts, dtype=np.int64)
    L = counts.shape[0]
    if L != len(rplacements):
        raise ValueError("need one replicated placement per MoE layer")
    scale = None
    if device_scale is not None:
        scale = np.asarray(device_scale, dtype=np.float64)
        if scale.shape != (profile.num_devices,):
            raise ValueError(
                "device_scale must be (num_devices,) observed/predicted "
                "latency ratios"
            )
    enables = np.zeros(L, dtype=np.int32)
    for layer in range(L):
        rp = rplacements[layer]
        sim = simulate_shed_pass(counts[layer], rp, capacity)
        if sim["overflow"] < min_overflow or sim["shed"] < min_overflow:
            continue
        tokens_g = counts[layer].astype(np.float64) @ rp.share_matrix()
        dev_delta = sim["delta"].reshape(
            profile.num_devices, rp.slots_per_device
        ).sum(-1)
        legacy_g = profile.cost_all(tokens_g[None, :])[0]
        adjusted_g = profile.cost_all(
            np.maximum(tokens_g + dev_delta, 0.0)[None, :]
        )[0]
        if scale is not None:
            legacy_g = legacy_g * scale
            adjusted_g = adjusted_g * scale
        legacy = float(legacy_g.max())
        adjusted = float(adjusted_g.max())
        cross = float(np.maximum(dev_delta, 0.0).sum())
        transfer_s = cross * token_bytes / bandwidth
        credit = sim["shed"] * drop_penalty_s
        if adjusted + transfer_s < legacy / hysteresis + credit:
            enables[layer] = 1
    return enables


def replica_fetch_rows(
    old: ReplicatedPlacement, new: ReplicatedPlacement
) -> int:
    """Expert-weight rows fetched over the interconnect by a pool install.

    Per device: rows whose expert is not already resident there cost one
    fetch each (multiset difference — extra copies of an expert a device
    already holds are local row copies, not interconnect traffic).
    """
    if old.num_devices != new.num_devices:
        raise ValueError("placements must cover the same devices")
    E = max(old.num_experts, new.num_experts)
    moves = 0
    for g in range(old.num_devices):
        old_slots = old.slot_to_expert[
            g * old.slots_per_device : (g + 1) * old.slots_per_device
        ]
        new_slots = new.slot_to_expert[
            g * new.slots_per_device : (g + 1) * new.slots_per_device
        ]
        have = np.bincount(old_slots, minlength=E)
        want = np.bincount(new_slots, minlength=E)
        moves += int(((want > 0) & (have == 0)).sum())
    return moves

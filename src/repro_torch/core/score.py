"""Eq. 1 mapping score and fast incremental scoring for the placement search.

    S(M) = sum_t  max_g  C_g( n_g(M, t) )

``n_g(M,t)`` is the token count device ``g`` receives at trace step ``t`` under
mapping ``M``; ``C_g`` is that device's profiled latency curve; the inner max
is the straggler at step ``t`` (paper §3.3.3, Fig. 13).

The swap search evaluates O(E^2) candidate swaps per iteration; naively that is
O(E^2 · T · G) interpolations. ``IncrementalScorer`` keeps the per-step
per-device token matrix and the per-step top-3 cost statistics so each swap is
scored with two curve lookups per step, vectorized over all pairs at once.
"""
from __future__ import annotations

import numpy as np

from .types import ExpertTrace, Placement, VariabilityProfile

__all__ = [
    "score",
    "per_step_latency",
    "step_token_matrix",
    "step_cost_matrix",
    "migration_net_benefit",
    "shed_gate_terms",
    "shed_decisions",
    "IncrementalScorer",
]


def per_step_latency(
    trace: ExpertTrace, profile: VariabilityProfile, placement: Placement
) -> np.ndarray:
    """(T,) straggler latency of each trace step under ``placement``."""
    n = trace.per_device_tokens(placement)  # (T, G)
    costs = profile.cost_all(n)  # (T, G)
    return costs.max(axis=1)


def score(
    trace: ExpertTrace, profile: VariabilityProfile, placement: Placement
) -> float:
    """S(M): summed straggler latency over the trace (Eq. 1)."""
    return float(per_step_latency(trace, profile, placement).sum())


def step_token_matrix(
    counts: np.ndarray,
    num_devices: int,
    placements: list[Placement],
) -> np.ndarray:
    """One engine step's (L, G) per-layer per-device token loads.

    ``counts`` (L, E): per-layer per-expert token counts of a single
    step, binned onto devices by each layer's placement. This is the
    input both to :func:`step_cost_matrix` and to the telemetry plane's
    straggler attribution (:mod:`repro.telemetry.attribution`).
    """
    counts = np.asarray(counts, dtype=np.float64)
    L = counts.shape[0]
    if L != len(placements):
        raise ValueError("need one placement per MoE layer")
    tokens = np.empty((L, num_devices), dtype=np.float64)
    for layer, placement in enumerate(placements):
        tokens[layer] = np.bincount(
            placement.expert_to_device, weights=counts[layer],
            minlength=num_devices,
        )
    return tokens


def step_cost_matrix(
    counts: np.ndarray,
    profile: VariabilityProfile,
    placements: list[Placement],
) -> np.ndarray:
    """One engine step's (L, G) per-layer per-device MoE latencies.

    ``counts`` (L, E): per-layer per-expert token counts of a single step.
    The straggler step latency is ``mat.max(axis=1).sum()``; the per-device
    column sums feed the online plane's variability-drift detector (observed
    vs predicted device time under the same placement).
    """
    tokens = step_token_matrix(counts, profile.num_devices, placements)
    return profile.cost_all(tokens)


def migration_net_benefit(
    current_score: float,
    target_score: float,
    window_steps: int,
    horizon_steps: int,
    migration_cost: float,
) -> float:
    """Expected latency saved (s) by migrating, net of the migration cost.

    ``current_score``/``target_score`` are Eq.-1 scores of the two placements
    over the same ``window_steps``-step trace; the per-step saving is assumed
    to persist for ``horizon_steps`` future steps. Positive ⇒ the migration
    pays for itself — the online controller's go/no-go hook, so a drift
    replan whose improvement can't amortise the weight traffic is skipped.
    """
    if window_steps <= 0:
        raise ValueError("window_steps must be positive")
    per_step_gain = (current_score - target_score) / window_steps
    return per_step_gain * horizon_steps - migration_cost


def shed_gate_terms(
    tokens_g: np.ndarray,
    overflow: float,
    profile: VariabilityProfile,
    device_scale: np.ndarray | None = None,
) -> tuple[float, float]:
    """Marginal-cost terms of the shed-vs-wait decision for one layer.

    ``tokens_g`` (G,) is the layer's per-device token load, ``overflow``
    the assignments past the straggler's capacity clamp. Returns
    ``(wait_s, recv_s)``:

    * ``wait_s`` — queue-wait bought back by taking ``overflow`` tokens
      off the straggler device: ``C_g*(n) − C_g*(n − overflow)`` on its
      profiled curve.
    * ``recv_s`` — the *cheapest* marginal cost of absorbing them
      elsewhere: ``min_{g≠g*} C_g(n_g + overflow) − C_g(n_g)``.

    The data plane's waterfall may split the overflow across several
    copies, so this single-receiver pricing is the *optimistic* (lower)
    bound on the receiving side — the replica-exact gate
    (:func:`repro.replication.score.shed_gate_decisions`) simulates the
    real split and supersedes this bound whenever live replicated
    placements are available; this form remains for the non-replicated
    controller fallback.

    ``device_scale`` (G,) multiplies each device's believed cost curve
    (observed/predicted latency ratios from the variability detector:
    believed × ratio ≈ observed), so a believed-fast device that slowed
    mid-run is priced at the queue-wait it actually imposes.
    """
    tokens = np.asarray(tokens_g, dtype=np.float64)
    scale = (
        np.ones(len(tokens))
        if device_scale is None
        else np.asarray(device_scale, dtype=np.float64)
    )
    base = profile.cost_all(tokens[None, :])[0] * scale  # (G,)
    g_s = int(base.argmax())
    reduced = tokens.copy()
    reduced[g_s] = max(reduced[g_s] - overflow, 0.0)
    wait_s = float(
        base[g_s]
        - profile.cost_all(reduced[None, :])[0, g_s] * scale[g_s]
    )
    bumped = tokens[None, :] + overflow * np.eye(len(tokens))
    marginal = profile.cost_all(bumped).diagonal() * scale - base
    marginal[g_s] = np.inf  # the straggler can't receive its own overflow
    recv_s = float(marginal.min())
    return wait_s, recv_s


def shed_decisions(
    tokens: np.ndarray,
    overflow: np.ndarray,
    profile: VariabilityProfile,
    *,
    bandwidth: float,
    token_bytes: float,
    min_overflow: int = 1,
    hysteresis: float = 1.0,
    device_scale: np.ndarray | None = None,
    drop_penalty_s: float = 0.0,
) -> np.ndarray:
    """Per-layer shed-vs-wait gate: (L,) 0/1 enables for the next step.

    ``tokens`` (L, G) per-layer per-device loads and ``overflow`` (L,)
    capacity-overflow counts, both from the *previous* engine step (the
    online pricing loop: observe, price, enable). Layer ``l`` sheds iff

        recv_s + overflow·token_bytes/bandwidth
            <  wait_s / hysteresis + overflow·drop_penalty_s

    — the receiving device's marginal compute plus the activation
    transfer must beat the straggler's queue wait (``hysteresis`` > 1
    demands a margin), with ``drop_penalty_s`` crediting the quality
    value of rescuing rows that would otherwise fall out of the capacity
    buffer (see :class:`repro.serving.shed.ShedConfig`). ``bandwidth``
    comes from the migration cost model
    (``BandwidthEstimator``-calibrated when the controller runs with
    ``MigrationConfig.calibrate_bandwidth``), so the gate reprices as the
    fabric's measured throughput drifts.
    """
    tokens = np.asarray(tokens, dtype=np.float64)
    overflow = np.asarray(overflow, dtype=np.float64).reshape(-1)
    L = tokens.shape[0]
    if overflow.shape[0] != L:
        raise ValueError("need one overflow count per layer")
    enables = np.zeros(L, dtype=np.int32)
    for layer in range(L):
        o = float(overflow[layer])
        if o < min_overflow:
            continue
        wait_s, recv_s = shed_gate_terms(
            tokens[layer], o, profile, device_scale
        )
        transfer_s = o * token_bytes / bandwidth
        if recv_s + transfer_s < wait_s / hysteresis + o * drop_penalty_s:
            enables[layer] = 1
    return enables


class IncrementalScorer:
    """Incremental S(M) evaluation over add-expert and swap-pair moves.

    Maintains:
      * ``tokens``    (T, G)  per-step per-device token counts,
      * ``costs``     (T, G)  per-step per-device latencies,
      * per-step top-3 cost values/indices (so a swap touching two devices can
        reconstruct the straggler max without a full G-wide re-max).
    """

    def __init__(self, trace: ExpertTrace, profile: VariabilityProfile):
        if profile.num_devices <= 0:
            raise ValueError("profile must cover at least one device")
        self.trace = trace
        self.profile = profile
        self.T = trace.num_steps
        self.E = trace.num_experts
        self.G = profile.num_devices
        self.counts = trace.counts.astype(np.float64)  # (T, E)
        self._xp = profile.token_counts.astype(np.float64)
        self._fp = profile.latencies  # (G, S)
        self.device_of = np.full(self.E, -1, dtype=np.int32)
        self.tokens = np.zeros((self.T, self.G), dtype=np.float64)
        self.costs = self._cost_matrix(self.tokens)

    # -- curve lookups -----------------------------------------------------
    def _cost(self, g: int, tokens: np.ndarray) -> np.ndarray:
        return np.interp(tokens, self._xp, self._fp[g])

    def _cost_matrix(self, tokens: np.ndarray) -> np.ndarray:
        out = np.empty_like(tokens)
        for g in range(self.G):
            out[:, g] = self._cost(g, tokens[:, g])
        return out

    # -- state -------------------------------------------------------------
    def placement(self) -> Placement:
        if (self.device_of < 0).any():
            raise ValueError("not all experts are placed yet")
        return Placement(self.device_of.copy(), self.G)

    def load_placement(self, placement: Placement) -> None:
        self.device_of = placement.expert_to_device.copy()
        self.tokens = self.counts @ self._onehot(placement)
        self.costs = self._cost_matrix(self.tokens)

    def _onehot(self, placement: Placement) -> np.ndarray:
        oh = np.zeros((self.E, self.G), dtype=np.float64)
        oh[np.arange(self.E), placement.expert_to_device] = 1.0
        return oh

    def score(self) -> float:
        return float(self.costs.max(axis=1).sum())

    def per_device_share(self) -> np.ndarray:
        """Fraction of total tokens each device processes (diagnostic)."""
        tot = self.tokens.sum()
        return self.tokens.sum(axis=0) / max(tot, 1.0)

    # -- greedy construction (Alg. 2 inner step) ----------------------------
    def placed_count(self) -> np.ndarray:
        cnt = np.zeros(self.G, dtype=np.int64)
        placed = self.device_of >= 0
        if placed.any():
            cnt = np.bincount(self.device_of[placed], minlength=self.G)
        return cnt

    def score_with_add(self, e: int) -> np.ndarray:
        """(G,) partial-mapping score if expert ``e`` were placed on each device."""
        col = self.counts[:, e]  # (T,)
        # For each candidate device g, only column g changes.
        # max' = max(max over g'!=g, new cost_g). Use top-2 stats.
        top1 = self.costs.max(axis=1)
        arg1 = self.costs.argmax(axis=1)
        tmp = self.costs.copy()
        tmp[np.arange(self.T), arg1] = -np.inf
        top2 = tmp.max(axis=1)
        scores = np.empty(self.G, dtype=np.float64)
        for g in range(self.G):
            new_cost_g = self._cost(g, self.tokens[:, g] + col)
            others = np.where(arg1 == g, top2, top1)
            scores[g] = np.maximum(others, new_cost_g).sum()
        return scores

    def add_expert(self, e: int, g: int) -> None:
        if self.device_of[e] >= 0:
            raise ValueError(f"expert {e} already placed")
        self.device_of[e] = g
        self.tokens[:, g] += self.counts[:, e]
        self.costs[:, g] = self._cost(g, self.tokens[:, g])

    # -- swap search (Alg. 3 inner step) -------------------------------------
    def _top3(self):
        """Per-step top-3 cost values and their device indices."""
        # argpartition for top3 along axis 1
        G = self.G
        k = min(3, G)
        idx = np.argpartition(-self.costs, kth=k - 1, axis=1)[:, :k]
        vals = np.take_along_axis(self.costs, idx, axis=1)
        order = np.argsort(-vals, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        if k < 3:  # pad so downstream indexing is uniform
            pad = 3 - k
            vals = np.concatenate(
                [vals, np.full((self.T, pad), -np.inf)], axis=1
            )
            idx = np.concatenate(
                [idx, np.full((self.T, pad), -1, dtype=idx.dtype)], axis=1
            )
        return vals, idx

    def best_swap(self) -> tuple[int, int, float]:
        """Evaluate all cross-device expert swaps; return (e_a, e_b, new_score).

        Vectorized over all pairs. Returns the pair minimizing the new score
        (ties broken arbitrarily); if no swap helps, the returned score is
        >= the current score and the caller decides to stop.
        """
        E, T = self.E, self.T
        dev = self.device_of
        ea, eb = np.triu_indices(E, k=1)
        cross = dev[ea] != dev[eb]
        ea, eb = ea[cross], eb[cross]
        P = len(ea)
        if P == 0:
            return -1, -1, self.score()
        dA = dev[ea]  # (P,)
        dB = dev[eb]
        delta = self.counts[:, eb] - self.counts[:, ea]  # (T, P)
        newA = self.tokens[:, dA] + delta  # (T, P) tokens on device A after swap
        newB = self.tokens[:, dB] - delta

        costA = np.empty((T, P), dtype=np.float64)
        costB = np.empty((T, P), dtype=np.float64)
        for g in range(self.G):
            mA = dA == g
            if mA.any():
                costA[:, mA] = np.interp(newA[:, mA], self._xp, self._fp[g])
            mB = dB == g
            if mB.any():
                costB[:, mB] = np.interp(newB[:, mB], self._xp, self._fp[g])

        vals, idx = self._top3()  # (T,3)
        # "max over devices other than dA,dB" per (t, pair):
        # first top-3 entry whose device is not dA and not dB.
        i0 = idx[:, 0][:, None]
        i1 = idx[:, 1][:, None]
        v0 = np.broadcast_to(vals[:, 0][:, None], (T, P))
        v1 = np.broadcast_to(vals[:, 1][:, None], (T, P))
        v2 = np.broadcast_to(vals[:, 2][:, None], (T, P))
        hit0 = (i0 == dA[None, :]) | (i0 == dB[None, :])
        hit1 = (i1 == dA[None, :]) | (i1 == dB[None, :])
        others = np.where(~hit0, v0, np.where(~hit1, v1, v2))
        if self.G == 2:
            others = np.full((T, P), -np.inf)

        step_max = np.maximum(others, np.maximum(costA, costB))  # (T, P)
        pair_scores = step_max.sum(axis=0)  # (P,)
        best = int(pair_scores.argmin())
        return int(ea[best]), int(eb[best]), float(pair_scores[best])

    def apply_swap(self, e_a: int, e_b: int) -> None:
        gA, gB = self.device_of[e_a], self.device_of[e_b]
        if gA == gB:
            raise ValueError("swap must cross devices")
        delta = self.counts[:, e_b] - self.counts[:, e_a]
        self.tokens[:, gA] += delta
        self.tokens[:, gB] -= delta
        self.device_of[e_a], self.device_of[e_b] = gB, gA
        self.costs[:, gA] = self._cost(gA, self.tokens[:, gA])
        self.costs[:, gB] = self._cost(gB, self.tokens[:, gB])

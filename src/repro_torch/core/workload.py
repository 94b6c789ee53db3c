"""Synthetic MoE routing workloads with consistent + correlated-temporal experts.

Reproduces the routing phenomenology the paper measures on real models
(Figs. 2, 6, 8): per layer,

  * a few **consistent** experts are active in ~85% of engine steps and absorb
    a large share of tokens;
  * groups of **temporal** experts are active together in bursts covering a
    small fraction (~17%) of steps but process ~3× a uniform share when
    active (burst phases are simulated as correlated on/off regimes, giving
    Pearson r ≈ 0.8–0.95 within a group);
  * the remaining tokens are spread over background experts with a skewed
    (Zipf-like) distribution — the paper's 4.2×-over-uniform hot expert.

The generator is exact about the per-step token budget: every step routes
``tokens_per_step * top_k`` expert-token assignments, matching a router that
always picks top-k experts per token.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import ExpertTrace

__all__ = ["WorkloadSpec", "generate_trace", "generate_layer_traces"]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    num_experts: int
    top_k: int
    tokens_per_step: int  # tokens entering the MoE layer per engine step
    num_consistent: int = 3
    num_temporal_groups: int = 2
    temporal_group_size: int = 2
    consistent_active_frac: float = 0.85
    temporal_active_frac: float = 0.17
    consistent_share: float = 0.30  # share of assignments to consistent experts
    temporal_burst_share: float = 0.45  # share during a burst step
    zipf_alpha: float = 1.1  # skew of the zipf background (background="zipf")
    background: str = "zipf"  # "zipf" | "lognormal"
    skew_sigma: float = 0.5  # lognormal background: σ of log-popularity.
    # σ≈0.5 over ~128 experts puts the hottest background expert ≈4× the
    # uniform share (paper Fig. 2's 4.2×) while most stay near uniform.
    burst_len: int = 4  # expected steps per temporal burst

    def __post_init__(self):
        hot = self.num_consistent + self.num_temporal_groups * self.temporal_group_size
        if hot > self.num_experts:
            raise ValueError("more hot experts than experts")


def _burst_mask(
    num_steps: int, active_frac: float, burst_len: int, rng: np.random.Generator
) -> np.ndarray:
    """Contiguous on/off phases with the requested stationary active fraction."""
    mask = np.zeros(num_steps, dtype=bool)
    t = 0
    on = rng.random() < active_frac
    while t < num_steps:
        dur = max(1, int(rng.geometric(1.0 / burst_len)))
        if on:
            mask[t : t + dur] = True
        t += dur
        # transition probabilities chosen so the chain's stationary
        # distribution matches active_frac
        on = rng.random() < (active_frac if not on else active_frac)
        # make bursts sticky: once on, stay on with prob ~ active_frac**0.5
        if mask[min(t, num_steps) - 1]:
            on = rng.random() < active_frac ** 0.5
    return mask


def generate_trace(
    spec: WorkloadSpec,
    num_steps: int,
    *,
    seed: int = 0,
    identity_seed: int | None = None,
) -> ExpertTrace:
    """Generate ``num_steps`` of routing counts.

    ``identity_seed`` fixes *which* experts are consistent/temporal/hot
    (the stable utilization pattern the paper observes — Fig. 10's premise);
    ``seed`` drives the per-step phase randomness. Fitting on one ``seed``
    and evaluating on another with the same ``identity_seed`` reproduces the
    paper's "500 unseen requests" methodology.
    """
    if identity_seed is None:
        identity_seed = seed
    id_rng = np.random.default_rng(identity_seed)
    rng = np.random.default_rng(seed)
    E = spec.num_experts
    total_assignments = spec.tokens_per_step * spec.top_k

    ids = id_rng.permutation(E)
    consistent = ids[: spec.num_consistent]
    groups = []
    p = spec.num_consistent
    for _ in range(spec.num_temporal_groups):
        groups.append(ids[p : p + spec.temporal_group_size])
        p += spec.temporal_group_size
    background = ids[p:]

    # Background popularity: lognormal (calibrated to the paper's Fig. 2
    # skew) or Zipf (heavier-tailed, small expert counts).
    if spec.background == "lognormal":
        bg_pop = np.exp(id_rng.normal(0.0, spec.skew_sigma, len(background)))
    else:
        ranks = np.arange(1, len(background) + 1, dtype=np.float64)
        bg_pop = id_rng.permutation(ranks ** (-spec.zipf_alpha))
    bg_pop /= bg_pop.sum()

    cons_active = np.stack(
        [
            rng.random(num_steps) < spec.consistent_active_frac
            for _ in consistent
        ],
        axis=1,
    )  # (T, C)
    group_bursts = [
        _burst_mask(num_steps, spec.temporal_active_frac, spec.burst_len, rng)
        for _ in groups
    ]

    counts = np.zeros((num_steps, E), dtype=np.int64)
    for t in range(num_steps):
        budget = total_assignments
        # temporal bursts take their share first
        for gi, grp in enumerate(groups):
            if group_bursts[gi][t]:
                share = int(
                    round(budget * spec.temporal_burst_share / spec.num_temporal_groups)
                )
                if share > 0:
                    # split within the group with mild noise (keeps r high)
                    w = rng.dirichlet(np.full(len(grp), 8.0))
                    alloc = np.floor(share * w).astype(np.int64)
                    alloc[0] += share - alloc.sum()
                    counts[t, grp] += alloc
        # consistent experts
        active_c = consistent[cons_active[t]]
        if len(active_c) > 0:
            share = int(round(total_assignments * spec.consistent_share))
            w = rng.dirichlet(np.full(len(active_c), 16.0))
            alloc = np.floor(share * w).astype(np.int64)
            alloc[0] += share - alloc.sum()
            counts[t, active_c] += alloc
        # remaining budget to background experts
        used = int(counts[t].sum())
        rem = max(total_assignments - used, 0)
        if rem > 0 and len(background) > 0:
            alloc = rng.multinomial(rem, bg_pop)
            counts[t, background] += alloc
        elif used > total_assignments:
            # trim overshoot from the largest holder to keep budget exact
            over = used - total_assignments
            while over > 0:
                j = int(counts[t].argmax())
                take = min(over, int(counts[t, j]) - 1)
                if take <= 0:
                    break
                counts[t, j] -= take
                over -= take
    return ExpertTrace(counts)


def generate_layer_traces(
    spec: WorkloadSpec,
    num_layers: int,
    num_steps: int,
    *,
    seed: int = 0,
    identity_seed: int = 0,
) -> list[ExpertTrace]:
    """Independent per-layer traces (hot experts differ per layer — Fig. 2).

    Layer identities are stable in ``identity_seed`` so that traces generated
    with different ``seed`` values are *unseen steps of the same workload*.
    """
    return [
        generate_trace(
            spec,
            num_steps,
            seed=seed * 10_000 + layer,
            identity_seed=identity_seed * 10_000 + layer,
        )
        for layer in range(num_layers)
    ]

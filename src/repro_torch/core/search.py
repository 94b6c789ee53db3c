"""GEM's placement search (paper Algorithms 1–4, §3.3.3 + Appendix B).

  * :func:`initial_mapping` — Alg. 2: sort experts by (noised) mean
    utilization, heaviest first, greedily place each on the device that
    minimizes the partial-mapping score, subject to equal per-device capacity.
  * :func:`refine` — Alg. 3: repeatedly apply the single cross-device expert
    swap that most reduces S(M); stop when the relative drop < 0.1%.
  * :func:`gem_place` — Alg. 4: K restarts (20% utilization noise on restarts
    after the first), return the best final mapping.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .score import IncrementalScorer, score
from .types import ExpertTrace, GEMConfig, Placement, VariabilityProfile

__all__ = ["SearchResult", "initial_mapping", "refine", "gem_place"]


@dataclasses.dataclass
class SearchResult:
    placement: Placement
    score: float
    restart_scores: list[float]
    swaps_per_restart: list[int]
    initial_score: float  # score of the unrefined best initial mapping

    @property
    def total_swaps(self) -> int:
        return sum(self.swaps_per_restart)


def initial_mapping(
    trace: ExpertTrace,
    profile: VariabilityProfile,
    *,
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
) -> Placement:
    """Alg. 2: greedy heaviest-first construction.

    Experts are sorted by mean utilization (perturbed by ``noise`` for
    restart diversity) and inserted one at a time onto the device yielding the
    lowest partial score. Capacity is E/G per device so the final mapping is
    balanced (equal expert-weight memory per device, §3.3.3).
    """
    util = trace.mean_utilization().astype(np.float64)
    if noise > 0.0:
        if rng is None:
            rng = np.random.default_rng(0)
        util = util * (1.0 + rng.uniform(-noise, noise, size=util.shape))
    order = np.argsort(-util, kind="stable")

    scorer = IncrementalScorer(trace, profile)
    cap = trace.num_experts // profile.num_devices
    for e in order:
        counts = scorer.placed_count()
        cand = scorer.score_with_add(int(e))
        cand[counts >= cap] = np.inf  # full devices are ineligible
        g = int(cand.argmin())
        scorer.add_expert(int(e), g)
    return scorer.placement()


def refine(
    placement: Placement,
    trace: ExpertTrace,
    profile: VariabilityProfile,
    *,
    tol: float = 1e-3,
    max_swaps: int = 200,
) -> tuple[Placement, float, int]:
    """Alg. 3: best-pair-swap hill climbing until relative drop < ``tol``.

    Returns (refined placement, final score, number of swaps applied).
    """
    scorer = IncrementalScorer(trace, profile)
    scorer.load_placement(placement)
    cur = scorer.score()
    swaps = 0
    while swaps < max_swaps:
        e_a, e_b, new = scorer.best_swap()
        if e_a < 0 or new >= cur:
            break  # no swap improves the score
        drop = cur - new
        scorer.apply_swap(e_a, e_b)
        swaps += 1
        prev = cur
        cur = new
        if drop / max(prev, 1e-30) < tol:
            break  # converged (< 0.1% relative improvement)
    return scorer.placement(), cur, swaps


def gem_place(
    trace: ExpertTrace,
    profile: VariabilityProfile,
    config: GEMConfig = GEMConfig(),
) -> SearchResult:
    """Alg. 4: K noisy restarts of (Alg. 2 → Alg. 3); return the best mapping."""
    rng = np.random.default_rng(config.seed)
    best: Placement | None = None
    best_score = np.inf
    restart_scores: list[float] = []
    swaps_per_restart: list[int] = []
    best_initial = np.inf
    for i in range(config.num_restarts):
        noise = 0.0 if i == 0 else config.restart_noise
        m0 = initial_mapping(trace, profile, noise=noise, rng=rng)
        s0 = score(trace, profile, m0)
        best_initial = min(best_initial, s0)
        m, s, n_swaps = refine(
            m0,
            trace,
            profile,
            tol=config.convergence_tol,
            max_swaps=config.max_swaps,
        )
        restart_scores.append(s)
        swaps_per_restart.append(n_swaps)
        if s < best_score:
            best_score = s
            best = m
    assert best is not None
    return SearchResult(
        placement=best,
        score=best_score,
        restart_scores=restart_scores,
        swaps_per_restart=swaps_per_restart,
        initial_score=best_initial,
    )

"""GEMPlanner: the paper's four-step pipeline as a single public API (§3.3).

    planner = GEMPlanner(num_experts, num_devices, config)
    planner.observe_step(layer, per_expert_token_counts)   # Step-1 (online)
    planner.set_profile(profile)                           # Step-2 (offline)
    plan = planner.plan()                                  # Step-3 (search)
    # Step-4: apply plan.placements[layer] — permute the expert-stacked
    # weights with plan.slot_permutations[layer] and remap router indices
    # with plan.expert_to_slot[layer] (see repro.models.moe / serving engine).

The planner is deliberately host-side and framework-agnostic: the JAX data
plane only consumes the resulting permutations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .eplb import linear_placement
from .score import score
from .search import SearchResult, gem_place
from .trace import TraceCollector
from .types import GEMConfig, Placement, VariabilityProfile

__all__ = ["GEMPlan", "GEMPlanner"]


@dataclasses.dataclass
class GEMPlan:
    placements: list[Placement]  # per MoE layer
    search_results: list[SearchResult]
    baseline_scores: list[float]  # S(linear) per layer, same trace/profile

    @property
    def slot_permutations(self) -> list[np.ndarray]:
        """Per-layer slot→expert permutation to apply to stacked weights."""
        return [p.slot_to_expert() for p in self.placements]

    @property
    def expert_to_slot(self) -> list[np.ndarray]:
        """Per-layer router remap tables (logical expert id → physical slot)."""
        return [p.expert_to_slot() for p in self.placements]

    @property
    def total_score(self) -> float:
        return float(sum(r.score for r in self.search_results))

    @property
    def predicted_improvement(self) -> float:
        """% predicted reduction in summed straggler latency vs linear."""
        base = sum(self.baseline_scores)
        return 100.0 * (1.0 - self.total_score / base) if base > 0 else 0.0


class GEMPlanner:
    """Collects traces per layer, holds the fleet profile, runs the search."""

    def __init__(
        self,
        num_experts: int,
        num_devices: int,
        num_layers: int,
        config: GEMConfig = GEMConfig(),
    ):
        self.num_experts = num_experts
        self.num_devices = num_devices
        self.num_layers = num_layers
        self.config = config
        self.collectors = [
            TraceCollector(num_experts) for _ in range(num_layers)
        ]
        self.profile: VariabilityProfile | None = None

    # Step-1 ---------------------------------------------------------------
    def observe_step(self, layer: int, counts: np.ndarray) -> None:
        self.collectors[layer].record(counts)

    def observe_routing(self, layer: int, expert_ids: np.ndarray) -> None:
        """Record raw router output (token, k) expert ids for one step."""
        self.collectors[layer].record_routing(expert_ids)

    def ready(self) -> bool:
        return all(
            c.num_steps >= self.config.trace_length for c in self.collectors
        ) and self.profile is not None

    # Step-2 ---------------------------------------------------------------
    def set_profile(self, profile: VariabilityProfile) -> None:
        if profile.num_devices != self.num_devices:
            raise ValueError(
                f"profile covers {profile.num_devices} devices, expected "
                f"{self.num_devices}"
            )
        self.profile = profile

    # Step-3 ---------------------------------------------------------------
    def plan(self) -> GEMPlan:
        if self.profile is None:
            raise RuntimeError("set_profile() must run before plan()")
        placements: list[Placement] = []
        results: list[SearchResult] = []
        baselines: list[float] = []
        linear = linear_placement(self.num_experts, self.num_devices)
        for collector in self.collectors:
            trace = collector.trace(window=self.config.trace_length)
            res = gem_place(trace, self.profile, self.config)
            placements.append(res.placement)
            results.append(res)
            baselines.append(score(trace, self.profile, linear))
        return GEMPlan(placements, results, baselines)

    def plan_layer(self, layer: int) -> SearchResult:
        if self.profile is None:
            raise RuntimeError("set_profile() must run before plan_layer()")
        trace = self.collectors[layer].trace(window=self.config.trace_length)
        return gem_place(trace, self.profile, self.config)

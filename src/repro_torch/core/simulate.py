"""Trace-replay serving simulator (the paper's evaluation harness, §4–§5).

Given per-layer expert traces, a fleet variability profile, and a placement
per layer, the simulator computes the per-engine-step latency

    step_latency(t) = Σ_layers  max_g C_g(n_g(M_layer, t))  +  other_time

where ``other_time`` covers attention + norm + collective time per step that
is placement-independent. From the step latencies it derives the paper's two
figures of merit:

  * **end-to-end latency** (Eq. 2) of each request — sum of the step latencies
    over the request's decode lifetime;
  * **TPOT percentiles** (Eq. 3/4) — the step-latency distribution itself
    (one output token per in-flight request per step).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .score import per_step_latency
from .types import ExpertTrace, Placement, VariabilityProfile

__all__ = ["SimulationResult", "simulate_serving", "latency_reduction"]


@dataclasses.dataclass
class SimulationResult:
    step_latencies: np.ndarray  # (T,) seconds
    e2e_latencies: np.ndarray  # (R,) per-request end-to-end seconds
    moe_time: float
    other_time: float

    @property
    def total_time(self) -> float:
        return float(self.step_latencies.sum())

    @property
    def mean_e2e(self) -> float:
        return float(self.e2e_latencies.mean())

    def tpot_percentile(self, q: float) -> float:
        return float(np.quantile(self.step_latencies, q))

    @property
    def mean_tpot(self) -> float:
        return float(self.step_latencies.mean())

    def summary(self) -> dict:
        return {
            "total_s": self.total_time,
            "mean_e2e_s": self.mean_e2e,
            "mean_tpot_s": self.mean_tpot,
            "p90_tpot_s": self.tpot_percentile(0.90),
            "p95_tpot_s": self.tpot_percentile(0.95),
            "p99_tpot_s": self.tpot_percentile(0.99),
        }


def simulate_serving(
    layer_traces: list[ExpertTrace],
    profile: VariabilityProfile,
    placements: list[Placement],
    *,
    other_time_per_step: float = 0.0,
    output_lengths: np.ndarray | None = None,
) -> SimulationResult:
    """Replay the traces and aggregate straggler latencies.

    ``output_lengths`` (R,) gives each request's decode length in steps; each
    request's e2e latency is the sum of step latencies over its lifetime
    (requests are assumed admitted at step 0, matching the paper's fixed-batch
    measurement harness). Defaults to all requests living the whole trace.
    """
    if len(layer_traces) != len(placements):
        raise ValueError("need one placement per MoE layer")
    T = layer_traces[0].num_steps
    step = np.zeros(T, dtype=np.float64)
    for trace, placement in zip(layer_traces, placements):
        step += per_step_latency(trace, profile, placement)
    moe_time = float(step.sum())
    step += other_time_per_step

    if output_lengths is None:
        output_lengths = np.asarray([T])
    cum = np.concatenate([[0.0], np.cumsum(step)])
    lengths = np.clip(np.asarray(output_lengths, dtype=np.int64), 1, T)
    e2e = cum[lengths]
    return SimulationResult(
        step_latencies=step,
        e2e_latencies=e2e,
        moe_time=moe_time,
        other_time=float(other_time_per_step) * T,
    )


def latency_reduction(baseline: SimulationResult, improved: SimulationResult) -> float:
    """Paper's headline metric: % end-to-end latency reduction vs baseline."""
    return 100.0 * (1.0 - improved.mean_e2e / baseline.mean_e2e)

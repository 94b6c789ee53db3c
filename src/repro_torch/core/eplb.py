"""Baseline placement policies (paper §4.3).

  * ``linear_placement`` — vLLM default: expert ``i`` → device ``i // (E/G)``.
  * ``eplb_placement``   — vLLM's Expert-Parallel Load Balancer: sums token
    counts across the trace window and greedily balances *token counts*
    (largest-processing-time-first bin packing with equal per-device expert
    capacity). Variability-blind and per-step-blind: it sees neither device
    speed differences nor temporal co-activation — exactly the two gaps GEM
    closes.

``PeriodicEPLB`` reproduces the online behaviour: rebalance every
``interval`` engine steps from the trailing window of router statistics.
"""
from __future__ import annotations

import numpy as np

from .types import ExpertTrace, Placement

__all__ = ["linear_placement", "eplb_placement", "PeriodicEPLB"]


def linear_placement(num_experts: int, num_devices: int) -> Placement:
    return Placement.linear(num_experts, num_devices)


def eplb_placement(trace: ExpertTrace, num_devices: int) -> Placement:
    """LPT greedy token-count balancing over the summed trace."""
    totals = trace.counts.sum(axis=0).astype(np.float64)  # (E,)
    E = trace.num_experts
    cap = E // num_devices
    order = np.argsort(-totals, kind="stable")
    load = np.zeros(num_devices, dtype=np.float64)
    count = np.zeros(num_devices, dtype=np.int64)
    e2d = np.empty(E, dtype=np.int32)
    for e in order:
        eligible = count < cap
        g = int(np.where(eligible, load, np.inf).argmin())
        e2d[e] = g
        load[g] += totals[e]
        count[g] += 1
    return Placement(e2d, num_devices)


class PeriodicEPLB:
    """Online EPLB: re-derive the placement from a trailing trace window."""

    def __init__(self, num_experts: int, num_devices: int, interval: int = 32,
                 window: int = 64):
        self.num_experts = num_experts
        self.num_devices = num_devices
        self.interval = interval
        self.window = window
        self._history: list[np.ndarray] = []
        self._steps = 0
        self.placement = linear_placement(num_experts, num_devices)
        self.rebalances = 0

    def observe(self, step_counts: np.ndarray) -> Placement:
        """Feed one step of per-expert token counts; maybe rebalance."""
        self._history.append(np.asarray(step_counts, dtype=np.int64))
        if len(self._history) > self.window:
            self._history.pop(0)
        self._steps += 1
        if self._steps % self.interval == 0 and self._history:
            trace = ExpertTrace(np.stack(self._history))
            self.placement = eplb_placement(trace, self.num_devices)
            self.rebalances += 1
        return self.placement

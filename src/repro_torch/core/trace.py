"""Step-1: expert-utilization trace collection (paper §3.3.1).

The MoE router already computes top-k expert ids for every token at every
step; the collector just bins them. ``record_routing`` accepts the raw
(token, k) id matrix straight from the router (the serving-engine hook), and
``record`` accepts pre-binned per-expert counts (the simulator path).

The paper's key finding (Fig. 10): a 16-step window captures both consistent
and temporal experts; performance saturates there across models, so
:class:`~repro.core.types.GEMConfig` defaults ``trace_length=16``.
"""
from __future__ import annotations

import numpy as np

from .types import ExpertTrace

__all__ = ["TraceCollector"]


class TraceCollector:
    """Ring-buffer of per-step per-expert token counts for one MoE layer."""

    def __init__(self, num_experts: int, capacity: int = 4096):
        self.num_experts = num_experts
        self.capacity = capacity
        self._buf = np.zeros((capacity, num_experts), dtype=np.int64)
        self._len = 0
        self._head = 0
        self.total_steps = 0

    @property
    def num_steps(self) -> int:
        return self._len

    def record(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts, dtype=np.int64)
        if counts.shape != (self.num_experts,):
            raise ValueError(
                f"expected ({self.num_experts},) counts, got {counts.shape}"
            )
        self._buf[self._head] = counts
        self._head = (self._head + 1) % self.capacity
        self._len = min(self._len + 1, self.capacity)
        self.total_steps += 1

    def record_routing(self, expert_ids: np.ndarray) -> None:
        """Bin raw router output: (tokens, k) int expert ids for one step."""
        ids = np.asarray(expert_ids).reshape(-1)
        counts = np.bincount(ids, minlength=self.num_experts)
        self.record(counts[: self.num_experts])

    def trace(self, window: int | None = None) -> ExpertTrace:
        """Return the most recent ``window`` steps (default: everything)."""
        if self._len == 0:
            raise ValueError("no steps recorded")
        window = self._len if window is None else min(window, self._len)
        # unwrap the ring buffer, newest-last
        if self._len < self.capacity:
            data = self._buf[: self._len]
        else:
            data = np.concatenate(
                [self._buf[self._head :], self._buf[: self._head]], axis=0
            )
        return ExpertTrace(data[-window:].copy())

    def reset(self) -> None:
        self._len = 0
        self._head = 0

"""Replication plane: its budget and split policy.

For now this holds only :class:`ReplicationConfig`, a verbatim copy of the
JAX package's (``repro/replication/types.py``), so that
``EngineConfig.replication`` exists. The serving engine refuses
``replica_slots > 0`` with ``NotImplementedError`` until the replicated
placements, the replica split and the pool install are ported.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ReplicationConfig"]


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Budget + split policy of the replication plane."""

    replica_slots: int = 0  # extra physical slots per device (HBM budget)
    # derive replica_slots from the serving engine's HBM headroom instead
    # of the hand constant above: the engine subtracts its paged-KV-pool
    # bytes from ``EngineConfig.hbm_budget_bytes`` and fits as many replica
    # slots as the remainder holds (serving.kv_cache.replica_slots_for_
    # headroom) — replication and KV paging share one memory budget
    auto_slots: bool = False
    pattern_period: int = 16  # replica-split table length P (rank mod P)
    # devices whose relative speed (vs the fleet mean) falls below this get
    # zero token share on multi-copy experts — "never replicate onto the
    # slowest GPUs"; single-copy experts are unaffected (their tokens have
    # nowhere else to go)
    exclude_speed_below: float = 0.92
    consistent_only: bool = True  # replicate consistent experts first
    refine: bool = True  # speed-aware swap refinement after the GEM search
    max_refine_swaps: int = 64

    def __post_init__(self):
        if self.replica_slots < 0:
            raise ValueError("replica_slots must be >= 0")
        if self.pattern_period < 1:
            raise ValueError("pattern_period must be >= 1")

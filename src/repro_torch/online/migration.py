"""Migration plane: its budget and interconnect parameters.

For now this holds only :class:`MigrationConfig`, a verbatim copy of the
JAX package's (``repro/online/migration.py``): the serving engine prices
its one-shot swap with ``MigrationConfig.cost_model_for_dims``. The swap
batches, the schedule lowering and the replica moves come with the online
plane.
"""
from __future__ import annotations

import dataclasses

from ..core.latency_model import MigrationCostModel

__all__ = ["MigrationConfig"]


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Budget + interconnect parameters of the migration plane."""

    max_moves_per_step: int = 2  # expert-weight rows rewritten per step (≥2)
    bandwidth: float = 450e9  # interconnect bytes/s (NVLink4-class)
    base_overhead: float = 20e-6  # per-batch launch overhead (s)
    # fraction of a collective batch's transfer time that hides behind the
    # step's decode compute: the double-buffered row copy overlaps the MoE
    # GEMMs, so only the non-overlappable tail is charged to the step
    # (0.0 = fully serialized, the host-path assumption)
    overlap_fraction: float = 0.0
    # learn the interconnect bandwidth from measured collective traffic
    # (BandwidthEstimator EWMA) instead of trusting the configured value
    calibrate_bandwidth: bool = False

    def __post_init__(self):
        if self.max_moves_per_step < 2:
            raise ValueError(
                "max_moves_per_step must be ≥ 2 (one swap rewrites two rows)"
            )
        if not 0.0 <= self.overlap_fraction <= 1.0:
            raise ValueError("overlap_fraction must be in [0, 1]")

    def cost_model(self, expert_bytes: float) -> MigrationCostModel:
        return MigrationCostModel(
            expert_bytes=expert_bytes, bandwidth=self.bandwidth,
            base_overhead=self.base_overhead,
        )

    def cost_model_for_dims(
        self, d_model: int, expert_d_ff: int, *, bytes_per_param: int = 2
    ) -> MigrationCostModel:
        """Cost model priced from expert dims — the one place the
        3·D·F weight-size formula lives is ``for_expert_dims``."""
        return MigrationCostModel.for_expert_dims(
            d_model, expert_d_ff, bytes_per_param=bytes_per_param,
            bandwidth=self.bandwidth, base_overhead=self.base_overhead,
        )

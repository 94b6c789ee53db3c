"""Online adaptation plane: drift → plan-diff → budgeted-swap pipeline.

GEM's Step-1 trace and Step-2 profile go stale in production — the task mix
shifts and devices slow down mid-run — so this subsystem closes the loop
around the placement instead of planning once:

  * :mod:`repro.online.drift` — EWMA load-distribution divergence (KL/χ²)
    against the planning-time trace, and per-device observed-vs-profiled
    latency ratios that both detect a drifting device and repair its curve.
  * :mod:`repro.online.migration` — diffs the live placement against a
    fresh plan, decomposes the delta's slot permutation into two-slot swaps
    (cycle decomposition), and packs them into per-step batches bounded by
    ``max_moves_per_step``, each priced by the interconnect cost model.
    Replicated layouts migrate with *one-row broadcast* moves instead
    (``plan_replica_migration``): a copy instantiation writes one weight
    row — cheaper than a swap cycle — so replica add/drop are first-class
    budgeted moves and the controller can grow/shrink replicas under drift.
    ``migration_cycles`` exposes the permutation delta per cycle for the
    controller's budget-aware truncation (migrate only the profitable
    prefix of a gate-rejected plan). Under a live mesh,
    ``lower_collective_step`` lowers either batch type to per-layer
    :class:`~repro.online.migration.CollectiveSchedule`\\ s — ppermute
    rounds + local row copies — that :mod:`repro.kernels.collective`
    executes on the expert-sharded weights, yielding *measured*
    interconnect traffic per batch.
  * :mod:`repro.online.controller` — the per-step control loop gluing the
    two to the :class:`~repro.core.gem.GEMPlanner`: warm-up plan when the
    collectors fill, drift-triggered (never timer-triggered) replans after
    that, a net-benefit go/no-go per migration, and one swap batch emitted
    per engine step for the data plane to mirror.
  * :mod:`repro.online.replay` — the closed-loop shift-scenario harness the
    ``fig20_online`` benchmark and regression tests replay traces through.

The serving engine's ``online`` mode drives the same controller against the
real JAX data plane, applying each batch as a partial per-layer expert-
weight permutation between decode steps.
"""
from .controller import OnlineConfig, OnlineController, StepDecision
from .drift import DriftConfig, LoadDriftDetector, VariabilityDriftDetector
from .migration import (
    CollectiveSchedule,
    MigrationConfig,
    MigrationCycle,
    MigrationSchedule,
    MigrationStep,
    ReplicaMigrationSchedule,
    ReplicaMigrationStep,
    ReplicaMove,
    RowTransfer,
    SlotSwap,
    dense_step_sources,
    lower_collective_step,
    lower_row_sources,
    migration_cycles,
    plan_migration,
    plan_replica_migration,
    replica_install_phases,
    replica_source_permutation,
    swap_permutation,
)
from .replay import (
    ReplayResult,
    ServeScenario,
    ShiftScenario,
    replay_online,
    serve_scenario,
)

__all__ = [
    "DriftConfig",
    "LoadDriftDetector",
    "VariabilityDriftDetector",
    "CollectiveSchedule",
    "MigrationConfig",
    "MigrationCycle",
    "MigrationSchedule",
    "MigrationStep",
    "ReplicaMigrationSchedule",
    "ReplicaMigrationStep",
    "ReplicaMove",
    "RowTransfer",
    "SlotSwap",
    "dense_step_sources",
    "lower_collective_step",
    "lower_row_sources",
    "migration_cycles",
    "plan_migration",
    "plan_replica_migration",
    "replica_install_phases",
    "replica_source_permutation",
    "swap_permutation",
    "OnlineConfig",
    "OnlineController",
    "StepDecision",
    "ShiftScenario",
    "ServeScenario",
    "ReplayResult",
    "replay_online",
    "serve_scenario",
]

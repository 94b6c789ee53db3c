"""GEM core: variability-aware expert-to-device mapping (host-side numpy).

The port's copy of ``repro/core``: every module here is a verbatim copy of
its namesake in the JAX package, so the planner is bit-equal across the two
packages on the same inputs (``tests/test_torch_core.py`` holds both). The
copies keep their docstrings, which name the reference package's modules.

  * Step-1 trace collection  — :mod:`repro_torch.core.trace`
  * Step-2 variability profiling — :mod:`repro_torch.core.profiling`
  * Step-3 placement search — :mod:`repro_torch.core.search` (scored by
    :mod:`repro_torch.core.score`, Eq. 1)
  * Step-4 deployment artifacts — :class:`repro_torch.core.gem.GEMPlan`
  * Baselines (linear / EPLB) — :mod:`repro_torch.core.eplb`
  * Evaluation harness — :mod:`repro_torch.core.simulate`,
    :mod:`repro_torch.core.workload`, :mod:`repro_torch.core.variability`
"""
from .classify import (
    classify_experts,
    correlated_groups,
    correlation_matrix,
    group_spread,
)
from .eplb import PeriodicEPLB, eplb_placement, linear_placement
from .gem import GEMPlan, GEMPlanner
from .latency_model import (
    BandwidthEstimator,
    DeviceFleet,
    MigrationCostModel,
    StaircaseLatencyModel,
    dense_grid,
    tile_boundary_grid,
)
from .profiling import (
    ProfilingResult,
    profile_fleet,
    profile_fleet_dense,
    profiling_cost_seconds,
    simulator_measure_fn,
)
from .score import (
    IncrementalScorer,
    migration_net_benefit,
    per_step_latency,
    score,
    step_cost_matrix,
    step_token_matrix,
)
from .search import SearchResult, gem_place, initial_mapping, refine
from .simulate import SimulationResult, latency_reduction, simulate_serving
from .trace import TraceCollector
from .types import ExpertTrace, GEMConfig, Placement, VariabilityProfile
from .variability import (
    L40_FLEET,
    MI300X_FLEET,
    PLATFORMS,
    TRAINIUM_FLEET,
    FleetDistribution,
    expected_gap_curve,
    setup_speeds,
)
from .workload import WorkloadSpec, generate_layer_traces, generate_trace

__all__ = [
    # types
    "ExpertTrace", "GEMConfig", "Placement", "VariabilityProfile",
    # step 1
    "TraceCollector",
    # step 2
    "ProfilingResult", "profile_fleet", "profile_fleet_dense",
    "profiling_cost_seconds", "simulator_measure_fn",
    "StaircaseLatencyModel", "DeviceFleet", "tile_boundary_grid", "dense_grid",
    # step 3
    "IncrementalScorer", "score", "per_step_latency", "step_cost_matrix",
    "step_token_matrix",
    "SearchResult", "gem_place", "initial_mapping", "refine",
    # online adaptation hooks
    "MigrationCostModel", "migration_net_benefit", "BandwidthEstimator",
    # step 4 / orchestration
    "GEMPlan", "GEMPlanner",
    # baselines
    "linear_placement", "eplb_placement", "PeriodicEPLB",
    # analysis
    "classify_experts", "correlation_matrix", "correlated_groups",
    "group_spread",
    # evaluation
    "SimulationResult", "simulate_serving", "latency_reduction",
    "WorkloadSpec", "generate_trace", "generate_layer_traces",
    "FleetDistribution", "L40_FLEET", "TRAINIUM_FLEET", "MI300X_FLEET",
    "PLATFORMS", "setup_speeds", "expected_gap_curve",
]

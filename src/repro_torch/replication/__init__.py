"""Expert replication plane: hot-expert copies with speed-proportional
token splitting.

GEM's permutation planner hits a floor when one consistent expert is hot
enough to saturate any device it lands on — no permutation removes that
straggler. This subsystem layers multi-copy experts on the single-copy
machinery end to end:

  * :mod:`repro.replication.types` — :class:`ReplicatedPlacement` (a
    device-major slot layout where experts may occupy several slots, with
    speed-proportional per-slot token shares baked in) and
    :class:`ReplicationConfig` (slot budget, split pattern period, the
    "never replicate onto the slowest GPUs" speed floor).
  * :mod:`repro.replication.score` — Eq. 1 generalized: a replicated
    expert is costed as its load split across copies weighted by each host
    device's profiled speed; reduces exactly to the single-copy score at
    budget 0.
  * :mod:`repro.replication.planner` — consistent-expert copy selection
    under the budget, the unmodified GEM search over the expanded slot
    space (uniform-split pseudo-experts), and a speed-aware refinement
    under the true replicated objective.

The data plane consumes a ``ReplicatedPlacement`` as two artifacts: the
slot→expert weight-pool gather (``apply_placement`` with repeated indices)
and the (E_v, P) ``replica_table`` the dispatch plane uses to split each
expert's token stream deterministically across its copies
(:func:`repro.models.dispatch.build_dispatch`). The online plane migrates
between replicated layouts with one-row broadcast moves
(:func:`repro.online.migration.plan_replica_migration`).
"""
from .planner import (
    ReplicatedSearchResult,
    choose_replica_counts,
    expanded_trace,
    plan_replicated,
    plan_replicated_layers,
    refine_replicated,
)
from .score import (
    replica_fetch_rows,
    replicated_per_device_tokens,
    replicated_per_step_latency,
    replicated_score,
    replica_slot_loads,
    replicated_step_cost_matrix,
    replicated_step_token_matrix,
    shed_adjusted_step_cost_matrix,
    shed_device_deltas,
    shed_gate_decisions,
    simulate_shed_pass,
)
from .types import ReplicatedPlacement, ReplicationConfig

__all__ = [
    "ReplicationConfig",
    "ReplicatedPlacement",
    "ReplicatedSearchResult",
    "choose_replica_counts",
    "expanded_trace",
    "plan_replicated",
    "plan_replicated_layers",
    "refine_replicated",
    "replica_fetch_rows",
    "replica_slot_loads",
    "replicated_per_device_tokens",
    "replicated_per_step_latency",
    "replicated_score",
    "replicated_step_cost_matrix",
    "replicated_step_token_matrix",
    "shed_adjusted_step_cost_matrix",
    "shed_device_deltas",
    "shed_gate_decisions",
    "simulate_shed_pass",
]

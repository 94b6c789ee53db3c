"""Shift-scenario trace replay: the online plane's evaluation harness.

Extends :mod:`repro.core.simulate` from static placement replay to the
*closed-loop* setting: each step's per-layer counts are (1) priced against
the **true** fleet profile under the live placement — the true profile can
change mid-run (an injected power cap) and may differ from what the
controller believes — and (2) fed to an :class:`~repro.online.controller.
OnlineController`, whose migration batches mutate the live placement and
whose migration cost is charged to the very step that performs the swap.

This is the harness behind ``benchmarks/fig20_online.py``'s two shift
scenarios (task-mix change; mid-run device slowdown) and the regression
tests; the serving engine runs the same controller against the real JAX
data plane.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.gem import GEMPlanner
from ..core.types import GEMConfig, VariabilityProfile
from ..telemetry import (
    AttributionAccumulator,
    RegretTracker,
    Telemetry,
    attribute_step,
)
from ..telemetry.regret import record_step_metrics
from .controller import OnlineConfig, OnlineController

__all__ = [
    "ShiftScenario",
    "ReplayResult",
    "ServeScenario",
    "replay_online",
    "serve_scenario",
]


@dataclasses.dataclass
class ShiftScenario:
    """A serving run whose workload and/or fleet changes mid-run.

    ``counts`` (T, L, E): per-step per-layer per-expert token counts (the
    concatenation of the phases' traces). ``profiles`` maps a start step to
    the *true* fleet profile from that step on (step 0 must be present);
    the controller's believed profile starts as ``profiles[0]`` and only
    changes if its variability-drift detector repairs it.
    """

    name: str
    counts: np.ndarray
    profiles: dict[int, VariabilityProfile]
    other_time_per_step: float = 0.0

    def __post_init__(self):
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if self.counts.ndim != 3:
            raise ValueError("counts must be (steps, layers, experts)")
        if 0 not in self.profiles:
            raise ValueError("profiles must define the step-0 true profile")

    @property
    def num_steps(self) -> int:
        return int(self.counts.shape[0])

    def true_profile_at(self, step: int) -> VariabilityProfile:
        start = max(s for s in self.profiles if s <= step)
        return self.profiles[start]


@dataclasses.dataclass
class ReplayResult:
    policy: str
    step_latencies: np.ndarray  # (T,) seconds, migration cost included
    migration_costs: np.ndarray  # (T,) seconds, the charged component
    moves_per_step: np.ndarray  # (T,) expert-weight rows rewritten
    replans: list[dict]
    total_migration_cost: float
    # per-step straggler attribution aggregate (repro.telemetry) — priced
    # with each step's *true* profile under the live placement
    attribution: AttributionAccumulator | None = None
    # per-step placement regret vs the hindsight oracle (keeps the full
    # series — fig20's regret-collapse gate reads it)
    regret: RegretTracker | None = None

    @property
    def total_time(self) -> float:
        return float(self.step_latencies.sum())

    @property
    def mean_tpot(self) -> float:
        return float(self.step_latencies.mean())

    def tpot_percentile(self, q: float) -> float:
        return float(np.quantile(self.step_latencies, q))

    def e2e_latencies(
        self,
        output_lengths: np.ndarray,
        arrival_steps: np.ndarray | None = None,
    ) -> np.ndarray:
        """Per-request e2e seconds: request ``r`` decodes for
        ``output_lengths[r]`` steps starting at ``arrival_steps[r]``
        (default 0 — the Fig. 15 fixed-batch accounting). Staggered arrivals
        model a continuously loaded fleet, so a mid-run shift is felt by the
        requests that actually live through it."""
        T = len(self.step_latencies)
        cum = np.concatenate([[0.0], np.cumsum(self.step_latencies)])
        lengths = np.asarray(output_lengths, dtype=np.int64)
        starts = (
            np.zeros_like(lengths)
            if arrival_steps is None
            else np.asarray(arrival_steps, dtype=np.int64)
        )
        starts = np.clip(starts, 0, T - 1)
        ends = np.clip(starts + np.maximum(lengths, 1), 1, T)
        return cum[ends] - cum[starts]

    def mean_e2e(
        self,
        output_lengths: np.ndarray,
        arrival_steps: np.ndarray | None = None,
    ) -> float:
        return float(self.e2e_latencies(output_lengths, arrival_steps).mean())

    def summary(
        self,
        output_lengths: np.ndarray,
        arrival_steps: np.ndarray | None = None,
    ) -> dict:
        out = {
            "policy": self.policy,
            "total_s": self.total_time,
            "mean_e2e_s": self.mean_e2e(output_lengths, arrival_steps),
            "mean_tpot_s": self.mean_tpot,
            "p99_tpot_s": self.tpot_percentile(0.99),
            "migration_s": self.total_migration_cost,
            "max_moves_per_step": int(self.moves_per_step.max(initial=0)),
            "replans": len(self.replans),
        }
        if self.attribution is not None and self.attribution.steps > 0:
            summ = self.attribution.summary()
            # rows stay scalar-valued: the per-device tally is on the
            # accumulator for telemetry_report-style consumers
            out.update(
                (k, v) for k, v in summ.items() if isinstance(v, float)
            )
        if self.regret is not None and self.regret.steps > 0:
            out.update(self.regret.summary())
        return out

    def regret_series(self) -> np.ndarray:
        """(T,) per-step regret seconds (zeros when regret was off)."""
        if self.regret is None or self.regret.series is None:
            return np.zeros(len(self.step_latencies))
        return np.asarray([sr.regret_s for sr in self.regret.series])


@dataclasses.dataclass
class ServeScenario:
    """A live-traffic serving run with timed mid-run fleet changes.

    The engine-level sibling of :class:`ShiftScenario`: instead of a
    pre-recorded count trace, ``specs`` is a timestamped arrival stream
    (:class:`~repro.serving.arrivals.RequestSpec`, e.g. from
    ``generate_arrivals`` — a task-mix shift is encoded in the stream
    itself via ``mix_shift``), and ``profile_schedule`` maps an *engine
    step* to the true fleet profile injected from that step on
    (``ServingEngine.set_true_profile``). The control plane keeps planning
    on its belief until its detectors catch the change — the same
    closed-loop semantics as :func:`replay_online`, but through the real
    JAX data plane with continuous batching, paged KV, and per-request
    SLO accounting.
    """

    name: str
    specs: list  # of repro.serving.arrivals.RequestSpec
    profile_schedule: dict[int, VariabilityProfile] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        self.specs = sorted(self.specs, key=lambda s: s.arrival_time)


def serve_scenario(engine, scenario: ServeScenario, *,
                   max_steps: int = 100_000) -> list:
    """Run a :class:`ServeScenario` through a ``ServingEngine``.

    Identical to ``engine.serve(scenario.specs)`` except that the true
    profile flips at the scheduled engine steps mid-drain. Returns the
    engine's finished-request list; SLO percentiles come from
    ``engine.latency_report()``. (``engine`` is duck-typed to keep this
    module importable before :mod:`repro.serving` — which imports the
    online plane — finishes loading.)
    """
    injections = sorted(scenario.profile_schedule.items())
    pending = list(scenario.specs)
    steps = 0
    while (pending or engine.arrivals or engine.scheduler.has_work()) \
            and steps < max_steps:
        while injections and engine.step_count >= injections[0][0]:
            engine.set_true_profile(injections[0][1])
            injections.pop(0)
        if pending:
            # hand the stream over in one batch; serve() merges + sorts
            engine.serve(pending, max_steps=0)
            pending = []
        engine.step()
        steps += 1
    return engine.finished


def replay_online(
    scenario: ShiftScenario,
    believed_profile: VariabilityProfile,
    gem_config: GEMConfig,
    online_config: OnlineConfig,
    *,
    expert_bytes: float,
    telemetry: Telemetry | None = None,
) -> ReplayResult:
    """Run one policy through a shift scenario, closed-loop.

    Per step: price the step with the scenario's *true* profile under the
    live placement, hand the counts + observed per-device times to the
    controller, mirror its migration batch onto the live placement list, and
    charge its migration cost to the step. A ``telemetry`` hub makes the
    run exportable: the controller's audit events land on it and every
    step's regret is mirrored as metrics + a timeline instant.
    """
    T, L, E = scenario.counts.shape
    G = believed_profile.num_devices
    planner = GEMPlanner(E, G, L, gem_config)
    planner.set_profile(believed_profile)
    tel = telemetry if telemetry is not None else Telemetry(enabled=False)
    controller = OnlineController(
        planner,
        online_config.migration.cost_model(expert_bytes),
        online_config,
        telemetry=tel,
    )
    step_lat = np.zeros(T)
    mig_cost = np.zeros(T)
    moves = np.zeros(T, dtype=np.int64)
    attribution = AttributionAccumulator(G)
    regret = RegretTracker(E, G, keep_series=True)
    for t in range(T):
        counts = scenario.counts[t]
        true_profile = scenario.true_profile_at(t)
        # replica-split aware: in replicated mode the per-device loads come
        # from the speed-proportional shares, not a one-hot placement
        mat = controller.cost_matrix(counts, true_profile)
        observed = mat.sum(axis=0)  # (G,) per-device time, summed over layers
        lat = float(mat.max(axis=1).sum()) + scenario.other_time_per_step
        attribution.observe(
            attribute_step(controller.token_matrix(counts), true_profile)
        )
        # regret reads the pre-decision state (like the engine): the MoE
        # cost actually paid this step vs the hindsight oracle, classified
        # by whether the controller had already committed to a plan
        sr = regret.observe(
            counts,
            true_profile,
            float(mat.max(axis=1).sum()),
            placements=(
                None if controller.replicated
                else controller.current_placements
            ),
            lagging=controller.adapting,
        )
        record_step_metrics(tel, sr, t)
        decision = controller.observe_step(counts, observed)
        if decision.migration_step is not None:
            lat += decision.migration_cost
            mig_cost[t] = decision.migration_cost
            moves[t] = decision.migration_step.num_moves
        step_lat[t] = lat
    return ReplayResult(
        policy=online_config.policy,
        step_latencies=step_lat,
        migration_costs=mig_cost,
        moves_per_step=moves,
        replans=controller.replans,
        total_migration_cost=controller.total_migration_cost,
        attribution=attribution,
        regret=regret,
    )

"""Online adaptation controller: drift → plan diff → budgeted swap pipeline.

:class:`OnlineController` is the control loop both the serving engine and
the trace-replay benchmark drive, one call per engine step:

    decision = controller.observe_step(counts, observed_device_latency)

Each call (1) feeds the step's per-layer router counts into the
:class:`~repro.core.gem.GEMPlanner` trace collectors and the
:class:`~repro.online.drift.LoadDriftDetector`; (2) compares the observed
per-device MoE time against the profile's prediction via the
:class:`~repro.online.drift.VariabilityDriftDetector`, rescaling the
believed profile's curves in place when a device departs them; (3) replans
when warranted — the *first* plan once the collectors fill (warm-up), then
drift-triggered replans, never on a step counter; (4) diffs the fresh plan
against the live placement, prices the delta with the migration cost model,
skips it when :func:`~repro.core.score.migration_net_benefit` says the
improvement cannot amortise the weight traffic, and otherwise drains the
budgeted :class:`~repro.online.migration.MigrationSchedule` one
:class:`~repro.online.migration.MigrationStep` per call.

The returned :class:`StepDecision` carries everything the data plane must
mirror: the swap batch to apply to the stacked weights + router tables and
the migration cost to charge to this step's latency. The controller never
touches jax — it is host-side numpy, like the rest of the control plane.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..core.eplb import eplb_placement, linear_placement
from ..core.gem import GEMPlanner
from ..core.latency_model import BandwidthEstimator, MigrationCostModel
from ..core.score import (
    migration_net_benefit,
    score,
    shed_decisions as _shed_decisions,
    step_cost_matrix,
    step_token_matrix,
)
from ..core.search import refine
from ..core.types import ExpertTrace, Placement, VariabilityProfile
from ..replication import (
    ReplicatedPlacement,
    ReplicationConfig,
    plan_replicated,
    replicated_score,
    replicated_step_cost_matrix,
    replicated_step_token_matrix,
    shed_gate_decisions,
)
from ..telemetry import Telemetry
from ..telemetry.audit import canonical, decision_payload
from .drift import DriftConfig, LoadDriftDetector, VariabilityDriftDetector
from .migration import (
    MigrationConfig,
    MigrationStep,
    ReplicaMigrationStep,
    ReplicaMove,
    dense_step_sources,
    migration_cycles,
    plan_migration,
    plan_replica_migration,
    replica_source_permutation,
)

__all__ = ["OnlineConfig", "StepDecision", "OnlineController"]


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Policy + cadence of the online adaptation plane."""

    policy: str = "gem"  # gem | eplb | linear (replan policy)
    online: bool = True  # False ⇒ plan exactly once (one-shot baseline)
    drift: DriftConfig = DriftConfig()
    migration: MigrationConfig = MigrationConfig()
    replication: ReplicationConfig = ReplicationConfig()  # replica_slots>0
    # ⇒ replans produce ReplicatedPlacements and migrations are one-row
    # broadcast batches (replica add/drop as first-class moves)
    replan_cooldown: int = 32  # min steps between drift replans
    payback_horizon: int = 1024  # steps a migration's gain must amortise over
    unbudgeted_first_swap: bool = False  # True ⇒ one-shot semantics for the
    # warm-up plan: the whole delta lands in one step (still priced),
    # matching the pre-online engine's single apply_placement. The online
    # mode keeps it False so *every* batch honours the budget.
    truncate_rejected: bool = True  # when the net-benefit gate rejects a
    # full migration, score its cycles individually and migrate the
    # profitable prefix instead of dropping the whole plan
    staggered_replan: bool = False  # load-drift replans re-search only the
    # layers whose own divergence crossed the threshold (plan_layer per
    # layer), freezing the rest at their live layout — a concentrated
    # single-layer shift then migrates one layer's delta instead of
    # paying whole-model plan cost and payload. Warmup and
    # variability-drift replans stay full (they invalidate every layer).

    def __post_init__(self):
        if self.policy not in ("gem", "eplb", "linear"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.replication.replica_slots > 0 and self.policy != "gem":
            raise ValueError(
                "expert replication needs the gem policy (linear/eplb have "
                "no replication-aware search)"
            )


@dataclasses.dataclass
class StepDecision:
    """What the data plane must do after this engine step."""

    replanned: bool = False
    reason: str | None = None  # "warmup" | "load-drift" | "variability-drift"
    migration_step: MigrationStep | ReplicaMigrationStep | None = None
    migration_cost: float = 0.0
    migration_skipped: bool = False  # replan happened but didn't pay back
    migration_truncated: bool = False  # gate rejected the full plan; only
    # the profitable cycle prefix migrated
    profile_rescaled: bool = False


class OnlineController:
    """Drives drift detection, replanning, and budgeted migration."""

    def __init__(
        self,
        planner: GEMPlanner,
        cost_model: MigrationCostModel,
        config: OnlineConfig = OnlineConfig(),
        *,
        initial_placements: list[Placement] | None = None,
        initial_rplacements: list[ReplicatedPlacement] | None = None,
        telemetry: Telemetry | None = None,
    ):
        if planner.profile is None:
            raise ValueError("planner must have a profile (set_profile)")
        self.planner = planner
        self.cost_model = cost_model
        self.config = config
        # decision counters/events (replans, gate rejections, truncations,
        # drift fires) flow through the telemetry hub; a disabled instance
        # keeps the counters live without event recording
        self.telemetry = (
            telemetry if telemetry is not None else Telemetry(enabled=False)
        )
        L, Ev, G = planner.num_layers, planner.num_experts, planner.num_devices
        self.replicated = config.replication.replica_slots > 0
        if self.replicated:
            # replicated mode: the pool carries Ev + G·replica_slots slots
            # from the start, so migrations never change the slot count
            rinitial = (
                list(initial_rplacements)
                if initial_rplacements is not None
                else [
                    ReplicatedPlacement.linear(
                        Ev, G, config.replication.replica_slots,
                        profile=planner.profile, config=config.replication,
                    )
                    for _ in range(L)
                ]
            )
            self.current_rplacements: list[ReplicatedPlacement] = rinitial
            self.slot_layouts: list[np.ndarray] = [
                rp.slot_layout() for rp in rinitial
            ]
            self.current_placements: list[Placement] = []
        else:
            initial = (
                list(initial_placements)
                if initial_placements is not None
                else [linear_placement(Ev, G) for _ in range(L)]
            )
            # physical slot→expert layout per layer — the ground truth the
            # data plane mirrors; mid-migration it is NOT canonical
            # (Placement sorts experts within a device), so Placement is
            # derived, never authoritative
            self.slot_layouts = [p.slot_to_expert() for p in initial]
            self.current_placements = initial
            self.current_rplacements = []
        self.load_detector = LoadDriftDetector(
            L, Ev, config.drift, telemetry=self.telemetry
        )
        self.var_detector = VariabilityDriftDetector(
            G, config.drift, telemetry=self.telemetry
        )
        self._pending: deque[MigrationStep] = deque()
        self._pending_unbudgeted = False
        self._step = 0
        self._last_plan_step: int | None = None
        self._deferred_replan_step: int | None = None  # drift fires schedule
        # the replan instead of running it inline: load drift waits one
        # trace window so the plan fits purely post-shift steps; variability
        # drift waits (at most) for the cooldown — it must not be dropped,
        # because the rescale resets the detector and it will never re-fire
        self._deferred_reason = ""
        self.planned = False
        # observability
        self.replans: list[dict] = []
        self.total_migration_cost = 0.0
        self.total_moves = 0
        self.max_moves_in_step = 0
        # measured-vs-modeled migration accounting (collective data plane):
        # the engine reports what each executed batch actually shipped, and
        # the estimator turns those samples into a calibrated bandwidth
        self.bandwidth_estimator = BandwidthEstimator()
        self.bandwidth_estimator.bind_telemetry(self.telemetry)
        self.migration_measurements: list[dict] = []
        self._audit_init()

    def _audit_init(self) -> None:
        """Emit the ``audit.init`` record: everything
        ``benchmarks/decision_replay.py`` needs to reconstruct this
        controller offline — configs, cost model, initial slot layouts,
        and the believed profile's curves. One instant, only recorded
        when event tracing is on."""
        prof = self.profile
        self.telemetry.instant(
            "audit.init",
            track="controller",
            config=canonical(dataclasses.asdict(self.config)),
            gem=canonical(dataclasses.asdict(self.planner.config)),
            cost_model={
                "expert_bytes": float(self.cost_model.expert_bytes),
                "bandwidth": float(self.cost_model.bandwidth),
                "base_overhead": float(self.cost_model.base_overhead),
            },
            num_layers=int(self.planner.num_layers),
            num_experts=int(self.planner.num_experts),
            num_devices=int(self.planner.num_devices),
            replicated=bool(self.replicated),
            slot_layouts=[lay.tolist() for lay in self.slot_layouts],
            profile={
                "token_counts": prof.token_counts.tolist(),
                "latencies": prof.latencies.tolist(),
                "tile_size": int(prof.tile_size),
            },
        )

    # ------------------------------------------------------------------
    @property
    def profile(self) -> VariabilityProfile:
        assert self.planner.profile is not None
        return self.planner.profile

    @property
    def migrating(self) -> bool:
        return bool(self._pending)

    @property
    def adapting(self) -> bool:
        """True while the controller has already committed to a plan it
        has not finished landing: migration batches in flight, a drift
        replan deferred behind the cooldown/window, or the warm-up trace
        still filling. The regret plane (:mod:`repro.telemetry.regret`)
        classifies a step's regret as migration lag exactly then — a
        replan *now* would not reach the oracle any sooner."""
        return (
            not self.planned
            or bool(self._pending)
            or self._deferred_replan_step is not None
        )

    @property
    def num_slots(self) -> int:
        """Physical slots per layer (E_v, plus the replica budget)."""
        return int(len(self.slot_layouts[0]))

    def dense_migration_sources(self, step) -> np.ndarray:
        """One batch as a dense (L, S) row-source map — the *scanned
        operand* form the data plane's schedule-generic executable takes
        (untouched layers are identity rows), instead of per-layer maps
        each paying their own jit. Works for both swap batches
        (:class:`MigrationStep`) and replica add/drops
        (:class:`ReplicaMigrationStep`)."""
        return dense_step_sources(
            step, self.planner.num_layers, self.num_slots
        )

    def expert_to_slot_tables(self) -> np.ndarray:
        """Router remap tables matching the physical slot layouts — what
        the data plane's router gather must use after mirroring a migration
        batch: (L, E_v) single-slot maps, or (L, E_v, P) replica-split
        tables in replicated mode."""
        L = self.planner.num_layers
        Ev = self.planner.num_experts
        if self.replicated:
            P = self.config.replication.pattern_period
            return np.stack(
                [rp.replica_table(P) for rp in self.current_rplacements]
            )
        out = np.empty((L, Ev), dtype=np.int32)
        for layer, layout in enumerate(self.slot_layouts):
            out[layer, layout] = np.arange(Ev, dtype=np.int32)
        return out

    def observe_migration_measurement(
        self,
        payload_bytes: float,
        measured_s: float,
        *,
        modeled_s: float,
        step: int | None = None,
    ) -> None:
        """Report what an executed migration batch *actually* moved.

        The engine's collective data plane calls this once per applied
        batch with the measured interconnect payload and transfer time;
        the modeled charge is recorded next to it (the measured-vs-modeled
        series ``fig22_collective`` gates on), and — when
        ``MigrationConfig.calibrate_bandwidth`` is set — the
        :class:`~repro.core.latency_model.BandwidthEstimator`'s learned
        bandwidth replaces the cost model's configured assumption, so the
        net-benefit gate prices future migrations with the fabric's
        measured throughput.
        """
        self.migration_measurements.append(
            {
                "step": self._step if step is None else step,
                "payload_bytes": float(payload_bytes),
                "measured_s": float(measured_s),
                "modeled_s": float(modeled_s),
            }
        )
        # audited: the measurement mutates controller state (bandwidth
        # estimate → cost model), so the offline replay must re-feed it
        self.telemetry.instant(
            "audit.measure", track="controller",
            **self.migration_measurements[-1],
        )
        self.telemetry.counter("migrate.model_abs_err_s").inc(
            abs(float(measured_s) - float(modeled_s))
        )
        self.bandwidth_estimator.observe(
            payload_bytes, measured_s,
            base_overhead=self.cost_model.base_overhead,
        )
        if self.config.migration.calibrate_bandwidth:
            self.cost_model = self.bandwidth_estimator.calibrated(
                self.cost_model
            )

    def cost_matrix(
        self, counts: np.ndarray, profile: VariabilityProfile
    ) -> np.ndarray:
        """(L, G) per-layer per-device MoE latencies of one step's counts
        under the live placements — replica-split aware."""
        if self.replicated:
            return replicated_step_cost_matrix(
                counts, profile, self.current_rplacements
            )
        return step_cost_matrix(counts, profile, self.current_placements)

    def token_matrix(self, counts: np.ndarray) -> np.ndarray:
        """(L, G) per-layer per-device token loads of one step's counts
        under the live placements — the straggler-attribution input
        (:mod:`repro.telemetry.attribution`), replica-split aware."""
        if self.replicated:
            return replicated_step_token_matrix(
                counts, self.planner.num_devices, self.current_rplacements
            )
        return step_token_matrix(
            counts, self.planner.num_devices, self.current_placements
        )

    def shed_decisions(
        self,
        counts: np.ndarray,
        overflow: np.ndarray,
        *,
        token_bytes: float,
        capacity: int | None = None,
        min_overflow: int = 1,
        hysteresis: float = 1.0,
        drop_penalty_s: float = 0.0,
    ) -> np.ndarray:
        """(L,) shed-enable flags for the *next* step's dispatch pass.

        Prices the shed-vs-wait gate with the controller's current
        beliefs: the believed profile, the live replica layouts, and the
        migration cost model's bandwidth — which tightens over time when
        ``migration.calibrate_bandwidth`` feeds measured transfers back
        in. With live replicated placements and the data plane's slot
        ``capacity``, the replica-exact pricing
        (:func:`repro.replication.score.shed_gate_decisions`) simulates
        the actual waterfall outcome; otherwise the single-receiver
        marginal-cost bound (:func:`repro.core.score.shed_decisions`).

        Deliberately stateless: it reads the same beliefs the replan path
        reads but mutates nothing, so interleaving shed pricing with
        placement decisions leaves the audit stream and the offline
        decision replay byte-exact. Shedding masks a straggler's queue
        *this step*; replanning still sees the un-shed loads and removes
        the imbalance itself (compose, don't compete).

        The believed costs are scaled by the variability detector's live
        per-device observed/predicted latency ratios (1.0 at rest): when
        a believed-fast device slows mid-run, its stale speed-
        proportional replica share keeps overloading it *in real time*
        while its slower-believed co-copies hold capacity slack — the
        ratio-scaled gate starts shedding into that slack steps before
        the detector fires and the replan (which resets the ratios via
        the profile repair) removes the need.
        """
        ratios = self.var_detector.ratios
        if self.replicated and capacity is not None:
            return shed_gate_decisions(
                counts,
                self.current_rplacements,
                self.profile,
                capacity,
                bandwidth=self.cost_model.bandwidth,
                token_bytes=token_bytes,
                min_overflow=min_overflow,
                hysteresis=hysteresis,
                device_scale=ratios,
                drop_penalty_s=drop_penalty_s,
            )
        return _shed_decisions(
            self.token_matrix(counts),
            overflow,
            self.profile,
            bandwidth=self.cost_model.bandwidth,
            token_bytes=token_bytes,
            min_overflow=min_overflow,
            hysteresis=hysteresis,
            device_scale=ratios,
            drop_penalty_s=drop_penalty_s,
        )

    def predicted_device_latency(self, counts: np.ndarray) -> np.ndarray:
        """(G,) per-device MoE time this step *should* take per the believed
        profile, under the live placement — the drift detector's baseline."""
        return self.cost_matrix(counts, self.profile).sum(axis=0)

    # ------------------------------------------------------------------
    def observe_step(
        self,
        counts: np.ndarray,
        observed_device_latency: np.ndarray | None = None,
    ) -> StepDecision:
        """Feed one engine step; returns the data-plane actions to mirror.

        ``counts`` (L, E_v): per-layer per-virtual-expert token counts.
        ``observed_device_latency`` (G,), optional: measured per-device MoE
        time of this step (wall-clock on hardware; the true-fleet simulation
        here). ``None`` disables variability-drift detection for the step.

        Every call is audited: an ``audit.step`` instant records the raw
        inputs next to the serialized decision, so the offline replayer
        can re-derive and byte-compare it from the JSONL alone.
        """
        counts = np.asarray(counts)
        decision = self._observe_step(counts, observed_device_latency)
        if self.telemetry.enabled:
            self.telemetry.instant(
                "audit.step",
                track="controller",
                step=self._step,
                counts=canonical(counts),
                observed=(
                    None
                    if observed_device_latency is None
                    else canonical(np.asarray(observed_device_latency))
                ),
                decision=decision_payload(decision),
            )
        return decision

    def _observe_step(
        self,
        counts: np.ndarray,
        observed_device_latency: np.ndarray | None,
    ) -> StepDecision:
        decision = StepDecision()
        for layer in range(self.planner.num_layers):
            self.planner.observe_step(layer, counts[layer])

        reason: str | None = None
        if (
            self.config.online
            and self.planned
            and observed_device_latency is not None
            and not self.migrating
        ):
            predicted = self.predicted_device_latency(counts)
            if self.var_detector.update(observed_device_latency, predicted):
                self._rescale_profile()
                decision.profile_rescaled = True
                reason = "variability-drift"
        if self.config.online and self.planned and not self.migrating:
            if self.load_detector.update(counts) and reason is None:
                reason = "load-drift"

        self._step += 1

        if self.migrating:
            self._emit_migration_step(decision)
            return decision

        if not self.planned:
            if self.planner.ready():
                self._replan(decision, "warmup")
                self._emit_migration_step(decision)
            return decision

        if reason == "variability-drift" and self._deferred_replan_step is None:
            # the workload window is still valid — only the curves changed —
            # so replan as soon as the cooldown allows (possibly right now).
            # This fire cannot be dropped: the rescale above reset the
            # detector, and with the belief repaired it never re-fires.
            self._deferred_reason = reason
            self._deferred_replan_step = (
                self._step
                if self._cooldown_elapsed()
                else self._last_plan_step + self.config.replan_cooldown
            )
        elif (
            reason == "load-drift"
            and self._deferred_replan_step is None
            and self._cooldown_elapsed()
        ):
            # defer: let a clean post-shift window fill before planning on it
            self._deferred_reason = reason
            self._deferred_replan_step = (
                self._step + self.planner.config.trace_length
            )
        if (
            self._deferred_replan_step is not None
            and self._step >= self._deferred_replan_step
        ):
            self._deferred_replan_step = None
            self._replan(decision, self._deferred_reason)
            self._emit_migration_step(decision)
        return decision

    # ------------------------------------------------------------------
    def _cooldown_elapsed(self) -> bool:
        return (
            self._last_plan_step is None
            or self._step - self._last_plan_step >= self.config.replan_cooldown
        )

    def _rescale_profile(self) -> None:
        """Repair the believed profile in place: scale each drifted device's
        latency curve by its smoothed observed/predicted ratio."""
        ratios = self.var_detector.ratios
        profile = self.profile
        new_lat = profile.latencies * ratios[:, None]
        self.planner.set_profile(
            VariabilityProfile(
                token_counts=profile.token_counts.copy(),
                latencies=new_lat,
                tile_size=profile.tile_size,
            )
        )
        self.var_detector.reset()
        if self.replicated:
            # the split follows the belief: repaired speeds reshape every
            # replicated expert's token shares immediately (the replan that
            # follows may then also move the copies themselves)
            for rp in self.current_rplacements:
                rp.compute_speed_shares(
                    self.profile, config=self.config.replication
                )

    def _plan_rplacements(
        self, window: int, layers: set[int] | None = None
    ) -> list[ReplicatedPlacement]:
        """Replicated-mode replan: per-layer copy selection + expanded GEM
        search + speed-aware refinement (see repro.replication.planner).
        ``layers`` (staggered replan) restricts the search to those layers;
        the rest keep their live placement."""
        out: list[ReplicatedPlacement] = []
        for layer, collector in enumerate(self.planner.collectors):
            if layers is not None and layer not in layers:
                out.append(self.current_rplacements[layer])
                continue
            res = plan_replicated(
                collector.trace(window), self.profile, self.planner.config,
                self.config.replication,
            )
            out.append(res.placement)
        return out

    def _plan_placements(
        self, window: int, layers: set[int] | None = None
    ) -> list[Placement]:
        Ev, G = self.planner.num_experts, self.planner.num_devices

        def skip(layer: int) -> bool:
            return layers is not None and layer not in layers

        if self.config.policy == "linear":
            return [
                self.current_placements[i] if skip(i)
                else linear_placement(Ev, G)
                for i in range(len(self.planner.collectors))
            ]
        if self.config.policy == "eplb":
            return [
                self.current_placements[i] if skip(i)
                else eplb_placement(c.trace(window), G)
                for i, c in enumerate(self.planner.collectors)
            ]
        # GEM, warm-started: alongside the restart search, hill-climb from
        # the *live* placement. The warm candidate is never worse than
        # current on the window (refine only applies improving swaps) and
        # usually closer to it, so migrations are cheaper; pick per layer.
        gcfg = self.planner.config
        out: list[Placement] = []
        for layer, collector in enumerate(self.planner.collectors):
            if skip(layer):
                out.append(self.current_placements[layer])
                continue
            trace = collector.trace(window)
            res = self.planner.plan_layer(layer)
            warm_p, warm_s, _ = refine(
                self.current_placements[layer], trace, self.profile,
                tol=gcfg.convergence_tol, max_swaps=gcfg.max_swaps,
            )
            out.append(warm_p if warm_s <= res.score else res.placement)
        return out

    def _record_replan(self, record: dict) -> None:
        """Append one replan record and mirror it onto the telemetry plane
        (``controller.replans*`` counters + a ``replan`` instant event)."""
        self.replans.append(record)
        tel = self.telemetry
        tel.counter("controller.replans").inc()
        if record["applied"]:
            tel.counter("controller.replans.applied").inc()
        if record.get("truncated"):
            tel.counter("controller.truncations").inc()
        tel.instant("replan", **record)

    def _staggered_layers(self, reason: str) -> set[int] | None:
        """Layer subset for a staggered replan, or ``None`` for a full one.

        Only load-drift replans stagger (a profile rescale or warm-up
        invalidates every layer), and only when the detector localizes the
        shift to a proper non-empty subset — an empty subset means the mean
        fired on broad elevation, which needs the full replan."""
        if not self.config.staggered_replan or reason != "load-drift":
            return None
        sel = self.load_detector.drifted_layers()
        if 0 < len(sel) < self.planner.num_layers:
            return {int(x) for x in sel}
        return None

    def _replan(self, decision: StepDecision, reason: str) -> None:
        window = self.planner.config.trace_length
        traces = [c.trace(window) for c in self.planner.collectors]
        layers = self._staggered_layers(reason)
        if self.replicated:
            rtarget = self._plan_rplacements(window, layers)
            # skipped layers reuse the live ReplicatedPlacement, whose
            # slot_layout() IS the live layout — zero moves by construction
            target_layouts = [rp.slot_layout() for rp in rtarget]
            schedule = plan_replica_migration(
                self.slot_layouts, target_layouts, self.config.migration
            )
            spd = self.num_slots // self.planner.num_devices
            cur_score = sum(
                replicated_score(t, self.profile, rp)
                for t, rp in zip(traces, self.current_rplacements)
            )
            tgt_score = sum(
                replicated_score(t, self.profile, rp)
                for t, rp in zip(traces, rtarget)
            )
        else:
            target = self._plan_placements(window, layers)
            # migration targets for skipped layers must be the *raw live*
            # layout, not the derived Placement: a Placement canonicalises
            # expert order within each device, and after a truncated
            # migration the live layout may not be canonical — diffing
            # against the Placement would emit spurious within-device moves
            migration_target = (
                list(target) if layers is None else [
                    target[i] if i in layers else self.slot_layouts[i]
                    for i in range(len(target))
                ]
            )
            schedule = plan_migration(
                self.slot_layouts, migration_target, self.config.migration
            )
            cur_score = sum(
                score(t, self.profile, p)
                for t, p in zip(traces, self.current_placements)
            )
            tgt_score = sum(
                score(t, self.profile, p) for t, p in zip(traces, target)
            )
        first_plan = not self.planned
        self.planned = True
        self._last_plan_step = self._step
        decision.replanned = True
        decision.reason = reason
        record = {
            "step": self._step, "reason": reason,
            "moves": schedule.total_moves, "applied": True,
            # candidate scores: the gate's inputs ride the record so the
            # audit plane can re-derive accept/reject from the log alone
            "cur_score_s": float(cur_score), "tgt_score_s": float(tgt_score),
        }
        if layers is not None:
            record["staggered_layers"] = sorted(layers)
        if schedule.total_moves == 0:
            self._record_replan(record)
            self._reset_reference(traces)
            return
        schedule_cost = (
            schedule.total_cost(self.cost_model, spd)
            if self.replicated
            else schedule.total_cost(self.cost_model)
        )
        net = migration_net_benefit(
            cur_score, tgt_score, window, self.config.payback_horizon,
            schedule_cost,
        )
        record["schedule_cost_s"] = float(schedule_cost)
        record["net_benefit_s"] = net
        if net <= 0.0:
            # the full plan failed the net-benefit gate, whether or not a
            # profitable cycle prefix survives truncation below
            self.telemetry.counter("controller.gate_rejections").inc()
            truncated = None
            if self.config.truncate_rejected and not self.replicated:
                truncated = self._truncate_schedule(
                    migration_target, traces, window, record
                )
            if truncated is None:
                record["applied"] = False
                decision.migration_skipped = True
                self._record_replan(record)
                self._reset_reference(traces)
                return
            schedule = truncated
            decision.migration_truncated = True
            record["truncated"] = True
            record["moves"] = schedule.total_moves
        self._record_replan(record)
        self._pending = deque(schedule.steps)
        self._pending_unbudgeted = (
            first_plan and self.config.unbudgeted_first_swap
        )
        self._reset_reference(traces)

    def _truncate_schedule(
        self,
        target: list,
        traces: list[ExpertTrace],
        window: int,
        record: dict,
    ):
        """Budget-aware plan truncation: when the full migration cannot
        amortise its weight traffic, score the delta's permutation cycles
        *individually* (each cycle is independently applicable) and migrate
        only the profitable ones. ``target`` entries are Placements or raw
        live layouts (staggered replans freeze skipped layers at the raw
        layout). Returns a schedule or ``None`` when no cycle pays for
        itself."""
        cycles = migration_cycles(self.slot_layouts, target)
        horizon = self.config.payback_horizon
        spb = max(self.config.migration.max_moves_per_step // 2, 1)
        keep: list = []
        for cyc in cycles:
            layout = self.slot_layouts[cyc.layer].copy()
            for sw in cyc.swaps:
                layout[[sw.slot_a, sw.slot_b]] = layout[[sw.slot_b, sw.slot_a]]
            before = score(
                traces[cyc.layer], self.profile,
                self.current_placements[cyc.layer],
            )
            after = score(
                traces[cyc.layer], self.profile,
                Placement.from_slots(layout, self.planner.num_devices),
            )
            # the cycle's swaps land in ⌈swaps/per-batch⌉ priced batches
            batches = -(-len(cyc.swaps) // spb)
            cost = batches * self.cost_model.cost(
                min(spb, len(cyc.swaps)) * 2
            )
            net = migration_net_benefit(before, after, window, horizon, cost)
            if net > 0.0:
                keep.append((net, cyc))
        if not keep:
            return None
        keep.sort(key=lambda x: -x[0])
        partial = [lay.copy() for lay in self.slot_layouts]
        for _, cyc in keep:
            for sw in cyc.swaps:
                partial[cyc.layer][[sw.slot_a, sw.slot_b]] = (
                    partial[cyc.layer][[sw.slot_b, sw.slot_a]]
                )
        record["cycles_kept"] = len(keep)
        record["cycles_total"] = len(cycles)
        return plan_migration(
            self.slot_layouts, partial, self.config.migration
        )

    def _reset_reference(self, traces: list[ExpertTrace]) -> None:
        ref = np.stack([t.counts.sum(axis=0) for t in traces])
        self.load_detector.set_reference(ref)
        self.var_detector.reset()

    def _emit_migration_step(self, decision: StepDecision) -> None:
        if not self._pending:
            return
        if self.replicated:
            step = self._emit_replica_step()
            # price only the rows that cross the interconnect — a replica
            # sourced from a same-device row is a local HBM copy, exactly
            # as the one-shot path's replica_fetch_rows accounts it
            spd = self.num_slots // self.planner.num_devices
            priced = step.cross_device_moves(spd)
        else:
            step = self._emit_swap_step()
            priced = step.num_moves
        decision.migration_step = step
        decision.migration_cost = self.cost_model.cost(priced)
        self.total_migration_cost += decision.migration_cost
        self.total_moves += step.num_moves
        self.max_moves_in_step = max(self.max_moves_in_step, step.num_moves)

    def _emit_swap_step(self) -> MigrationStep:
        if self._pending_unbudgeted:
            # one-shot semantics: the whole remaining delta lands now
            swaps = [s for st in self._pending for s in st.swaps]
            step = MigrationStep(swaps)
            self._pending.clear()
            self._pending_unbudgeted = False
        else:
            step = self._pending.popleft()
        touched = set()
        for sw in step.swaps:
            layout = self.slot_layouts[sw.layer]
            layout[[sw.slot_a, sw.slot_b]] = layout[[sw.slot_b, sw.slot_a]]
            touched.add(sw.layer)
        for layer in touched:
            self.current_placements[layer] = Placement.from_slots(
                self.slot_layouts[layer], self.planner.num_devices
            )
        return step

    def _emit_replica_step(self) -> ReplicaMigrationStep:
        if self._pending_unbudgeted:
            # one-shot semantics: replay the remaining batches onto a copy
            # of the live layouts, then emit the whole delta as a single
            # parallel source map per layer (batch-internal ordering
            # collapses — the final row sources come from the live pool)
            final = [lay.copy() for lay in self.slot_layouts]
            S = self.num_slots
            for st in self._pending:
                snap = [lay.copy() for lay in final]
                for layer, src in st.sources_by_layer(S).items():
                    final[layer] = snap[layer][src]
            moves = []
            for layer, (cur, tgt) in enumerate(zip(self.slot_layouts, final)):
                src = replica_source_permutation(cur, tgt)
                for s in np.nonzero(src != np.arange(len(src)))[0]:
                    moves.append(ReplicaMove(layer, int(s), int(src[s])))
            step = ReplicaMigrationStep(moves)
            self._pending.clear()
            self._pending_unbudgeted = False
        else:
            step = self._pending.popleft()
        # parallel batch semantics: all sources read the pre-batch layout
        S = self.num_slots
        touched = set()
        sources = step.sources_by_layer(S)
        for layer, src in sources.items():
            self.slot_layouts[layer] = self.slot_layouts[layer][src]
            touched.add(layer)
        for layer in touched:
            rp = ReplicatedPlacement(
                self.slot_layouts[layer].copy(),
                self.planner.num_devices,
                self.planner.num_experts,
            )
            rp.compute_speed_shares(
                self.profile, config=self.config.replication
            )
            self.current_rplacements[layer] = rp
        return step

"""Continuous-batching serving engine on the paged KV cache, with GEM's
control plane: the one-shot replan and the online adaptation plane.

Port of the serving core of ``repro/serving/engine.py``: a fixed pool of
``max_batch`` decode slots, FCFS admission against the paged KV pool,
one prefill per admitted request (chunked-prefill accounting optional),
youngest-first preemption when the pool runs dry, and a simulated clock
advanced by the configured per-step and per-prefill-token costs. Every
step runs the model's decode step over all ``max_batch`` rows, idle ones
included, exactly as the JAX engine does, so the MoE layers see the same
batches on both.

The GEM control plane (:mod:`repro_torch.core`):

* **Step-1** — after each decode step the router's per-layer (L, E)
  ``expert_counts`` (the K2 kernel's statistics), repeated ``expert_tp``
  times into virtual experts, feed the planner's trace collectors.
* **Step-2** — a fleet :class:`~repro_torch.core.types.VariabilityProfile`
  is attached at construction; every decode step is also charged its
  simulated MoE latency under the current placement on that fleet.
* **Step-3/4** — once ``replan_after`` steps have run and the collectors
  hold ``trace_length`` steps, the ``placement_policy`` (``gem``, ``eplb``
  or ``linear``) picks a placement, and between two decode steps the
  stacked expert pool on the device is permuted in place and the router
  tables are swapped (:class:`~repro_torch.kernels.collective.
  MigrationExecutable`). The swap's modelled cost is charged to the step
  that performs it.

**Online mode** (``EngineConfig(online=True)``, a profile required)
replaces the one-shot replan with the
:class:`~repro_torch.online.OnlineController`: after each decode step it
sees the Step-1 counts and each device's observed MoE time on the
ground-truth fleet (``set_true_profile`` injects a mid-run slowdown),
replans on warm-up, load drift or variability drift, and hands back
budgeted batches of at most ``migration.max_moves_per_step`` moved slots.
Each batch is one dense (L, S) row-source map, identity but for its moved
slots; the executable copies only those rows in place and the swapped
tables are copied into the engine's one table tensor, so the captured
decode step sees the new layout with no new capture. ``migration_via`` is
``"host"``; ``"collective"`` raises until the multi-card path lands.

**Telemetry** (:mod:`repro_torch.telemetry`): the engine always holds a
hub (``telemetry=None`` gives a disabled one, which records counters but
no events) whose clock is the simulated time. It counts steps, decoded and
prefilled tokens, dropped assignments, preemptions and migration batches,
emits the ``step``, ``prefill``, ``decode`` and ``migrate`` spans, holds
``migration_records``, and receives the controller's ``audit.*`` events,
which ``benchmarks/decision_replay.py`` replays byte for byte. While a
profile is attached, every decode step is also split into load and
variability slack (attribution) and priced against a hindsight oracle
(regret, a warm-started search per layer on the host); ``latency_report``
carries both summaries. The JAX registry's ``jit.trace.*`` counters have
no counterpart here: captures are :attr:`ServingEngine.
graph_capture_counts`.

``decode_mode`` picks how the decode step runs, as in the JAX engine.
``"scan"`` (the default) runs it through
:class:`~repro_torch.models.model.DecodeGraph`: captured once as a CUDA
graph when the engine is built, replayed every step, with the step's
inputs, the router tables, the expert pool and the KV pools at fixed
addresses, so a migration never recaptures it. ``"python"`` is the eager
per-layer loop, the parity baseline. Whatever the decode step reads is
updated in place: assigning ``placements`` copies into the engine's one
table tensor, and the swap rewrites the pool in place. Replacing a weight
tensor after the capture recaptures, and is counted.

Not here yet: replication (``replica_slots > 0`` raises
``NotImplementedError``, so the controller's replicated and shed branches
are never taken), shedding, the collective migration path and the dense
KV mode (it comes with the sliding-window families).

On a host without a GPU, ``tests/test_torch_online.py`` holds the online
engine against the JAX engine in both decode modes
(``PYTHONPATH=src python -m pytest -q tests/test_torch_online.py``); on the
card, ``chip_smoke.py``'s ``online`` phase serves full granite with
``online=True`` and checks the rows, tables, tokens, launches and captures
after every batch has landed.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.eplb import eplb_placement
from ..core.gem import GEMPlanner
from ..core.score import step_cost_matrix, step_token_matrix
from ..core.types import GEMConfig, Placement, VariabilityProfile
from ..device import resolve_device
from ..kernels.collective import MigrationExecutable
from ..models.model import (
    DecodeGraph,
    decode_step,
    init_paged_decode_cache,
    prefill,
)
from ..models.moe import identity_placement
from ..online import (
    DriftConfig,
    MigrationConfig,
    OnlineConfig,
    OnlineController,
)
from ..replication import ReplicatedPlacement, ReplicationConfig
from ..telemetry import (
    AttributionAccumulator,
    RegretTracker,
    Telemetry,
    attribute_step,
)
from ..telemetry.regret import record_step_metrics
from .arrivals import RequestSpec
from .kv_cache import PagedKVConfig, PagedKVPool
from .sampling import sample
from .scheduler import Request, Scheduler
from .slo import slo_report

__all__ = ["EngineConfig", "ServingEngine"]

# fixed histogram buckets for per-step straggler slack (seconds), as in the
# JAX engine, so that both registries' snapshots are equal
_ATTR_SLACK_BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0
    gem: GEMConfig = GEMConfig()
    placement_policy: str = "gem"  # gem | eplb | linear
    replan_after: int | None = None  # engine steps before replan (default:
    # gem.trace_length; 0 means "as soon as the trace collectors fill")
    # replica_slots > 0 raises NotImplementedError until the replicated
    # data plane lands
    replication: ReplicationConfig = ReplicationConfig()
    # --- online adaptation plane (repro_torch.online) ---
    online: bool = False  # drift-triggered replans + budgeted partial swaps
    # instead of the one-shot step-counter replan above
    drift: DriftConfig = DriftConfig()
    # the online plane's batch budget; also prices the one-shot swap
    migration: MigrationConfig = MigrationConfig()
    replan_cooldown: int = 32  # min steps between drift replans
    payback_horizon: int = 1024  # steps a migration's gain must amortise over
    staggered_replan: bool = False  # load-drift replans re-search only the
    # layers the detector localises the shift to (OnlineConfig)
    # "host": batches apply as indexed row copies on the weights' device.
    # "collective" (rows over an interconnect) raises NotImplementedError
    # until the multi-card path lands
    migration_via: str = "host"
    other_time_per_step: float = 0.0  # simulated non-MoE per-step latency
    kv: PagedKVConfig = PagedKVConfig()
    # chunked prefill: >0 spreads a prompt's *simulated* prefill time over
    # ceil(P/chunk) engine steps; the prefill itself runs once, when the
    # last chunk lands
    prefill_chunk: int = 0
    prefill_time_per_token: float = 0.0  # simulated prefill s/token
    admit_lookahead: int = 8  # scheduler head-of-line lookahead window
    ttft_slo_s: float | None = None  # TTFT target the scheduler records
    # "scan" captures the decode step once as a CUDA graph (models/model.py
    # DecodeGraph) whose tables, inputs and pools are static buffers: no
    # migration recaptures it. "python" runs the per-layer loop eagerly:
    # the parity baseline.
    decode_mode: str = "scan"


class ServingEngine:
    def __init__(self, params, config: ModelConfig,
                 engine_config: EngineConfig = EngineConfig(), *,
                 profile: VariabilityProfile | None = None,
                 num_devices: int | None = None,
                 telemetry: Telemetry | None = None,
                 device=None):
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(
                f"params live on {embed.device}, engine runs on {self.device}"
            )
        if engine_config.decode_mode not in ("scan", "python"):
            raise ValueError(
                f"decode_mode={engine_config.decode_mode!r} not in "
                "('scan', 'python')"
            )
        if engine_config.placement_policy not in ("gem", "eplb", "linear"):
            raise ValueError(
                f"placement_policy={engine_config.placement_policy!r} not in "
                "('gem', 'eplb', 'linear')"
            )
        if engine_config.migration_via not in ("host", "collective"):
            raise ValueError(
                f"migration_via={engine_config.migration_via!r} not in "
                "('host', 'collective')"
            )
        if engine_config.migration_via == "collective":
            raise NotImplementedError(
                "migration_via='collective' is not ported yet: the row "
                "exchange over an interconnect comes with the multi-card "
                "path; 'host' applies every batch on the weights' device"
            )
        rep = engine_config.replication
        if rep.replica_slots > 0 or rep.auto_slots:
            raise NotImplementedError(
                "expert replication is not ported yet: the replicated pool, "
                "the replica split and the replication-aware planner come "
                "with the replication plane"
            )
        if engine_config.online and profile is None:
            raise ValueError(
                "EngineConfig(online=True) needs an attached "
                "VariabilityProfile — without it no adaptation plane can "
                "run and the engine would silently never replan"
            )
        self.params = params
        self.config = config
        self.ecfg = engine_config
        # the telemetry hub, always built (disabled when none is passed):
        # its registry holds the migration records. The clock binds to the
        # simulated time before the online controller is built, whose
        # audit.init event stamps it
        self.telemetry = (
            telemetry if telemetry is not None else Telemetry(enabled=False)
        )
        self.sim_time = 0.0
        self.telemetry.set_clock(lambda: self.sim_time)
        self.scheduler = Scheduler(
            engine_config.max_batch,
            admit_lookahead=engine_config.admit_lookahead,
            ttft_slo_s=engine_config.ttft_slo_s,
        )
        self.scheduler.telemetry = self.telemetry
        self.step_count = 0
        self._uid = 0
        self.finished: list[Request] = []
        self.arrivals: deque[RequestSpec] = deque()
        self.installed = np.zeros(engine_config.max_batch, dtype=bool)
        self.preemption_count = 0
        self.prefill_count = 0  # prefills run (one per installed request)
        self.decode_count = 0  # decode steps run
        # (L, E_v) expert→slot tables, identity while the pool is in
        # virtual-expert order; the one-shot replan swaps them. One tensor
        # for the engine's life: `placements = …` copies into it
        self._placements = identity_placement(
            config, config.num_layers, device=self.device
        )
        self.expert_counts: np.ndarray | None = None  # (L, E), last step
        self.sim_step_latencies: list[float] = []

        # GEM control plane (the port serves MoE configs only)
        self.profile = profile
        # ground truth, when a caller injects one that departs the profile
        self.true_profile: VariabilityProfile | None = None
        self.placement_applied = False
        # the replicated layouts stay None: the engine refuses replication
        self.current_rplacements: list[ReplicatedPlacement] | None = None
        if profile is not None:
            # admission tracks the profiled fleet's slowest device
            self.scheduler.set_slow_device_factor(
                float(profile.relative_speed().min())
            )
        nd = num_devices or (profile.num_devices if profile else 4)
        Ev = config.num_virtual_experts
        self.planner = GEMPlanner(
            Ev, nd, config.num_layers, engine_config.gem
        )
        # per-step straggler attribution (load vs variability) and
        # placement regret against the hindsight oracle: host numpy, run
        # on every decode step while a profile is attached
        self.attribution = AttributionAccumulator(nd)
        self.regret = RegretTracker(Ev, nd)
        if profile is not None:
            self.planner.set_profile(profile)
        self.current_placements: list[Placement] = [
            Placement.linear(Ev, nd) for _ in range(config.num_layers)
        ]
        self._migrate = MigrationExecutable()
        # one cost model for both replan paths: the online plane prices its
        # batches with it and the one-shot swap is charged the same way
        self._cost_model = engine_config.migration.cost_model_for_dims(
            config.d_model, config.expert_d_ff // config.expert_tp,
            bytes_per_param=embed.dtype.itemsize,
        )
        self.controller: OnlineController | None = None
        if engine_config.online:
            self.controller = OnlineController(
                self.planner,
                self._cost_model,
                OnlineConfig(
                    policy=engine_config.placement_policy,
                    online=True,
                    drift=engine_config.drift,
                    migration=engine_config.migration,
                    replication=engine_config.replication,
                    replan_cooldown=engine_config.replan_cooldown,
                    payback_horizon=engine_config.payback_horizon,
                    staggered_replan=engine_config.staggered_replan,
                ),
                initial_placements=self.current_placements,
                initial_rplacements=self.current_rplacements,
                telemetry=self.telemetry,
            )

        block_size = engine_config.kv.block_size
        self._n_max = -(-engine_config.max_len // block_size)
        num_blocks = engine_config.kv.num_blocks
        if num_blocks is None:
            # every slot holds a full-length request: admission never fails
            num_blocks = 1 + engine_config.max_batch * self._n_max
        self.kv_pool = PagedKVPool(
            num_blocks, block_size,
            watermark_blocks=engine_config.kv.watermark_blocks,
        )
        self.kv_pool.telemetry = self.telemetry
        self.caches = init_paged_decode_cache(
            config, num_blocks, block_size, device=self.device,
            dtype=embed.dtype,
        )
        self.cur_len = np.zeros(engine_config.max_batch, dtype=np.int32)
        self.last_token = np.zeros(engine_config.max_batch, dtype=np.int32)
        # (B, n_max) attention-side view; null-block rows for idle slots
        self.block_tables = np.zeros(
            (engine_config.max_batch, self._n_max), dtype=np.int32
        )
        self.decode_graph: DecodeGraph | None = None
        self._decode = decode_step
        if engine_config.decode_mode == "scan":
            self.decode_graph = DecodeGraph(
                params, self.caches, self._placements, config,
                batch=engine_config.max_batch, n_max=self._n_max,
                device=self.device,
            )
            self._decode = self.decode_graph

    @property
    def placements(self) -> torch.Tensor:
        """The (L, E_v) int32 expert→slot tables the model routes through."""
        return self._placements

    @placements.setter
    def placements(self, tables) -> None:
        """Copy new tables into the engine's one table tensor; the captured
        decode step reads that tensor, so it is never rebound."""
        tables = torch.as_tensor(tables, device=self.device)
        if tuple(tables.shape) != tuple(self._placements.shape):
            raise ValueError(
                f"placements {tuple(tables.shape)} != "
                f"{tuple(self._placements.shape)} (L, E_v)"
            )
        self._placements.copy_(tables)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: float | None = None, task: str = "") -> int:
        prompt = np.asarray(prompt, np.int32)
        total = int(prompt.shape[0]) + int(max_new_tokens)
        need = self.kv_pool.blocks_for(total)
        if need > self.kv_pool.usable_blocks:
            raise ValueError(
                f"request needs {need} KV blocks but the pool only has "
                f"{self.kv_pool.usable_blocks} — it could never be served "
                "(grow PagedKVConfig.num_blocks or shorten it)"
            )
        self._uid += 1
        req = Request(
            self._uid, prompt, max_new_tokens,
            arrival_step=self.step_count, task=task,
        )
        req.arrival_time = (
            self.sim_time if arrival_time is None else float(arrival_time)
        )
        self.scheduler.submit(req)
        return self._uid

    def serve(self, specs: Iterable[RequestSpec], *, max_steps: int = 100_000
              ) -> list[Request]:
        """Run a timestamped arrival stream to completion; when the engine
        is idle the clock jumps to the next arrival."""
        merged = sorted(
            list(self.arrivals) + list(specs),
            key=lambda s: s.arrival_time,  # stable: ties keep list order
        )
        self.arrivals = deque(merged)
        steps = 0
        while (self.arrivals or self.scheduler.has_work()) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def _ingest_arrivals(self) -> None:
        if self.arrivals and not self.scheduler.has_work():
            self.sim_time = max(self.sim_time, self.arrivals[0].arrival_time)
        while self.arrivals and \
                self.arrivals[0].arrival_time <= self.sim_time:
            spec = self.arrivals.popleft()
            self.submit(
                spec.prompt, spec.max_new_tokens,
                arrival_time=spec.arrival_time, task=spec.task,
            )

    # ------------------------------------------------------------------
    def _install_paged_slot(self, slot: int, req: Request) -> None:
        """Prefill one request and write its K/V into its owned blocks."""
        tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
        logits, caches = prefill(
            self.params, tokens, self.config, self.placements
        )
        self.prefill_count += 1
        table = self.kv_pool.block_table(req.uid)
        blocks = torch.as_tensor(table, dtype=torch.long, device=self.device)
        bs = self.kv_pool.block_size
        for name in ("k", "v"):
            pool = self.caches["attn"][name]
            new = caches["attn"][name][:, 0]  # (L, P, KV, hd)
            L, P = new.shape[:2]
            padded = new.new_zeros((L, len(table) * bs, *new.shape[2:]))
            padded[:, :P] = new
            pool[:, blocks] = padded.reshape(L, len(table), bs,
                                             *new.shape[2:])
        self.block_tables[slot, :] = 0
        self.block_tables[slot, : len(table)] = table
        self.cur_len[slot] = req.prompt_len
        self.last_token[slot] = int(torch.argmax(logits[0]))
        self.installed[slot] = True

    def _prefill_phase(self) -> float:
        """Advance prefill for admitted-but-uninstalled slots; returns the
        simulated prefill time charged to this step."""
        chunk = self.ecfg.prefill_chunk
        charge = 0.0
        advanced = 0
        installed_now: list[Request] = []
        for slot, req in sorted(self.scheduler.active.items()):
            if self.installed[slot]:
                continue
            advance = req.prompt_len - req.prefill_progress
            if chunk > 0:
                advance = min(advance, chunk)
            req.prefill_progress += advance
            advanced += advance
            charge += advance * self.ecfg.prefill_time_per_token
            if req.prefilled:
                self._install_paged_slot(slot, req)
                installed_now.append(req)
        self.sim_time += charge
        if advanced > 0:
            self.telemetry.counter("engine.prefill_tokens").inc(advanced)
            self.telemetry.emit_span(
                "prefill", self.sim_time - charge, charge, tokens=advanced
            )
        for req in installed_now:
            if req.first_token_time < 0:  # keep TTFT across preemptions
                req.first_token_time = self.sim_time
        return charge

    def _kv_admit(self, req: Request) -> bool:
        """Admission gate: reserve the prompt's KV blocks (decode growth
        allocates on demand), keeping the watermark free."""
        if not self.kv_pool.can_allocate(req.prompt_len):
            return False
        return self.kv_pool.allocate(req.uid, req.prompt_len)

    def _preempt(self, slot: int, req: Request) -> None:
        """Evict a running request: free its blocks and requeue it at the
        head; greedy decode regenerates its tokens on re-admission."""
        self.kv_pool.release(req.uid)
        self.scheduler.release(slot)
        req.generated.clear()
        req.preemptions += 1
        self.preemption_count += 1
        self.telemetry.counter("engine.preemptions").inc()
        self.telemetry.instant("preempt", request=req.uid)
        self.scheduler.requeue_front(req)
        self.installed[slot] = False
        self.cur_len[slot] = 0
        self.last_token[slot] = 0
        self.block_tables[slot, :] = 0

    def _ensure_decode_capacity(self) -> None:
        """Grow each running row's block table to cover this step's write;
        when the pool runs dry, preempt the youngest arrival and retry."""
        for slot in list(np.nonzero(self.installed)[0]):
            req = self.scheduler.active.get(int(slot))
            if req is None:
                continue
            want = int(self.cur_len[slot]) + 1
            while not self.kv_pool.allocate(req.uid, want):
                victims = sorted(
                    (
                        (s, r) for s, r in self.scheduler.active.items()
                        if self.installed[s]
                    ),
                    key=lambda sr: (sr[1].arrival_time, sr[1].uid),
                    reverse=True,
                )
                if not victims:
                    raise RuntimeError("KV pool dry with no one to preempt")
                vslot, victim = victims[0]
                self._preempt(vslot, victim)
                if victim is req:
                    break  # evicted itself: row is no longer runnable
            else:
                table = self.kv_pool.block_table(req.uid)
                self.block_tables[slot, : len(table)] = table

    # ------------------------------------------------------------------
    @property
    def migration_records(self) -> list[dict[str, Any]]:
        """One record per applied migration batch: a read-through of the
        telemetry hub's record list."""
        return self.telemetry.migration_records

    def _apply_migration_sources(self, src: np.ndarray) -> None:
        """Rewrite the expert pool in place to ``new[l] = old[l][src[l]]``
        (only the moved rows are copied) and copy the swapped (L, E_v)
        tables into the engine's one table tensor. Nothing the captured
        decode step reads is rebound."""
        moe = self.params["blocks"]["moe"]
        _, self.placements = self._migrate(  # copied in place (setter)
            src, self.placements, moe["w_gate"], moe["w_up"], moe["w_down"]
        )

    def set_true_profile(self, profile: VariabilityProfile | None) -> None:
        """Inject the *actual* fleet behaviour when it departs the believed
        profile (a mid-run power cap): simulated latencies come from this
        ground truth while the control plane keeps planning on its belief
        until the online plane's variability-drift detector repairs it."""
        self.true_profile = profile

    @property
    def _sim_profile(self) -> VariabilityProfile | None:
        return self.true_profile if self.true_profile is not None else self.profile

    def _step_cost_matrix(self, counts_virt: np.ndarray) -> np.ndarray | None:
        """(L, G) per-layer per-device latencies of this step on the
        ground-truth fleet, under the current placements."""
        if self._sim_profile is None:
            return None
        return step_cost_matrix(
            counts_virt, self._sim_profile, self.current_placements
        )

    def _step_token_matrix(self, counts_virt: np.ndarray) -> np.ndarray | None:
        """(L, G) per-layer per-device token loads of this step: the
        straggler attribution's input."""
        if self._sim_profile is None:
            return None
        return step_token_matrix(
            counts_virt, self._sim_profile.num_devices,
            self.current_placements,
        )

    def _observe_attribution(self, counts_virt: np.ndarray) -> None:
        """Split this step's straggler slack into load and variability
        (:mod:`repro_torch.telemetry.attribution`) and fold it into the run
        aggregate and the registry. Host numpy only."""
        prof = self._sim_profile
        if prof is None:
            return
        tokens = self._step_token_matrix(counts_virt)
        att = attribute_step(tokens, prof)
        self.attribution.observe(att)
        tel = self.telemetry
        # slack_total/slack_load are max−mean ⇒ non-negative (counters);
        # the variability residual can be negative, so its sum is a gauge
        tel.counter("attr.slack_total_s").inc(att.total)
        tel.counter("attr.slack_load_s").inc(att.load)
        tel.gauge("attr.slack_var_s").set(self.attribution.sum_var)
        tel.histogram("attr.step_slack_s", _ATTR_SLACK_BOUNDS).observe(
            att.total
        )
        if tel.enabled:
            cost = prof.cost_all(tokens)  # (L, G)
            device_time = cost.sum(axis=0)
            straggler = int(device_time.argmax())
            for g in range(cost.shape[1]):
                tel.emit_span(
                    "expert_compute", self.sim_time, float(device_time[g]),
                    track=f"device{g}", step=self.step_count,
                    straggler=(g == straggler),
                )

    def _observe_regret(self, counts_virt: np.ndarray,
                        cost_mx: np.ndarray | None) -> None:
        """Fold this step into the placement-regret aggregate
        (:mod:`repro_torch.telemetry.regret`: a warm-started search per
        layer over the step's own loads) and the registry. Host numpy."""
        prof = self._sim_profile
        if prof is None or cost_mx is None:
            return
        # migration-lag when the control plane has committed but not
        # landed: the controller mid-adaptation, or the one-shot plan not
        # applied yet
        lagging = (
            self.controller.adapting
            if self.controller is not None
            else not self.placement_applied
        )
        sr = self.regret.observe(
            counts_virt, prof, float(cost_mx.max(axis=1).sum()),
            placements=self.current_placements, lagging=lagging,
        )
        record_step_metrics(self.telemetry, sr, self.step_count)

    def _maybe_replan(self) -> None:
        """The one-shot replan: once the threshold step is reached and every
        layer's collector holds ``trace_length`` steps, plan with the
        configured policy and apply it between two decode steps. The
        online mode replans on drift instead (:meth:`_online_step`)."""
        if (self.controller is not None or self.placement_applied
                or self.profile is None):
            return
        gem = self.ecfg.gem
        threshold = (
            self.ecfg.replan_after
            if self.ecfg.replan_after is not None
            else gem.trace_length
        )
        if self.step_count < threshold:
            return
        if not all(c.num_steps >= gem.trace_length
                   for c in self.planner.collectors):
            return
        if self.ecfg.placement_policy == "linear":
            self.placement_applied = True
            return
        if self.ecfg.placement_policy == "eplb":
            placements = [
                eplb_placement(c.trace(gem.trace_length),
                               self.profile.num_devices)
                for c in self.planner.collectors
            ]
        else:
            placements = self.planner.plan().placements
        # Step-4: the pool is still in virtual order, so each layer's
        # row-source map is its slot_to_expert table, and the table swap
        # inverts it into expert_to_slot; the pool is rewritten in place
        slot_to_expert = np.stack([p.slot_to_expert() for p in placements])
        self._apply_migration_sources(slot_to_expert.astype(np.int32))
        # the swap moves weights: charge its modelled cost (the host path
        # measures nothing) to the step that performs it
        moves = sum(
            len(cur.moved_slots(new))
            for cur, new in zip(self.current_placements, placements)
        )
        swap_cost = self._record_migration(moves, self._cost_model.cost(moves))
        if self.sim_step_latencies:
            self.sim_step_latencies[-1] += swap_cost
        self.sim_time += swap_cost
        self.current_placements = placements
        self.placement_applied = True

    def _online_step(self, counts_virt: np.ndarray,
                     cost_mx: np.ndarray) -> float:
        """Drive the online controller for one step; returns the migration
        cost to charge to this step's simulated latency.

        The controller sees the (L, E_v) counts and the per-device observed
        MoE time on the ground-truth fleet; a batch it hands back is one
        dense (L, S) row-source map, identity but for its moved slots,
        applied to the pool in place with the router tables swapped in the
        same call."""
        decision = self.controller.observe_step(counts_virt,
                                                cost_mx.sum(axis=0))
        if decision.migration_step is not None:
            src = self.controller.dense_migration_sources(
                decision.migration_step
            )
            self._apply_migration_sources(src)
            self._record_migration(
                decision.migration_step.num_moves, decision.migration_cost
            )
            self.current_placements = list(self.controller.current_placements)
        if decision.profile_rescaled:
            self.profile = self.controller.profile
            self.scheduler.set_slow_device_factor(
                float(self.profile.relative_speed().min())
            )
        # "applied" means a planned placement reached the pool (a 0-move
        # schedule counts), not that a plan was made and gate-skipped
        if self.controller.planned and any(
            r["applied"] for r in self.controller.replans
        ):
            self.placement_applied = True
        return decision.migration_cost

    def _record_migration(self, moves: int, modeled_s: float) -> float:
        """Record one applied batch on the telemetry hub; returns the charge
        for the step. The host path measures nothing: the cost model's
        charge stands."""
        record: dict[str, Any] = {
            "step": self.step_count, "via": "host", "moves": int(moves),
            "modeled_s": float(modeled_s), "sim_time": float(self.sim_time),
        }
        tel = self.telemetry
        tel.counter("migrate.applies").inc()
        tel.record_migration(record)
        tel.emit_span("migrate", self.sim_time, float(modeled_s),
                      moves=record["moves"], via="host")
        return float(modeled_s)

    # ------------------------------------------------------------------
    def step(self) -> dict[str, Any]:
        """One engine iteration: ingest arrivals → admit → prefill →
        decode → sample → bookkeeping (continuous batching)."""
        self._ingest_arrivals()
        tel = self.telemetry
        t0 = self.sim_time
        for _slot, req in self.scheduler.admit(can_admit=self._kv_admit):
            req.start_step = self.step_count

        if not self.scheduler.active:
            return {"active": 0}

        prefill_charge = self._prefill_phase()
        self._ensure_decode_capacity()
        if not self.installed.any():
            # prefill-only step (chunked prefill in flight, or everything
            # was preempted): charge the prefill time, no decode
            if prefill_charge > 0:
                self.sim_step_latencies.append(prefill_charge)
            tel.counter("engine.steps").inc()
            tel.emit_span(
                "step", t0, self.sim_time - t0,
                step=self.step_count, active=self.scheduler.num_active,
            )
            self.step_count += 1
            return {
                "active": self.scheduler.num_active,
                "finished": len(self.finished),
                "sim_latency": prefill_charge,
                "placement_applied": self.placement_applied,
            }

        dev = self.device
        inputs = (self.cur_len, self.last_token[:, None], self.block_tables)
        if self.decode_graph is None:  # "python": new device tensors a step
            inputs = tuple(torch.as_tensor(a, device=dev) for a in inputs)
        cur_len, tokens, block_tables = inputs
        logits, self.caches, moe_aux = self._decode(
            self.params, self.caches, cur_len, tokens, self.config,
            self.placements, block_tables=block_tables,
        )
        self.decode_count += 1
        generator = None
        if self.ecfg.temperature > 0.0:
            generator = torch.Generator(device=dev)
            generator.manual_seed(self.step_count)
        next_tokens = sample(
            logits, temperature=self.ecfg.temperature, generator=generator
        ).cpu().numpy()
        # read back after the step (a replay's static outputs), never
        # inside the captured body
        self.expert_counts = moe_aux.expert_counts.cpu().numpy()
        dropped = int(moe_aux.dropped_tokens.cpu().numpy().sum())

        # GEM Step-1: the router's per-layer counts, in virtual experts
        sim_latency = prefill_charge + self.ecfg.other_time_per_step
        counts_virt = np.repeat(self.expert_counts, self.config.expert_tp,
                                axis=1)
        cost_mx = self._step_cost_matrix(counts_virt)
        if cost_mx is not None:
            sim_latency += float(cost_mx.max(axis=1).sum())
        self._observe_attribution(counts_virt)
        self._observe_regret(counts_virt, cost_mx)
        tel.counter("dispatch.dropped_tokens").inc(dropped)
        if self.controller is not None:
            sim_latency += self._online_step(counts_virt, cost_mx)
        else:
            for layer in range(self.config.num_layers):
                self.planner.observe_step(layer, counts_virt[layer])
        tel.emit_span(
            "decode", self.sim_time, sim_latency - prefill_charge,
            step=self.step_count, active=int(self.installed.sum()),
        )
        self.sim_step_latencies.append(sim_latency)
        # _prefill_phase already advanced the clock by its charge
        self.sim_time += sim_latency - prefill_charge

        done_slots = []
        decoded = 0
        for slot, req in list(self.scheduler.active.items()):
            if not self.installed[slot]:
                continue  # still prefilling (chunked): no token this step
            tok = int(next_tokens[slot])
            req.generated.append(tok)
            decoded += 1
            self.last_token[slot] = tok
            self.cur_len[slot] += 1
            if req.done or self.cur_len[slot] >= self.ecfg.max_len - 1:
                req.finish_step = self.step_count
                req.finish_time = self.sim_time
                self.finished.append(req)
                done_slots.append((slot, req))
        for slot, req in done_slots:
            self.scheduler.release(slot)
            self.cur_len[slot] = 0
            self.installed[slot] = False
            self.kv_pool.release(req.uid)
            self.block_tables[slot, :] = 0

        if decoded:
            tel.counter("engine.decode_tokens").inc(decoded)
        tel.counter("engine.steps").inc()
        self.step_count += 1
        self._maybe_replan()
        tel.emit_span(
            "step", t0, self.sim_time - t0,
            step=self.step_count - 1, active=self.scheduler.num_active,
        )
        return {
            "active": self.scheduler.num_active,
            "finished": len(self.finished),
            "sim_latency": sim_latency,
            "placement_applied": self.placement_applied,
        }

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.scheduler.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ------------------------------------------------------------------
    @property
    def graph_capture_counts(self) -> dict[str, int]:
        """Captures per entry point, the counterpart of the JAX engine's
        ``jit_trace_counts``. ``decode`` is the decode graph's builds: 1
        for a whole run under ``"scan"`` (on the CPU, bindings of the
        static buffers), 0 under ``"python"``. Prefill runs eagerly and the
        swap is the host path, so ``prefill`` and ``migrate`` stay 0. A
        migration adds no capture."""
        graph = self.decode_graph
        return {"decode": graph.builds if graph is not None else 0,
                "prefill": 0, "migrate": 0}

    def slo_report(self) -> dict[str, float]:
        """Per-request percentile TTFT/TPOT/E2E (serving/slo.py)."""
        return slo_report(self.finished)

    def kv_stats(self) -> dict[str, float]:
        """Paged-pool occupancy/pressure counters."""
        out = self.kv_pool.stats()
        out["kv_preemptions"] = float(self.preemption_count)
        return out

    def latency_report(self) -> dict[str, float]:
        """Step-level latency stats (``mean_tpot`` etc. are *step*
        latencies) merged with the per-request SLO percentiles and the
        paged-pool counters, the online plane's replan and migration totals,
        and the attribution and regret summaries: the JAX engine's report
        without the keys of the planes not ported yet (shed, collective)."""
        lat = np.asarray(self.sim_step_latencies)
        lat = lat[lat > 0]
        e2e = np.asarray(
            [r.finish_time - r.arrival_time for r in self.finished]
        )
        out = {"steps": float(self.step_count)}
        if len(lat):
            out.update(
                mean_tpot=float(lat.mean()),
                p90_tpot=float(np.quantile(lat, 0.9)),
                p99_tpot=float(np.quantile(lat, 0.99)),
            )
        if len(e2e):
            out["mean_e2e"] = float(e2e.mean())
        out.update(self.slo_report())
        out.update(self.kv_stats())
        if self.controller is not None:
            out.update(
                replans=float(len(self.controller.replans)),
                migration_s=self.controller.total_migration_cost,
                max_moves_per_step=float(self.controller.max_moves_in_step),
            )
        if self.attribution.steps > 0:
            # the per-device straggler tally (a list) stays on the
            # accumulator and in the registry
            out.update(
                (k, v) for k, v in self.attribution.summary().items()
                if isinstance(v, float)
            )
        if self.regret.steps > 0:
            out.update(self.regret.summary())
        return out

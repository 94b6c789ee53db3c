"""Continuous-batching serving engine for every model family, with GEM's
control plane on MoE configs: the one-shot replan and the online
adaptation plane.

Port of the serving core of ``repro/serving/engine.py``: a fixed pool of
``max_batch`` decode slots, FCFS admission, one prefill per admitted
request (chunked-prefill accounting optional), and a simulated clock
advanced by the configured per-step and per-prefill-token costs. Every
step runs the model's decode step over all ``max_batch`` rows, idle ones
included, exactly as the JAX engine does, so the MoE layers see the same
batches on both.

**KV modes** (``EngineConfig.kv_mode``). ``"paged"``: admission against
the paged KV pool, per-row lengths, and youngest-first preemption when the
pool runs dry; attention families without a sliding window only.
``"dense"``: one ``max_len`` panel per slot and attention site (a ring of
``min(window, max_len)`` entries under a sliding window) and the SSM
state and conv buffers per slot; every step runs at one length shared by
the batch, the longest row's, so a shorter row attends over the zero
panels past its prompt and takes its RoPE position and write index from
that maximum (the JAX engine's dense approximation, kept as it is). A
prompt longer than the ring raises ``ValueError``. ``"auto"`` (the
default) is paged exactly when the family qualifies and the policy has no
mesh, as in the JAX engine.

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
decode step sees the new layout with no new capture. ``migration_via``
``"host"`` and ``"collective"`` apply every batch the same way on one
device, where no expert row crosses an interconnect: ``"collective"`` is
then the JAX engine without live expert sharding, and its records say
``"via": "host"``. ``set_true_interconnect`` injects the fabric that times
a measured batch and the shed pass's transfer, as in the JAX engine.

**A mesh** (``ServingEngine(params, config, EngineConfig(…),
policy=policy)`` with a :class:`~repro_torch.sharding.ShardingPolicy` over a
:mod:`repro_torch.launch.mesh` of ranks, each rank running this engine on
its own shard of the parameters, :func:`repro_torch.models.init_params` or
:func:`repro_torch.bridge.params_from_numpy` with the policy). The expert
pool's slots shard over ``model`` (placement device d is model rank d),
the decode batch and the dispatch groups over ``data``, and the
projections, the SSD heads and the vocabulary over ``model``
(:func:`~repro_torch.sharding.param_specs`). The KV cache is dense and
holds the rank's rows and its block of positions over ``kv_seq`` (the
SSM state its rows and heads: the SSM and hybrid families serve on the
dense cache alone, ``kv_mode="dense"``); every
rank prefills every request (its MoE layers collapse to one group,
sequence-parallel over ``model`` where the axis divides the prompt) and
keeps the rows and positions it decodes. Every rank runs the same host
control plane — scheduler, planner, online controller, shed gate — on the
same inputs (K2's counts summed over the data ranks, the logits gathered
over them), so their decisions, tables and tokens stay identical; their
telemetry hubs hold the same records, and a caller exports one rank's (the
first). Migrations move rows between the ranks of each model row
(:class:`~repro_torch.kernels.collective.MigrationExecutable` with the
mesh) whichever ``migration_via``; under ``"collective"`` each record
carries the traffic its minimal schedule ships
(:func:`~repro_torch.kernels.collective.stats_for_dense_sources`) and is
charged by it, as the JAX engine's are. A replicated pool's retarget
under ``"collective"`` is fig21's two-phase install (one fetch a device
and new expert, then the local fan-out). ``decode_mode="scan"`` needs
NCCL on the card (a gloo collective cannot be captured: ``ValueError``);
on the CPU every mode runs eagerly. Under an FSDP decode policy
(``policy_for`` past 6 GB a model-axis shard: ``fsdp=True``,
``batch_axes=()``, ``cache_batch_axes=("data",)``) the leaves are also
stored over ``data`` and gathered a layer at a time, every rank decodes
every row as one dispatch group, and the dense cache holds the rank's
rows over ``data`` (:func:`~repro_torch.models.model.decode_cache_rows`):
the prefill's K/V is seated only by the row's owner, and a migration
record's ``payload_bytes`` counts each slot's whole row, every data row's
block of it.

**Two clocks.** The engine keeps two records of its work. The telemetry
hub, copied from the JAX package, stamps the simulated fleet's clock and
feeds the parity tests and the decision replay. The real-clock timeline
(:attr:`ServingEngine.timeline`, :mod:`~repro_torch.serving.timeline`)
stamps the host's ``time.perf_counter`` and feeds operators and the
benchmark: one ``step`` span a step with work, with its ``prefill``
(``issue``), ``decode`` and ``control`` children, and on each request
(``Request.timeline``) its first admission, its prefill and the steps it
decoded in. The timeline is always on, makes no device call and opens no
profiler range.

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

**Replication** (``EngineConfig(replication=ReplicationConfig(
replica_slots>0))``, the ``gem`` policy and a profile required): at
construction, before the decode step is captured, the virtual-order pool
is expanded into S = E_v + G·replica_slots rows a layer (each device's
extra slots copy its own experts) and the router remaps through (L, E_v,
P) replica-split tables. The one-shot replan retargets the pool to the
replication-aware plan in one row gather per layer; online replica
batches rewrite only their moved rows. Either way the tables are rebuilt
from the live layouts' shares and copied into the engine's one table
tensor. Step costs and straggler attribution follow the speed-proportional
split; regret prices against no placement. ``auto_slots`` derives
``replica_slots`` from ``hbm_budget_bytes`` minus the paged KV pool.

**Shedding** (``EngineConfig(shed=ShedConfig(enabled=True))``, a
replicated pool required): the dispatch's second pass re-seats
assignments past their slot's capacity on free rows of the expert's other
copies. After each step the engine reads the (L,) shed and overflow
counts and the (L, S) ``shed_delta``, charges the shed-adjusted latency,
and prices the next step's (L,) enables (one step behind); the captured
step reads the enables from its static input buffer, so a flip never
recaptures it.

The GEM planes (replans, online, replication, shedding) need a MoE config
and refuse the others, as the JAX engine does; a config without MoE
layers serves with no control plane.

On a host without a GPU, ``tests/test_torch_online.py`` holds the online
engine against the JAX engine in both decode modes
(``PYTHONPATH=src python -m pytest -q tests/test_torch_online.py``); on the
card, ``chip_smoke.py``'s ``online`` phase serves full granite with
``online=True`` and checks the rows, tables, tokens, launches and captures
after every batch has landed.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
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
from ..kernels.collective import (
    MigrationExecutable,
    gather_rows,
    stats_for_dense_sources,
)
from ..models.attention import sequence_shards
from ..models.dispatch import slot_capacity
from ..models.model import (
    DecodeGraph,
    decode_cache_rows,
    decode_step,
    init_decode_cache,
    init_paged_decode_cache,
    prefill,
)
from ..models.moe import apply_placement, identity_placement
from ..online import (
    DriftConfig,
    MigrationConfig,
    OnlineConfig,
    OnlineController,
)
from ..online.migration import (
    replica_install_phases,
    replica_source_permutation,
)
from ..replication import (
    ReplicatedPlacement,
    ReplicationConfig,
    plan_replicated_layers,
    replica_fetch_rows,
    replicated_step_cost_matrix,
    replicated_step_token_matrix,
    shed_adjusted_step_cost_matrix,
    shed_device_deltas,
    shed_gate_decisions,
)
from ..telemetry import (
    AttributionAccumulator,
    RegretTracker,
    Telemetry,
    attribute_step,
)
from ..telemetry.regret import record_step_metrics
from .arrivals import RequestSpec
from .kv_cache import (
    PagedKVConfig,
    PagedKVPool,
    kv_pool_bytes,
    replica_slots_for_headroom,
)
from ..sharding.policy import (
    ShardingPolicy,
    fsdp_gather_axis,
    host_policy,
    kv_shard,
    local_expert_slots,
)
from .sampling import sample
from .scheduler import Request, Scheduler
from .shed import ShedConfig, default_token_bytes
from .slo import slo_report
from .timeline import Timeline, clock

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
    # replica_slots>0 installs a replicated pool (E_v + G·slots rows a
    # layer) and replica-split router tables; needs the gem policy and a
    # profile
    replication: ReplicationConfig = ReplicationConfig()
    # enabled=True arms the dispatch's shed pass, priced each step for the
    # next one; needs a replicated pool
    shed: ShedConfig = ShedConfig()
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
    # "collective": rows over the mesh's model axis between the ranks that
    # hold the expert shards, and the records carry the measured traffic;
    # without a sharded pool (one device) it applies the same row copies
    # (bit for bit) and its records say "via": "host", as the JAX
    # engine's do without a live expert axis
    migration_via: str = "host"
    other_time_per_step: float = 0.0  # simulated non-MoE per-step latency
    moe_backend: str | None = None  # override ModelConfig.moe_backend for
    # the engine's data plane (einsum | pallas | dense_ref)
    # "auto" pages the KV cache on attention families without a sliding
    # window when the policy has no mesh; "paged" / "dense" force
    kv_mode: str = "auto"  # auto | paged | dense
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
    # HBM budget shared by the paged KV pool and the replica pool; needed
    # when replication.auto_slots derives replica_slots from the headroom
    hbm_budget_bytes: float | None = None


class ServingEngine:
    def __init__(self, params, config: ModelConfig,
                 engine_config: EngineConfig = EngineConfig(), *,
                 policy: ShardingPolicy | None = None,
                 profile: VariabilityProfile | None = None,
                 num_devices: int | None = None,
                 telemetry: Telemetry | None = None,
                 device=None):
        """``policy`` (keyword-only; the host policy, one device, when
        None) places the engine on a mesh of ranks; with a mesh,
        ``device`` defaults to the rank's own."""
        if engine_config.moe_backend is not None:
            config = dataclasses.replace(
                config, moe_backend=engine_config.moe_backend
            )
        policy = policy if policy is not None else host_policy()
        self.policy = policy
        if device is None and policy.mesh is not None:
            device = policy.mesh.device
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
        family_ok = (not (config.is_ssm or config.is_hybrid)
                     and config.sliding_window == 0)
        if engine_config.kv_mode == "auto":
            # the paged pool is not sharded: a mesh keeps the dense layout
            self.paged = family_ok and policy.mesh is None
        elif engine_config.kv_mode == "paged":
            if not family_ok:
                raise ValueError(
                    "kv_mode='paged' needs an attention-family arch without "
                    "a sliding window (SSM state is O(1) per slot; SWA ring "
                    "ages don't survive the block indirection)"
                )
            self.paged = True
        elif engine_config.kv_mode == "dense":
            self.paged = False
        else:
            raise ValueError(
                f"kv_mode={engine_config.kv_mode!r} not in "
                "('auto', 'paged', 'dense')"
            )
        block_size = engine_config.kv.block_size
        self._n_max = -(-engine_config.max_len // block_size)
        num_blocks = engine_config.kv.num_blocks
        if num_blocks is None:
            # every slot holds a full-length request: admission never fails
            num_blocks = 1 + engine_config.max_batch * self._n_max
        dtype_bytes = embed.dtype.itemsize
        if engine_config.replication.auto_slots:
            # replica copies get what the KV pool leaves of the budget
            if engine_config.hbm_budget_bytes is None or not config.is_moe:
                raise ValueError(
                    "replication.auto_slots needs a MoE config and "
                    "EngineConfig.hbm_budget_bytes — the replica budget is "
                    "derived from the paged KV pool's headroom"
                )
            pool_blocks = (num_blocks if self.paged
                           else 1 + engine_config.max_batch * self._n_max)
            pool_bytes = kv_pool_bytes(
                pool_blocks, block_size, config.num_layers,
                config.num_kv_heads, config.head_dim, dtype_bytes,
            )
            engine_config = dataclasses.replace(
                engine_config,
                replication=dataclasses.replace(
                    engine_config.replication,
                    auto_slots=False,
                    replica_slots=replica_slots_for_headroom(
                        engine_config.hbm_budget_bytes - pool_bytes,
                        d_model=config.d_model,
                        expert_d_ff=config.expert_d_ff // config.expert_tp,
                        num_layers=config.num_layers,
                        bytes_per_param=dtype_bytes,
                    ),
                ),
            )
        replica_slots = engine_config.replication.replica_slots
        if engine_config.shed.enabled and (profile is None
                                           or not config.is_moe
                                           or replica_slots <= 0):
            raise ValueError(
                "EngineConfig(shed.enabled=True) needs a MoE config, an "
                "attached VariabilityProfile, and a replicated pool "
                "(replication.replica_slots > 0) — overflow tokens can "
                "only re-seat on a live replica row, and the shed-vs-wait "
                "gate prices against the profile's staircase curves"
            )
        if engine_config.online and (profile is None or not config.is_moe):
            raise ValueError(
                "EngineConfig(online=True) needs a MoE config and an attached "
                "VariabilityProfile — without them no adaptation plane can "
                "run and the engine would silently never replan"
            )
        if replica_slots > 0 and (
            profile is None
            or not config.is_moe
            or engine_config.placement_policy != "gem"
        ):
            raise ValueError(
                "EngineConfig(replication.replica_slots>0) needs a MoE "
                "config, an attached VariabilityProfile, and the gem "
                "placement policy — the replica split is speed-proportional "
                "and only the gem planner is replication-aware"
            )
        self.params = params
        self.config = config
        self.ecfg = engine_config
        # the dense cache's rows this rank holds (None: all of them): the
        # rows it decodes, or under replicated activations its cache rows
        self._rows = decode_cache_rows(policy, engine_config.max_batch)
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
        self.kv_pool: PagedKVPool | None = None
        self.expert_counts: np.ndarray | None = None  # (L, E), last step
        self.sim_step_latencies: list[float] = []
        # the real-clock spans (serving/timeline.py), and the (start, end)
        # of the last install's issue of its forward
        self.timeline = Timeline()
        self._issued: tuple[float, float] | None = None
        self.profile = profile
        # ground truth, when a caller injects one that departs the profile
        self.true_profile: VariabilityProfile | None = None
        # the injected ground-truth interconnect (set_true_interconnect)
        self.true_interconnect: Any | None = None
        self.placement_applied = False
        # capacity-overflow shedding: (L,) int32 enables for the NEXT
        # step's shed pass; None when the plane is off, and the decode step
        # then holds no shed operation
        self._shed_enables: np.ndarray | None = None
        self._shed_token_bytes = 0.0
        self._shed_total = 0
        self._shed_overflow_total = 0
        self._shed_saved_s = 0.0
        self._shed_transfer_s = 0.0
        if profile is not None:
            # admission tracks the profiled fleet's slowest device
            self.scheduler.set_slow_device_factor(
                float(profile.relative_speed().min())
            )
        # GEM control plane: MoE configs only; None for the others
        self._placements: torch.Tensor | None = None
        self.planner: GEMPlanner | None = None
        self.controller: OnlineController | None = None
        self.attribution: AttributionAccumulator | None = None
        self.regret: RegretTracker | None = None
        self.current_placements: list[Placement] | None = None
        # the live replicated layouts; None without a replicated pool
        self.current_rplacements: list[ReplicatedPlacement] | None = None
        # the expert pool's global slot count S (each rank stores S/m rows
        # when the model axis divides S); None without MoE layers
        self._num_slots: int | None = None
        if config.is_moe:
            self._init_control_plane(profile, num_devices, replica_slots,
                                     dtype_bytes)

        if self.paged:
            self.kv_pool = PagedKVPool(
                num_blocks, block_size,
                watermark_blocks=engine_config.kv.watermark_blocks,
            )
            self.kv_pool.telemetry = self.telemetry
            self.caches = init_paged_decode_cache(
                config, num_blocks, block_size, device=self.device,
                dtype=embed.dtype,
            )
        else:
            # the rank's rows only, where the batch or the cache shards
            rows = self._rows
            self.caches = init_decode_cache(
                config,
                engine_config.max_batch if rows is None
                else rows.stop - rows.start,
                engine_config.max_len, device=self.device, dtype=embed.dtype,
                policy=policy,
            )
        self.cur_len = np.zeros(engine_config.max_batch, dtype=np.int32)
        self.last_token = np.zeros(engine_config.max_batch, dtype=np.int32)
        # (B, n_max) attention-side view of the paged cache; null-block
        # rows for idle slots. None on the dense cache
        self.block_tables = (
            np.zeros((engine_config.max_batch, self._n_max), dtype=np.int32)
            if self.paged else None
        )
        self.decode_graph: DecodeGraph | None = None
        self._decode = functools.partial(decode_step, policy=policy,
                                         num_slots=self._num_slots)
        if engine_config.decode_mode == "scan":
            self.decode_graph = DecodeGraph(
                self.params, self.caches, self._placements, config,
                batch=engine_config.max_batch,
                n_max=self._n_max if self.paged else None,
                device=self.device, shed=self._shed_enables is not None,
                policy=policy, num_slots=self._num_slots,
            )
            self._decode = self.decode_graph

    def _init_control_plane(self, profile, num_devices, replica_slots,
                            dtype_bytes) -> None:
        """The GEM planner, attribution, regret, the placement tables, the
        replicated pool, the migration executable, the shed plane and the
        online controller of a MoE config."""
        config, engine_config = self.config, self.ecfg
        # (L, E_v) expert→slot tables, identity while the pool is in
        # virtual-expert order; the one-shot replan swaps them. With a
        # replicated pool, (L, E_v, P) replica-split tables. One tensor for
        # the engine's life once the decode step is built: `placements = …`
        # copies into it
        self._placements = identity_placement(
            config, config.num_layers, device=self.device
        )
        nd = num_devices or (profile.num_devices if profile else 4)
        Ev = config.num_virtual_experts
        self._num_slots = Ev
        policy = self.policy
        if (engine_config.migration_via == "collective"
                and policy.mesh is not None and policy.model_axis_size > 1
                and nd != policy.model_axis_size):
            # the collective plane shards rows over the model axis, the
            # cost model prices locality by placement device: when the two
            # disagree a "cross-device" move can be a same-rank copy (or
            # the reverse), and measured traffic stops matching the model
            warnings.warn(
                f"migration_via='collective': placement device count {nd} "
                f"!= model-axis size {policy.model_axis_size}; measured "
                "migration traffic will not match the cost model's "
                "cross-device accounting",
                RuntimeWarning, stacklevel=3,
            )
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
        self.current_placements = [
            Placement.linear(Ev, nd) for _ in range(config.num_layers)
        ]
        if replica_slots > 0:
            # the replicated pool goes in now, before the decode step is
            # captured: the slot count is a run constant, and the capture
            # binds the expanded pool and the replica tables
            self.current_rplacements = [
                ReplicatedPlacement.linear(
                    Ev, nd, replica_slots, profile=profile,
                    config=engine_config.replication,
                )
                for _ in range(config.num_layers)
            ]
            self._install_replicated_pool(self.current_rplacements)
        # a pool sharded over ranks moves over the model axis under either
        # data plane; "collective" also measures what crossed
        shard_axis = policy.expert_collective_axis(self._num_slots)
        self._collective_axis = (
            shard_axis if engine_config.migration_via == "collective"
            else None)
        self._migrate = MigrationExecutable(
            mesh=policy.mesh if shard_axis is not None else None,
            axis=shard_axis or "model")
        # one cost model for both replan paths: the online plane prices its
        # batches with it and the one-shot swap is charged the same way
        self._cost_model = engine_config.migration.cost_model_for_dims(
            config.d_model, config.expert_d_ff // config.expert_tp,
            bytes_per_param=dtype_bytes,
        )
        if engine_config.shed.enabled:
            # all layers start disabled: step t's overflow prices step t+1
            self._shed_enables = np.zeros(config.num_layers, dtype=np.int32)
            self._shed_token_bytes = (
                float(engine_config.shed.token_bytes)
                if engine_config.shed.token_bytes is not None
                else default_token_bytes(config.d_model, dtype_bytes)
            )
            # the decode capacity the gate must predict: build_dispatch's
            # own formula, per data group
            gd = policy.data_axis_size if policy.mesh is not None else 1
            self._shed_capacity = slot_capacity(
                max(engine_config.max_batch // max(gd, 1), 1), config,
                capacity_factor=config.decode_capacity_factor,
                num_slots=self._num_slots, replicated=True,
            )
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

    @property
    def placements(self) -> torch.Tensor | None:
        """The int32 tables the model routes through: (L, E_v) expert→slot
        maps, or (L, E_v, P) replica-split tables with a replicated pool;
        None for a config without MoE layers."""
        return self._placements

    @placements.setter
    def placements(self, tables) -> None:
        """Copy new tables into the engine's one table tensor; the captured
        decode step reads that tensor, so it is never rebound."""
        if self._placements is None:
            raise ValueError(f"{self.config.name} has no MoE layers to place")
        tables = torch.as_tensor(tables, device=self.device)
        if tuple(tables.shape) != tuple(self._placements.shape):
            raise ValueError(
                f"placements {tuple(tables.shape)} != the engine's tables "
                f"{tuple(self._placements.shape)}: (L, E_v), or (L, E_v, P) "
                "with a replicated pool"
            )
        self._placements.copy_(tables)

    @property
    def shed_enables(self) -> np.ndarray | None:
        """A copy of the (L,) 0/1 shed enables the *next* step dispatches
        with (priced from the last step's overflow), or None when the shed
        plane is off."""
        if self._shed_enables is None:
            return None
        return self._shed_enables.copy()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: float | None = None, task: str = "") -> int:
        prompt = np.asarray(prompt, np.int32)
        if self.kv_pool is not None:
            total = int(prompt.shape[0]) + int(max_new_tokens)
            need = self.kv_pool.blocks_for(total)
            if need > self.kv_pool.usable_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only has "
                    f"{self.kv_pool.usable_blocks} — it could never be "
                    "served (grow PagedKVConfig.num_blocks or shorten it)"
                )
        self._uid += 1
        req = Request(
            self._uid, prompt, max_new_tokens,
            arrival_step=self.step_count, task=task,
        )
        req.timeline.spans = self.timeline
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
    def _whole_prompt_cache(self, caches, prompt_len: int):
        """The prefill's K/V whole over the prompt's positions: under a
        model axis that divides the prompt each rank holds its block, and
        the blocks are gathered (every rank prefills, so all call it). The
        SSM caches are whole over the prompt already (the rank's heads)."""
        policy = self.policy
        if ("attn" not in caches
                or sequence_shards(policy, prompt_len) == 1):
            return caches
        whole = {name: torch.cat(list(policy.mesh.all_gather(
            t, policy.model_axis).unbind(0)), dim=-3)
            for name, t in caches["attn"].items()}
        return {**caches, "attn": whole}

    def _write_slot(self, slot: int, req: Request) -> None:
        """Prefill one request and install its caches into slot ``slot`` of
        the dense cache: the K/V panels written at [0, P) and zeroed past
        the prompt, the SSM state and conv buffers replaced. A prompt
        longer than the panel (the ring, under a sliding window) raises
        ``ValueError``, where the JAX engine's pad by ``pool − new`` does.
        Under ``kv_seq`` sharding the rank writes the positions of its
        block only."""
        t_issue = clock()
        tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
        logits, caches = prefill(
            self.params, tokens, self.config, self.placements,
            policy=self.policy, num_slots=self._num_slots,
        )
        caches = self._whole_prompt_cache(caches, req.prompt_len)
        self.prefill_count += 1
        c = self.caches
        local = slot
        rows = self._rows
        if rows is not None:  # the rank holds only the rows it decodes
            local = slot - rows.start
        lo, n_kv = 0, 1
        kv = kv_shard(self.policy)
        if "attn" in c and kv is not None:
            n_kv = self.policy.mesh.size(kv)
            lo = self.policy.mesh.index(kv) * c["attn"]["k"].shape[-3]
        if "attn" in c:
            P = caches["attn"]["k"].shape[-3]
            S_pool = c["attn"]["k"].shape[-3] * n_kv
            if P > S_pool:
                raise ValueError(
                    f"prompt of {P} tokens does not fit the dense KV "
                    f"cache's {S_pool} positions a slot (the ring under "
                    "a sliding window: min(window, max_len))"
                )
        if rows is not None and not rows.start <= slot < rows.stop:
            c = {}  # another data rank decodes this row
        if "attn" in c:
            for name in ("k", "v"):
                pool, new = c["attn"][name], caches["attn"][name]
                panel = pool[..., local, :, :, :]
                mine = min(max(new.shape[-3] - lo, 0), panel.shape[-3])
                panel[..., :mine, :, :].copy_(
                    new[..., 0, lo:lo + mine, :, :])
                panel[..., mine:, :, :].zero_()
        for key in ("ssm", "ssm_staged", "ssm_tail"):
            if key in c:
                for part, pool in c[key].items():
                    # batch axis: state (…, B, nh, hd, N), conv (…, B, cw-1, C)
                    new = caches[key][part]
                    pool.select(pool.dim() - 4 if part == "state"
                                else pool.dim() - 3, local).copy_(
                        new.select(new.dim() - 4 if part == "state"
                                   else new.dim() - 3, 0))
        self._issued = (t_issue, clock())
        self.cur_len[slot] = req.prompt_len
        self.last_token[slot] = int(torch.argmax(logits[0]))
        self.installed[slot] = True

    def _install_paged_slot(self, slot: int, req: Request) -> None:
        """Prefill one request and write its K/V into its owned blocks (the
        paged pool is whole on every rank)."""
        t_issue = clock()
        tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
        logits, caches = prefill(
            self.params, tokens, self.config, self.placements,
            policy=self.policy, num_slots=self._num_slots,
        )
        caches = self._whole_prompt_cache(caches, req.prompt_len)
        self.prefill_count += 1
        self._issued = (t_issue, clock())
        table = self.kv_pool.block_table(req.uid)
        # a copy from pageable host memory: it waits for the forward
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

    def _prefill_phase(self, step_row: int) -> float:
        """Advance prefill for admitted-but-uninstalled slots; returns the
        simulated prefill time charged to this step. Each install is a
        real-clock ``prefill`` span under the step's span, at ``step_row``."""
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
                row = self.timeline.add(
                    "prefill", clock(), parent=step_row, uid=req.uid,
                    slot=slot, tokens=req.prompt_len)
                self._issued = None
                if self.paged:
                    self._install_paged_slot(slot, req)
                else:
                    self._write_slot(slot, req)
                self.timeline.close(row, clock())
                self.timeline.add("issue", *self._issued, parent=row)
                if req.timeline.prefill < 0:  # keep the first
                    req.timeline.prefill = row
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

    def _apply_migration_sources(self, src: np.ndarray, *,
                                 swap_tables: bool) -> list:
        """Rewrite the expert pool in place to ``new[l] = old[l][src[l]]``
        (only the moved rows are copied; over the mesh's model axis when
        the pool is sharded). With ``swap_tables`` (permutation batches)
        the swapped (L, E_v) tables are copied into the engine's one table
        tensor; replica batches leave the tables to the caller, which
        rebuilds them from the live layouts' shares. Nothing the captured
        decode step reads is rebound. Returns the per-layer
        :class:`~repro_torch.kernels.collective.CollectiveStats` of the
        batch under ``migration_via="collective"`` on a sharded pool, else
        an empty list (no measurement)."""
        moe = self.params["blocks"]["moe"]
        tables = self.placements if swap_tables else None
        ws = (moe["w_gate"], moe["w_up"], moe["w_down"])
        _, new_tables = self._migrate(src, tables, *ws)
        if swap_tables:
            self.placements = new_tables  # copied in place (setter)
        if self._collective_axis is None:
            return []
        # one slot's bytes over every rank of its model rank's column: a
        # rank stores its block of d_model under FSDP, and each data row
        # moves its own
        row_bytes = sum(int(np.prod(w.shape[2:])) * w.element_size()
                        for w in ws)
        if fsdp_gather_axis(self.policy):
            row_bytes *= self.policy.mesh.size("data")
        return [st for _, st in stats_for_dense_sources(
            src, self.policy.model_axis_size, row_bytes)]

    def _replica_tables(self, rplacements) -> np.ndarray:
        """(L, E_v, P) replica-split router tables of the layouts."""
        P = self.ecfg.replication.pattern_period
        return np.stack([rp.replica_table(P) for rp in rplacements])

    def _install_replicated_pool(self, rplacements) -> None:
        """Expand the virtual-ordered expert weights into the replicated
        slot pool: row ``s`` ← virtual expert ``slot_to_expert[s]``. Only
        valid while the pool is in virtual order, at construction before
        the decode step is captured: the expanded weights and the (L, E_v,
        P) table tensor are new tensors, which the capture then binds."""
        s2e = np.stack([rp.slot_to_expert for rp in rplacements])
        self._num_slots = s2e.shape[1]
        blocks = dict(self.params["blocks"])
        moe = blocks["moe"]
        policy, Ev = self.policy, self.config.num_virtual_experts
        if local_expert_slots(policy, Ev) is None:
            # the virtual pool is whole here: gather, and keep this rank's
            # slots of the new pool if the model axis divides it
            new = apply_placement(moe, torch.as_tensor(s2e, device=self.device))
            keep = local_expert_slots(policy, s2e.shape[1])
            if keep is not None:
                new = {k: (v[:, keep].contiguous()
                           if k in ("w_gate", "w_up", "w_down") else v)
                       for k, v in new.items()}
        else:
            # rows cross ranks: each new slot fetches its expert from the
            # rank that holds it
            keep = local_expert_slots(policy, s2e.shape[1])
            rows = s2e.shape[1] if keep is None else keep.stop - keep.start
            names = ("w_gate", "w_up", "w_down")
            outs = [moe[n].new_empty((moe[n].shape[0], rows,
                                      *moe[n].shape[2:])) for n in names]
            gather_rows(policy.mesh, policy.model_axis, s2e,
                        [moe[n] for n in names], outs)
            new = {**moe, **dict(zip(names, outs))}
        blocks["moe"] = new
        self.params = {**self.params, "blocks": blocks}
        self._placements = torch.as_tensor(
            self._replica_tables(rplacements), device=self.device
        )

    def _retarget_replicated_pool(self, rplacements) -> list:
        """Move the live replicated pool to new layouts in one row gather
        per layer (each target slot reads a current copy of its expert),
        in place, and copy the new layouts' tables into the table tensor.
        Under ``migration_via="collective"`` on a sharded pool it is the
        two-phase install: one fetch a (device, new expert) over the
        axis, then the fan-out within each rank, each phase one dense map;
        returns their measured stats (empty otherwise)."""
        if self._collective_axis is not None:
            spd = rplacements[0].slots_per_device
            phases = [replica_install_phases(cur.slot_layout(),
                                             new.slot_layout(), spd)
                      for cur, new in zip(self.current_rplacements,
                                          rplacements)]
            stats = []
            for phase in (0, 1):
                stats += self._apply_migration_sources(
                    np.stack([p[phase] for p in phases]).astype(np.int32),
                    swap_tables=False)
        else:
            srcs = np.stack([
                replica_source_permutation(cur.slot_layout(),
                                           new.slot_layout())
                for cur, new in zip(self.current_rplacements, rplacements)
            ])
            stats = self._apply_migration_sources(srcs.astype(np.int32),
                                                  swap_tables=False)
        self.placements = self._replica_tables(rplacements)
        return stats

    def set_true_profile(self, profile: VariabilityProfile | None) -> None:
        """Inject the *actual* fleet behaviour when it departs the believed
        profile (a mid-run power cap): simulated latencies come from this
        ground truth while the control plane keeps planning on its belief
        until the online plane's variability-drift detector repairs it."""
        self.true_profile = profile

    def set_true_interconnect(self, bandwidth: float,
                              base_overhead: float | None = None) -> None:
        """Inject the *actual* interconnect when it departs the cost
        model's configured assumption (a mis-specified fabric, a congested
        link). Measured migration times and the shed pass's transfer then
        come from this ground truth while the controller keeps pricing
        with its believed bandwidth, until its bandwidth estimator learns
        the real one from the measurements (with
        ``MigrationConfig.calibrate_bandwidth``)."""
        self.true_interconnect = dataclasses.replace(
            self._cost_model,
            bandwidth=float(bandwidth),
            base_overhead=(self._cost_model.base_overhead
                           if base_overhead is None
                           else float(base_overhead)),
        )

    @property
    def _measure_interconnect(self):
        """The interconnect that times executed batches and shed
        transfers: the injected ground truth, else the believed model."""
        if self.true_interconnect is not None:
            return self.true_interconnect
        return (self.controller.cost_model
                if self.controller is not None else self._cost_model)

    @property
    def _sim_profile(self) -> VariabilityProfile | None:
        return self.true_profile if self.true_profile is not None else self.profile

    def _step_cost_matrix(self, counts_virt: np.ndarray) -> np.ndarray | None:
        """(L, G) per-layer per-device latencies of this step on the
        ground-truth fleet, under the current placements (the
        speed-proportional split with a replicated pool)."""
        if self._sim_profile is None:
            return None
        if self.current_rplacements is not None:
            return replicated_step_cost_matrix(
                counts_virt, self._sim_profile, self.current_rplacements
            )
        return step_cost_matrix(
            counts_virt, self._sim_profile, self.current_placements
        )

    def _step_token_matrix(self, counts_virt: np.ndarray) -> np.ndarray | None:
        """(L, G) per-layer per-device token loads of this step: the
        straggler attribution's input, replica-split aware."""
        if self._sim_profile is None:
            return None
        G = self._sim_profile.num_devices
        if self.current_rplacements is not None:
            return replicated_step_token_matrix(
                counts_virt, G, self.current_rplacements
            )
        return step_token_matrix(counts_virt, G, self.current_placements)

    def _shed_operand(self) -> np.ndarray | None:
        """The decode step's (L,) shed enables, None when the plane is off
        (the step then holds no shed operation)."""
        return self._shed_enables

    def _shed_step(self, counts_virt: np.ndarray, moe_aux,
                   cost_mx: np.ndarray | None) -> float | None:
        """Per-step shed accounting and the next step's gate pricing.

        Reads the (L,) ``overflow_tokens`` and ``shed_tokens`` and the
        (L, S) ``shed_delta`` back after the step (never inside the
        captured body). Returns the shed-adjusted latency the simulated
        fleet paid this step, transfer included, or None when nothing shed
        (the caller then charges ``cost_mx``). The controller, attribution
        and regret keep seeing the un-shed ``cost_mx``."""
        tel = self.telemetry
        overflow = moe_aux.overflow_tokens.cpu().numpy().astype(np.int64)
        shed_tok = moe_aux.shed_tokens.cpu().numpy().astype(np.int64)
        shed_delta = moe_aux.shed_delta.cpu().numpy().astype(np.int64)
        total_over = int(overflow.sum())
        total_shed = int(shed_tok.sum())
        self._shed_overflow_total += total_over
        if total_over:
            tel.counter("shed.overflow_tokens").inc(total_over)

        adjusted: float | None = None
        prof = self._sim_profile
        if (total_shed > 0 and prof is not None and cost_mx is not None
                and self.current_rplacements is not None):
            tokens = self._step_token_matrix(counts_virt)  # un-shed (L, G)
            spd = self.current_rplacements[0].slots_per_device
            adj_mx = shed_adjusted_step_cost_matrix(
                tokens, shed_delta, prof, spd
            )
            # only rows that change device cross the interconnect, charged
            # at the measuring interconnect's bandwidth (the injected ground
            # truth when there is one): the migration batches' rule
            cross_rows = float(
                np.maximum(shed_device_deltas(shed_delta, spd), 0.0).sum()
            )
            transfer_s = (cross_rows * self._shed_token_bytes
                          / self._measure_interconnect.bandwidth)
            legacy = float(cost_mx.max(axis=1).sum())
            adjusted = float(adj_mx.max(axis=1).sum()) + transfer_s
            self._shed_total += total_shed
            self._shed_transfer_s += transfer_s
            self._shed_saved_s += legacy - adjusted
            tel.counter("shed.tokens").inc(total_shed)
            tel.counter("shed.steps").inc()
            tel.counter("shed.transfer_s").inc(transfer_s)
            tel.gauge("shed.saved_s").set(self._shed_saved_s)
            if tel.enabled:
                recv_dev = np.maximum(
                    shed_device_deltas(shed_delta, spd), 0.0
                ).sum(axis=0)  # (G,) assignments received per device
                total_recv = float(recv_dev.sum())
                for g in range(recv_dev.shape[0]):
                    if recv_dev[g] <= 0:
                        continue
                    tel.emit_span(
                        "shed.recv", self.sim_time,
                        transfer_s * float(recv_dev[g]) / total_recv,
                        track=f"device{g}", step=self.step_count,
                        tokens=int(recv_dev[g]),
                    )

        # price the NEXT step's enables from this step's overflow with the
        # believed profile and bandwidth
        shed = self.ecfg.shed
        if self.controller is not None:
            enables = self.controller.shed_decisions(
                counts_virt, overflow,
                token_bytes=self._shed_token_bytes,
                capacity=self._shed_capacity,
                min_overflow=shed.min_overflow,
                hysteresis=shed.hysteresis,
                drop_penalty_s=shed.drop_penalty_s,
            )
        else:
            enables = shed_gate_decisions(
                counts_virt, self.current_rplacements, self.profile,
                self._shed_capacity,
                bandwidth=self._cost_model.bandwidth,
                token_bytes=self._shed_token_bytes,
                min_overflow=shed.min_overflow,
                hysteresis=shed.hysteresis,
                drop_penalty_s=shed.drop_penalty_s,
            )
        self._shed_enables = np.asarray(enables, dtype=np.int32)
        return adjusted

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
            placements=(None if self.current_rplacements is not None
                        else self.current_placements),
            lagging=lagging,
        )
        record_step_metrics(self.telemetry, sr, self.step_count)

    def _maybe_replan(self) -> None:
        """The one-shot replan: once the threshold step is reached and every
        layer's collector holds ``trace_length`` steps, plan with the
        configured policy and apply it between two decode steps. The
        online mode replans on drift instead (:meth:`_online_step`)."""
        if (self.planner is None or self.controller is not None
                or self.placement_applied or self.profile is None):
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
        elif self.current_rplacements is not None:
            self._retarget_replan()
            return
        else:
            placements = self.planner.plan().placements
        # Step-4: the pool is still in virtual order, so each layer's
        # row-source map is its slot_to_expert table, and the table swap
        # inverts it into expert_to_slot; the pool is rewritten in place
        slot_to_expert = np.stack([p.slot_to_expert() for p in placements])
        stats = self._apply_migration_sources(
            slot_to_expert.astype(np.int32), swap_tables=True)
        # the swap moves weights: charge its cost (modelled, or measured
        # over the mesh) to the step that performs it
        moves = sum(
            len(cur.moved_slots(new))
            for cur, new in zip(self.current_placements, placements)
        )
        swap_cost = self._record_migration(moves, self._cost_model.cost(moves),
                                           stats)
        if self.sim_step_latencies:
            self.sim_step_latencies[-1] += swap_cost
        self.sim_time += swap_cost
        self.current_placements = placements
        self.placement_applied = True

    def _retarget_replan(self) -> None:
        """The one-shot replan of a replicated pool: the replication-aware
        plan, priced by the rows each device must fetch, audited, and
        applied as one retarget of the pool."""
        rplacements = [
            r.placement
            for r in plan_replicated_layers(self.planner,
                                            self.ecfg.replication)
        ]
        moves = sum(
            replica_fetch_rows(cur, new)
            for cur, new in zip(self.current_rplacements, rplacements)
        )
        # the decision's live and target layouts ride the event, so that a
        # replay re-derives the priced move count from the log alone
        self.telemetry.instant(
            "audit.retarget",
            track="controller",
            step=self.step_count,
            num_experts=int(self.planner.num_experts),
            num_devices=int(self.profile.num_devices),
            slot_layouts=[
                rp.slot_layout().tolist() for rp in self.current_rplacements
            ],
            target_layouts=[rp.slot_layout().tolist() for rp in rplacements],
            moves=int(moves),
            modeled_s=float(self._cost_model.cost(moves)),
        )
        stats = self._retarget_replicated_pool(rplacements)
        swap_cost = self._record_migration(moves, self._cost_model.cost(moves),
                                           stats)
        if self.sim_step_latencies:
            self.sim_step_latencies[-1] += swap_cost
        self.sim_time += swap_cost
        self.current_rplacements = rplacements
        self.placement_applied = True

    def _online_step(self, counts_virt: np.ndarray,
                     cost_mx: np.ndarray) -> float:
        """Drive the online controller for one step; returns the migration
        cost to charge to this step's simulated latency.

        The controller sees the (L, E_v) counts and the per-device observed
        MoE time on the ground-truth fleet; a batch it hands back is one
        dense (L, S) row-source map, identity but for its moved slots,
        applied to the pool in place. A swap batch swaps the router tables
        in the same call; a replica batch (a replicated pool) takes the
        controller's tables, rebuilt from the new layouts' shares."""
        ctrl = self.controller
        decision = ctrl.observe_step(counts_virt, cost_mx.sum(axis=0))
        charge = decision.migration_cost
        if decision.migration_step is not None:
            src = ctrl.dense_migration_sources(decision.migration_step)
            stats = self._apply_migration_sources(
                src, swap_tables=not ctrl.replicated)
            charge = self._record_migration(
                decision.migration_step.num_moves, decision.migration_cost,
                stats, cost_mx,
            )
            if ctrl.replicated:
                self.placements = ctrl.expert_to_slot_tables()
                self.current_rplacements = list(ctrl.current_rplacements)
            else:
                self.current_placements = list(ctrl.current_placements)
        if decision.profile_rescaled:
            self.profile = ctrl.profile
            self.scheduler.set_slow_device_factor(
                float(self.profile.relative_speed().min())
            )
            if ctrl.replicated:
                # the repair re-shared every replicated expert: the split
                # tables follow now, not at the next batch
                self.placements = ctrl.expert_to_slot_tables()
                self.current_rplacements = list(ctrl.current_rplacements)
        # "applied" means a planned placement reached the pool (a 0-move
        # schedule counts), not that a plan was made and gate-skipped
        if self.controller.planned and any(
            r["applied"] for r in self.controller.replans
        ):
            self.placement_applied = True
        return charge

    def _record_migration(self, moves: int, modeled_s: float, stats=(),
                          cost_mx: np.ndarray | None = None) -> float:
        """Record one applied batch's measured-vs-modeled cost on the
        telemetry hub; returns the charge for the step.

        ``stats`` are the batch's measured per-layer
        :class:`~repro_torch.kernels.collective.CollectiveStats`: none on
        one device or under ``migration_via="host"``, and the modelled
        cost is charged, as the JAX engine's host path and its collective
        path without a live expert axis do. A measured batch (the
        collective plane's over a mesh) is timed by the
        (possibly injected) true interconnect on the payload its schedules
        shipped; the double-buffered copy can hide
        ``migration.overlap_fraction`` of its transfer behind this step's
        MoE compute (``cost_mx``'s per-layer maxima), so only the rest is
        charged, and the measurement feeds the controller's bandwidth
        estimator. The JAX engine's ``_record_migration``."""
        record: dict[str, Any] = {
            "step": self.step_count,
            "via": self.ecfg.migration_via if stats else "host",
            "moves": int(moves),
            "modeled_s": float(modeled_s),
        }
        charge = float(modeled_s)
        tel = self.telemetry
        if stats:
            total = stats[0]
            for st in stats[1:]:
                total = total + st
            mi = self._measure_interconnect
            measured_s = mi.cost_bytes(total.payload_bytes)
            transfer_s = total.payload_bytes / mi.bandwidth
            compute_s = (float(cost_mx.max(axis=1).sum())
                         if cost_mx is not None else 0.0)
            overlap_s = min(
                self.ecfg.migration.overlap_fraction * transfer_s, compute_s)
            charge = max(measured_s - overlap_s, 0.0)
            record.update(
                measured_s=float(measured_s),
                charged_s=float(charge),
                payload_bytes=int(total.payload_bytes),
                cross_rows=int(total.cross_rows),
                local_rows=int(total.local_rows),
                rounds=int(total.rounds),
                overlap_s=float(overlap_s),
            )
            tel.counter("migrate.payload_bytes").inc(
                float(total.payload_bytes))
            tel.counter("migrate.rounds").inc(float(total.rounds))
            if self.controller is not None:
                self.controller.observe_migration_measurement(
                    total.payload_bytes, measured_s, modeled_s=modeled_s,
                    step=self.step_count,
                )
        tel.counter("migrate.applies").inc()
        record["sim_time"] = float(self.sim_time)
        tel.record_migration(record)
        tel.emit_span("migrate", self.sim_time, charge,
                      moves=record["moves"], via=record["via"])
        return charge

    # ------------------------------------------------------------------
    def step(self) -> dict[str, Any]:
        """One engine iteration: ingest arrivals → admit → prefill →
        decode → sample → bookkeeping (continuous batching). A step with
        work is one real-clock ``step`` span (serving/timeline.py)."""
        t_step = clock()
        self._ingest_arrivals()
        tel = self.telemetry
        t0 = self.sim_time
        can_admit = self._kv_admit if self.kv_pool is not None else None
        for _slot, req in self.scheduler.admit(can_admit=can_admit):
            req.start_step = self.step_count

        if not self.scheduler.active:
            return {"active": 0}

        step_row = self.timeline.add("step", t_step, step=self.step_count)
        rows_before = int(self.installed.sum())
        prefill_charge = self._prefill_phase(step_row)
        if self.paged:
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
            self.timeline.close(step_row, clock())
            return {
                "active": self.scheduler.num_active,
                "finished": len(self.finished),
                "sim_latency": prefill_charge,
                "placement_applied": self.placement_applied,
            }

        dev = self.device
        if self.paged:
            cur_len = self.cur_len
        else:
            # one length shared by the batch, the longest row's: shorter
            # rows attend over the zero panels past their prompts (the JAX
            # engine's dense approximation)
            cur_len = np.asarray(self.cur_len.max(), dtype=np.int32)
        inputs = (cur_len, self.last_token[:, None], self.block_tables)
        if self.decode_graph is None:  # "python": new device tensors a step
            inputs = tuple(None if a is None else torch.as_tensor(a, device=dev)
                           for a in inputs)
        shed = self._shed_operand()
        if self.decode_graph is None and shed is not None:
            shed = torch.as_tensor(shed, device=dev)
        cur_len, tokens, block_tables = inputs
        t_decode = clock()
        logits, self.caches, moe_aux = self._decode(
            self.params, self.caches, cur_len, tokens, self.config,
            self.placements, block_tables=block_tables, shed_enables=shed,
        )
        self.timeline.add("decode", t_decode, clock(), parent=step_row,
                          rows_before=rows_before)
        self.decode_count += 1
        generator = None
        if self.ecfg.temperature > 0.0:
            generator = torch.Generator(device=dev)
            generator.manual_seed(self.step_count)
        next_tokens = sample(
            logits, temperature=self.ecfg.temperature, generator=generator
        ).cpu().numpy()
        sim_latency = prefill_charge + self.ecfg.other_time_per_step
        if moe_aux is not None:
            t_control = clock()
            sim_latency = self._moe_step(moe_aux, sim_latency)
            self.timeline.add("control", t_control, clock(),
                              parent=step_row)
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
            req.timeline.steps.append(step_row)
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
            if self.kv_pool is not None:
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
        self.timeline.close(step_row, clock())
        return {
            "active": self.scheduler.num_active,
            "finished": len(self.finished),
            "sim_latency": sim_latency,
            "placement_applied": self.placement_applied,
        }

    def _moe_step(self, moe_aux, sim_latency: float) -> float:
        """The GEM control plane's share of a step: Step-1's counts, the
        simulated MoE latency (shed-adjusted with the shed plane on),
        attribution, regret, and the online plane or the one-shot
        planner's trace. Returns ``sim_latency`` with the step's charges
        added in the JAX engine's order."""
        tel = self.telemetry
        # read back after the step (a replay's static outputs), never
        # inside the captured body
        self.expert_counts = moe_aux.expert_counts.cpu().numpy()
        dropped = int(moe_aux.dropped_tokens.cpu().numpy().sum())
        # GEM Step-1: the router's per-layer counts, in virtual experts
        counts_virt = np.repeat(self.expert_counts, self.config.expert_tp,
                                axis=1)
        cost_mx = self._step_cost_matrix(counts_virt)
        shed_latency = None
        if self._shed_enables is not None:
            # shedding changes what the fleet paid, not what the control
            # plane sees: cost_mx stays the un-shed matrix below
            shed_latency = self._shed_step(counts_virt, moe_aux, cost_mx)
        if shed_latency is not None:
            sim_latency += shed_latency
        elif cost_mx is not None:
            sim_latency += float(cost_mx.max(axis=1).sum())
        self._observe_attribution(counts_virt)
        self._observe_regret(counts_virt, cost_mx)
        tel.counter("dispatch.dropped_tokens").inc(dropped)
        if self.controller is not None:
            sim_latency += self._online_step(counts_virt, cost_mx)
        else:
            for layer in range(self.config.num_layers):
                self.planner.observe_step(layer, counts_virt[layer])
        return sim_latency

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
        """Paged-pool occupancy/pressure counters (empty when dense)."""
        if self.kv_pool is None:
            return {}
        out = self.kv_pool.stats()
        out["kv_preemptions"] = float(self.preemption_count)
        return out

    def latency_report(self) -> dict[str, float]:
        """Step-level latency stats (``mean_tpot`` etc. are *step*
        latencies) merged with the per-request SLO percentiles and the
        paged-pool counters, the online plane's replan and migration totals,
        the shed totals, the measured migration totals (when a batch was
        measured), and the attribution and regret summaries: the JAX
        engine's report."""
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
        if self._shed_enables is not None:
            out.update(
                shed_tokens=float(self._shed_total),
                shed_overflow_tokens=float(self._shed_overflow_total),
                shed_saved_s=float(self._shed_saved_s),
                shed_transfer_s=float(self._shed_transfer_s),
            )
        measured = [r for r in self.migration_records if "measured_s" in r]
        if measured:
            out.update(
                migration_modeled_s=float(
                    sum(r["modeled_s"] for r in measured)),
                migration_measured_s=float(
                    sum(r["measured_s"] for r in measured)),
                migration_payload_bytes=float(
                    sum(r["payload_bytes"] for r in measured)),
                migration_overlap_s=float(
                    sum(r["overlap_s"] for r in measured)),
            )
        if self.attribution is not None and self.attribution.steps > 0:
            # the per-device straggler tally (a list) stays on the
            # accumulator and in the registry
            out.update(
                (k, v) for k, v in self.attribution.summary().items()
                if isinstance(v, float)
            )
        if self.regret is not None and self.regret.steps > 0:
            out.update(self.regret.summary())
        return out

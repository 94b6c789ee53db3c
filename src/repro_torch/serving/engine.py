"""Continuous-batching serving engine on the paged KV cache, with GEM's
one-shot control plane.

Port of the serving core of ``repro/serving/engine.py``: a fixed pool of
``max_batch`` decode slots, FCFS admission against the paged KV pool,
one prefill per admitted request (chunked-prefill accounting optional),
youngest-first preemption when the pool runs dry, and a simulated clock
advanced by the configured per-step and per-prefill-token costs. Every
step runs the model's decode step over all ``max_batch`` rows, idle ones
included, exactly as the JAX engine does, so the MoE layers see the same
batches on both.

The GEM control plane (:mod:`repro_torch.core`), as the JAX engine runs it
without the online plane:

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

The engine starts from the linear layout (identity tables, weights in
virtual-expert order). A caller may still install a placement of its own by
replacing ``params["blocks"]["moe"]`` and ``placements`` together when no
profile is attached, in which case the engine never replans.

``decode_mode`` picks how the decode step runs, as in the JAX engine.
``"scan"`` (the default) runs it through
:class:`~repro_torch.models.model.DecodeGraph`: captured once as a CUDA
graph when the engine is built, replayed every step, with the step's
inputs, the router tables, the expert pool and the KV pools at fixed
addresses, so a migration never recaptures it
(:attr:`ServingEngine.graph_capture_counts`). ``"python"`` is the eager
per-layer loop, the parity baseline. Whatever the decode step reads is
updated in place: assigning ``placements`` copies into the engine's one
table tensor, and the swap rewrites the pool in place. Replacing a weight
tensor after the capture recaptures, and is counted.

Not here yet: the online plane, replication (``replica_slots > 0`` raises
``NotImplementedError``) and shedding, the collective migration path,
telemetry with its attribution and regret, and the dense KV mode (it comes
with the sliding-window families).
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
from ..core.score import step_cost_matrix
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
from ..online.migration import MigrationConfig
from ..replication.types import ReplicationConfig
from .arrivals import RequestSpec
from .kv_cache import PagedKVConfig, PagedKVPool
from .sampling import sample
from .scheduler import Request, Scheduler
from .slo import slo_report

__all__ = ["EngineConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0
    gem: GEMConfig = GEMConfig()
    placement_policy: str = "gem"  # gem | eplb | linear
    replan_after: int | None = None  # engine steps before replan (default:
    # gem.trace_length; 0 means "as soon as the trace collectors fill")
    # replica_slots > 0 raises NotImplementedError until replication lands
    replication: ReplicationConfig = ReplicationConfig()
    # prices the one-shot swap (MigrationCostModel for the expert dims)
    migration: MigrationConfig = MigrationConfig()
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
        rep = engine_config.replication
        if rep.replica_slots > 0 or rep.auto_slots:
            raise NotImplementedError(
                "expert replication is not ported yet: the replicated pool, "
                "the replica split and the replication-aware planner come "
                "with the replication plane"
            )
        self.params = params
        self.config = config
        self.ecfg = engine_config
        self.sim_time = 0.0
        self.scheduler = Scheduler(
            engine_config.max_batch,
            admit_lookahead=engine_config.admit_lookahead,
            ttft_slo_s=engine_config.ttft_slo_s,
        )
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
        self.migration_records: list[dict[str, Any]] = []
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
        if profile is not None:
            self.planner.set_profile(profile)
        self.current_placements: list[Placement] = [
            Placement.linear(Ev, nd) for _ in range(config.num_layers)
        ]
        self._migrate = MigrationExecutable()
        self._cost_model = engine_config.migration.cost_model_for_dims(
            config.d_model, config.expert_d_ff // config.expert_tp,
            bytes_per_param=embed.dtype.itemsize,
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
        installed_now: list[Request] = []
        for slot, req in sorted(self.scheduler.active.items()):
            if self.installed[slot]:
                continue
            advance = req.prompt_len - req.prefill_progress
            if chunk > 0:
                advance = min(advance, chunk)
            req.prefill_progress += advance
            charge += advance * self.ecfg.prefill_time_per_token
            if req.prefilled:
                self._install_paged_slot(slot, req)
                installed_now.append(req)
        self.sim_time += charge
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
    def set_true_profile(self, profile: VariabilityProfile | None) -> None:
        """Inject the *actual* fleet behaviour when it departs the believed
        profile (a mid-run power cap): simulated latencies come from this
        ground truth while the planner keeps planning on its belief."""
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

    def _maybe_replan(self) -> None:
        """The one-shot replan: once the threshold step is reached and every
        layer's collector holds ``trace_length`` steps, plan with the
        configured policy and apply it between two decode steps."""
        if self.placement_applied or self.profile is None:
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
        moe = self.params["blocks"]["moe"]
        _, self.placements = self._migrate(  # copied in place (setter)
            slot_to_expert.astype(np.int32), self.placements,
            moe["w_gate"], moe["w_up"], moe["w_down"],
        )
        # the swap moves weights: charge its modelled cost (the host path
        # measures nothing) to the step that performs it
        moves = sum(
            len(cur.moved_slots(new))
            for cur, new in zip(self.current_placements, placements)
        )
        swap_cost = float(self._cost_model.cost(moves))
        self.migration_records.append({
            "step": self.step_count, "via": "host", "moves": int(moves),
            "modeled_s": swap_cost, "sim_time": float(self.sim_time),
        })
        if self.sim_step_latencies:
            self.sim_step_latencies[-1] += swap_cost
        self.sim_time += swap_cost
        self.current_placements = placements
        self.placement_applied = True

    # ------------------------------------------------------------------
    def step(self) -> dict[str, Any]:
        """One engine iteration: ingest arrivals → admit → prefill →
        decode → sample → bookkeeping (continuous batching)."""
        self._ingest_arrivals()
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
        self.expert_counts = moe_aux.expert_counts.cpu().numpy()

        # GEM Step-1: the router's per-layer counts, in virtual experts
        sim_latency = prefill_charge + self.ecfg.other_time_per_step
        counts_virt = np.repeat(self.expert_counts, self.config.expert_tp,
                                axis=1)
        cost_mx = self._step_cost_matrix(counts_virt)
        if cost_mx is not None:
            sim_latency += float(cost_mx.max(axis=1).sum())
        for layer in range(self.config.num_layers):
            self.planner.observe_step(layer, counts_virt[layer])
        self.sim_step_latencies.append(sim_latency)
        # _prefill_phase already advanced the clock by its charge
        self.sim_time += sim_latency - prefill_charge

        done_slots = []
        for slot, req in list(self.scheduler.active.items()):
            if not self.installed[slot]:
                continue  # still prefilling (chunked): no token this step
            tok = int(next_tokens[slot])
            req.generated.append(tok)
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

        self.step_count += 1
        self._maybe_replan()
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
        paged-pool counters: the JAX engine's report without the keys of
        the planes not ported yet (online, shed, collective, attribution,
        regret)."""
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
        return out

"""Continuous-batching serving engine on the paged KV cache.

Port of the serving core of ``repro/serving/engine.py``: a fixed pool of
``max_batch`` decode slots, FCFS admission against the paged KV pool,
one prefill per admitted request (chunked-prefill accounting optional),
youngest-first preemption when the pool runs dry, and a simulated clock
advanced by the configured per-step and per-prefill-token costs. Every
step runs the model's decode step over all ``max_batch`` rows, idle ones
included, exactly as the JAX engine does, so the MoE layers see the same
batches on both.

The engine serves under the placement installed in its public ``params``
and ``placements`` attributes (:func:`repro_torch.models.moe.
apply_placement` on the weights, the (L, E_v) ``expert_to_slot`` tables),
the same way as the JAX engine built with ``profile=None``; it does not
replan. After each decode step ``expert_counts`` holds that step's
per-layer (L, E) router counts, GEM's Step-1 trace.

Not here yet: the GEM planner and replans, the online plane, replication
and shedding, migration, telemetry, and the dense KV mode (it comes with
the sliding-window families).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.model import decode_step, init_paged_decode_cache, prefill
from ..models.moe import identity_placement
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
    other_time_per_step: float = 0.0  # simulated non-MoE per-step latency
    kv: PagedKVConfig = PagedKVConfig()
    # chunked prefill: >0 spreads a prompt's *simulated* prefill time over
    # ceil(P/chunk) engine steps; the prefill itself runs once, when the
    # last chunk lands
    prefill_chunk: int = 0
    prefill_time_per_token: float = 0.0  # simulated prefill s/token
    admit_lookahead: int = 8  # scheduler head-of-line lookahead window
    ttft_slo_s: float | None = None  # TTFT target the scheduler records


class ServingEngine:
    def __init__(self, params, config: ModelConfig,
                 engine_config: EngineConfig = EngineConfig(), *,
                 device=None):
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(
                f"params live on {embed.device}, engine runs on {self.device}"
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
        # (L, E_v) expert→slot tables; a caller installs a placement by
        # replacing these together with params["blocks"]["moe"]
        self.placements = identity_placement(
            config, config.num_layers, device=self.device
        )
        self.expert_counts: np.ndarray | None = None  # (L, E), last step
        self.sim_step_latencies: list[float] = []

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
        self._decode = decode_step

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
            }

        dev = self.device
        logits, self.caches, moe_aux = self._decode(
            self.params, self.caches,
            torch.as_tensor(self.cur_len, device=dev),
            torch.as_tensor(self.last_token[:, None], device=dev),
            self.config, self.placements,
            block_tables=torch.as_tensor(self.block_tables, device=dev),
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

        sim_latency = prefill_charge + self.ecfg.other_time_per_step
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
        return {
            "active": self.scheduler.num_active,
            "finished": len(self.finished),
            "sim_latency": sim_latency,
        }

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.scheduler.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ------------------------------------------------------------------
    def slo_report(self) -> dict[str, float]:
        """Per-request percentile TTFT/TPOT/E2E (serving/slo.py)."""
        return slo_report(self.finished)

    def kv_stats(self) -> dict[str, float]:
        """Paged-pool occupancy/pressure counters."""
        out = self.kv_pool.stats()
        out["kv_preemptions"] = float(self.preemption_count)
        return out

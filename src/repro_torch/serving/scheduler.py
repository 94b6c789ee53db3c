"""Request scheduling: FCFS slot assignment with token + KV-block budgets.

The port's own copy of ``repro/serving/scheduler.py`` (numpy only). The
engine binds its telemetry hub to :attr:`Scheduler.telemetry`, which
counts admissions, budget skips and KV blocks, and records queue age and
TTFT slack as the JAX scheduler does; the online plane re-wires the slow
device factor when it repairs the profile. Admission also stamps a
request's first admission on its real-clock ``Request.timeline``
(:mod:`~repro_torch.serving.timeline`). On the CPU,
``PYTHONPATH=src python -m pytest -q tests/test_torch_online.py`` holds
these instruments against the JAX engine's registry; on the card,
``chip_smoke.py``'s ``online`` phase admits a 48-request stream through
this scheduler and checks its tokens against a ``linear`` run.

The engine runs a fixed pool of ``max_batch`` decode slots (continuous
batching: a finished request's slot is immediately refillable). The
scheduler decides which queued requests to admit each step:

  * the **prefill token budget** guards prefill cost per step; the
    variability-aware mode (beyond-paper, §Perf) weights it by the
    profiled speed of the slowest device so admission bursts don't
    amplify stragglers;
  * the **KV-block budget** (``can_admit`` callback from the engine's
    paged pool) refuses requests the physical cache can't hold;
  * admission scans a bounded ``lookahead`` window past a budget-blocked
    head instead of stopping at it — an over-budget request at the head
    no longer starves smaller queued requests of free slots (head-of-line
    fix). Skipped requests keep their queue position, and the head is
    always first in line for the replenished budget next step, so FCFS
    completion-order fairness survives. A *KV*-blocked request stops the
    scan entirely: blocks only free on completion, so skipping past a
    memory-blocked request would let later arrivals starve it.

``requeue_front`` supports preemption: a request evicted when the KV pool
runs dry re-enters at the head of the queue (its service order is
preserved; its generated tokens are recomputed on re-admission).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np

from .timeline import RequestTimeline, clock

__all__ = ["Request", "Scheduler"]

# decade ladders for the admission-time instruments (upper bucket edges,
# seconds). Queue age is non-negative sim-time; TTFT slack is signed —
# negative buckets count admissions that already missed the target.
QUEUE_AGE_BOUNDS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)
TTFT_SLACK_BOUNDS = (-1.0, -1e-1, -1e-2, 0.0, 1e-2, 1e-1, 1.0, 10.0)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    arrival_step: int = 0
    # filled by the engine
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    prompt_len: int = 0
    start_step: int = -1
    finish_step: int = -1
    arrival_time: float = 0.0
    finish_time: float = 0.0
    # serving-plane lifecycle (continuous batching)
    first_token_time: float = -1.0  # sim-time of the prefill's output token
    prefill_progress: int = 0  # prompt tokens prefilled so far (chunked)
    preemptions: int = 0  # times evicted by KV-pool pressure
    task: str = ""  # arrival-process task name (mix accounting)
    # the real-clock stamps and spans (serving/timeline.py)
    timeline: RequestTimeline = dataclasses.field(
        default_factory=RequestTimeline, compare=False, repr=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32)
        self.prompt_len = int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def prefilled(self) -> bool:
        return self.prefill_progress >= self.prompt_len


class Scheduler:
    def __init__(self, max_batch: int, *, prefill_token_budget: int = 8192,
                 slow_device_factor: float = 1.0, admit_lookahead: int = 8,
                 ttft_slo_s: float | None = None):
        self.max_batch = max_batch
        self.prefill_token_budget = prefill_token_budget
        self.slow_device_factor = slow_device_factor  # <1 ⇒ tighter budget
        self.admit_lookahead = admit_lookahead
        # optional TTFT target (sim-seconds): admission records each
        # request's remaining slack against it (see admit())
        self.ttft_slo_s = None if ttft_slo_s is None else float(ttft_slo_s)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}  # slot → request
        # optional repro.telemetry.Telemetry hub (the engine binds its
        # own): admission outcome counters, pure host-side bookkeeping
        self.telemetry = None

    def set_slow_device_factor(self, factor: float) -> None:
        """Tighten/relax the prefill budget to the fleet's slowest device.

        The engine wires this from the attached
        :class:`~repro.core.types.VariabilityProfile` (slowest device's
        relative throughput) and re-wires it when the online plane repairs
        the profile mid-run, so admission bursts track the *current* fleet.
        """
        if not 0.0 < factor:
            raise ValueError("slow_device_factor must be positive")
        self.slow_device_factor = float(min(factor, 1.0))

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def requeue_front(self, req: Request) -> None:
        """Re-queue a preempted request at the head (service order kept)."""
        req.slot = -1
        req.prefill_progress = 0
        self.queue.appendleft(req)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.max_batch) if s not in self.active]

    def admit(self, *, can_admit=None) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots within the budgets.

        ``can_admit(req) -> bool`` is the engine's KV-pool gate (None when
        the pool is dense/unpaged). Scans up to ``admit_lookahead`` queue
        entries: budget-blocked entries are skipped in place, the first
        KV-blocked entry ends the scan (see module docstring for why the
        two budgets starve differently).
        """
        admissions: list[tuple[int, Request]] = []
        budget = int(self.prefill_token_budget * self.slow_device_factor)
        free = self.free_slots()
        idx = 0
        scanned = 0
        while free and idx < len(self.queue) and scanned < self.admit_lookahead:
            req = self.queue[idx]
            scanned += 1
            # the head always has first claim on a fresh budget: admit it
            # even over-budget when nothing else was admitted this step
            # (progress guarantee for prompts larger than the budget)
            fits_budget = req.prompt_len <= budget or not admissions
            if not fits_budget:
                if self.telemetry is not None:
                    self.telemetry.counter("sched.budget_skips").inc()
                idx += 1  # skipped in place — keeps its queue position
                continue
            # the engine's can_admit may reserve KV blocks on success, so
            # it runs only after every cheaper gate has passed
            if can_admit is not None and not can_admit(req):
                if self.telemetry is not None:
                    self.telemetry.counter("sched.kv_blocked").inc()
                break  # KV-blocked: blocks free on completion only
            del self.queue[idx]
            budget -= req.prompt_len
            slot = free.pop(0)
            req.slot = slot
            self.active[slot] = req
            admissions.append((slot, req))
            if math.isnan(req.timeline.admitted):  # the first admission
                req.timeline.admitted = clock()
            if self.telemetry is not None:
                self._record_admission(req)
        if admissions and self.telemetry is not None:
            self.telemetry.counter("sched.admitted").inc(len(admissions))
        return admissions

    def _record_admission(self, req: Request) -> None:
        """Admission-time queue-age / TTFT-slack instruments.

        Queue age is hub-clock *now* (the engine binds its simulated
        time) minus the request's arrival time. When a TTFT target is
        configured, the remaining slack ``ttft_slo_s - age`` is recorded
        per request — negative slack means the request already aged past
        its target while queued, before prefill even starts; those
        admissions also bump ``sched.slo_at_risk``.
        """
        tel = self.telemetry
        age = max(0.0, float(tel.now()) - float(req.arrival_time))
        tel.histogram("sched.queue_age_s", QUEUE_AGE_BOUNDS).observe(age)
        slack = None
        if self.ttft_slo_s is not None:
            slack = self.ttft_slo_s - age
            tel.histogram(
                "sched.ttft_slack_s", TTFT_SLACK_BOUNDS
            ).observe(slack)
            if slack <= 0.0:
                tel.counter("sched.slo_at_risk").inc()
        args = {"uid": int(req.uid), "queue_age_s": age}
        if slack is not None:
            args["ttft_slack_s"] = slack
        tel.instant("sched.admit", track="sched", **args)

    def release(self, slot: int) -> Request:
        return self.active.pop(slot)

    @property
    def num_active(self) -> int:
        return len(self.active)

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active)

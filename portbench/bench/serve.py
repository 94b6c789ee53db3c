"""A serve cell: the port's continuous-batching engine under an open loop.

Set-up makes the weights from the seed, builds the engine through the
port's public API (``ServingEngine`` on the weight tree, its decode step
captured once as a CUDA graph), serves a warm-up of the mix's own prompts
for ``GEMConfig.trace_length`` decode steps, plans a GEM placement from
the router's counts on the emulated fleet that ``launch/serve.py`` uses,
and installs it in place (``models.apply_placement`` on the expert pool,
``ServingEngine.placements`` for the tables), so that the captured step
reads the new layout and nothing is captured again. The engine's own
replan stays off: no fleet profile is attached, so the window's host work
is the engine's and not the emulated fleet's.

The window submits each request when it is due, steps the engine while it
holds work and sleeps until the next request is due when it holds none.
The benchmark wraps four of the engine's calls, and renames none of them:
``scheduler.admit`` (admission), ``_install_paged_slot`` or
``_write_slot`` (a request's prefill, ending when its first token is on
the host), ``_decode`` (the decode step) and ``step`` itself, stamping
each on the host clock; with ``--trace 1`` each also becomes a profiler
range, the decode step is timed with CUDA events and waited for, and
each prefill's MoE layers report the assignments their K1 launches got.
Once the window closes the engine keeps stepping, with no new request,
until every request due in the window has its first token (at most a
minute): a late answer counts its wait.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import time

import numpy as np
import torch

from ..traffic import process
from . import check
from . import weights as W

clock = time.perf_counter
DRAIN_S = 60.0


@dataclasses.dataclass(eq=False)
class Rec:
    """One request of the window, as the benchmark saw it."""

    spec: process.Request
    due: float  # host clock
    submitted: float
    ereq: object  # the engine's Request
    admit: float = math.nan
    first: float = math.nan  # its first token on the host
    t0: int = -1  # the prefill's token
    tokens: list = dataclasses.field(default_factory=list)  # decode stamps
    pos: list = dataclasses.field(default_factory=list)  # decode positions

    @property
    def finished(self) -> bool:
        return self.ereq.finish_step >= 0


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: str
    seconds: float
    setup_s: float
    start: float
    end: float
    model: dict
    slots: int
    requests: list  # Rec of every request due in the window
    steps: list  # (start, end) of engine.step
    prefills: list  # (start, end, prompt_len)
    decodes: list  # (start, end, [keys a row attends to]) host
    waits: list  # (start, end): the engine held no request
    decode_event_ms: list  # CUDA events a decode step (--trace 1)
    trace: dict | None = None  # the profiled slice (--trace 1)


def _model_config(m: dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**m)


def _dtype(cfg: dict):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["engine"]["dtype"]]


def check_layout(weights: dict, mc, dtype) -> None:
    """The weight tree has the port's layout: the leaves, shapes and dtypes
    of ``init_params`` on the meta device."""
    from repro_torch.models import init_params

    want = dict(W.leaves(init_params(mc, device="meta", dtype=dtype)))
    got = dict(W.leaves(weights))
    if set(want) != set(got):
        raise ValueError(f"weight leaves differ: {sorted(set(want) ^ set(got))}")
    for k, t in want.items():
        if tuple(t.shape) != tuple(got[k].shape) or t.dtype != got[k].dtype:
            raise ValueError(f"{k}: {tuple(got[k].shape)} {got[k].dtype}, "
                             f"the port wants {tuple(t.shape)} {t.dtype}")


def decode_capacity_holds_batch(m: dict, batch: int) -> bool:
    """Whether a decode step's per-slot capacity ``ceil(B·k/E·cf)`` holds the
    whole batch, so that no decode assignment is ever dropped and a row's
    tokens do not depend on the other rows."""
    c = math.ceil(batch * m["experts_per_token"] / m["num_experts"]
                  * m["decode_capacity_factor"])
    return c >= batch


def build_engine(cfg: dict, traffic: dict, weights: dict, device):
    from repro_torch.core import GEMConfig
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.kv_cache import PagedKVConfig

    e, g = cfg["engine"], cfg["gem"]
    mc = _model_config(cfg["model"])
    check_layout(weights, mc, _dtype(cfg))
    if not decode_capacity_holds_batch(cfg["model"], traffic["slots"]):
        raise ValueError("decode_capacity_factor must give every slot room "
                         "for the whole batch")
    ecfg = EngineConfig(
        max_batch=traffic["slots"],
        max_len=process.max_len(traffic, e["block_size"]),
        temperature=0.0,
        gem=GEMConfig(trace_length=g["trace_length"],
                      num_restarts=g["num_restarts"]),
        placement_policy="linear",
        kv_mode=e["kv_mode"],
        kv=PagedKVConfig(block_size=e["block_size"]),
        decode_mode=e["decode_mode"],
    )
    return ServingEngine(weights, mc, ecfg, device=device)


def emulated_profile(g: dict):
    """The fleet profile of ``launch/serve.py``: staircase devices at the
    setup's spread, profiled at the tile boundaries."""
    from repro_torch.core import (DeviceFleet, profile_fleet, setup_speeds,
                                  simulator_measure_fn)

    fleet = DeviceFleet.from_speeds(
        setup_speeds(g["variability"], g["num_devices"]),
        tile=g["tile"], tile_time=g["tile_time"])
    return profile_fleet(simulator_measure_fn(fleet), g["num_devices"],
                         max_tokens=g["max_tokens"], tile=g["tile"],
                         repeats=g["repeats"]).profile


def plan_and_install(engine, cfg: dict) -> dict:
    """GEM's plan from the warm-up's router counts, installed in place."""
    from repro_torch.core import GEMConfig, gem_place
    from repro_torch.models import apply_placement

    g = cfg["gem"]
    t0 = clock()
    profile = emulated_profile(g)
    gcfg = GEMConfig(trace_length=g["trace_length"],
                     num_restarts=g["num_restarts"])
    placements = [gem_place(c.trace(window=g["trace_length"]), profile,
                            gcfg).placement
                  for c in engine.planner.collectors]
    s2e = np.stack([p.slot_to_expert() for p in placements]).astype(np.int32)
    e2s = np.stack([p.expert_to_slot() for p in placements]).astype(np.int32)
    plan_s = clock() - t0
    pool = engine.params["blocks"]["moe"]
    names = ("w_gate", "w_up", "w_down")
    with torch.no_grad():
        for layer in range(s2e.shape[0]):
            moved = apply_placement({n: pool[n][layer:layer + 1] for n in names},
                                    s2e[layer:layer + 1])
            for n in names:
                pool[n][layer].copy_(moved[n][0])
    engine.placements = e2s
    moved = int((s2e != np.arange(s2e.shape[1])).sum())
    return {"plan_s": plan_s, "moved_slots": moved}


def _submit(engine, r: process.Request) -> object:
    engine.submit(r.prompt, r.max_new_tokens, task=r.task)
    return engine.scheduler.queue[-1]


def warm_up(engine, cfg: dict, traffic: dict, seed: int) -> int:
    """Serve ``slots`` requests of the mix's prompts (the longest prompt of
    its clip among them) for ``trace_length`` decode steps and more, until
    the engine is empty again. Returns the decode steps run."""
    g = cfg["gem"]
    reqs = process.warmup(traffic, cfg["model"]["vocab_size"], seed,
                          traffic["slots"], g["trace_length"] + 4)
    for r in reqs:
        _submit(engine, r)
    before = engine.decode_count
    while engine.scheduler.has_work():
        engine.step()
    steps = engine.decode_count - before
    if steps < g["trace_length"]:
        raise RuntimeError(f"warm-up ran {steps} decode steps, fewer than "
                           f"the trace length {g['trace_length']}")
    return steps


class _Hooks:
    """The wrappers around the engine's calls that stamp the window."""

    def __init__(self, engine, *, trace: bool, fault=None):
        self.engine = engine
        self.trace = trace
        self.fault = fault
        self.by_slot: dict[int, Rec] = {}
        self.by_req: dict[int, Rec] = {}
        self.prefills: list = []
        self.decodes: list = []
        self.events: list = []  # (start, end) CUDA events a decode
        self.decode_counts: dict[int, np.ndarray] = {}  # K2's (L, E) a step
        self.prefill_work: dict[int, list] = {}  # (assignments, slots) a layer
        self._work: list | None = None
        sched = engine.scheduler
        self._admit = sched.admit
        sched.admit = self.admit
        self._install_name = ("_install_paged_slot" if engine.paged
                              else "_write_slot")
        self._install = getattr(engine, self._install_name)
        setattr(engine, self._install_name, self.install)
        self._decode = engine._decode
        engine._decode = self.decode
        if trace:
            import repro_torch.models.moe as moe_mod

            self._moe_mod = moe_mod
            self._expert_compute = moe_mod.expert_compute

    def _range(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def admit(self, **kw):
        out = self._admit(**kw)
        t = clock()
        for slot, req in out:
            rec = self.by_req.get(id(req))
            if rec is not None and math.isnan(rec.admit):
                rec.admit = t
        return out

    def _counting_expert_compute(self, xg, plan, *a, **kw):
        ng = xg.shape[1]
        self._work.append(torch.stack([(plan.dispatch_idx < ng).sum(),
                                       (plan.dispatch_idx[..., 0] < ng).sum()]))
        return self._expert_compute(xg, plan, *a, **kw)

    def install(self, slot, req):
        idx = len(self.prefills)
        rec = self.by_req.get(id(req))
        with self._range(f"pb.prefill#{idx}"):
            if self.trace:
                self._work = []
                self._moe_mod.expert_compute = self._counting_expert_compute
            t0 = clock()
            try:
                self._install(slot, req)
            finally:
                if self.trace:
                    self._moe_mod.expert_compute = self._expert_compute
            t1 = clock()
        if self.fault is not None:
            self.fault("prefill", self.engine, slot)
        self.prefills.append((t0, t1, int(req.prompt_len)))
        if self.trace:
            self.prefill_work[idx] = self._work
            self._work = None
        if rec is not None:
            rec.first = t1
            rec.t0 = int(self.engine.last_token[slot])
            self.by_slot[slot] = rec

    def decode(self, params, caches, cur_len, tokens, *a, **kw):
        eng = self.engine
        idx = len(self.decodes)
        rows = np.nonzero(eng.installed)[0]
        lens = np.broadcast_to(np.asarray(cur_len), (len(eng.installed),))
        window = eng.config.sliding_window
        keys = []
        for slot in rows:
            c = int(lens[slot])
            keys.append(min(c, window - 1) + 1 if window else c + 1)
            rec = self.by_slot.get(int(slot))
            if rec is not None:
                rec.pos.append(c)
        with self._range(f"pb.decode#{idx}"):
            t0 = clock()
            if self.trace:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = self._decode(params, caches, cur_len, tokens, *a, **kw)
            if self.trace:
                ev[1].record()
                ev[1].synchronize()
                self.events.append(ev)
            t1 = clock()
        if self.fault is not None:
            out = self.fault("decode", eng, out)
        self.decodes.append((t0, t1, keys))
        return out

    def remove(self) -> None:
        """Put the engine's own calls back."""
        eng = self.engine
        eng.scheduler.admit = self._admit
        setattr(eng, self._install_name, self._install)
        eng._decode = self._decode

    def close(self, step_counts: dict) -> None:
        """Read back what the trace kept on the device."""
        self.decode_counts = step_counts
        self.prefill_work = {
            i: torch.stack(w).cpu().tolist() if w else []
            for i, w in self.prefill_work.items()}


def setup(cell, *, seed: int, device, t_origin: float, log) -> dict:
    """Weights, engine, warm-up and placement. ``t_origin`` is the
    process's start on the host clock: set-up is counted from it."""
    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    weights = W.make(cfg["model"], seed, device, _dtype(cfg))
    engine = build_engine(cfg, traffic, weights, device)
    captures = dict(engine.graph_capture_counts)
    warm_steps = warm_up(engine, cfg, traffic, seed)
    placed = plan_and_install(engine, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = clock() - t_origin
    log(f"set-up {setup_s:.2f} s: warm-up {warm_steps} decode steps, "
        f"plan {placed['plan_s']:.2f} s, {placed['moved_slots']} slots moved")
    return {"cell": cell, "engine": engine, "weights": weights,
            "device": device, "setup_s": setup_s, "captures": captures,
            "seed": seed}


def window(state: dict, *, seconds: float, trace: bool, rate=None,
           fault=None, finish: bool = False, log) -> dict:
    """Serve one window; return what the metrics and the check need. With
    ``finish`` the engine serves every request it took to its end."""
    cell, engine = state["cell"], state["engine"]
    traffic, m = cell.traffic, cell.config["model"]
    seed = state["seed"]
    cuda = state["device"].type == "cuda"
    reqs = process.generate(traffic, m["vocab_size"], seed,
                            process.count_for(traffic, seconds, rate),
                            rate=rate)
    hooks = _Hooks(engine, trace=trace, fault=fault)
    recs: list[Rec] = []
    active: list[Rec] = []
    steps, waits = [], []
    counts: dict[int, np.ndarray] = {}
    prof = slice_rf = None
    prof_at = prof_until = math.inf
    launches0 = launches1 = None
    if trace:
        from repro_torch.kernels import launches

        # the profiler's first start sets up its tracer: do it before the
        # window opens
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=state["device"]).add_(1)
    start = clock()
    end = start + seconds
    if trace:
        # the slice opens just before the first request due from
        # ``trace_at`` of the window on, so that it holds that prefill
        at = seconds * float(traffic["trace_at"])
        due = next((r.due for r in reqs if r.due >= at), at)
        prof_at = start + max(at, due - 0.05)
        prof_until = prof_at + min(float(traffic["trace_seconds"]), seconds)
    nxt = 0
    closed = False
    drain_until = end + (10 * DRAIN_S if finish else DRAIN_S)
    while True:
        now = clock()
        if not closed and now >= end:
            closed = True
        if trace and prof is None and now >= prof_at:
            if cuda:
                torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            slice_rf = torch.profiler.record_function("pb.slice")
            slice_rf.__enter__()
            launches0 = dict(launches.LAUNCHES)
            # the profiler's start takes its time: the slice runs from here
            prof_until = clock() + min(float(traffic["trace_seconds"]),
                                       seconds)
        if slice_rf is not None and now >= prof_until:
            if cuda:
                torch.cuda.synchronize()
            launches1 = dict(launches.LAUNCHES)
            slice_rf.__exit__(None, None, None)
            slice_rf = None
            prof.stop()
        if closed:
            answered = all(not math.isnan(r.first) for r in recs)
            if ((answered and not finish) or now >= drain_until
                    or not engine.scheduler.has_work()):
                break
        else:
            while nxt < len(reqs) and start + reqs[nxt].due <= now:
                r = reqs[nxt]
                ereq = _submit(engine, r)
                rec = Rec(r, start + r.due, clock(), ereq)
                hooks.by_req[id(ereq)] = rec
                recs.append(rec)
                active.append(rec)
                nxt += 1
        if engine.scheduler.has_work():
            n_dec = len(hooks.decodes)
            with hooks._range(f"pb.step#{len(steps)}"):
                t0 = clock()
                engine.step()
                t1 = clock()
            steps.append((t0, t1))
            if trace and len(hooks.decodes) > n_dec:
                counts[n_dec] = engine.expert_counts.copy()
            still = []
            for rec in active:
                n = len(rec.ereq.generated)
                while len(rec.tokens) < n:
                    rec.tokens.append(t1)
                if not rec.finished:
                    still.append(rec)
            active = still
        elif not closed:
            until = end if nxt >= len(reqs) else min(end, start + reqs[nxt].due)
            if slice_rf is not None:
                until = min(until, prof_until)
            elif trace and prof is None:
                until = min(until, prof_at)
            with hooks._range("pb.wait"):
                t0 = clock()
                delay = until - t0
                if delay > 0:
                    time.sleep(delay)
                t1 = clock()
            waits.append((t0, t1))
    if slice_rf is not None:  # the window ended inside the slice
        if cuda:
            torch.cuda.synchronize()
        launches1 = dict(launches.LAUNCHES)
        slice_rf.__exit__(None, None, None)
        prof.stop()
    if cuda:
        torch.cuda.synchronize()
    drained = clock()
    hooks.remove()
    hooks.close(counts)
    mem_peak = torch.cuda.max_memory_allocated(state["device"]) if cuda else 0
    late = sorted(r.submitted - r.due for r in recs) or [0.0]
    log(f"window {seconds} s: {len(recs)} due, {len(steps)} steps, "
        f"{engine.preemption_count} preemptions, served "
        f"{max(0.0, drained - end):.2f} s past the close; submitted late "
        f"by {late[len(late) // 2] * 1e3:.1f} ms (median), "
        f"{late[-1] * 1e3:.1f} ms (most)")
    if steps:  # the longest step, and what it held
        i = max(range(len(steps)), key=lambda k: steps[k][1] - steps[k][0])
        a, b = steps[i]
        held = [p for p in hooks.prefills if a <= p[0] <= b]
        longest = max((w[1] - w[0] for w in waits), default=0.0)
        log(f"longest step {(b - a) * 1e3:.1f} ms at {a - start:.2f} s: "
            f"{len(held)} prefills of {[p[2] for p in held]} tokens, "
            f"{sum(p[1] - p[0] for p in held) * 1e3:.1f} ms; longest wait "
            f"{longest * 1e3:.1f} ms")
    if cuda:
        ms = torch.cuda.memory_stats(state["device"])
        log(f"allocator: {ms.get('num_alloc_retries', 0)} retries, "
            f"{ms.get('num_ooms', 0)} OOMs, reserved peak "
            f"{ms.get('reserved_bytes.all.peak', 0)} B")
    run = Run(
        cell=cell.name, seconds=seconds, setup_s=state["setup_s"],
        start=start, end=end, model=m, slots=traffic["slots"],
        requests=recs,
        steps=[s for s in steps if start <= s[0] < end],
        prefills=[p for p in hooks.prefills if start <= p[0] < end],
        decodes=[d for d in hooks.decodes if start <= d[0] < end],
        waits=[w for w in waits if start <= w[0] < end],
        decode_event_ms=[a.elapsed_time(b) for (a, b), d in
                         zip(hooks.events, hooks.decodes) if start <= d[0] < end],
    )
    if prof is not None:
        from . import trace as trace_mod

        t_read = clock()
        run.trace = trace_mod.collect(
            prof, decode_counts=hooks.decode_counts,
            prefill_work=hooks.prefill_work,
            launches=({k: launches1[k] - launches0[k] for k in launches0}
                      if launches1 is not None else {}))
        log(f"trace read in {clock() - t_read:.2f} s: "
            f"{len(run.trace['ops'])} device operations")
        del prof
    return {
        "run": run,
        "memory_peak_bytes": int(mem_peak),
        "captures": (state["captures"], dict(engine.graph_capture_counts)),
        "preemptions": int(engine.preemption_count),
        "decode_dropped": float(
            engine.telemetry.counter("dispatch.dropped_tokens").value),
        "paged": bool(engine.paged),
        "max_len": int(engine.ecfg.max_len),
        "attempted": len(recs),
    }


def passes(checks: dict) -> bool:
    """Every number read, and none above its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def judge(cell, state: dict, w: dict, *, seed: int, device, log,
          control: bool = False) -> dict:
    """Decide ``correct`` once the window has closed: free the program's
    state, run the sample of finished requests through the reference, and
    hold each number to its limit. With ``control`` the float8 control's
    gaps at the same positions go through the same comparison in the
    program's place, and ``control_correct`` is that verdict."""
    run = w["run"]
    t_check = clock()
    limits = cell.config["check"]
    unanswered = sum(math.isnan(r.first) for r in run.requests)
    picked = check.sample(run.requests, tokens=cell.traffic["check_tokens"],
                          most=cell.traffic["check_requests"], seed=seed)
    faults = check.schedule_faults(picked, paged=w["paged"])
    for f in faults:
        log(f"schedule: {f}")
    release(state)
    got = {"requests": 0, "tokens": 0}
    if picked and not faults:
        got = check.run_check(cell.config, picked, seed=seed, device=device,
                              paged=w["paged"], max_len=w["max_len"],
                              control=control)
    log(f"check: {got['requests']} requests, {got['tokens']} served tokens, "
        f"{clock() - t_check:.2f} s")
    for k in ("program", "control"):
        if k in got:
            log(f"{k} gaps: {json.dumps(got[k])}")

    def compared(side: str) -> dict:
        # a number the check could not read is null, and fails
        return {name: {"value": got.get(side, {}).get(name), "limit": limit}
                for name, limit in limits.items()}

    plain = {
        "unanswered": {"value": unanswered, "limit": 0},
        "schedule_faults": {"value": len(faults), "limit": 0},
        "decode_dropped": {"value": w["decode_dropped"], "limit": 0},
        "preemptions": {"value": w["preemptions"], "limit": 0},
        "decode_captures": {"value": w["captures"][1]["decode"],
                            "limit": w["captures"][0]["decode"]},
    }
    checks = {**compared("program"), **plain}
    out = {"correct": bool(picked) and passes(checks), "failed": unanswered,
           "checks": checks}
    if control:
        ctl = compared("control")
        out["control_correct"] = bool(picked) and passes({**ctl, **plain})
        checks.update({"control." + k: v for k, v in ctl.items()})
    return out


def release(state: dict) -> None:
    """Free the program's state (engine, caches, graph, weights)."""
    for k in ("engine", "weights"):
        state.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

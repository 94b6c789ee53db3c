"""Streaming request generators: Poisson, diurnal, and burst arrivals.

The trace-replay engine consumed one fixed workload in lock-step; this
module produces *live traffic* — timestamped requests whose prompt
contents, lengths, and output budgets are drawn from a task mix — so the
online controller chases a moving workload instead of a scripted shift.

Tasks tie into the :mod:`repro.core.workload` phenomenology from the
serving side: the engine's router is driven by real token ids, so a task's
**vocab band** (the slice of the vocabulary its prompts sample from)
determines which experts its tokens excite. Shifting the task mix mid-run
therefore shifts the per-layer expert counts the GEM planner sees — the
serving-plane analogue of ``generate_trace``'s ``identity_seed`` change.
Burst arrival regimes use ``_burst_mask``, a copy of the JAX package's
``core/workload.py`` chain (the sticky on/off process that drives temporal
expert groups there), so both packages draw the same streams from a seed.

Prompt lengths are drawn from a small per-task *bucket set* rather than a
continuum: each distinct prompt length compiles one prefill program, so
buckets bound jit recompilation while still exercising ragged batches.

Every generator is deterministic in its seed (CI's ``--seed`` contract).
``batch_arrivals`` is the degenerate process — the whole request list at
``t=0`` in submission order — under which the continuous-batching engine
must reproduce trace-replay tokens bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


__all__ = [
    "RequestSpec",
    "TaskProfile",
    "ArrivalConfig",
    "generate_arrivals",
    "batch_arrivals",
    "DEFAULT_TASKS",
]


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request on the wire: when it arrives and what it asks for."""

    arrival_time: float
    prompt: np.ndarray  # (P,) int32 token ids
    max_new_tokens: int
    task: str = ""


@dataclasses.dataclass(frozen=True)
class TaskProfile:
    """A request population: prompt-length buckets, output budget, vocab band.

    ``vocab_band`` is the (lo, hi) *fraction* of the vocabulary this task's
    prompts sample from — distinct bands give distinct router footprints,
    which is what makes a mix shift visible to the drift detector.
    """

    name: str
    prompt_buckets: tuple[int, ...] = (8, 16, 32)
    bucket_weights: tuple[float, ...] | None = None  # default: uniform
    output_mean: float = 16.0
    output_bounds: tuple[int, int] = (4, 48)
    vocab_band: tuple[float, float] = (0.0, 1.0)

    def __post_init__(self):
        if not self.prompt_buckets:
            raise ValueError("prompt_buckets must be non-empty")
        if self.bucket_weights is not None and len(self.bucket_weights) != len(
            self.prompt_buckets
        ):
            raise ValueError("bucket_weights must match prompt_buckets")
        lo, hi = self.vocab_band
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError("vocab_band must satisfy 0 <= lo < hi <= 1")

    def sample(self, rng: np.random.Generator, vocab_size: int
               ) -> tuple[np.ndarray, int]:
        """Draw one (prompt, max_new_tokens) pair."""
        w = self.bucket_weights
        if w is None:
            plen = int(rng.choice(self.prompt_buckets))
        else:
            p = np.asarray(w, np.float64)
            plen = int(rng.choice(self.prompt_buckets, p=p / p.sum()))
        lo = int(self.vocab_band[0] * vocab_size)
        hi = max(lo + 1, int(self.vocab_band[1] * vocab_size))
        prompt = rng.integers(lo, hi, size=plen, dtype=np.int32)
        o_lo, o_hi = self.output_bounds
        out = int(np.clip(round(rng.exponential(self.output_mean)), o_lo, o_hi))
        return prompt, out


# Two default populations with disjoint vocab bands: a mix shift between
# them moves the router's expert histogram (drift-detector food).
DEFAULT_TASKS: tuple[TaskProfile, ...] = (
    TaskProfile("chat", prompt_buckets=(8, 16), output_mean=20.0,
                vocab_band=(0.0, 0.5)),
    TaskProfile("summarize", prompt_buckets=(16, 32), output_mean=8.0,
                output_bounds=(4, 24), vocab_band=(0.5, 1.0)),
)


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Arrival process parameters. ``rate`` is mean requests per simulated
    second; the burst/diurnal processes modulate around it while keeping
    the same long-run mean."""

    rate: float = 50.0
    num_requests: int = 32
    process: str = "poisson"  # poisson | diurnal | burst
    # diurnal: sinusoidal rate swing rate·(1 ± depth) over one period
    diurnal_period: float = 2.0  # simulated seconds per cycle
    diurnal_depth: float = 0.8
    # burst: sticky on/off regimes (``_burst_mask``); rate is
    # multiplied in bursts and rebalanced outside so the mean stays `rate`
    burst_multiplier: float = 4.0
    burst_active_frac: float = 0.25
    burst_regime_len: int = 8  # regime steps (each 1/rate seconds long)

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError("rate must be positive")
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        if self.process not in ("poisson", "diurnal", "burst"):
            raise ValueError(f"unknown process {self.process!r}")
        if self.burst_multiplier <= 1.0:
            raise ValueError("burst_multiplier must be > 1")
        if not 0.0 < self.burst_active_frac < 1.0:
            raise ValueError("burst_active_frac must be in (0, 1)")
        if not 0.0 <= self.diurnal_depth < 1.0:
            raise ValueError("diurnal_depth must be in [0, 1)")


def _burst_mask(
    num_steps: int, active_frac: float, burst_len: int, rng: np.random.Generator
) -> np.ndarray:
    """Contiguous on/off phases with the requested stationary active fraction."""
    mask = np.zeros(num_steps, dtype=bool)
    t = 0
    on = rng.random() < active_frac
    while t < num_steps:
        dur = max(1, int(rng.geometric(1.0 / burst_len)))
        if on:
            mask[t : t + dur] = True
        t += dur
        # transition probabilities chosen so the chain's stationary
        # distribution matches active_frac
        on = rng.random() < (active_frac if not on else active_frac)
        # make bursts sticky: once on, stay on with prob ~ active_frac**0.5
        if mask[min(t, num_steps) - 1]:
            on = rng.random() < active_frac ** 0.5
    return mask


def _poisson_times(cfg: ArrivalConfig, rng: np.random.Generator) -> np.ndarray:
    gaps = rng.exponential(1.0 / cfg.rate, size=cfg.num_requests)
    return np.cumsum(gaps)


def _diurnal_times(cfg: ArrivalConfig, rng: np.random.Generator) -> np.ndarray:
    """Nonhomogeneous Poisson via Lewis–Shedler thinning against the
    sinusoidal rate λ(t) = rate·(1 + depth·sin(2πt/period))."""
    rate_max = cfg.rate * (1.0 + cfg.diurnal_depth)
    times = []
    t = 0.0
    while len(times) < cfg.num_requests:
        t += rng.exponential(1.0 / rate_max)
        lam = cfg.rate * (
            1.0 + cfg.diurnal_depth * np.sin(2.0 * np.pi * t / cfg.diurnal_period)
        )
        if rng.random() < lam / rate_max:
            times.append(t)
    return np.asarray(times)


def _burst_times(cfg: ArrivalConfig, rng: np.random.Generator) -> np.ndarray:
    """Markov-modulated Poisson: sticky on/off regimes from ``_burst_mask``.

    Regime r's rate is ``rate·mult`` when on and ``rate·off_scale`` when
    off, with ``off_scale`` solving the stationarity constraint
    ``frac·mult + (1-frac)·off_scale = 1`` so the long-run mean stays
    ``rate``.
    """
    frac, mult = cfg.burst_active_frac, cfg.burst_multiplier
    off_scale = max((1.0 - frac * mult) / (1.0 - frac), 0.05)
    # enough regime steps to cover the request count with margin
    n_regimes = max(16, int(4 * cfg.num_requests / max(cfg.rate, 1e-9)) + 16)
    regime_dt = 1.0 / cfg.rate * cfg.burst_regime_len
    mask = _burst_mask(n_regimes, frac, cfg.burst_regime_len, rng)
    times = []
    t = 0.0
    for r in range(n_regimes):
        lam = cfg.rate * (mult if mask[r] else off_scale)
        end = (r + 1) * regime_dt
        while True:
            t += rng.exponential(1.0 / lam)
            if t >= end:
                t = end  # carry into the next regime
                break
            times.append(t)
            if len(times) >= cfg.num_requests:
                return np.asarray(times)
    # tail: finish at the base rate if the regimes ran out
    while len(times) < cfg.num_requests:
        t += rng.exponential(1.0 / cfg.rate)
        times.append(t)
    return np.asarray(times)


def generate_arrivals(
    cfg: ArrivalConfig,
    vocab_size: int,
    *,
    seed: int = 0,
    mix: Sequence[tuple[TaskProfile, float]] | None = None,
    mix_shift: tuple[float, Sequence[tuple[TaskProfile, float]]] | None = None,
) -> list[RequestSpec]:
    """Generate a timestamped request stream, deterministic in ``seed``.

    ``mix`` weights tasks; ``mix_shift=(t_shift, new_mix)`` switches the
    task mix for arrivals after ``t_shift`` — a live mix shift the drift
    detector must catch from router counts alone.
    """
    rng = np.random.default_rng(seed)
    if mix is None:
        mix = [(DEFAULT_TASKS[0], 0.8), (DEFAULT_TASKS[1], 0.2)]
    if cfg.process == "poisson":
        times = _poisson_times(cfg, rng)
    elif cfg.process == "diurnal":
        times = _diurnal_times(cfg, rng)
    else:
        times = _burst_times(cfg, rng)

    def draw(active_mix):
        tasks = [t for t, _ in active_mix]
        w = np.asarray([p for _, p in active_mix], np.float64)
        task = tasks[int(rng.choice(len(tasks), p=w / w.sum()))]
        prompt, out = task.sample(rng, vocab_size)
        return task.name, prompt, out

    specs = []
    for t in times:
        active = mix
        if mix_shift is not None and t >= mix_shift[0]:
            active = mix_shift[1]
        name, prompt, out = draw(active)
        specs.append(RequestSpec(float(t), prompt, out, task=name))
    return specs


def batch_arrivals(prompts: Sequence[np.ndarray], max_new_tokens: int | Sequence[int]
                   ) -> list[RequestSpec]:
    """Degenerate arrival process: everything at ``t=0`` in order.

    This is the trace-replay mode — the continuous-batching engine must
    generate bit-identical tokens under it as under ``submit()`` calls.
    """
    if isinstance(max_new_tokens, int):
        max_new_tokens = [max_new_tokens] * len(prompts)
    return [
        RequestSpec(0.0, np.asarray(p, np.int32), int(m))
        for p, m in zip(prompts, max_new_tokens)
    ]

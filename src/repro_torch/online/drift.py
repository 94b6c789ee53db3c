"""Drift detection: when does the planning-time picture stop being true?

GEM's placement is computed from two artifacts — a Step-1 routing trace and
a Step-2 variability profile — and is only as good as they are. A serving
fleet invalidates both continuously: the task mix shifts (new tenants, a
prompt-template rollout) and devices slow down mid-run (thermal throttling,
power caps). This module watches both failure modes on the live request
stream, cheaply, so the controller replans *when the world changes* instead
of on a timer:

* :class:`LoadDriftDetector` — streams each step's per-layer per-expert
  router counts (the aux the dispatch plane already surfaces) into an EWMA
  load distribution per layer and fires when the KL (or χ²) divergence from
  the planning-time reference distribution, **averaged over layers**,
  crosses a threshold. The EWMA absorbs per-step routing noise, and the
  layer average exploits that temporal expert bursts are independent per
  layer while a genuine task-mix change moves the hot experts of *every*
  layer at once — common-mode drift stands ~3× above the stationary band
  where a single layer's burst does not (calibrated on the
  :mod:`repro.core.workload` generator).
* :class:`VariabilityDriftDetector` — compares the *observed* per-device
  MoE time of each step against the time *predicted* by the profiled curves
  for the same token loads, tracking an EWMA of the observed/predicted
  ratio per device. A device departing its profiled curve (e.g. an injected
  mid-run power cap halving its throughput) drives its ratio away from 1;
  crossing ``var_threshold`` fires, and the detector's ratios are exactly
  the per-device rescaling factors that repair the profile without a full
  re-profiling pass.

Both detectors are host-side numpy and O(L·E) / O(G) per step — negligible
next to a decode step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DriftConfig", "LoadDriftDetector", "VariabilityDriftDetector"]

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Knobs of the drift → replan trigger."""

    metric: str = "kl"  # "kl" | "chi2" load-divergence metric
    ewma_alpha: float = 0.1  # smoothing of the live load distribution
    threshold: float | None = 1.0  # layer-mean divergence that fires a
    # replan (≥2× the stationary band of the repro.core.workload generators;
    # a hot-expert identity change lands 2.2–6 nats — raise it for burstier
    # mixes). ``None`` ⇒ auto-calibrate: after each (re)plan the detector
    # measures its own stationary band over ``calib_steps`` warm-up steps
    # and sets the threshold to ``calib_margin × the calib_quantile`` of the
    # observed layer-mean divergences — no per-workload constant needed.
    min_steps: int = 8  # EWMA warm-up steps after each (re)plan
    calib_steps: int = 24  # auto-calibration window (threshold=None)
    calib_quantile: float = 0.95  # stationary-band quantile to anchor on
    calib_margin: float = 3.0  # threshold = margin × quantile. The margin
    # covers two gaps measured on the repro.core.workload generators: the
    # long-run stationary *max* sits ~2× above the warm-up window's q95
    # (rare burst regimes arrive late), while a hot-expert identity change
    # drives the level ~4× above it — 3× separates the two.
    threshold_floor: float = 0.05  # auto threshold never below this
    var_alpha: float = 0.2  # smoothing of observed/predicted latency ratios
    var_threshold: float = 0.25  # relative curve departure that fires

    def __post_init__(self):
        if self.metric not in ("kl", "chi2"):
            raise ValueError(f"metric={self.metric!r} not in ('kl', 'chi2')")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.threshold is None:
            if self.calib_steps < 2:
                raise ValueError(
                    "auto-calibration needs calib_steps >= 2"
                )
            if self.calib_margin <= 1.0:
                raise ValueError(
                    "calib_margin must exceed 1 (threshold above the band)"
                )


def _normalize(counts: np.ndarray) -> np.ndarray:
    """Rows of counts → smoothed probability distributions."""
    p = np.asarray(counts, dtype=np.float64) + _EPS
    return p / p.sum(axis=-1, keepdims=True)


class LoadDriftDetector:
    """Per-layer EWMA routing distribution vs the planning-time reference."""

    def __init__(self, num_layers: int, num_experts: int,
                 config: DriftConfig = DriftConfig(), *, telemetry=None):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.config = config
        # optional repro.telemetry.Telemetry hub: divergence-level gauge
        # + fire counter/instant (the controller binds its own)
        self.telemetry = telemetry
        self._ref: np.ndarray | None = None  # (L, E) distributions
        self._ewma: np.ndarray | None = None  # (L, E) distributions
        self._steps_since_ref = 0
        self.last_divergence = np.zeros(num_layers)
        self._calib_samples: list[float] = []
        self._auto_threshold: float | None = None

    def set_reference(self, counts: np.ndarray) -> None:
        """Anchor the reference to the (L, E) summed/mean counts the current
        placement was planned from; resets the EWMA onto it (and, under
        auto-calibration, restarts the stationary-band measurement — the
        replan may have been triggered by a workload change, so the old
        band is stale)."""
        counts = np.asarray(counts, dtype=np.float64)
        if counts.shape != (self.num_layers, self.num_experts):
            raise ValueError(
                f"expected ({self.num_layers}, {self.num_experts}) counts, "
                f"got {counts.shape}"
            )
        self._ref = _normalize(counts)
        self._ewma = self._ref.copy()
        self._steps_since_ref = 0
        self.last_divergence = np.zeros(self.num_layers)
        self._calib_samples = []
        self._auto_threshold = None

    @property
    def effective_threshold(self) -> float | None:
        """The firing threshold in force: the configured constant, or the
        auto-calibrated one (``None`` while still calibrating)."""
        if self.config.threshold is not None:
            return self.config.threshold
        return self._auto_threshold

    @property
    def armed(self) -> bool:
        return self._ref is not None

    def divergence(self) -> np.ndarray:
        """(L,) current divergence of the EWMA from the reference."""
        if self._ref is None or self._ewma is None:
            return np.zeros(self.num_layers)
        q, p = self._ewma, self._ref
        if self.config.metric == "kl":
            return np.sum(q * np.log(q / p), axis=-1)
        # χ² in its symmetrised (triangular-discrimination) form: the raw
        # (q−p)²/p explodes when an expert absent from the reference
        # (p ≈ ε) turns hot — exactly the shift we want to measure, not
        # saturate on. Bounded in [0, 2].
        return np.sum((q - p) ** 2 / ((q + p) / 2.0), axis=-1)

    def update(self, counts: np.ndarray) -> bool:
        """Feed one step's (L, E) counts; True ⇒ load drift fired."""
        if self._ref is None or self._ewma is None:
            return False
        a = self.config.ewma_alpha
        self._ewma = (1.0 - a) * self._ewma + a * _normalize(counts)
        self._steps_since_ref += 1
        self.last_divergence = self.divergence()
        if self.telemetry is not None:
            self.telemetry.gauge("controller.drift.load_level").set(
                float(self.last_divergence.mean())
            )
        if self._steps_since_ref < self.config.min_steps:
            return False
        level = float(self.last_divergence.mean())
        threshold = self.effective_threshold
        if threshold is None:
            # auto-calibration: the post-warm-up window is assumed
            # stationary (the controller just planned on it), so its
            # divergences *are* the stationary band — estimate the
            # threshold from their upper quantile
            self._calib_samples.append(level)
            if len(self._calib_samples) >= self.config.calib_steps:
                band = float(
                    np.quantile(
                        self._calib_samples, self.config.calib_quantile
                    )
                )
                self._auto_threshold = max(
                    self.config.calib_margin * band,
                    self.config.threshold_floor,
                )
            return False
        # fire on the layer *mean*: bursts are layer-independent, a task-mix
        # change is common-mode across layers
        fired = bool(level > threshold)
        if fired and self.telemetry is not None:
            self.telemetry.counter("controller.drift.load_fires").inc()
            # the fire decision's full inputs ride the event (audit plane)
            self.telemetry.instant(
                "drift.load", level=level, threshold=float(threshold),
                steps_since_ref=int(self._steps_since_ref),
            )
        return fired

    def drifted_layers(self) -> np.ndarray:
        """Layer ids whose *individual* divergence exceeds the threshold.

        The fire decision uses the layer mean (common-mode drift), but a
        shift can be concentrated: a single-layer hot-expert change leaves
        the other layers inside their stationary band. Staggered replans
        (``OnlineConfig.staggered_replan``) re-search only these layers.
        Empty result ⇒ the mean fired on broad low-level elevation with no
        layer individually over threshold — callers should replan all.
        """
        thr = self.effective_threshold
        if thr is None:
            return np.arange(self.num_layers, dtype=np.int32)
        return np.nonzero(self.last_divergence > thr)[0].astype(np.int32)


class VariabilityDriftDetector:
    """EWMA of observed/predicted per-device latency — curve departure."""

    def __init__(self, num_devices: int, config: DriftConfig = DriftConfig(),
                 *, telemetry=None):
        self.num_devices = num_devices
        self.config = config
        self.telemetry = telemetry
        self.ratios = np.ones(num_devices)
        self._steps = 0

    def reset(self) -> None:
        self.ratios = np.ones(self.num_devices)
        self._steps = 0

    def update(self, observed: np.ndarray, predicted: np.ndarray) -> bool:
        """Feed one step's per-device (G,) observed + predicted MoE time.

        Returns True when any device's smoothed ratio departs 1.0 by more
        than ``var_threshold`` (after the EWMA warm-up).
        """
        observed = np.asarray(observed, dtype=np.float64)
        predicted = np.asarray(predicted, dtype=np.float64)
        ratio = observed / np.maximum(predicted, 1e-30)
        # a device that received no tokens this step carries no signal
        ratio = np.where(predicted > 0, ratio, self.ratios)
        a = self.config.var_alpha
        self.ratios = (1.0 - a) * self.ratios + a * ratio
        self._steps += 1
        departure = float(np.abs(self.ratios - 1.0).max())
        if self.telemetry is not None:
            self.telemetry.gauge("controller.drift.var_ratio").set(departure)
        if self._steps < self.config.min_steps:
            return False
        fired = bool(departure > self.config.var_threshold)
        if fired and self.telemetry is not None:
            self.telemetry.counter("controller.drift.var_fires").inc()
            # the fire decision's full inputs ride the event (audit plane)
            self.telemetry.instant(
                "drift.var", departure=departure,
                threshold=float(self.config.var_threshold),
                steps=int(self._steps),
            )
        return fired

    def drifted_devices(self) -> np.ndarray:
        """Device ids whose smoothed ratio is outside the threshold band."""
        dev = np.abs(self.ratios - 1.0) > self.config.var_threshold
        return np.nonzero(dev)[0].astype(np.int32)

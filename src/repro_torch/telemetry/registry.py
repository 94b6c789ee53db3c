"""Deterministic metrics registry: counters, gauges, histograms.

The registry is the single source of truth for every scalar the planes
emit — jit trace counts, dropped tokens, KV occupancy, controller
decisions. All instruments are pure host-side Python state: recording
never touches a traced value, so instrumenting a plane cannot perturb
its tokens (the telemetry-off bit-parity gate in CI relies on this).

Histograms use **fixed, caller-supplied boundaries** rather than
adaptive buckets so two runs of the same workload produce byte-identical
snapshots — CI pins them.

Naming convention: dot-separated lowercase paths grouped by plane, e.g.
``engine.steps``, ``jit.trace.decode``, ``kv.pool.used_blocks``,
``controller.replans.applied``, ``dispatch.dropped_tokens``. The full
metric inventory is documented in ``telemetry/README.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]


@dataclasses.dataclass
class Counter:
    """Monotonic accumulator. ``inc`` by any non-negative amount."""

    name: str
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount


@dataclasses.dataclass
class Gauge:
    """Last-write-wins level, with a high-watermark ride-along."""

    name: str
    value: float = 0.0
    max_value: float = float("-inf")
    _set_count: int = 0

    def set(self, value: float) -> None:
        self.value = float(value)
        if self.value > self.max_value:
            self.max_value = self.value
        self._set_count += 1

    @property
    def observed(self) -> bool:
        return self._set_count > 0


class Histogram:
    """Fixed-boundary histogram: ``boundaries`` are the *upper* edges of
    the finite buckets; one overflow bucket catches the rest. A value v
    lands in the first bucket with ``v <= boundaries[i]``.
    """

    def __init__(self, name: str, boundaries: Sequence[float]):
        bounds = [float(b) for b in boundaries]
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {name}: boundaries must be strictly increasing"
            )
        self.name = name
        self.boundaries = tuple(bounds)
        self.counts = [0] * (len(bounds) + 1)  # +1 overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        idx = len(self.boundaries)
        for i, b in enumerate(self.boundaries):
            if value <= b:
                idx = i
                break
        self.counts[idx] += 1
        self.total += 1
        self.sum += value

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0


class Registry:
    """Name→instrument map. ``counter``/``gauge``/``histogram`` create on
    first use and return the existing instrument afterwards (re-declaring
    a histogram with different boundaries is an error — deterministic
    buckets are the point).
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  boundaries: Sequence[float] | None = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            if boundaries is None:
                raise KeyError(
                    f"histogram {name!r} not declared; pass boundaries"
                )
            h = self._histograms[name] = Histogram(name, boundaries)
        elif boundaries is not None and tuple(
            float(b) for b in boundaries
        ) != h.boundaries:
            raise ValueError(
                f"histogram {name!r} re-declared with different boundaries"
            )
        return h

    def snapshot(self) -> dict:
        """Deterministic (sorted-key) plain-dict dump of every instrument.

        Shape is part of the versioned schema (see export.SCHEMA):
        ``{"counters": {name: value}, "gauges": {name: {value, max}},
        "histograms": {name: {boundaries, counts, total, sum}}}``.
        """
        return {
            "counters": {
                k: self._counters[k].value for k in sorted(self._counters)
            },
            "gauges": {
                k: {
                    "value": self._gauges[k].value,
                    "max": (self._gauges[k].max_value
                            if self._gauges[k].observed else 0.0),
                }
                for k in sorted(self._gauges)
            },
            "histograms": {
                k: {
                    "boundaries": list(self._histograms[k].boundaries),
                    "counts": list(self._histograms[k].counts),
                    "total": self._histograms[k].total,
                    "sum": self._histograms[k].sum,
                }
                for k in sorted(self._histograms)
            },
        }

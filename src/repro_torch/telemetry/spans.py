"""Simulated-clock span tracing and the :class:`Telemetry` hub.

The serving engine runs on a *simulated* clock (``engine.sim_time``
advances in discrete charges), so spans here are not wall-clock timers:
a span's duration is whatever the instrumented plane says it charged.
Two recording styles:

- ``with tel.span("decode_step", track="engine"):`` — context manager
  for phases whose charge is applied while the span is open (the clock
  callback is read at enter and exit).
- ``tel.emit_span(name, start, dur, track=..., **args)`` — explicit
  emission for phases whose charge is computed after the fact (e.g. the
  decode charge is ``cost_mx.max(axis=1).sum()``, known only once the
  step's cost matrix exists).

Every span/instant becomes one structured event dict (the JSONL schema
in :mod:`repro.telemetry.export`); ``track`` names the timeline it
renders on in the Chrome trace ("engine", "device0".."deviceG-1").

:class:`Telemetry` is the object the planes hold. It is **always
constructed** — ``ServingEngine(..., telemetry=None)`` gets a disabled
instance — because the metrics registry doubles as the single source of
truth for read-through attributes (``jit_trace_counts``,
``migration_records``) that must keep working with telemetry off.
Only *event recording* (spans/instants, the export surface) is gated by
``enabled``; registry instruments are pure host-side state and can never
perturb tokens.
"""
from __future__ import annotations

import contextlib
from typing import Callable

from .registry import Registry

__all__ = ["Telemetry"]


class Telemetry:
    """Per-run telemetry hub: registry + event log + simulated clock."""

    def __init__(self, *, enabled: bool = True,
                 clock: Callable[[], float] | None = None):
        self.enabled = enabled
        self.registry = Registry()
        self.events: list[dict] = []
        # Structured per-migration records (the engine's old ad-hoc
        # ``migration_records`` list now lives here; the engine attribute
        # is a read-through). Always recorded — callers introspect these
        # regardless of event tracing.
        self.migration_records: list[dict] = []
        self._clock = clock if clock is not None else (lambda: 0.0)

    # -- clock ---------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        """Bind the simulated-time source (e.g. ``lambda: engine.sim_time``)."""
        self._clock = clock

    def now(self) -> float:
        return float(self._clock())

    # -- registry passthrough ------------------------------------------
    def counter(self, name: str):
        return self.registry.counter(name)

    def gauge(self, name: str):
        return self.registry.gauge(name)

    def histogram(self, name: str, boundaries=None):
        return self.registry.histogram(name, boundaries)

    # -- events --------------------------------------------------------
    def emit_span(self, name: str, start: float, dur: float, *,
                  track: str = "engine", **args) -> None:
        """Record a completed span ``[start, start+dur)`` on ``track``."""
        if not self.enabled:
            return
        ev = {"kind": "span", "name": name, "track": track,
              "ts": float(start), "dur": float(dur)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, track: str = "engine", **args):
        """Context-manager span over the simulated clock."""
        if not self.enabled:
            yield
            return
        start = self.now()
        try:
            yield
        finally:
            self.emit_span(name, start, self.now() - start,
                           track=track, **args)

    def instant(self, name: str, *, track: str = "engine",
                ts: float | None = None, **args) -> None:
        """Record a zero-duration marker (preemption, drift fire, ...)."""
        if not self.enabled:
            return
        ev = {"kind": "instant", "name": name, "track": track,
              "ts": self.now() if ts is None else float(ts)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def record_migration(self, record: dict) -> None:
        """Append one structured migration record (always, even when
        event tracing is off) and mirror it as an instant event."""
        self.migration_records.append(record)
        self.instant("migration", ts=record.get("sim_time"),
                     **{k: v for k, v in record.items() if k != "sim_time"})

"""Real-clock spans of the serving engine, on the host's ``time.perf_counter``.

The engine's telemetry hub (:mod:`repro_torch.telemetry`) stamps the
simulated fleet's clock. This module stamps the host's: where a step's
wall time goes on the machine that runs it. Recording is always on and
costs a few ``perf_counter`` calls and a small tuple a span. It never
touches the device and opens no profiler range: each span starts and ends
on the host, and a span that waits for the device ends on one of the
engine's own sync points.

The tree of one :meth:`ServingEngine.step` that has work::

    step                 the whole call (step: its number)
      prefill            one per request installed (uid, slot, tokens),
                         ending when its first token is on the host
        issue            the host issues the forward (the dense path: and
                         the panel copies)
      decode             the call of the decode step (rows_before: the
                         rows that held a token when the step began)
      control            GEM's Step-1 work: the expert-count and drop
                         readbacks, then the planner's or the online
                         controller's observation (MoE configs)

The engine keeps every span as one row of a :class:`Timeline`. Each
:class:`~repro_torch.serving.scheduler.Request` holds a
:class:`RequestTimeline`: the engine's timeline, the request's first
admission, the row of its first ``prefill`` and the rows of the ``step``
spans it decoded in (shared with the other requests of the step).
"""
from __future__ import annotations

import math
import time

__all__ = ["RequestTimeline", "Timeline", "clock"]

clock = time.perf_counter


class Timeline:
    """Spans, one row each in ``rows``: a flat tuple ``(name, start, end,
    parent, key, value, key, value, ...)``. ``parent`` is the row of the
    span that caused it (-1 for a step), ``end`` is NaN while the span is
    open, and the pairs are its integer args.

    A row holds only strings and numbers, so the garbage collector stops
    tracking it at the first collection it survives. The timeline thus
    adds nothing to the collector's older generations: objects that
    survive there bring its full passes, each a tenth of a second or more
    in a serving process, into the serving loop sooner."""

    __slots__ = ("rows",)

    def __init__(self):
        self.rows: list[tuple] = []

    def add(self, name: str, start: float, end: float = math.nan,
            parent: int = -1, **args: int) -> int:
        """Record a span (open, without ``end``); return its row."""
        row = [name, start, end, parent]
        for key, value in args.items():
            row += (key, value)
        self.rows.append(tuple(row))
        return len(self.rows) - 1

    def close(self, row: int, end: float) -> None:
        """End the open span at ``row``."""
        r = self.rows[row]
        self.rows[row] = (*r[:2], end, *r[3:])


class RequestTimeline:
    """A request's life on :func:`clock`: ``spans``, the timeline of the
    engine that took it; ``admitted`` and ``prefill`` (a row), its first
    admission and first prefill, kept across a preemption (as
    ``Request.first_token_time`` is); ``steps``, the row of every step it
    decoded in."""

    __slots__ = ("spans", "admitted", "prefill", "steps")

    def __init__(self):
        self.spans: Timeline | None = None
        self.admitted = math.nan
        self.prefill = -1
        self.steps: list[int] = []

"""The program's own real-clock spans, as the metric readers reach them.

The port's serving engine records a timeline on the host's
``time.perf_counter`` (``repro_torch.serving.timeline``): a ``step`` span
for each step with work, its children (``prefill`` with ``issue``,
``decode``, ``control``), each a row of flat numbers, and on each request
the engine's timeline, its first admission, the row of its prefill and
the rows of the steps it decoded in. A run reaches all of it through the
engine's requests it holds (``Rec.ereq.timeline``); :func:`spans` turns
the rows into :class:`Span` trees. A program without a timeline gives
nothing here, and each reader of it then returns None.

The profiled slice of a ``--trace 1`` run is on the profiler's clock. The
serve kind stamps each engine step on ``perf_counter`` (``run.steps[i]``)
inside the profiler range ``pb.step#i``, so the median of the starts'
differences maps one clock onto the other; the spread of those
differences says how well (it is logged once a run). The profiler's
cost on each host operation stretches the host's work inside the slice,
so the readers of host spans leave out what overlaps it
(:func:`clear_of_slice`)."""
from __future__ import annotations

import dataclasses
import statistics
import sys

from ..yardstick.stats import union_length
from .trace import ops_between


@dataclasses.dataclass(eq=False)
class Span:
    """One of the program's spans, with the spans it caused."""

    name: str
    start: float
    end: float
    args: dict
    children: list

    def named(self, name: str) -> list:
        """The children called ``name``, in the order they were made."""
        return [c for c in self.children if c.name == name]


def timelines(run) -> list:
    """The timelines of the run's requests (none for a program without)."""
    out = []
    for r in run.requests:
        tl = getattr(r.ereq, "timeline", None)
        if tl is not None and tl.spans is not None:
            out.append(tl)
    return out


def spans(run) -> list:
    """The program's spans, by row: each a :class:`Span` that holds its
    children (empty for a program without a timeline)."""
    tls = timelines(run)
    if not tls:
        return []
    rows = tls[0].spans.rows
    out = [Span(r[0], r[1], r[2], dict(zip(r[4::2], r[5::2])), [])
           for r in rows]
    for span, r in zip(out, rows):
        if r[3] >= 0:
            out[r[3]].children.append(span)
    return out


def in_window(run, t: float) -> bool:
    return run.start <= t < run.end


def prefills(run) -> list:
    """The requests' first prefill spans that began in the window, by
    start."""
    every = spans(run)
    found = [every[tl.prefill] for tl in timelines(run) if tl.prefill >= 0]
    return sorted((p for p in found if in_window(run, p.start)),
                  key=lambda p: p.start)


def steps(run) -> list:
    """Each step span that began in the window, once, by start: every one
    a request decoded in (a request decodes in the step that prefills it)."""
    every = spans(run)
    rows = {i for tl in timelines(run) for i in tl.steps}
    return sorted((every[i] for i in rows if in_window(run, every[i].start)),
                  key=lambda s: s.start)


def total(parts) -> float:
    return sum(s.end - s.start for s in parts)


def clock_offset(run) -> float | None:
    """Profiler time less ``perf_counter`` time: the median over the
    slice's ``pb.step#i`` ranges of their start less ``run.steps[i]``'s.
    None without a trace or a step in it."""
    t = run.trace
    if t is None or t.get("window") is None:
        return None
    if "_pc_offset" not in t:
        diffs = [s - run.steps[i][0] for s, _, i in t["spans"]["step"]
                 if 0 <= i < len(run.steps)]
        t["_pc_offset"] = statistics.median(diffs) if diffs else None
        if len(diffs) > 1:
            q1, _, q3 = statistics.quantiles(diffs, n=4)
            print(f"program spans: profiler clock = perf_counter + "
                  f"{t['_pc_offset']:.6f} s over {len(diffs)} steps; the "
                  f"differences span {(max(diffs) - min(diffs)) * 1e6:.1f} "
                  f"us, quartiles {(q3 - q1) * 1e6:.1f} us apart",
                  file=sys.stderr, flush=True)
    return t["_pc_offset"]


def host_slice(run) -> tuple[float, float] | None:
    """The profiled slice on ``perf_counter``."""
    off = clock_offset(run)
    if off is None:
        return None
    a, b = run.trace["window"]
    return a - off, b - off


def clear_of_slice(run):
    """A test ``clear(a, b)`` of whether the interval [a, b] on
    ``perf_counter`` lies clear of the profiled slice: always true for a
    run without a trace; None for a trace whose slice cannot be placed."""
    if run.trace is None:
        return lambda a, b: True
    cut = host_slice(run)
    if cut is None:
        return None
    return lambda a, b: b <= cut[0] or a >= cut[1]


def device_busy(trace: dict, a: float, b: float) -> float:
    """Seconds of [a, b] (the profiler's clock) in which some device
    operation ran, counting those that began before ``a``."""
    ops = trace["ops"]
    if "_longest_op" not in trace:
        trace["_longest_op"] = max((e - s for _, s, e in ops), default=0.0)
    near = ops_between(trace, a - trace["_longest_op"], b)
    return union_length([(max(s, a), min(e, b)) for _, s, e in near
                         if e > a and s < b])

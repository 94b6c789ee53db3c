"""Exporters: versioned JSONL event log + Chrome trace-event JSON.

JSONL layout (schema ``repro.telemetry/v1``; versioning rule in
``telemetry/README.md``): one JSON object per line —

1. header:   ``{"kind": "header", "schema": SCHEMA, ...meta}``
2. events:   the :class:`Telemetry` event dicts in emission order
   (``kind`` ∈ {"span", "instant"}, simulated-clock ``ts``/``dur`` in
   seconds)
3. trailer:  ``{"kind": "metrics", "snapshot": registry.snapshot()}``

The Chrome export emits the trace-event JSON array format that
``chrome://tracing`` / Perfetto load directly: "X" complete events for
spans (``ts``/``dur`` in microseconds), "i" instants, and "M" metadata
events naming one thread per track — ``engine`` plus one ``device{g}``
row per fleet device.
"""
from __future__ import annotations

import json
import math

from .audit import validate_audit_event
from .spans import Telemetry

__all__ = [
    "SCHEMA",
    "write_jsonl",
    "read_jsonl",
    "to_chrome_trace",
    "write_chrome_trace",
]

SCHEMA = "repro.telemetry/v1"

_EVENT_KINDS = ("span", "instant")


def write_jsonl(tel: Telemetry, path: str, **meta) -> int:
    """Write the run's event log + metrics snapshot. Returns line count."""
    lines = [json.dumps({"kind": "header", "schema": SCHEMA, **meta},
                        sort_keys=True)]
    for ev in tel.events:
        lines.append(json.dumps(ev, sort_keys=True))
    lines.append(json.dumps(
        {"kind": "metrics", "snapshot": tel.registry.snapshot()},
        sort_keys=True,
    ))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


def read_jsonl(path: str, *, recover_tail: bool = False) -> dict:
    """Parse + validate a v1 event log.

    Returns ``{"meta": header-extras, "events": [...], "metrics":
    snapshot}``. Raises ``ValueError`` on schema mismatch or malformed
    structure — this is the validator the CI telemetry gate runs.
    Structural checks beyond the original layout:

    - spans must carry a finite non-negative ``dur`` (an out-of-order
      span close would serialize as a negative duration) and every event
      a finite ``ts``;
    - ``audit.*`` events must carry the full input set their offline
      replay needs (:func:`repro.telemetry.audit.validate_audit_event`).

    ``recover_tail=True`` handles crash-consistent logs deterministically
    instead of rejecting them: a partially-written *final* line is
    dropped and a missing metrics trailer yields ``metrics: None``; the
    result then carries ``"recovered": True``. Corruption anywhere but
    the tail still raises — a torn write only ever loses the tail.
    """
    with open(path) as f:
        raw = [line for line in f if line.strip()]
    rows = []
    tail_dropped = False
    for i, line in enumerate(raw):
        try:
            rows.append(json.loads(line))
        except ValueError:
            if recover_tail and i == len(raw) - 1:
                tail_dropped = True  # torn final write: drop it
                break
            raise ValueError(f"telemetry jsonl: line {i + 1} is not JSON")
    if not rows or rows[0].get("kind") != "header":
        raise ValueError("telemetry jsonl: missing header line")
    header = rows[0]
    if header.get("schema") != SCHEMA:
        raise ValueError(
            f"telemetry jsonl: schema {header.get('schema')!r} != {SCHEMA!r}"
        )
    snapshot = None
    if rows[-1].get("kind") == "metrics":
        snapshot = rows[-1].get("snapshot")
        if not isinstance(snapshot, dict) or not {
            "counters", "gauges", "histograms"
        } <= set(snapshot):
            raise ValueError("telemetry jsonl: malformed metrics snapshot")
        events = rows[1:-1]
    elif recover_tail:
        events = rows[1:]  # trailer lost with the tail
    else:
        raise ValueError("telemetry jsonl: missing metrics trailer")
    for i, ev in enumerate(events):
        kind = ev.get("kind")
        if kind not in _EVENT_KINDS:
            raise ValueError(f"telemetry jsonl: line {i + 2} bad kind {kind!r}")
        name = ev.get("name")
        if not isinstance(name, str) or "ts" not in ev:
            raise ValueError(f"telemetry jsonl: line {i + 2} missing name/ts")
        if not math.isfinite(float(ev["ts"])):
            raise ValueError(f"telemetry jsonl: line {i + 2} non-finite ts")
        if kind == "span":
            if "dur" not in ev:
                raise ValueError(
                    f"telemetry jsonl: line {i + 2} span missing dur"
                )
            dur = float(ev["dur"])
            if not math.isfinite(dur) or dur < 0.0:
                raise ValueError(
                    f"telemetry jsonl: line {i + 2} span closed out of "
                    f"order (dur={ev['dur']!r})"
                )
        if name.startswith("audit."):
            try:
                validate_audit_event(name, ev.get("args"))
            except ValueError as e:
                raise ValueError(f"telemetry jsonl: line {i + 2}: {e}")
    meta = {k: v for k, v in header.items() if k not in ("kind", "schema")}
    out = {"meta": meta, "events": events, "metrics": snapshot}
    if recover_tail:
        out["recovered"] = tail_dropped or snapshot is None
    return out


def _track_order(events: list[dict]) -> list[str]:
    """Stable track→tid assignment: engine first, then device rows in
    numeric order, then anything else by first appearance."""
    seen: list[str] = []
    for ev in events:
        t = ev.get("track", "engine")
        if t not in seen:
            seen.append(t)

    def key(t: str):
        if t == "engine":
            return (0, 0, t)
        if t.startswith("device") and t[6:].isdigit():
            return (1, int(t[6:]), t)
        return (2, seen.index(t), t)

    return sorted(seen, key=key)


def to_chrome_trace(tel: Telemetry, **meta) -> dict:
    """Render the event log as a Chrome trace-event JSON object."""
    tracks = _track_order(tel.events)
    tid = {t: i for i, t in enumerate(tracks)}
    trace = [
        {"ph": "M", "pid": 0, "tid": tid[t], "name": "thread_name",
         "args": {"name": t}}
        for t in tracks
    ]
    for ev in tel.events:
        t = ev.get("track", "engine")
        ts_us = float(ev["ts"]) * 1e6
        base = {"pid": 0, "tid": tid[t], "name": ev["name"], "ts": ts_us,
                "cat": t}
        if ev.get("args"):
            base["args"] = ev["args"]
        if ev["kind"] == "span":
            trace.append({**base, "ph": "X", "dur": float(ev["dur"]) * 1e6})
        else:
            trace.append({**base, "ph": "i", "s": "t"})
    return {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {"schema": SCHEMA, **meta},
    }


def write_chrome_trace(tel: Telemetry, path: str, **meta) -> int:
    """Write the Chrome trace JSON. Returns the trace-event count."""
    doc = to_chrome_trace(tel, **meta)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True)
    return len(doc["traceEvents"])

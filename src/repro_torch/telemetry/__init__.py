"""Unified telemetry plane: metrics registry, simulated-clock span
tracing, per-step straggler attribution, and Chrome-trace/JSONL export.

See ``telemetry/README.md`` in this package for the event/metric schema
reference and the versioning rule.
"""
from .attribution import (
    AttributionAccumulator,
    StepAttribution,
    attribute_step,
)
from .audit import (
    AUDIT_EVENTS,
    decision_payload,
    validate_audit_event,
)
from .export import (
    SCHEMA,
    read_jsonl,
    to_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from .registry import Counter, Gauge, Histogram, Registry
from .regret import NOISE_FLOOR, RegretTracker, StepRegret
from .spans import Telemetry

__all__ = [
    "AUDIT_EVENTS",
    "AttributionAccumulator",
    "Counter",
    "Gauge",
    "Histogram",
    "NOISE_FLOOR",
    "Registry",
    "RegretTracker",
    "SCHEMA",
    "StepAttribution",
    "StepRegret",
    "Telemetry",
    "attribute_step",
    "decision_payload",
    "read_jsonl",
    "to_chrome_trace",
    "validate_audit_event",
    "write_chrome_trace",
    "write_jsonl",
]

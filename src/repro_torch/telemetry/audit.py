"""Controller decision-audit records: serialization + validation.

Every decision the online control plane takes — drift fire, replan
trigger with candidate scores, net-benefit gate accept/reject, schedule
truncation, replica retarget — is recorded as a structured instant event
carrying its **full inputs**, so ``benchmarks/decision_replay.py`` can
re-derive the decision offline *from the JSONL alone* and verify it
byte-exactly: the controller is a deterministic function of its logged
inputs, and the log proves it.

Four event names (all additive — the schema stays
``repro.telemetry/v1``):

- ``audit.init``    — one per controller: everything needed to
  reconstruct it (configs, cost model, initial slot layouts, the
  believed profile's curves);
- ``audit.step``    — one per ``observe_step`` call: the step's inputs
  (per-layer counts, observed per-device latency) next to the
  serialized :class:`~repro.online.controller.StepDecision` output;
- ``audit.measure`` — one per reported migration measurement (the
  collective plane's bandwidth-calibration input);
- ``audit.retarget`` — the serving engine's one-shot replicated-pool
  retarget: live + target slot layouts in, priced move count out.

This module owns the canonical encoding both the live hooks and the
offline replayer share — byte-exact comparison only means something when
the two sides serialize through the same function. It deliberately
imports nothing from :mod:`repro.online` (which imports this package):
migration batches are serialized by duck type.
"""
from __future__ import annotations

import json

import numpy as np

__all__ = [
    "AUDIT_EVENTS",
    "canonical",
    "dumps",
    "decision_payload",
    "validate_audit_event",
]

# required ``args`` keys per audit event name — read_jsonl rejects audit
# records missing any of these (a log the replayer cannot re-derive
# decisions from is malformed, not merely incomplete)
AUDIT_EVENTS: dict[str, tuple[str, ...]] = {
    "audit.init": (
        "config",
        "gem",
        "cost_model",
        "num_layers",
        "num_experts",
        "num_devices",
        "replicated",
        "slot_layouts",
        "profile",
    ),
    "audit.step": ("step", "counts", "observed", "decision"),
    "audit.measure": ("step", "payload_bytes", "measured_s", "modeled_s"),
    # the serving engine's one-shot replicated retarget: live + target
    # layouts in, priced move count out (engine hook, not the controller)
    "audit.retarget": (
        "step",
        "num_experts",
        "num_devices",
        "slot_layouts",
        "target_layouts",
        "moves",
        "modeled_s",
    ),
}


def canonical(obj):
    """Recursively convert to JSON-native types (numpy → python scalars,
    arrays → nested lists). Dict key order is irrelevant — :func:`dumps`
    sorts keys — but values must round-trip exactly, which JSON floats do
    (``json.dumps`` emits ``repr``-precision decimals)."""
    if isinstance(obj, dict):
        return {str(k): canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return canonical(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def dumps(obj) -> str:
    """The canonical byte encoding both the live hook and the offline
    replayer compare: canonicalized values, sorted keys, no whitespace
    variance."""
    return json.dumps(canonical(obj), sort_keys=True)


def _migration_step_payload(step) -> dict | None:
    """Serialize a migration batch by duck type: swap batches carry
    ``.swaps`` (:class:`SlotSwap` entries), replica batches ``.moves``
    (:class:`ReplicaMove` entries)."""
    if step is None:
        return None
    if hasattr(step, "swaps"):
        return {
            "kind": "swap",
            "moves": [[s.layer, s.slot_a, s.slot_b] for s in step.swaps],
        }
    return {
        "kind": "replica",
        "moves": [[m.layer, m.dst_slot, m.src_slot] for m in step.moves],
    }


def decision_payload(decision) -> dict:
    """Canonical serialization of a :class:`StepDecision` — the *output*
    side of an ``audit.step`` record, and exactly what the replayer
    recomputes and byte-compares."""
    return canonical(
        {
            "replanned": bool(decision.replanned),
            "reason": decision.reason,
            "migration": _migration_step_payload(decision.migration_step),
            "migration_cost": float(decision.migration_cost),
            "migration_skipped": bool(decision.migration_skipped),
            "migration_truncated": bool(decision.migration_truncated),
            "profile_rescaled": bool(decision.profile_rescaled),
        }
    )


def validate_audit_event(name: str, args) -> None:
    """Reject malformed audit records (``read_jsonl`` calls this): an
    audit event missing its required inputs cannot be replayed, so the
    log fails validation deterministically instead of failing replay
    confusingly later."""
    required = AUDIT_EVENTS.get(name)
    if required is None:
        raise ValueError(f"unknown audit event {name!r}")
    if not isinstance(args, dict):
        raise ValueError(f"audit event {name!r} has no args dict")
    missing = [k for k in required if k not in args]
    if missing:
        raise ValueError(f"audit event {name!r} missing args {missing}")

"""Capacity-overflow token shedding: config + host-side pricing glue.

The *mechanism* lives in the dispatch plane
(:func:`repro.models.dispatch.build_dispatch` — the second scatter pass
that re-seats overflow assignments on free replica rows), and the
*economics* live in :mod:`repro.core.score` (``shed_decisions``: the
shed-vs-wait marginal-cost gate). This module holds what the serving
engine needs to wire the two together:

* :class:`ShedConfig` — the engine-facing knob set
  (``EngineConfig.shed``).
* :func:`default_token_bytes` — the activation payload one shed token
  charges to the interconnect: the (D,) hidden vector travels to the
  receiving device and the expert output travels back, so 2·D·itemsize.

The pricing loop is one step behind by construction: step ``t``'s
measured per-layer overflow prices the (L,) shed-enable operand for step
``t+1``. The enables are a *scanned operand* of the whole-model decode
executable, so flipping them never retraces (``jit_trace_counts`` stays
flat — the fig25 CI gate).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShedConfig", "default_token_bytes"]


@dataclasses.dataclass(frozen=True)
class ShedConfig:
    """Knobs for the capacity-overflow shed pass (``EngineConfig.shed``).

    ``enabled`` turns the whole plane on: the decode executable gains the
    (L,) shed-enable scanned operand and the engine starts pricing the
    gate each step. Off (the default), the engine passes ``None`` and the
    traced decode program is byte-identical to the pre-shed engine.

    ``min_overflow`` — layers with fewer overflow assignments than this
    are never shed (the transfer setup isn't worth pennies of wait).
    ``hysteresis`` ≥ 1 demands the wait saving exceed the shed cost by
    that factor before enabling (1.0 = break-even gating).
    ``token_bytes`` — interconnect bytes charged per shed assignment;
    ``None`` derives 2·d_model·itemsize from the model
    (:func:`default_token_bytes`).
    ``drop_penalty_s`` — the latency-equivalent price of *dropping* one
    overflow assignment. Un-shed overflow rows fall out of the capacity
    buffer entirely (a quality loss the pure shed-vs-wait comparison
    never sees), so the gate credits ``rescued · drop_penalty_s`` to the
    shed side:

        shed iff  adjusted + transfer
                      <  legacy / hysteresis + rescued · drop_penalty_s

    ``0.0`` (default) is the pure latency gate — shed only when the
    straggler's queue-wait strictly beats the receiving copy's marginal
    cost plus the transfer. A positive value makes the gate quality-
    aware: large enough, it rescues every droppable row a live replica
    can absorb (fig25's regime — ``moe.dropped_tokens == 0`` whenever a
    live replica slot has room).
    """

    enabled: bool = False
    min_overflow: int = 1
    hysteresis: float = 1.0
    token_bytes: float | None = None
    drop_penalty_s: float = 0.0


def default_token_bytes(d_model: int, dtype_bytes: int) -> float:
    """Activation round trip of one shed assignment: the (D,) hidden
    vector out to the receiving copy's device, the expert output back."""
    return 2.0 * float(d_model) * float(dtype_bytes)

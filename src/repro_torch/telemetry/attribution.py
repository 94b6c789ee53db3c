"""Per-step straggler attribution: load imbalance vs speed variability.

GEM's thesis (paper §2, Figure 2; same decomposition as ViBE) is that
the straggler device sets MoE layer latency, and the straggler's excess
over the mean has exactly two causes: it got more tokens (load
imbalance) or it is a slower GPU (speed variability). This module makes
that decomposition a live metric.

For one layer with per-device token counts ``n_g`` and per-device cost
curves ``C_g``:

- actual costs      ``T_g = C_g(n_g)``
- counterfactual    ``U_g = C̄(n_g)`` where ``C̄`` is the *fleet-mean*
  curve (mean of the per-device latency samples at each profiled token
  count) — "same token split, uniform hardware"

and the slack decomposition is::

    slack_total = max_g T_g − mean_g T_g
    slack_load  = max_g U_g − mean_g U_g     (imbalance on uniform fleet)
    slack_var   = slack_total − slack_load   (residual: hardware effect)

The components sum to the total **by construction**, so the invariant
the tests pin (sum within fp tolerance) is exact. Limits:

- uniform fleet (identical curves): ``C̄ = C_g`` so ``U = T`` and
  ``slack_var = 0`` — all slack is load imbalance.
- uniform load (equal ``n_g``): ``U_g`` is one constant, so
  ``slack_load = 0`` — all slack is speed variability.
- ``slack_var`` may be *negative*: when the fast devices carry the extra
  tokens, hardware variability cancels part of the imbalance. That sign
  is the interesting diagnostic, not an error.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StepAttribution", "attribute_step", "AttributionAccumulator"]


@dataclasses.dataclass(frozen=True)
class StepAttribution:
    """Per-layer slack decomposition for one engine step (seconds)."""

    slack_total: np.ndarray  # (L,) max_g T_g − mean_g T_g
    slack_load: np.ndarray  # (L,) imbalance component
    slack_var: np.ndarray  # (L,) variability component (residual)
    straggler: np.ndarray  # (L,) argmax_g T_g

    @property
    def total(self) -> float:
        return float(self.slack_total.sum())

    @property
    def load(self) -> float:
        return float(self.slack_load.sum())

    @property
    def var(self) -> float:
        return float(self.slack_var.sum())


def _mean_curve_cost(profile, tokens: np.ndarray) -> np.ndarray:
    """C̄(tokens): fleet-mean latency curve interpolated per entry."""
    grid = profile.token_counts.astype(np.float64)
    mean_lat = profile.latencies.mean(axis=0)
    return np.interp(np.asarray(tokens, dtype=np.float64), grid, mean_lat)


def attribute_step(tokens, profile) -> StepAttribution:
    """Decompose straggler slack for one step.

    ``tokens`` is the (L, G) per-layer per-device token matrix (the
    router counts pushed through the placement / replica share split);
    ``profile`` a :class:`repro.core.VariabilityProfile` over G devices.
    """
    tokens = np.atleast_2d(np.asarray(tokens, dtype=np.float64))
    actual = profile.cost_all(tokens)  # (L, G) T_g
    uniform = _mean_curve_cost(profile, tokens)  # (L, G) U_g
    slack_total = actual.max(axis=1) - actual.mean(axis=1)
    slack_load = uniform.max(axis=1) - uniform.mean(axis=1)
    return StepAttribution(
        slack_total=slack_total,
        slack_load=slack_load,
        slack_var=slack_total - slack_load,
        straggler=actual.argmax(axis=1),
    )


class AttributionAccumulator:
    """Running per-run aggregate of :func:`attribute_step` results.

    Tracks step-summed slack components plus a per-device straggler tally
    (how many (layer, step) cells each device was the straggler for) —
    the raw material for ``benchmarks/telemetry_report.py``'s table.
    """

    def __init__(self, num_devices: int):
        self.num_devices = int(num_devices)
        self.steps = 0
        self.sum_total = 0.0
        self.sum_load = 0.0
        self.sum_var = 0.0
        self.straggler_cells = np.zeros(self.num_devices, dtype=np.int64)

    def observe(self, att: StepAttribution) -> None:
        self.steps += 1
        self.sum_total += att.total
        self.sum_load += att.load
        self.sum_var += att.var
        np.add.at(self.straggler_cells, att.straggler, 1)

    def summary(self) -> dict:
        """Flat dict merged into ``latency_report()`` / fig rows.

        ``*_frac`` are shares of total slack (load + var == 1 up to fp
        when total > 0); means are per engine step.
        """
        steps = max(self.steps, 1)
        total = self.sum_total
        return {
            "attr_steps": float(self.steps),
            "attr_slack_total_s": float(self.sum_total),
            "attr_slack_load_s": float(self.sum_load),
            "attr_slack_var_s": float(self.sum_var),
            "attr_mean_slack_s": float(self.sum_total / steps),
            "attr_load_frac": float(self.sum_load / total) if total else 0.0,
            "attr_var_frac": float(self.sum_var / total) if total else 0.0,
            "attr_straggler_cells": [int(c) for c in self.straggler_cells],
        }

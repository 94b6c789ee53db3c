"""Per-step placement regret against a hindsight oracle.

PR 8's attribution plane says *why* a step was slow (load imbalance vs
hardware variability); this module says how much of it a better expert
placement could actually have recovered. For each engine step we take
the (L, E) router counts, the *true* device profile, and the live
placements, and compute

- ``actual_s``      — the step cost the run really paid,
  ``Σ_l max_g C_g(n_g)`` under the live placement;
- ``oracle_s``      — the hindsight-oracle step cost: a warm-started GEM
  re-search (:func:`repro.core.search.refine`) over *this step's own
  loads*, seeded from the live placement and from the previous step's
  oracle. Because refine only ever applies improving swaps, the oracle
  is never worse than the live placement on the step's loads, so
  ``regret = actual − oracle ≥ 0`` holds **by construction** (the
  replicated pool's split shares can beat any single-copy placement, so
  the oracle is additionally clamped at ``actual``);
- ``lower_bound_s`` — the cheap placement-free floor: the fleet-mean
  load ``n̄ = N_l / G`` evaluated on every device's latency curve. Some
  device must carry ≥ ``n̄`` tokens, so the straggler cost is at least
  ``min_g C_g(n̄)`` — the min over devices is the only statement
  provable without search (the optimum may pile the mean load onto the
  fastest curve). ``oracle − lower_bound`` is the slack placement alone
  cannot fix — the headroom ROADMAP directions 1–3 (token shedding,
  co-placement, expert sharding) would have to recover.

Each step's regret is attributed to exactly one component, so the
components sum to the total **exactly**:

- ``placement``     — a replan could reach the oracle right now;
- ``migration-lag`` — the controller already decided (plan in flight,
  deferred behind the cooldown/window, or still in warm-up): the gap is
  migration latency, not placement choice.

Host-side numpy only — like attribution, regret never touches traced
values, so ``telemetry=None`` token streams stay bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.eplb import linear_placement
from ..core.search import refine
from ..core.types import ExpertTrace, Placement, VariabilityProfile

__all__ = [
    "NOISE_FLOOR",
    "REGRET_STEP_BOUNDS",
    "StepRegret",
    "RegretTracker",
    "record_step_metrics",
]

# declared fp noise floor for the ``regret ≥ 0`` invariant: the oracle is
# a clamped min, so any negative regret beyond this is a real bug, not
# rounding (CI gates on it — benchmarks/telemetry_report.py)
NOISE_FLOOR = 1e-9

# fixed histogram buckets for per-step regret (seconds) — deterministic
# boundaries so CI can pin exported snapshots (same decade ladder as the
# attribution slack histogram)
REGRET_STEP_BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)

COMPONENTS = ("placement", "migration-lag")


@dataclasses.dataclass(frozen=True)
class StepRegret:
    """One engine step's regret decomposition (seconds)."""

    actual_s: float  # step cost actually paid under the live placement
    oracle_s: float  # hindsight-oracle cost (≤ actual by construction)
    lower_bound_s: float  # placement-free floor (≤ oracle)
    component: str  # "placement" | "migration-lag"

    @property
    def regret_s(self) -> float:
        return self.actual_s - self.oracle_s

    @property
    def unrecoverable_s(self) -> float:
        """Slack no placement can fix: oracle cost above the fleet floor."""
        return self.oracle_s - self.lower_bound_s


def record_step_metrics(telemetry, sr: StepRegret, step: int) -> None:
    """Mirror one step's regret onto a telemetry hub: cumulative
    counters + the per-step histogram (always recorded — registry
    instruments are pure host state) and a ``regret`` instant for the
    report's timeline (event-gated). All quantities are non-negative by
    construction, so counters fit."""
    telemetry.counter("regret.actual_s").inc(sr.actual_s)
    telemetry.counter("regret.oracle_s").inc(sr.oracle_s)
    telemetry.counter("regret.lower_bound_s").inc(sr.lower_bound_s)
    telemetry.counter("regret.total_s").inc(sr.regret_s)
    telemetry.counter(
        "regret.migration_lag_s"
        if sr.component == "migration-lag"
        else "regret.placement_s"
    ).inc(sr.regret_s)
    telemetry.histogram("regret.step_s", REGRET_STEP_BOUNDS).observe(
        sr.regret_s
    )
    telemetry.instant(
        "regret",
        step=int(step),
        actual_s=sr.actual_s,
        oracle_s=sr.oracle_s,
        lower_bound_s=sr.lower_bound_s,
        regret_s=sr.regret_s,
        component=sr.component,
    )


class RegretTracker:
    """Owns the hindsight oracle's warm-start state + the run aggregate.

    One instance per run (mirrors :class:`AttributionAccumulator`); feed
    each step with :meth:`observe`. ``keep_series`` retains the per-step
    :class:`StepRegret` list — the fig20 regret-collapse gate and the
    report timeline want it; the serving engine leaves it off.
    """

    def __init__(
        self,
        num_experts: int,
        num_devices: int,
        *,
        tol: float = 1e-3,
        max_swaps: int = 64,
        keep_series: bool = False,
    ):
        self.num_experts = int(num_experts)
        self.num_devices = int(num_devices)
        self.tol = float(tol)
        self.max_swaps = int(max_swaps)
        self._warm: dict[int, Placement] = {}  # layer → last oracle placement
        self.steps = 0
        self.sum_actual = 0.0
        self.sum_oracle = 0.0
        self.sum_lower_bound = 0.0
        self.sum_regret = 0.0
        self.sum_by_component = dict.fromkeys(COMPONENTS, 0.0)
        self.series: list[StepRegret] | None = [] if keep_series else None

    # -- oracle --------------------------------------------------------
    def _oracle_layer(
        self,
        layer: int,
        counts: np.ndarray,
        profile: VariabilityProfile,
        live: Placement | None,
    ) -> float:
        """Hindsight re-search of one layer's loads: hill-climb from the
        live placement and from the previous step's oracle, keep the best.
        The warm pair makes the per-step search a handful of swaps — the
        oracle placement barely moves between adjacent steps."""
        trace = ExpertTrace(counts[None, :].astype(np.int64))
        seeds: list[Placement] = []
        if live is not None:
            seeds.append(live)
        prev = self._warm.get(layer)
        if prev is not None and not any(
            np.array_equal(prev.expert_to_device, s.expert_to_device)
            for s in seeds
        ):
            seeds.append(prev)
        if not seeds:
            seeds.append(linear_placement(self.num_experts, self.num_devices))
        best_p: Placement | None = None
        best_s = np.inf
        for seed in seeds:
            p, s, _ = refine(
                seed, trace, profile, tol=self.tol, max_swaps=self.max_swaps
            )
            if s < best_s:
                best_p, best_s = p, s
        assert best_p is not None
        self._warm[layer] = best_p
        return float(best_s)

    def _lower_bound(
        self, counts: np.ndarray, profile: VariabilityProfile
    ) -> float:
        """Σ_l min_g C_g(N_l / G): the placement-free step-cost floor."""
        G = self.num_devices
        mean_load = counts.sum(axis=1, dtype=np.float64) / G  # (L,)
        per_device = profile.cost_all(
            np.repeat(mean_load[:, None], G, axis=1)
        )  # (L, G)
        return float(per_device.min(axis=1).sum())

    # -- per-step observation ------------------------------------------
    def observe(
        self,
        counts: np.ndarray,
        profile: VariabilityProfile,
        actual_s: float,
        *,
        placements: list[Placement] | None = None,
        lagging: bool = False,
    ) -> StepRegret:
        """Fold one step into the run aggregate.

        ``counts`` (L, E): the step's per-layer per-(virtual-)expert router
        counts; ``profile`` the **true** fleet profile; ``actual_s`` the
        step cost actually charged (``cost_mx.max(axis=1).sum()``);
        ``placements`` the live per-layer placements (``None`` in
        replicated mode — the oracle then warm-starts from its own state);
        ``lagging`` True when the controller has already committed (plan in
        flight / deferred / warm-up) so the gap is migration lag.
        """
        counts = np.atleast_2d(np.asarray(counts))
        searched = sum(
            self._oracle_layer(
                layer,
                counts[layer],
                profile,
                placements[layer] if placements is not None else None,
            )
            for layer in range(counts.shape[0])
        )
        actual_s = float(actual_s)
        # the live placement is always a hindsight candidate ("do nothing"),
        # so the oracle can never exceed what the run paid — this clamp is
        # what makes the regret ≥ 0 invariant exact, including in replicated
        # mode where the search runs over single-copy placements only
        oracle = min(actual_s, searched)
        lb = min(self._lower_bound(counts, profile), oracle)
        sr = StepRegret(
            actual_s=actual_s,
            oracle_s=oracle,
            lower_bound_s=lb,
            component="migration-lag" if lagging else "placement",
        )
        self.steps += 1
        self.sum_actual += sr.actual_s
        self.sum_oracle += sr.oracle_s
        self.sum_lower_bound += sr.lower_bound_s
        self.sum_regret += sr.regret_s
        self.sum_by_component[sr.component] += sr.regret_s
        if self.series is not None:
            self.series.append(sr)
        return sr

    # -- run aggregate -------------------------------------------------
    def summary(self) -> dict:
        """Flat scalar dict merged into ``latency_report()`` / fig rows.

        ``regret_placement_s + regret_migration_lag_s == regret_total_s``
        exactly (each step lands in one component);
        ``regret_unrecoverable_s`` is the oracle's distance to the
        placement-free floor — what directions 1–3 would have to recover.
        """
        steps = max(self.steps, 1)
        actual = self.sum_actual
        return {
            "regret_steps": float(self.steps),
            "regret_actual_s": float(self.sum_actual),
            "regret_oracle_s": float(self.sum_oracle),
            "regret_lower_bound_s": float(self.sum_lower_bound),
            "regret_total_s": float(self.sum_regret),
            "regret_placement_s": float(self.sum_by_component["placement"]),
            "regret_migration_lag_s": float(
                self.sum_by_component["migration-lag"]
            ),
            "regret_mean_s": float(self.sum_regret / steps),
            "regret_frac": float(self.sum_regret / actual) if actual else 0.0,
            "regret_unrecoverable_s": float(
                self.sum_oracle - self.sum_lower_bound
            ),
        }

"""Consistent / temporal expert classification and correlation analysis.

Paper §3.1–§3.2: the heaviest experts fall into two classes —

  * **consistent** experts are active in a large fraction of engine steps
    (detectable from mean utilization; paper Fig. 6: active in ~85% of steps);
  * **temporal** experts are active in a small fraction of steps but process
    large bursts when active, often *together* (Pearson r up to 0.88,
    Fig. 8). Mean utilization under-ranks them; per-step traces expose them.

These diagnostics are not needed by the search itself (Eq. 1 scoring over the
per-step trace already prices temporal co-activation correctly — that is the
point of scoring per step rather than on averages), but they power analysis
benchmarks (Figs. 6/8/17) and the serving engine's placement report.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import ExpertTrace

__all__ = [
    "ExpertClasses",
    "classify_experts",
    "correlation_matrix",
    "correlated_groups",
]


@dataclasses.dataclass
class ExpertClasses:
    consistent: np.ndarray  # expert ids, active fraction >= consistent_thresh
    temporal: np.ndarray  # bursty ids: low active fraction, high burst load
    active_fraction: np.ndarray  # (E,) fraction of steps with nonzero tokens
    burst_intensity: np.ndarray  # (E,) mean tokens over *active* steps / uniform


def classify_experts(
    trace: ExpertTrace,
    *,
    consistent_thresh: float = 0.5,
    temporal_active_max: float = 0.5,
    burst_factor: float = 1.5,
    hot_factor: float = 1.25,
) -> ExpertClasses:
    """Split *hot* experts into consistent vs temporal.

    An expert is "hot" when its load is meaningfully above the uniform share:
    mean utilization >= ``hot_factor``× uniform (consistent candidates) or
    per-active-step burst >= ``burst_factor``× uniform (temporal candidates).

    ``consistent``: hot and active in >= ``consistent_thresh`` of steps
    (paper Fig. 6: experts 2/5/15 active in ~85% of steps).
    ``temporal``: bursty — active in < ``temporal_active_max`` of steps but
    processing ``burst_factor``×-uniform loads when active (paper Fig. 6:
    experts 0/3/10 active in 17% of steps with ~3× load).
    """
    counts = trace.counts
    T, E = counts.shape
    active = counts > 0
    active_fraction = active.mean(axis=0)
    tokens_per_step = counts.sum(axis=1, keepdims=True).astype(np.float64)
    uniform_share = tokens_per_step.mean() / E
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_when_active = np.where(
            active.sum(axis=0) > 0,
            counts.sum(axis=0) / np.maximum(active.sum(axis=0), 1),
            0.0,
        )
    burst_intensity = mean_when_active / max(uniform_share, 1e-12)
    mean_util = counts.mean(axis=0) / max(uniform_share, 1e-12)
    consistent = np.where(
        (active_fraction >= consistent_thresh) & (mean_util >= hot_factor)
    )[0]
    temporal = np.where(
        (active_fraction < temporal_active_max)
        & (burst_intensity >= burst_factor)
    )[0]
    return ExpertClasses(
        consistent=consistent.astype(np.int32),
        temporal=temporal.astype(np.int32),
        active_fraction=active_fraction,
        burst_intensity=burst_intensity,
    )


def correlation_matrix(trace: ExpertTrace) -> np.ndarray:
    """(E, E) Pearson correlation of per-step token counts across experts.

    Constant (zero-variance) experts get zero correlation with everything.
    """
    x = trace.counts.astype(np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    std = x.std(axis=0)
    safe = np.where(std > 0, std, 1.0)
    xn = x / safe
    corr = (xn.T @ xn) / max(trace.num_steps, 1)
    corr[std == 0, :] = 0.0
    corr[:, std == 0] = 0.0
    np.fill_diagonal(corr, 1.0)
    return np.clip(corr, -1.0, 1.0)


def correlated_groups(
    trace: ExpertTrace, *, r_thresh: float = 0.5, min_size: int = 2
) -> list[list[int]]:
    """Connected components of the expert graph with edges where r >= thresh.

    These are the *correlated temporal groups* (Insight-2): experts in one
    group tend to burst simultaneously, so a good mapping spreads each group
    across devices.
    """
    corr = correlation_matrix(trace)
    E = corr.shape[0]
    adj = (corr >= r_thresh) & ~np.eye(E, dtype=bool)
    seen = np.zeros(E, dtype=bool)
    groups: list[list[int]] = []
    for s in range(E):
        if seen[s] or not adj[s].any():
            continue
        stack, comp = [s], []
        seen[s] = True
        while stack:
            v = stack.pop()
            comp.append(v)
            for w in np.where(adj[v] & ~seen)[0]:
                seen[w] = True
                stack.append(int(w))
        if len(comp) >= min_size:
            groups.append(sorted(comp))
    return groups


def group_spread(groups: list[list[int]], placement) -> float:
    """Mean fraction of distinct devices used per correlated group (1.0 = best)."""
    if not groups:
        return 1.0
    fracs = []
    for g in groups:
        devs = placement.devices_of(g)
        fracs.append(len(set(devs.tolist())) / min(len(g), placement.num_devices))
    return float(np.mean(fracs))

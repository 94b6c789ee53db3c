"""Statistics over all of a window's samples (never over chunks of it)."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``;
    an infinite value (a request that never got its answer) counts as the
    slowest. None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(math.ceil(q / 100.0 * len(xs)), 1)
    return xs[rank - 1]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of
    the median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merge(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]

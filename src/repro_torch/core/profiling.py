"""Step-2: per-device performance-variability profiling (paper §3.3.2).

The profiler launches an isolated MoE expert micro-benchmark at a set of
target token counts on every device and records mean latency, producing the
per-device token→latency curves consumed by the placement search.

Two strategies:
  * ``profile_fleet`` (GEM, fast): sample only at tile boundaries, switch to
    sparse sampling + linear interpolation at high token counts. Minutes.
  * ``profile_fleet_dense`` (baseline, slow): every token count 1..max. Hours.
    Implemented to reproduce the paper's Fig. 18 cost comparison.

On real TPU hardware, ``measure_fn`` runs the Pallas grouped-GEMM kernel
(`repro.kernels.ops.moe_ffn`) under ``jax.block_until_ready`` timing; on this
CPU-only container the simulator's staircase models stand in, exactly like the
paper's power-cap emulation stands in for natural fleet variability.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .latency_model import DeviceFleet, dense_grid, tile_boundary_grid
from .types import VariabilityProfile

__all__ = [
    "ProfilingResult",
    "profile_fleet",
    "profile_fleet_dense",
    "profiling_cost_seconds",
]

# measure_fn(device_index, token_count, repeats) -> mean latency in seconds
MeasureFn = Callable[[int, int, int], float]


@dataclasses.dataclass
class ProfilingResult:
    profile: VariabilityProfile
    num_samples: int  # token counts sampled per device
    device_seconds: float  # simulated/physical device time consumed
    wall_seconds: float  # host wall-clock spent profiling


def _run(
    measure_fn: MeasureFn,
    num_devices: int,
    grid: np.ndarray,
    repeats: int,
    tile: int,
) -> tuple[VariabilityProfile, float]:
    lat = np.empty((num_devices, len(grid)), dtype=np.float64)
    device_seconds = 0.0
    for g in range(num_devices):
        for i, n in enumerate(grid):
            mean_lat = measure_fn(g, int(n), repeats)
            lat[g, i] = mean_lat
            device_seconds += mean_lat * repeats
    # Enforce monotone non-decreasing curves: measurement noise can produce
    # tiny inversions which would make the scoring non-monotone in load.
    lat = np.maximum.accumulate(lat, axis=1)
    return VariabilityProfile(grid, lat, tile), device_seconds


def profile_fleet(
    measure_fn: MeasureFn,
    num_devices: int,
    *,
    max_tokens: int,
    tile: int,
    repeats: int = 500,
    sparse_above: int | None = None,
    sparse_stride: int = 4096,
) -> ProfilingResult:
    """GEM's fast tile-boundary profiler.

    ``max_tokens`` is model-specific (paper Fig. 11): the profiler only covers
    the token-count range the model can actually route to one device.
    """
    t0 = time.perf_counter()
    grid = tile_boundary_grid(
        max_tokens, tile, sparse_above=sparse_above, sparse_stride=sparse_stride
    )
    profile, dev_s = _run(measure_fn, num_devices, grid, repeats, tile)
    return ProfilingResult(
        profile, len(grid), dev_s, time.perf_counter() - t0
    )


def profile_fleet_dense(
    measure_fn: MeasureFn,
    num_devices: int,
    *,
    max_tokens: int,
    tile: int,
    repeats: int = 500,
) -> ProfilingResult:
    """Naive full sweep over every token count (paper's slow baseline)."""
    t0 = time.perf_counter()
    grid = dense_grid(max_tokens)
    profile, dev_s = _run(measure_fn, num_devices, grid, repeats, tile)
    return ProfilingResult(profile, len(grid), dev_s, time.perf_counter() - t0)


def profiling_cost_seconds(
    fleet: DeviceFleet, grid: np.ndarray, repeats: int
) -> float:
    """Analytic device-time cost of profiling ``grid`` on ``fleet``.

    Used by the Fig. 18 benchmark to report the hours-vs-minutes gap without
    actually sleeping for the dense sweep.
    """
    total = 0.0
    for m in fleet.models:
        total += float(m.latency(grid).sum()) * repeats
    return total


def simulator_measure_fn(
    fleet: DeviceFleet, seed: int = 0
) -> MeasureFn:
    """measure_fn backed by the staircase simulator (CPU-only container)."""
    rng = np.random.default_rng(seed)

    def measure(device: int, tokens: int, repeats: int) -> float:
        return fleet.models[device].measure(tokens, repeats, rng)

    return measure

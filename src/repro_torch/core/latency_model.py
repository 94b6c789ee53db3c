"""Staircase latency model for MoE expert compute (paper §3.3.2).

MoE kernels process tokens in fixed-size *tiles* (multiples of 32/64 on GPU;
the MXU-aligned block rows of our Pallas grouped GEMM on TPU). Latency is flat
within a tile and jumps at tile boundaries — a staircase. GEM exploits this to
profile devices only at tile boundaries instead of every token count.

Two uses:
  * ``StaircaseLatencyModel`` — the ground-truth device simulator used by the
    benchmark/simulation layer (the analogue of a physical accelerator with a
    given sustained throughput multiplier).
  * ``fit_profile`` / sampling utilities used by the profiler to reconstruct a
    :class:`~repro.core.types.VariabilityProfile` from (simulated or measured)
    latency samples.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "StaircaseLatencyModel",
    "DeviceFleet",
    "MigrationCostModel",
    "BandwidthEstimator",
    "tile_boundary_grid",
    "dense_grid",
]


@dataclasses.dataclass(frozen=True)
class StaircaseLatencyModel:
    """Ground-truth latency of one device's MoE layer vs token count.

    latency(n) = base + ceil(n / tile) * tile_time / speed

    ``speed`` is the device's throughput multiplier (1.0 = nominal; the paper's
    L40 fleet spans roughly [0.88, 1.11] around the mean). ``base`` models
    kernel-launch / dispatch overhead, which the paper observes is *not*
    proportional to load, so a slow device is slow mostly in its tile time.
    ``jitter`` adds multiplicative measurement noise when sampling.
    """

    tile: int = 512  # tokens per latency step (paper Fig. 7: 512 on L40)
    tile_time: float = 120e-6  # seconds per tile at speed 1.0
    base: float = 35e-6  # fixed per-invocation overhead (s)
    speed: float = 1.0  # relative throughput of this device
    jitter: float = 0.0  # stdev of multiplicative measurement noise

    def latency(self, tokens, rng: np.random.Generator | None = None) -> np.ndarray:
        tokens = np.asarray(tokens, dtype=np.float64)
        tiles = np.ceil(np.maximum(tokens, 0) / self.tile)
        lat = (self.base + tiles * self.tile_time) / self.speed
        if self.jitter > 0.0:
            if rng is None:
                rng = np.random.default_rng(0)
            lat = lat * (1.0 + rng.normal(0.0, self.jitter, size=lat.shape))
        return lat

    def measure(
        self, tokens: int, repeats: int, rng: np.random.Generator
    ) -> float:
        """Simulate ``repeats`` kernel launches and return the mean latency.

        This is the microbenchmark primitive of Step-2: each call costs
        ``repeats * latency`` of (simulated) device time, which the profiler
        budget accounting charges.
        """
        samples = self.latency(np.full(repeats, tokens, dtype=np.int64), rng=rng)
        return float(samples.mean())


@dataclasses.dataclass
class DeviceFleet:
    """A set of devices with heterogeneous speeds (one EP group each)."""

    models: Sequence[StaircaseLatencyModel]

    @property
    def num_devices(self) -> int:
        return len(self.models)

    @property
    def speeds(self) -> np.ndarray:
        return np.asarray([m.speed for m in self.models])

    @staticmethod
    def homogeneous(
        num_devices: int, *, tile: int = 512, tile_time: float = 120e-6,
        base: float = 35e-6, jitter: float = 0.0,
    ) -> "DeviceFleet":
        return DeviceFleet(
            [
                StaircaseLatencyModel(tile, tile_time, base, 1.0, jitter)
                for _ in range(num_devices)
            ]
        )

    @staticmethod
    def from_speeds(
        speeds: Sequence[float], *, tile: int = 512, tile_time: float = 120e-6,
        base: float = 35e-6, jitter: float = 0.0,
    ) -> "DeviceFleet":
        return DeviceFleet(
            [
                StaircaseLatencyModel(tile, tile_time, base, float(s), jitter)
                for s in speeds
            ]
        )

    def latency_matrix(self, token_grid: np.ndarray) -> np.ndarray:
        """(G, S) noiseless latencies over a token grid."""
        return np.stack([m.latency(token_grid) for m in self.models])


@dataclasses.dataclass(frozen=True)
class MigrationCostModel:
    """Prices an in-deployment expert-weight migration (online plane).

    Moving one expert means shipping its stacked FFN weights
    (w_gate + w_up + w_down rows, ``expert_bytes`` total) over the
    interconnect; a batch of ``n`` moves applied between two decode steps
    costs

        cost(n) = base_overhead + n * expert_bytes / bandwidth

    and is *charged to that step's latency* by the serving engine / replay
    simulator, so migration is never free. ``base_overhead`` covers the
    collective launch + router-table swap, paid once per non-empty batch.
    """

    expert_bytes: float  # bytes to move one (virtual) expert's weights
    bandwidth: float = 50e9  # interconnect bytes/s (NVLink-class default)
    base_overhead: float = 20e-6  # per-batch launch overhead (s)

    def cost(self, num_moves: int) -> float:
        if num_moves <= 0:
            return 0.0
        return self.base_overhead + num_moves * self.expert_bytes / self.bandwidth

    def cost_bytes(self, payload_bytes: float) -> float:
        """Cost of a batch by its *measured* interconnect payload — the
        collective plane's accounting (a batch whose rows all resolve to
        local HBM copies ships zero bytes and pays no overhead)."""
        if payload_bytes <= 0:
            return 0.0
        return self.base_overhead + payload_bytes / self.bandwidth

    def with_bandwidth(self, bandwidth: float) -> "MigrationCostModel":
        """The same model with a recalibrated bandwidth term."""
        return dataclasses.replace(self, bandwidth=float(bandwidth))

    @staticmethod
    def for_expert_dims(d_model: int, expert_d_ff: int, *,
                        bytes_per_param: int = 2,
                        bandwidth: float = 50e9,
                        base_overhead: float = 20e-6) -> "MigrationCostModel":
        """Cost model from expert dims: 3 D·F matrices (gate/up/down)."""
        return MigrationCostModel(
            expert_bytes=float(3 * d_model * expert_d_ff * bytes_per_param),
            bandwidth=bandwidth, base_overhead=base_overhead,
        )


@dataclasses.dataclass
class BandwidthEstimator:
    """Learns the interconnect bandwidth from measured migration batches.

    The :class:`MigrationCostModel`'s ``bandwidth`` is a configured
    assumption; once the collective migration plane runs, every batch
    yields a (payload bytes, transfer seconds) sample of the *actual*
    interconnect. The estimator EWMA-smooths the per-batch implied
    bandwidth and hands back a recalibrated cost model, so the controller's
    net-benefit gate prices future migrations with what the fabric really
    delivers instead of the NVLink-class default.
    """

    alpha: float = 0.25  # EWMA weight of the newest sample
    min_bytes: float = 1.0  # ignore batches too small to time meaningfully
    bandwidth_hat: float | None = None
    num_samples: int = 0

    def bind_telemetry(self, telemetry) -> None:
        """Mirror the running estimate onto a telemetry gauge
        (``bandwidth.estimate_gbps``); pure host-side, optional."""
        self._telemetry = telemetry

    def observe(
        self, payload_bytes: float, seconds: float, *,
        base_overhead: float = 0.0,
    ) -> float | None:
        """Feed one measured batch; returns the updated estimate.

        ``seconds`` is the batch's full measured time; the per-batch
        ``base_overhead`` (launch + router-table swap) is subtracted so
        only the bandwidth-proportional part enters the estimate.
        """
        transfer = seconds - base_overhead
        if payload_bytes < self.min_bytes or transfer <= 0.0:
            return self.bandwidth_hat
        sample = payload_bytes / transfer
        if self.bandwidth_hat is None:
            self.bandwidth_hat = sample
        else:
            self.bandwidth_hat += self.alpha * (sample - self.bandwidth_hat)
        self.num_samples += 1
        tel = getattr(self, "_telemetry", None)
        if tel is not None:
            tel.gauge("bandwidth.estimate_gbps").set(
                self.bandwidth_hat / 1e9
            )
        return self.bandwidth_hat

    def calibrated(self, model: MigrationCostModel) -> MigrationCostModel:
        """``model`` with the learned bandwidth (unchanged before the first
        usable sample)."""
        if self.bandwidth_hat is None:
            return model
        return model.with_bandwidth(self.bandwidth_hat)


def tile_boundary_grid(
    max_tokens: int,
    tile: int,
    *,
    sparse_above: int | None = None,
    sparse_stride: int = 4096,
) -> np.ndarray:
    """GEM's fast profiling grid (paper §3.3.2).

    Samples one point per tile boundary (the only places latency can change)
    up to ``sparse_above``, then switches to sparse sampling every
    ``sparse_stride`` tokens, relying on linear interpolation between samples
    — the per-tile increment is a vanishing fraction of total latency at high
    counts.
    """
    if sparse_above is None:
        sparse_above = min(max_tokens, 16 * tile)
    dense = np.arange(tile, min(sparse_above, max_tokens) + 1, tile)
    grid = [np.asarray([1], dtype=np.int64), dense.astype(np.int64)]
    if max_tokens > sparse_above:
        sparse = np.arange(
            sparse_above + sparse_stride, max_tokens + 1, sparse_stride
        )
        grid.append(sparse.astype(np.int64))
    out = np.unique(np.concatenate(grid))
    if out[-1] != max_tokens:
        out = np.append(out, max_tokens)
    return out


def dense_grid(max_tokens: int) -> np.ndarray:
    """The naive full sweep (every token count) — the paper's slow baseline."""
    return np.arange(1, max_tokens + 1, dtype=np.int64)

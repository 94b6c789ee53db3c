"""Core datatypes for GEM: placements, traces, and variability profiles.

Everything in ``repro.core`` is host-side (numpy) by design: the paper's
algorithms (trace capture, profiling, placement search) all run on CPU in the
serving control plane, while the JAX data plane consumes only the resulting
*placement permutation*.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

__all__ = [
    "Placement",
    "ExpertTrace",
    "VariabilityProfile",
    "GEMConfig",
]


@dataclasses.dataclass(frozen=True)
class Placement:
    """An expert→device assignment for one MoE layer.

    ``expert_to_device[e]`` is the device hosting (logical) expert ``e``.
    Every device hosts exactly ``num_experts // num_devices`` experts
    (paper §3.3.3: equal expert counts keep per-device weight memory equal so
    KV-cache headroom is uniform).

    The *slot permutation* is the physical layout: slot ``s`` (row ``s`` of the
    stacked expert-weight arrays) holds logical expert ``slot_to_expert[s]``,
    where slots are device-major (device ``g`` owns slots
    ``[g*E/G, (g+1)*E/G)``).
    """

    expert_to_device: np.ndarray  # (E,) int32
    num_devices: int

    def __post_init__(self):
        e2d = np.asarray(self.expert_to_device, dtype=np.int32)
        object.__setattr__(self, "expert_to_device", e2d)
        counts = np.bincount(e2d, minlength=self.num_devices)
        if len(set(counts.tolist())) != 1:
            raise ValueError(
                f"placement must give each device the same number of experts, "
                f"got per-device counts {counts.tolist()}"
            )

    @property
    def num_experts(self) -> int:
        return int(self.expert_to_device.shape[0])

    @property
    def experts_per_device(self) -> int:
        return self.num_experts // self.num_devices

    def slot_to_expert(self) -> np.ndarray:
        """Physical slot layout: device-major list of logical expert ids."""
        order = np.argsort(self.expert_to_device, kind="stable")
        return order.astype(np.int32)

    def expert_to_slot(self) -> np.ndarray:
        """Inverse of :meth:`slot_to_expert` (router remap table)."""
        s2e = self.slot_to_expert()
        e2s = np.empty_like(s2e)
        e2s[s2e] = np.arange(len(s2e), dtype=np.int32)
        return e2s

    def devices_of(self, experts: Sequence[int]) -> np.ndarray:
        return self.expert_to_device[np.asarray(experts)]

    @staticmethod
    def linear(num_experts: int, num_devices: int) -> "Placement":
        """vLLM default: expert ``i`` on device ``i // (E/G)`` (paper §4.3)."""
        per = num_experts // num_devices
        if per * num_devices != num_experts:
            raise ValueError("num_devices must divide num_experts evenly")
        return Placement(
            np.repeat(np.arange(num_devices, dtype=np.int32), per), num_devices
        )

    @staticmethod
    def from_slots(slot_to_expert: np.ndarray, num_devices: int) -> "Placement":
        slot_to_expert = np.asarray(slot_to_expert, dtype=np.int32)
        num_experts = slot_to_expert.shape[0]
        per = num_experts // num_devices
        e2d = np.empty(num_experts, dtype=np.int32)
        for g in range(num_devices):
            e2d[slot_to_expert[g * per : (g + 1) * per]] = g
        return Placement(e2d, num_devices)

    def swap(self, e_a: int, e_b: int) -> "Placement":
        e2d = self.expert_to_device.copy()
        e2d[e_a], e2d[e_b] = e2d[e_b], e2d[e_a]
        return Placement(e2d, self.num_devices)

    # -- plan diffing (online adaptation plane) ------------------------------
    @staticmethod
    def slot_relative_permutation(
        cur_s2e: np.ndarray, tgt_s2e: np.ndarray
    ) -> np.ndarray:
        """(S,) ``rel`` between two raw slot→expert layouts: the row ending
        up in slot ``s`` currently lives in slot ``rel[s]``.

        Shared by :meth:`relative_slot_permutation` (canonical placements)
        and :func:`repro.online.migration.plan_migration` (live *physical*
        layouts, which mid-migration are not canonical)."""
        cur_s2e = np.asarray(cur_s2e, dtype=np.int32)
        tgt_s2e = np.asarray(tgt_s2e, dtype=np.int32)
        if cur_s2e.shape != tgt_s2e.shape:
            raise ValueError("layouts must cover the same slots")
        cur_e2s = np.empty_like(cur_s2e)
        cur_e2s[cur_s2e] = np.arange(len(cur_s2e), dtype=np.int32)
        # slot s must hold expert tgt_s2e[s], which currently sits in slot
        # cur_e2s[that expert]
        return cur_e2s[tgt_s2e]

    def relative_slot_permutation(self, target: "Placement") -> np.ndarray:
        """(E,) ``rel`` such that permuting the *current* physical weight rows
        with ``rel`` realises ``target``: the row ending up in slot ``s``
        currently lives in slot ``rel[s]``.

        This is the in-deployment migration primitive — ``rel`` is what an
        incremental planner decomposes into budgeted swap batches
        (:mod:`repro.online.migration`).
        """
        if target.num_experts != self.num_experts:
            raise ValueError("placements must cover the same experts")
        return Placement.slot_relative_permutation(
            self.slot_to_expert(), target.slot_to_expert()
        )

    def moved_slots(self, target: "Placement") -> np.ndarray:
        """Slot ids whose resident expert changes going to ``target``.

        ``len(moved_slots)`` is the number of expert-weight rows a migration
        must rewrite — the quantity the migration cost model prices.
        """
        rel = self.relative_slot_permutation(target)
        return np.nonzero(rel != np.arange(len(rel)))[0].astype(np.int32)

    def to_json(self) -> str:
        return json.dumps(
            {
                "expert_to_device": self.expert_to_device.tolist(),
                "num_devices": self.num_devices,
            }
        )

    @staticmethod
    def from_json(s: str) -> "Placement":
        d = json.loads(s)
        return Placement(np.asarray(d["expert_to_device"]), d["num_devices"])


@dataclasses.dataclass
class ExpertTrace:
    """Step-1 artifact: per-step per-expert token counts for one MoE layer.

    ``counts[t, e]`` = tokens routed to expert ``e`` during engine step ``t``
    (paper §3.3.1). A "step" is one engine iteration (one generated token per
    in-flight request).
    """

    counts: np.ndarray  # (T, E) int64

    def __post_init__(self):
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if self.counts.ndim != 2:
            raise ValueError("trace counts must be (steps, experts)")

    @property
    def num_steps(self) -> int:
        return int(self.counts.shape[0])

    @property
    def num_experts(self) -> int:
        return int(self.counts.shape[1])

    def mean_utilization(self) -> np.ndarray:
        """Per-expert mean token load across the trace (detects consistent experts)."""
        return self.counts.mean(axis=0)

    def window(self, length: int, start: int = 0) -> "ExpertTrace":
        return ExpertTrace(self.counts[start : start + length])

    def per_device_tokens(self, placement: Placement) -> np.ndarray:
        """(T, G): tokens each device processes at each step under ``placement``."""
        onehot = np.zeros((self.num_experts, placement.num_devices), dtype=np.int64)
        onehot[np.arange(self.num_experts), placement.expert_to_device] = 1
        return self.counts @ onehot

    def concat(self, other: "ExpertTrace") -> "ExpertTrace":
        return ExpertTrace(np.concatenate([self.counts, other.counts], axis=0))


@dataclasses.dataclass
class VariabilityProfile:
    """Step-2 artifact: per-device token-count→latency curves.

    ``curves[g]`` maps a token count to the latency (seconds) for device ``g``
    to run one MoE layer's expert compute over that many tokens. Backed by the
    staircase model in :mod:`repro.core.latency_model`.
    """

    token_counts: np.ndarray  # (S,) sample grid (shared across devices)
    latencies: np.ndarray  # (G, S) seconds
    tile_size: int  # hardware tile granularity used for sampling

    def __post_init__(self):
        self.token_counts = np.asarray(self.token_counts, dtype=np.int64)
        self.latencies = np.asarray(self.latencies, dtype=np.float64)
        if self.latencies.ndim != 2 or self.latencies.shape[1] != len(
            self.token_counts
        ):
            raise ValueError("latencies must be (devices, samples)")

    @property
    def num_devices(self) -> int:
        return int(self.latencies.shape[0])

    def cost(self, device: int, tokens) -> np.ndarray:
        """C_g(n): latency for ``device`` to process ``tokens`` tokens.

        Piecewise-linear interpolation over the sampled grid (paper §3.3.2:
        sparse samples at high counts are linearly interpolated).
        """
        return np.interp(
            np.asarray(tokens, dtype=np.float64),
            self.token_counts.astype(np.float64),
            self.latencies[device],
        )

    def cost_all(self, tokens: np.ndarray) -> np.ndarray:
        """Vectorized C over all devices: tokens (..., G) → latency (..., G)."""
        tokens = np.asarray(tokens, dtype=np.float64)
        out = np.empty(tokens.shape, dtype=np.float64)
        for g in range(self.num_devices):
            out[..., g] = np.interp(
                tokens[..., g],
                self.token_counts.astype(np.float64),
                self.latencies[g],
            )
        return out

    def relative_speed(self) -> np.ndarray:
        """Throughput of each device relative to the mean (diagnostic)."""
        # Use latency at the largest profiled token count as the speed proxy.
        lat = self.latencies[:, -1]
        thr = 1.0 / lat
        return thr / thr.mean()


@dataclasses.dataclass(frozen=True)
class GEMConfig:
    """Hyper-parameters of the GEM pipeline (paper defaults)."""

    trace_length: int = 16  # §3.3.1: 16 steps suffice
    num_restarts: int = 30  # §3.3.3: ~30 restarts
    restart_noise: float = 0.20  # Alg. 2: 20% utilization noise
    convergence_tol: float = 1e-3  # Alg. 3: stop when rel. drop < 0.1%
    max_swaps: int = 200  # safety bound (paper observes <18)
    seed: int = 0

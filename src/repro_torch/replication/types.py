"""Replicated expert placements: several physical slots per hot expert.

A :class:`~repro.core.types.Placement` is a *permutation* — one slot per
virtual expert — so a single hot consistent expert pins its whole token
load to whichever device hosts it, and no permutation can remove that
straggler floor (paper Insight 1). :class:`ReplicatedPlacement` relaxes
exactly this: the slot layout is device-major like a ``Placement``, every
device still hosts the same number of slots (equal weight memory → uniform
KV headroom), but a virtual expert may occupy several slots, and its tokens
are split across the copies **proportionally to each host device's profiled
speed** — never uniformly, and never onto devices the planner has excluded
as too slow.

Two deployment artifacts come out of a ``ReplicatedPlacement``:

  * ``slot_to_expert`` (S,) — the weight-pool gather: physical row ``s``
    holds a copy of virtual expert ``slot_to_expert[s]`` (the Step-4 install
    is the same row gather ``apply_placement`` performs, just with repeated
    indices).
  * ``replica_table(period)`` (E_v, P) — the router-side split table: the
    assignment with rank ``r`` (within its dispatch group and virtual
    expert) lands on physical slot ``table[e, r % P]``. The table interleaves
    each expert's copies by their token shares (Bresenham apportionment), so
    the split is deterministic, order-stable, and speed-proportional for any
    token count ≫ P.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..core.types import Placement, VariabilityProfile

__all__ = ["ReplicationConfig", "ReplicatedPlacement"]


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Budget + split policy of the replication plane."""

    replica_slots: int = 0  # extra physical slots per device (HBM budget)
    # derive replica_slots from the serving engine's HBM headroom instead
    # of the hand constant above: the engine subtracts its paged-KV-pool
    # bytes from ``EngineConfig.hbm_budget_bytes`` and fits as many replica
    # slots as the remainder holds (serving.kv_cache.replica_slots_for_
    # headroom) — replication and KV paging share one memory budget
    auto_slots: bool = False
    pattern_period: int = 16  # replica-split table length P (rank mod P)
    # devices whose relative speed (vs the fleet mean) falls below this get
    # zero token share on multi-copy experts — "never replicate onto the
    # slowest GPUs"; single-copy experts are unaffected (their tokens have
    # nowhere else to go)
    exclude_speed_below: float = 0.92
    consistent_only: bool = True  # replicate consistent experts first
    refine: bool = True  # speed-aware swap refinement after the GEM search
    max_refine_swaps: int = 64

    def __post_init__(self):
        if self.replica_slots < 0:
            raise ValueError("replica_slots must be >= 0")
        if self.pattern_period < 1:
            raise ValueError("pattern_period must be >= 1")


@dataclasses.dataclass
class ReplicatedPlacement:
    """A device-major slot layout where experts may occupy several slots.

    ``slot_to_expert`` (S,): slot ``s`` (on device ``s // (S/G)``) holds a
    copy of virtual expert ``slot_to_expert[s]``. Every expert appears at
    least once; every device hosts exactly ``S / num_devices`` slots.
    ``shares`` (S,): the fraction of its expert's tokens each slot receives
    (per-expert shares sum to 1); computed speed-proportionally by
    :meth:`compute_speed_shares` and carried with the placement so the data
    plane, the cost model, and serialization all see the same split.
    """

    slot_to_expert: np.ndarray  # (S,) int32, device-major
    num_devices: int
    num_experts: int  # E_v — the virtual expert count
    shares: np.ndarray | None = None  # (S,) per-slot token share

    def __post_init__(self):
        s2e = np.asarray(self.slot_to_expert, dtype=np.int32)
        self.slot_to_expert = s2e
        S, G, E = len(s2e), self.num_devices, self.num_experts
        if S % G != 0:
            raise ValueError(
                f"{S} slots do not divide evenly over {G} devices"
            )
        present = np.bincount(s2e, minlength=E)
        if s2e.min(initial=0) < 0 or s2e.max(initial=-1) >= E:
            raise ValueError("slot_to_expert ids must be in [0, num_experts)")
        if (present == 0).any():
            missing = np.nonzero(present == 0)[0]
            raise ValueError(
                f"every expert needs at least one slot; missing {missing.tolist()}"
            )
        if self.shares is not None:
            sh = np.asarray(self.shares, dtype=np.float64)
            if sh.shape != s2e.shape:
                raise ValueError("shares must be one value per slot")
            sums = np.bincount(s2e, weights=sh, minlength=E)
            if not np.allclose(sums, 1.0, atol=1e-6):
                raise ValueError("per-expert shares must sum to 1")
            self.shares = sh

    # -- shape helpers -------------------------------------------------------
    @property
    def num_slots(self) -> int:
        return int(len(self.slot_to_expert))

    @property
    def slots_per_device(self) -> int:
        return self.num_slots // self.num_devices

    @property
    def total_replicas(self) -> int:
        """Extra slots beyond one per expert."""
        return self.num_slots - self.num_experts

    @property
    def is_single_copy(self) -> bool:
        return self.total_replicas == 0

    def slot_device(self) -> np.ndarray:
        """(S,) device hosting each slot (device-major layout)."""
        return (
            np.arange(self.num_slots, dtype=np.int32) // self.slots_per_device
        )

    def copy_counts(self) -> np.ndarray:
        """(E,) number of physical copies per virtual expert."""
        return np.bincount(self.slot_to_expert, minlength=self.num_experts)

    def copy_slots(self, expert: int) -> np.ndarray:
        return np.nonzero(self.slot_to_expert == expert)[0].astype(np.int32)

    def slot_layout(self) -> np.ndarray:
        return self.slot_to_expert.copy()

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_placement(placement: Placement) -> "ReplicatedPlacement":
        """Single-copy view of a permutation placement (budget 0)."""
        s2e = placement.slot_to_expert()
        return ReplicatedPlacement(
            s2e, placement.num_devices, placement.num_experts,
            shares=np.ones(len(s2e)),
        )

    @staticmethod
    def linear(
        num_experts: int,
        num_devices: int,
        replica_slots: int = 0,
        *,
        profile: VariabilityProfile | None = None,
        config: ReplicationConfig = ReplicationConfig(),
    ) -> "ReplicatedPlacement":
        """vLLM-default layout padded with per-device round-robin copies.

        Device ``g``'s extra slots replicate its own resident experts (so
        the initial pool install moves no rows across devices); shares are
        speed-proportional when a profile is given, uniform otherwise.
        """
        per = num_experts // num_devices
        if per * num_devices != num_experts:
            raise ValueError(
                "num_devices must divide num_experts evenly"
            )
        rp = ReplicatedPlacement(
            np.arange(num_experts, dtype=np.int32), num_devices, num_experts
        ).pad_with_local_copies(replica_slots)
        rp.compute_speed_shares(profile, config=config)
        return rp

    def pad_with_local_copies(
        self, replica_slots: int
    ) -> "ReplicatedPlacement":
        """Grow each device by ``replica_slots`` slots replicating its own
        resident experts round-robin — a pool expansion that moves no rows
        across devices (shares unset; callers recompute)."""
        per = self.slots_per_device
        rows = []
        for g in range(self.num_devices):
            own = self.slot_to_expert[g * per : (g + 1) * per]
            extra = own[np.arange(replica_slots) % per]
            rows.append(np.concatenate([own, extra]))
        return ReplicatedPlacement(
            np.concatenate(rows), self.num_devices, self.num_experts
        )

    # -- token split ---------------------------------------------------------
    def compute_speed_shares(
        self,
        profile: VariabilityProfile | None,
        *,
        config: ReplicationConfig = ReplicationConfig(),
    ) -> np.ndarray:
        """Set (and return) speed-proportional per-slot shares.

        A multi-copy expert's tokens split ∝ each host device's relative
        speed; copies hosted on devices slower than
        ``config.exclude_speed_below`` × fleet mean get share 0 whenever the
        expert has at least one faster copy (the "never replicate onto the
        slowest GPUs" rule). With no profile the split is uniform.
        """
        S = self.num_slots
        dev = self.slot_device()
        if profile is None:
            speed = np.ones(self.num_devices)
        else:
            speed = profile.relative_speed()
        w = speed[dev].astype(np.float64)
        fast = speed >= config.exclude_speed_below
        shares = np.zeros(S)
        for e in range(self.num_experts):
            slots = self.copy_slots(e)
            we = w[slots].copy()
            if len(slots) > 1 and fast[dev[slots]].any():
                we = we * fast[dev[slots]]
            if we.sum() <= 0:
                we = np.ones(len(slots))
            shares[slots] = we / we.sum()
        self.shares = shares
        return shares

    def effective_shares(self) -> np.ndarray:
        """(S,) shares, defaulting to uniform-per-expert when unset."""
        if self.shares is not None:
            return self.shares
        counts = self.copy_counts().astype(np.float64)
        return 1.0 / counts[self.slot_to_expert]

    def share_matrix(self) -> np.ndarray:
        """(E, G) fraction of expert ``e``'s tokens landing on device ``g``.

        The replicated generalization of the placement one-hot: per-device
        token loads are ``counts @ share_matrix()`` (see
        :mod:`repro.replication.score`).
        """
        W = np.zeros((self.num_experts, self.num_devices))
        np.add.at(
            W,
            (self.slot_to_expert, self.slot_device()),
            self.effective_shares(),
        )
        return W

    def replica_table(self, period: int = 16) -> np.ndarray:
        """(E_v, P) data-plane split table: rank ``r`` → slot ``[e, r % P]``.

        Bresenham (largest-deficit) apportionment interleaves each expert's
        copies in proportion to their shares, deterministically: position
        ``j`` goes to the copy maximizing ``share·(j+1) − assigned`` (ties to
        the lowest slot id). Single-copy experts get a constant row, so at
        budget 0 the table collapses to ``expert_to_slot`` broadcast over P.
        """
        shares = self.effective_shares()
        table = np.empty((self.num_experts, period), dtype=np.int32)
        for e in range(self.num_experts):
            slots = self.copy_slots(e)
            if len(slots) == 1:
                table[e] = slots[0]
                continue
            sh = shares[slots]
            if sh.sum() <= 0:
                sh = np.ones(len(slots))
            sh = sh / sh.sum()
            assigned = np.zeros(len(slots))
            for j in range(period):
                deficit = sh * (j + 1) - assigned
                c = int(np.argmax(deficit))
                table[e, j] = slots[c]
                assigned[c] += 1.0
        return table

    def expert_to_slot(self) -> np.ndarray:
        """(E_v,) single-slot router table (each expert's first copy).

        Used by the capacity-free ``dense_ref`` oracle, which gathers one
        copy per expert — copies are bit-identical rows, so any copy works.
        """
        out = np.empty(self.num_experts, dtype=np.int32)
        for e in range(self.num_experts):
            out[e] = self.copy_slots(e)[0]
        return out

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "slot_to_expert": self.slot_to_expert.tolist(),
                "num_devices": self.num_devices,
                "num_experts": self.num_experts,
                "shares": None if self.shares is None else self.shares.tolist(),
            }
        )

    @staticmethod
    def from_json(s: str) -> "ReplicatedPlacement":
        d = json.loads(s)
        shares = d.get("shares")
        return ReplicatedPlacement(
            np.asarray(d["slot_to_expert"], dtype=np.int32),
            d["num_devices"],
            d["num_experts"],
            shares=None if shares is None else np.asarray(shares),
        )

"""Budgeted expert migration: from plan delta to per-step swap batches.

A fresh :class:`~repro.core.gem.GEMPlan` and the live placement differ by a
per-layer *slot permutation* (``Placement.relative_slot_permutation``).
Swapping the whole stacked weight array at once — what the one-shot engine
does — stalls decode for the full weight transfer. The migration planner
instead decomposes the delta into a sequence of **two-slot swaps** and packs
them into per-step batches bounded by ``max_moves_per_step`` expert-weight
rewrites, so the engine applies a small batch between consecutive decode
steps and decode latency absorbs many small hits instead of one huge one.

Why swaps: every intermediate state of a swap sequence is itself a valid
slot permutation — each expert exists in exactly one slot, every device
still hosts E/G experts, and the router remap table can be kept exactly
consistent with the weights at every step. The decomposition is the cycle
decomposition of the relative permutation: a cycle (s₀ s₁ … s_{c-1}) is
realised by the transpositions (s₀,s₁), (s₁,s₂), …, (s_{c-2},s_{c-1}) in
order — c−1 swaps, 2 weight-row rewrites each, the minimum possible for
that cycle.

Costing: each batch is priced by :class:`~repro.core.latency_model.
MigrationCostModel` (expert-weight bytes over the interconnect plus a fixed
batch overhead) and the engine/replay charges that cost to the step's
simulated latency — migration is never free, and the controller's
``migration_net_benefit`` go/no-go uses the same model.

**Replicated layouts** (:mod:`repro.replication`) change the move algebra:
two replicated layouts over the same slot count differ by an arbitrary
*reassignment*, not a permutation — copy counts grow and shrink, so a slot's
new expert may have to be **broadcast** from another slot (one weight-row
rewrite — cheaper than a swap's two) rather than exchanged.
:func:`plan_replica_migration` schedules these one-row copies into budgeted
batches with two invariants: within a batch every source row is read from
the *pre-batch* pool (the data plane applies a batch as one parallel row
gather), and at every batch boundary every virtual expert still has at
least one live copy — mid-migration the layout is always a valid
:class:`~repro.replication.types.ReplicatedPlacement` the router tables can
be rebuilt from. Pure relocation cycles that exceed the per-batch budget
fall back to the transposition trick above.

**Budget-aware truncation**: when the controller's net-benefit gate rejects
a *full* migration, :func:`migration_cycles` exposes the delta's per-cycle
structure so the controller can score each cycle's contribution
independently and migrate only the profitable prefix (see
``OnlineController._replan``).

**Collective lowering**: under a live mesh a batch is not a host-side row
gather — it is device traffic on the expert-sharded weights.
:func:`lower_row_sources` lowers a batch's per-layer ``(S,)`` row-source map
(the uniform ``sources_by_layer`` interface both batch types share) into a
:class:`CollectiveSchedule`: a per-shard *local* gather (same-device row
copies, read from the pre-batch shard — the double buffer that preserves
read-before-overwrite ordering) plus a minimal sequence of ``ppermute``
*rounds*, each round a partial shard permutation (every shard sends at most
one expert row and receives at most one). A two-slot swap lowers to one
pairwise round; a one-to-many replica broadcast lowers to one round per
destination shard. The schedule is host-side numpy — static, inspectable,
and exactly what :mod:`repro.kernels.collective` executes — so the
*measured* interconnect traffic (``cross_rows``/``payload_bytes``) falls
out of the lowering itself rather than the cost model's assumption.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.latency_model import MigrationCostModel
from ..core.types import Placement

__all__ = [
    "MigrationConfig",
    "SlotSwap",
    "MigrationStep",
    "MigrationSchedule",
    "MigrationCycle",
    "ReplicaMove",
    "ReplicaMigrationStep",
    "ReplicaMigrationSchedule",
    "RowTransfer",
    "CollectiveSchedule",
    "plan_migration",
    "migration_cycles",
    "plan_replica_migration",
    "replica_install_phases",
    "replica_source_permutation",
    "swap_permutation",
    "lower_row_sources",
    "lower_collective_step",
]


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Budget + interconnect parameters of the migration plane."""

    max_moves_per_step: int = 2  # expert-weight rows rewritten per step (≥2)
    bandwidth: float = 450e9  # interconnect bytes/s (NVLink4-class)
    base_overhead: float = 20e-6  # per-batch launch overhead (s)
    # fraction of a collective batch's transfer time that hides behind the
    # step's decode compute: the double-buffered row copy overlaps the MoE
    # GEMMs, so only the non-overlappable tail is charged to the step
    # (0.0 = fully serialized, the host-path assumption)
    overlap_fraction: float = 0.0
    # learn the interconnect bandwidth from measured collective traffic
    # (BandwidthEstimator EWMA) instead of trusting the configured value
    calibrate_bandwidth: bool = False

    def __post_init__(self):
        if self.max_moves_per_step < 2:
            raise ValueError(
                "max_moves_per_step must be ≥ 2 (one swap rewrites two rows)"
            )
        if not 0.0 <= self.overlap_fraction <= 1.0:
            raise ValueError("overlap_fraction must be in [0, 1]")

    def cost_model(self, expert_bytes: float) -> MigrationCostModel:
        return MigrationCostModel(
            expert_bytes=expert_bytes, bandwidth=self.bandwidth,
            base_overhead=self.base_overhead,
        )

    def cost_model_for_dims(
        self, d_model: int, expert_d_ff: int, *, bytes_per_param: int = 2
    ) -> MigrationCostModel:
        """Cost model priced from expert dims — the one place the
        3·D·F weight-size formula lives is ``for_expert_dims``."""
        return MigrationCostModel.for_expert_dims(
            d_model, expert_d_ff, bytes_per_param=bytes_per_param,
            bandwidth=self.bandwidth, base_overhead=self.base_overhead,
        )


@dataclasses.dataclass(frozen=True)
class SlotSwap:
    """Exchange the experts resident in two physical slots of one layer."""

    layer: int
    slot_a: int
    slot_b: int


@dataclasses.dataclass
class MigrationStep:
    """One engine step's worth of migration: ≤ budget weight-row rewrites."""

    swaps: list[SlotSwap]

    @property
    def num_moves(self) -> int:
        return 2 * len(self.swaps)

    def swaps_by_layer(self) -> dict[int, list[tuple[int, int]]]:
        out: dict[int, list[tuple[int, int]]] = {}
        for s in self.swaps:
            out.setdefault(s.layer, []).append((s.slot_a, s.slot_b))
        return out

    def sources_by_layer(self, num_slots: int) -> dict[int, np.ndarray]:
        """Per-layer (S,) row-source maps: ``new_rows = old_rows[src]``.

        The uniform data-plane interface shared with
        :class:`ReplicaMigrationStep` — the engine mirrors any batch type
        as one parallel row gather per touched layer."""
        return {
            layer: swap_permutation(num_slots, swaps)
            for layer, swaps in self.swaps_by_layer().items()
        }

    def cross_device_moves(self, slots_per_device: int) -> int:
        """Row rewrites whose source lives on a different device — the only
        ones that ship bytes over the interconnect (an intra-device swap is
        two local HBM row copies). Mirrors the replica step's accounting so
        measured collective traffic can be checked against the model."""
        return sum(
            2
            for s in self.swaps
            if s.slot_a // slots_per_device != s.slot_b // slots_per_device
        )


@dataclasses.dataclass
class MigrationSchedule:
    steps: list[MigrationStep]

    @property
    def total_moves(self) -> int:
        return sum(s.num_moves for s in self.steps)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def total_cost(self, cost_model: MigrationCostModel) -> float:
        return sum(cost_model.cost(s.num_moves) for s in self.steps)


@dataclasses.dataclass(frozen=True)
class MigrationCycle:
    """One cycle of a layer's relative slot permutation.

    ``slots`` is the cycle in traversal order; ``swaps`` the transposition
    sequence realising it (``len(slots) − 1`` swaps, 2 row rewrites each).
    Cycles are the natural unit of budget-aware truncation: each is
    independently applicable (applying any subset of a permutation's cycles
    yields a valid slot layout), so a rejected full migration can fall back
    to its profitable prefix.
    """

    layer: int
    slots: tuple[int, ...]
    swaps: tuple[SlotSwap, ...]

    @property
    def num_moves(self) -> int:
        return 2 * len(self.swaps)


def _rel_cycles(rel: np.ndarray, layer: int) -> list[MigrationCycle]:
    """Cycle decomposition of one layer's relative permutation."""
    n = len(rel)
    seen = np.zeros(n, dtype=bool)
    cycles: list[MigrationCycle] = []
    for start in range(n):
        if seen[start] or rel[start] == start:
            seen[start] = True
            continue
        cycle = [start]
        seen[start] = True
        nxt = int(rel[start])
        while nxt != start:
            cycle.append(nxt)
            seen[nxt] = True
            nxt = int(rel[nxt])
        # (s0,s1),(s1,s2),…: after each swap, slot s_i holds its target row
        swaps = tuple(
            SlotSwap(layer, a, b) for a, b in zip(cycle[:-1], cycle[1:])
        )
        cycles.append(MigrationCycle(layer, tuple(cycle), swaps))
    return cycles


def _cycle_swaps(rel: np.ndarray, layer: int) -> list[SlotSwap]:
    """Transposition sequence realising one layer's relative permutation.

    Order matters *within* a cycle (each transposition assumes the previous
    ones were applied); the emitted sequence preserves that order, and the
    packer below never reorders swaps.
    """
    return [s for c in _rel_cycles(rel, layer) for s in c.swaps]


def migration_cycles(current: list, target: list) -> list[MigrationCycle]:
    """Per-layer cycle decomposition of the migration delta.

    ``current``/``target`` as in :func:`plan_migration`. The controller's
    budget-aware truncation scores these independently: a cycle's swaps
    applied to the live layout move exactly the cycle's slots and leave
    every other slot untouched.
    """
    if len(current) != len(target):
        raise ValueError("need matching per-layer placement lists")
    out: list[MigrationCycle] = []
    for layer, (cur, tgt) in enumerate(zip(current, target)):
        rel = Placement.slot_relative_permutation(
            _as_slot_layout(cur), _as_slot_layout(tgt)
        )
        out.extend(_rel_cycles(rel, layer))
    return out


def _as_slot_layout(p) -> np.ndarray:
    """Physical slot→expert layout: a raw array passes through untouched; a
    :class:`Placement` contributes its *canonical* layout (experts sorted
    within each device). The distinction matters: mid-migration physical
    layouts are not canonical, and a swap sequence addresses physical slots."""
    if isinstance(p, Placement):
        return p.slot_to_expert()
    return np.asarray(p, dtype=np.int32)


def plan_migration(
    current: list,
    target: list,
    config: MigrationConfig = MigrationConfig(),
) -> MigrationSchedule:
    """Decompose the per-layer placement delta into budgeted swap batches.

    ``current``/``target`` are per-layer slot layouts — either raw
    slot→expert arrays (the live *physical* layout, which mid-migration is
    not canonical) or :class:`Placement` objects (canonicalised). Returns a
    schedule whose steps each rewrite at most ``config.max_moves_per_step``
    expert-weight rows; applying every step in order transforms ``current``
    into ``target`` exactly (bit-exact weight rows — a pure permutation).
    An empty schedule means the layouts already agree.
    """
    if len(current) != len(target):
        raise ValueError("need matching per-layer placement lists")
    all_swaps: list[SlotSwap] = []
    for layer, (cur, tgt) in enumerate(zip(current, target)):
        rel = Placement.slot_relative_permutation(
            _as_slot_layout(cur), _as_slot_layout(tgt)
        )
        all_swaps.extend(_cycle_swaps(rel, layer))
    swaps_per_batch = config.max_moves_per_step // 2
    steps = [
        MigrationStep(all_swaps[i : i + swaps_per_batch])
        for i in range(0, len(all_swaps), swaps_per_batch)
    ]
    return MigrationSchedule(steps)


def swap_permutation(num_slots: int, swaps: list[tuple[int, int]]) -> np.ndarray:
    """(S,) permutation ``p`` with ``new_rows = old_rows[p]`` after applying
    ``swaps`` sequentially (the data-plane form of one layer's batch)."""
    p = np.arange(num_slots, dtype=np.int32)
    for a, b in swaps:
        p[[a, b]] = p[[b, a]]
    return p


# ---------------------------------------------------------------------------
# Replicated layouts: add/drop/relocate copies with one-row broadcast moves
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaMove:
    """Overwrite one layer's slot ``dst_slot`` with the row at ``src_slot``.

    One expert-weight row rewrite — a replica *add* (instantiate a copy) or
    *drop* (retarget a replica slot to a different expert) costs one move,
    half a swap's price."""

    layer: int
    dst_slot: int
    src_slot: int


@dataclasses.dataclass
class ReplicaMigrationStep:
    """One engine step's batch of row broadcasts (parallel semantics).

    Every ``src_slot`` refers to the pool *before* the batch: the data
    plane applies the batch as one row gather per layer, so moves within a
    batch never observe each other — which also makes a two-move entry
    ``{a←b, b←a}`` an atomic in-batch swap."""

    moves: list[ReplicaMove]

    @property
    def num_moves(self) -> int:
        return len(self.moves)

    def cross_device_moves(self, slots_per_device: int) -> int:
        """Moves whose source row lives on a different device than the
        destination slot — the only ones that ship bytes over the
        interconnect (a same-device source is a local HBM row copy)."""
        return sum(
            1
            for m in self.moves
            if m.dst_slot // slots_per_device != m.src_slot // slots_per_device
        )

    def sources_by_layer(self, num_slots: int) -> dict[int, np.ndarray]:
        """Per-layer (S,) row-source maps: ``new_rows = old_rows[src]``."""
        out: dict[int, np.ndarray] = {}
        for m in self.moves:
            arr = out.setdefault(
                m.layer, np.arange(num_slots, dtype=np.int32)
            )
            arr[m.dst_slot] = m.src_slot
        return out


@dataclasses.dataclass
class ReplicaMigrationSchedule:
    steps: list[ReplicaMigrationStep]

    @property
    def total_moves(self) -> int:
        return sum(s.num_moves for s in self.steps)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def total_cost(
        self,
        cost_model: MigrationCostModel,
        slots_per_device: int | None = None,
    ) -> float:
        """Interconnect cost of the schedule. With ``slots_per_device``,
        only cross-device moves are priced (same-device row copies are
        local HBM traffic) — matching ``replica_fetch_rows``' one-shot
        pricing so online and one-shot replicated migrations stay
        comparable. Without it, every move is priced (upper bound)."""
        if slots_per_device is None:
            return sum(cost_model.cost(s.num_moves) for s in self.steps)
        return sum(
            cost_model.cost(s.cross_device_moves(slots_per_device))
            for s in self.steps
        )


def _as_layout(p) -> np.ndarray:
    """Slot→expert layout from a raw array or a (Replicated)Placement."""
    if hasattr(p, "slot_layout"):
        return p.slot_layout()
    if isinstance(p, Placement):
        return p.slot_to_expert()
    return np.asarray(p, dtype=np.int32)


def _layer_replica_groups(
    cur: np.ndarray, tgt: np.ndarray, layer: int, budget: int
) -> list[list[ReplicaMove]]:
    """Ordered atomic move groups transforming ``cur`` into ``tgt``.

    Strategy: every slot whose expert changes gets one source — a *stable*
    slot of the target expert when one exists (a pure broadcast, no
    ordering constraint), else a slot that is itself being overwritten
    (creating a read-before-write edge). The edges form a functional graph
    (out-degree ≤ 1): tree/chain nodes are emitted readers-first so
    sequential batch packing keeps each read no later than the write of its
    source; cycles are emitted as one atomic group when they fit the batch
    budget (parallel gather resolves them at once) and as the classic
    transposition sequence otherwise.
    """
    S = len(cur)
    pending = [s for s in range(S) if cur[s] != tgt[s]]
    if not pending:
        return []
    stable_of: dict[int, int] = {}
    for s in range(S):
        if cur[s] == tgt[s]:
            stable_of.setdefault(int(cur[s]), s)
    overwritten = set(pending)
    src: dict[int, int] = {}
    for s in pending:
        e = int(tgt[s])
        if e in stable_of:
            src[s] = stable_of[e]
            continue
        cands = np.nonzero(cur == e)[0]
        if len(cands) == 0:
            raise ValueError(
                f"target expert {e} has no copy in the current layout"
            )
        free = [int(c) for c in cands if int(c) not in overwritten]
        src[s] = free[0] if free else int(cands[0])

    # functional graph over pending slots: edge s → src[s] when the source
    # is itself overwritten (read must happen no later than that write)
    nxt = {
        s: src[s] if src[s] in overwritten and src[s] != s else None
        for s in pending
    }
    # peel cycles (every node has out-degree ≤ 1)
    on_cycle: set[int] = set()
    state: dict[int, int] = {}  # 0 in-progress, 1 done
    for s in pending:
        if s in state:
            continue
        path = []
        v = s
        while v is not None and v not in state:
            state[v] = 0
            path.append(v)
            v = nxt[v]
        if v is not None and state.get(v) == 0:
            # found a new cycle: v..end of path
            cyc = path[path.index(v):]
            on_cycle.update(cyc)
        for u in path:
            state[u] = 1

    # tree/chain nodes: depth = steps until leaving pending or hitting a
    # cycle; emit deepest-first so every reader precedes its source's write
    depth: dict[int, int] = {}

    def _depth(s: int) -> int:
        if s in depth:
            return depth[s]
        n = nxt[s]
        d = 1 if (n is None or n in on_cycle) else 1 + _depth(n)
        depth[s] = d
        return d

    groups: list[list[ReplicaMove]] = []
    tree_nodes = [s for s in pending if s not in on_cycle]
    for s in sorted(tree_nodes, key=lambda s: -_depth(s)):
        groups.append([ReplicaMove(layer, s, src[s])])

    # cycles: atomic parallel group when it fits the budget, else the
    # transposition sequence (atomic two-move swap groups)
    seen: set[int] = set()
    for s in sorted(on_cycle):
        if s in seen:
            continue
        cyc = [s]
        seen.add(s)
        v = nxt[s]
        while v != s:
            cyc.append(v)
            seen.add(v)
            v = nxt[v]
        if len(cyc) <= budget:
            groups.append([ReplicaMove(layer, u, src[u]) for u in cyc])
        else:
            # rel restricted to the cycle: row ending in u comes from src[u]
            order = list(cyc)
            for a, b in zip(order[:-1], order[1:]):
                groups.append(
                    [ReplicaMove(layer, a, b), ReplicaMove(layer, b, a)]
                )
    return groups


def plan_replica_migration(
    current: list,
    target: list,
    config: MigrationConfig = MigrationConfig(),
) -> ReplicaMigrationSchedule:
    """Budgeted one-row broadcast schedule between two replicated layouts.

    ``current``/``target`` are per-layer slot→expert layouts (raw arrays or
    :class:`~repro.replication.types.ReplicatedPlacement` /
    :class:`~repro.core.types.Placement` objects) over the **same** slot
    count. Applying every batch in order — each as a parallel row gather
    from the pre-batch pool — transforms ``current`` into ``target``
    exactly; at every batch boundary each virtual expert keeps at least one
    live copy, so the layout stays a valid placement throughout.
    """
    if len(current) != len(target):
        raise ValueError("need matching per-layer placement lists")
    budget = config.max_moves_per_step
    groups: list[list[ReplicaMove]] = []
    for layer, (cur, tgt) in enumerate(zip(current, target)):
        cur, tgt = _as_layout(cur), _as_layout(tgt)
        if cur.shape != tgt.shape:
            raise ValueError("layouts must cover the same slots")
        groups.extend(_layer_replica_groups(cur, tgt, layer, budget))
    steps: list[ReplicaMigrationStep] = []
    batch: list[ReplicaMove] = []
    batch_dsts: set[tuple[int, int]] = set()
    for group in groups:
        if len(group) > budget:
            raise ValueError(
                f"atomic move group of {len(group)} exceeds the per-step "
                f"budget {budget}"
            )
        # a batch is one parallel gather from the pre-batch pool, so a
        # group that would *read* or *re-write* a slot already written in
        # this batch (a long cycle's sequential transpositions) must wait
        # for the next batch
        touched = {
            (m.layer, m.dst_slot) for m in group
        } | {(m.layer, m.src_slot) for m in group}
        if batch and (
            len(batch) + len(group) > budget or touched & batch_dsts
        ):
            steps.append(ReplicaMigrationStep(batch))
            batch, batch_dsts = [], set()
        batch.extend(group)
        batch_dsts |= {(m.layer, m.dst_slot) for m in group}
    if batch:
        steps.append(ReplicaMigrationStep(batch))
    return ReplicaMigrationSchedule(steps)


# ---------------------------------------------------------------------------
# Collective lowering: batches → per-layer ppermute schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowTransfer:
    """One cross-shard expert-row shipment: the row at local index
    ``src_idx`` of shard ``src_shard`` overwrites local index ``dst_idx``
    of shard ``dst_shard``."""

    src_shard: int
    src_idx: int
    dst_shard: int
    dst_idx: int


@dataclasses.dataclass
class CollectiveSchedule:
    """One layer's migration batch lowered for the ppermute data plane.

    ``local_src`` (n_shards, S/n_shards): per-shard local row gather —
    every shard reads same-device sources from its *pre-batch* block
    (identity where a cross-shard transfer will land). ``rounds``: ordered
    ``ppermute`` rounds; within a round every shard sends at most one row
    and receives at most one, so each round is a single partial shard
    permutation. All reads (local and remote) observe the pre-batch pool —
    the double buffer that makes read-before-overwrite ordering a
    non-issue regardless of round order.
    """

    num_slots: int
    num_shards: int
    local_src: np.ndarray
    rounds: list[list[RowTransfer]]

    @property
    def slots_per_shard(self) -> int:
        return self.num_slots // self.num_shards

    @property
    def cross_rows(self) -> int:
        """Rows shipped over the interconnect."""
        return sum(len(r) for r in self.rounds)

    @property
    def local_rows(self) -> int:
        """Rows copied within their own shard's HBM."""
        per = self.slots_per_shard
        ident = np.arange(per, dtype=np.int32)
        return int((self.local_src != ident[None, :]).sum())

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def payload_bytes(self, row_bytes: float) -> float:
        """Interconnect payload of executing this schedule."""
        return self.cross_rows * row_bytes

    def source_map(self) -> np.ndarray:
        """Reconstruct the (S,) row-source map the schedule realises
        (``new_rows = old_rows[src]``) — the lowering's round-trip check."""
        per = self.slots_per_shard
        src = np.empty(self.num_slots, dtype=np.int32)
        for shard in range(self.num_shards):
            src[shard * per : (shard + 1) * per] = (
                self.local_src[shard] + shard * per
            )
        for rnd in self.rounds:
            for t in rnd:
                src[t.dst_shard * per + t.dst_idx] = (
                    t.src_shard * per + t.src_idx
                )
        return src


def lower_row_sources(src, num_shards: int) -> CollectiveSchedule:
    """Lower one layer's (S,) row-source map onto ``num_shards`` expert
    shards (the model-axis extent the slot dim is sharded over).

    Cross-shard reads are packed greedily into rounds under the ppermute
    constraint (≤ 1 send and ≤ 1 receive per shard per round): a pairwise
    swap becomes one round of two opposed transfers, a one-to-many
    broadcast one round per destination shard (the source re-reads its
    pre-batch row each round). Same-shard reads become the local gather.
    """
    src = np.asarray(src, dtype=np.int32)
    S = len(src)
    if S % num_shards != 0:
        raise ValueError(
            f"{S} slots do not shard evenly over {num_shards} shards"
        )
    per = S // num_shards
    local_src = np.tile(np.arange(per, dtype=np.int32), (num_shards, 1))
    transfers: list[RowTransfer] = []
    for s in range(S):
        r = int(src[s])
        if r == s:
            continue
        dst_shard, src_shard = s // per, r // per
        if src_shard == dst_shard:
            local_src[dst_shard, s % per] = r % per
        else:
            transfers.append(
                RowTransfer(src_shard, r % per, dst_shard, s % per)
            )
    rounds: list[list[RowTransfer]] = []
    for t in transfers:
        for rnd in rounds:
            if all(
                t.src_shard != o.src_shard and t.dst_shard != o.dst_shard
                for o in rnd
            ):
                rnd.append(t)
                break
        else:
            rounds.append([t])
    return CollectiveSchedule(S, num_shards, local_src, rounds)


def dense_step_sources(
    step: "MigrationStep | ReplicaMigrationStep",
    num_layers: int,
    num_slots: int,
) -> np.ndarray:
    """One batch as a dense (L, S) row-source operand: the batch's per-layer
    maps on the layers it touches, identity rows everywhere else.

    This is the *scanned-operand* form the schedule-generic migration
    executable (:func:`repro.kernels.collective.make_migration_executable`)
    consumes — one traced array covering the whole layer stack, so applying
    any batch is a single pre-compiled call instead of per-layer dispatches
    each jitting their own collective schedule."""
    src = np.tile(
        np.arange(num_slots, dtype=np.int32), (int(num_layers), 1)
    )
    for layer, s in step.sources_by_layer(num_slots).items():
        src[layer] = s
    return src


def lower_collective_step(
    step: "MigrationStep | ReplicaMigrationStep",
    num_slots: int,
    num_shards: int,
) -> dict[int, CollectiveSchedule]:
    """Lower one engine step's batch — either type — to per-layer collective
    schedules via the shared ``sources_by_layer`` interface."""
    return {
        layer: lower_row_sources(src, num_shards)
        for layer, src in step.sources_by_layer(num_slots).items()
    }


def replica_source_permutation(
    cur_layout: np.ndarray, tgt_layout: np.ndarray
) -> np.ndarray:
    """(S,) one-shot row-source map: ``new_rows = old_rows[src]``.

    The unbudgeted analogue of a full ``apply_placement``: every slot whose
    expert changes reads any current copy of its target expert (lowest slot
    id — deterministic) in one parallel gather.
    """
    cur = np.asarray(cur_layout, dtype=np.int32)
    tgt = np.asarray(tgt_layout, dtype=np.int32)
    if cur.shape != tgt.shape:
        raise ValueError("layouts must cover the same slots")
    src = np.arange(len(cur), dtype=np.int32)
    for s in range(len(cur)):
        if cur[s] != tgt[s]:
            cands = np.nonzero(cur == tgt[s])[0]
            if len(cands) == 0:
                raise ValueError(
                    f"target expert {int(tgt[s])} has no copy in the "
                    "current layout"
                )
            src[s] = int(cands[0])
    return src


def replica_install_phases(
    cur_layout: np.ndarray,
    tgt_layout: np.ndarray,
    slots_per_device: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-phase one-shot install: ``(fetch_src, fanout_src)`` row-source
    maps applied in order.

    A one-shot :func:`replica_source_permutation` reads every changed slot
    independently, so a device installing several copies of a newly arrived
    expert would ship the same row over the interconnect once per copy —
    while :func:`~repro.replication.score.replica_fetch_rows` (and any sane
    deployment) prices one fetch per (device, new expert) plus local HBM
    fan-out. This lowering realises exactly that: phase 1 reads same-device
    copies locally and fetches each missing expert's row **once** per
    device (lowest wanting slot is the designated fetcher, reading the
    lowest-id current copy — deterministic); phase 2 fans the fetched rows
    out to the device's remaining wanting slots, a purely local gather.
    Composing the phases transforms ``cur_layout`` into ``tgt_layout``, and
    the phase-1 cross-shard reads equal the modeled fetch rows exactly.
    """
    cur = np.asarray(cur_layout, dtype=np.int32)
    tgt = np.asarray(tgt_layout, dtype=np.int32)
    if cur.shape != tgt.shape:
        raise ValueError("layouts must cover the same slots")
    S = len(cur)
    if S % slots_per_device != 0:
        raise ValueError(
            f"{S} slots do not divide over {slots_per_device}-slot devices"
        )
    fetch = np.arange(S, dtype=np.int32)
    fanout = np.arange(S, dtype=np.int32)
    for g in range(S // slots_per_device):
        lo, hi = g * slots_per_device, (g + 1) * slots_per_device
        fetcher: dict[int, int] = {}  # expert → designated phase-1 slot
        for s in range(lo, hi):
            if cur[s] == tgt[s]:
                continue
            e = int(tgt[s])
            local = np.nonzero(cur[lo:hi] == e)[0]
            if len(local):
                fetch[s] = lo + int(local[0])  # same-device HBM copy
            elif e not in fetcher:
                cands = np.nonzero(cur == e)[0]
                if len(cands) == 0:
                    raise ValueError(
                        f"target expert {e} has no copy in the current layout"
                    )
                fetch[s] = int(cands[0])  # the one interconnect fetch
                fetcher[e] = s
            else:
                fanout[s] = fetcher[e]  # local fan-out of the fetched row
    return fetch, fanout

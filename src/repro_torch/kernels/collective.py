"""Expert-row migration: in place on one device, and as collectives between
the ranks of a mesh (port of ``repro/kernels/collective.py``).

A migration batch is an (L, S) int32 row-source map ``src``: slot ``s`` of
layer ``l`` takes the row that slot ``src[l, s]`` held before the batch.

**One device** (``MigrationExecutable(mesh=None)``, the JAX executable's
host path and ``_swap_tables``). On the TPU this is an XLA gather outside
any Pallas kernel, with the weight buffers donated so that it rewrites
them in place; here it is indexed copies on the weights' device that touch
only the rows that move. The moved slots (``src[l, s] != s``) are found on
the host; for each layer that has any, and for each weight, the source
rows of those slots are gathered into scratch (``index_select``) and
written into the moved slots (``index_copy_``). The copies move bits, so
each weight is viewed as the widest integer words its rows divide into (8
bytes: four bf16 values), which the index kernels move as one element. The
scratch holds the pre-batch rows, so swaps, cycles and one-to-many
broadcasts are exact; an identity layer issues no copy. The extra memory
is at most one layer's rows of one weight, and the caller keeps the same
tensor objects. An online batch of ``k`` swaps thus moves ``2k`` rows per
weight instead of rewriting the pool.

**A mesh** (:mod:`repro_torch.launch.mesh`): the slot dim is sharded over
the model axis, rank ``d`` holding slots ``[d·S/m, (d+1)·S/m)`` (the data
axes see the weights replicated, and each row of the grid runs the same
exchange). JAX runs these under ``shard_map``; here every rank runs the
same host-side plan on the same ``src`` and the rows travel as
``torch.distributed`` collectives:

* :func:`apply_row_sources` — the schedule of
  :func:`~repro_torch.online.migration.lower_row_sources`: a local gather
  of same-rank sources, then the schedule's rounds as paired send/recv
  (each rank sends and receives at most one row a round; one slot's rows
  of every weight travel as one message).
* :func:`swap_expert_rows` and :func:`broadcast_expert_row` — the two batch
  shapes, reduced to it.
* :class:`MigrationExecutable` with a mesh — the serving loop's form, over
  the whole (L, S) map: for each layer, the dense ``all_to_all`` in which
  each rank offers each peer the local rows that peer's slots want and
  keeps what their true owners sent. JAX's exchange ships every row of the
  pool (its program may not depend on the batch); this one ships only the
  moved rows that change rank, with per-peer split sizes.

Every read — the local gather and every send — addresses the **pre-batch**
rows, the double buffer that JAX's functional update gives: the sends and
the local sources are gathered into scratch before anything is written,
and what arrives is written after the exchange completes, so a row sent in
one round is never one that an earlier write replaced.

:class:`CollectiveStats` report what a schedule moved;
:func:`stats_for_dense_sources` is the accountable traffic of a dense map
(the minimal schedule each layer lowers to), which the serving engine
records against the cost model's charge.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..online.migration import (
    CollectiveSchedule,
    RowTransfer,
    lower_row_sources,
)

__all__ = [
    "CollectiveStats",
    "MigrationExecutable",
    "apply_row_sources",
    "stats_for_dense_sources",
    "swap_expert_rows",
    "broadcast_expert_row",
    "gather_rows",
]


@dataclasses.dataclass(frozen=True)
class CollectiveStats:
    """What one executed schedule actually moved (measured, not modeled)."""

    rows_rewritten: int  # slots whose weight row changed
    cross_rows: int  # rows shipped over the interconnect (ppermute payload)
    local_rows: int  # rows copied within their own shard's HBM
    rounds: int  # ppermute rounds (collective launches)
    payload_bytes: int  # interconnect bytes across all weight arrays

    def __add__(self, other: "CollectiveStats") -> "CollectiveStats":
        return CollectiveStats(
            self.rows_rewritten + other.rows_rewritten,
            self.cross_rows + other.cross_rows,
            self.local_rows + other.local_rows,
            self.rounds + other.rounds,
            self.payload_bytes + other.payload_bytes,
        )

    @staticmethod
    def zero() -> "CollectiveStats":
        return CollectiveStats(0, 0, 0, 0, 0)


def _round_tables(rnd: list[RowTransfer], num_shards: int):
    """Per-shard send/receive tables of one round: the local row each
    shard sends and the local slot it writes, whether it receives, and the
    (source, destination) pairs."""
    send_idx = np.zeros(num_shards, dtype=np.int32)
    recv_idx = np.zeros(num_shards, dtype=np.int32)
    is_dst = np.zeros(num_shards, dtype=bool)
    perm = []
    for t in rnd:
        send_idx[t.src_shard] = t.src_idx
        recv_idx[t.dst_shard] = t.dst_idx
        is_dst[t.dst_shard] = True
        perm.append((t.src_shard, t.dst_shard))
    return send_idx, recv_idx, is_dst, perm


def _stats_for(schedule: CollectiveSchedule, arrays) -> CollectiveStats:
    row_bytes = sum(
        int(np.prod(a.shape[1:])) * a.element_size() for a in arrays
    )
    return CollectiveStats(
        rows_rewritten=schedule.cross_rows + schedule.local_rows,
        cross_rows=schedule.cross_rows,
        local_rows=schedule.local_rows,
        rounds=schedule.num_rounds,
        payload_bytes=schedule.cross_rows * row_bytes,
    )


def _pack(rows) -> torch.Tensor:
    """One slot's rows of every weight as one byte vector."""
    return torch.cat([r.contiguous().reshape(-1).view(torch.uint8)
                      for r in rows])


def _unpack(buf: torch.Tensor, like) -> list[torch.Tensor]:
    out, off = [], 0
    for a in like:
        n = int(np.prod(a.shape[1:])) * a.element_size()
        out.append(buf[off:off + n].view(a.dtype).reshape(a.shape[1:]))
        off += n
    return out


def apply_row_sources(arrays, src, *, mesh, axis: str = "model",
                      schedule: CollectiveSchedule | None = None):
    """Apply ``new_rows = old_rows[src]`` to expert-sharded weight arrays
    with collectives, returning ``(new_arrays, CollectiveStats)``.

    ``arrays`` is a tuple of this rank's ``(S/m, …)`` blocks of arrays
    whose slot dim is sharded over ``axis``; ``src`` the batch's global
    (S,) row-source map; pass ``schedule`` to reuse an existing lowering.
    One slot's rows across all arrays travel together, so a round's payload
    is exactly one expert's stacked weights. The inputs are left as they
    were.

    Execution: (1) every rank gathers its same-rank sources from its
    pre-batch block; (2) each round, the source ranks read their pre-batch
    row, one batch of paired send/recv moves the payloads, and the
    destination ranks write them at their local slots.
    """
    arrays = tuple(arrays)
    n = mesh.size(axis)
    if schedule is None:
        schedule = lower_row_sources(src, n)
    if schedule.num_shards != n:
        raise ValueError(
            f"schedule lowered for {schedule.num_shards} shards but mesh "
            f"axis {axis!r} has {n}"
        )
    stats = _stats_for(schedule, arrays)
    if stats.rows_rewritten == 0:
        return arrays, stats
    me = mesh.index(axis)
    dev = arrays[0].device
    lsrc = torch.as_tensor(schedule.local_src[me], device=dev).long()
    new = [blk.index_select(0, lsrc) for blk in arrays]
    for rnd in schedule.rounds:
        send_idx, recv_idx, is_dst, perm = _round_tables(rnd, n)
        sends, recvs = [], []
        for s_shard, d_shard in perm:
            if s_shard == me:  # the PRE-batch row: the double buffer
                row = int(send_idx[me])
                sends.append((d_shard, _pack([b[row] for b in arrays])))
            if d_shard == me:
                nbytes = sum(int(np.prod(a.shape[1:])) * a.element_size()
                             for a in arrays)
                recvs.append((s_shard, (nbytes,), torch.uint8))
        got = mesh.send_recv(sends, recvs, axis)
        if is_dst[me]:
            slot = int(recv_idx[me])
            for nb, row in zip(new, _unpack(got[0], arrays)):
                nb[slot] = row
    return tuple(new), stats


def swap_expert_rows(arrays, swaps, *, mesh, axis: str = "model"):
    """Exchange expert rows pairwise: ``swaps`` is a sequence of global
    ``(slot_a, slot_b)`` pairs applied in order. Cross-rank pairs lower to
    paired send/recv rounds, same-rank pairs to local row copies. Returns
    ``(new_arrays, CollectiveStats)``."""
    S = int(arrays[0].shape[0]) * mesh.size(axis)
    src = np.arange(S, dtype=np.int32)
    for a, b in swaps:
        src[[a, b]] = src[[b, a]]
    return apply_row_sources(arrays, src, mesh=mesh, axis=axis)


def broadcast_expert_row(arrays, src_slot: int, dst_slots, *, mesh,
                         axis: str = "model"):
    """Overwrite every slot in ``dst_slots`` with the row at ``src_slot`` —
    the replica add/drop primitive. Destinations on the source's own rank
    are local copies; each remote destination costs one round's payload.
    Returns ``(new_arrays, CollectiveStats)``."""
    S = int(arrays[0].shape[0]) * mesh.size(axis)
    src = np.arange(S, dtype=np.int32)
    for d in dst_slots:
        src[int(d)] = int(src_slot)
    return apply_row_sources(arrays, src, mesh=mesh, axis=axis)


def stats_for_dense_sources(src, num_shards: int, row_bytes: int):
    """Per-layer measured traffic for a dense (L, S) row-source operand.

    The *accountable* traffic — what a row-level transport would ship, and
    what the cost model prices — is the minimal schedule each layer's map
    lowers to (the JAX package's dense ``all_to_all`` ships more on the
    wire). Returns ``[(layer, CollectiveStats), …]`` for
    layers whose map is not the identity (``row_bytes`` = one slot's
    bytes summed over the weight arrays).
    """
    src = np.asarray(src)
    out = []
    for layer in range(src.shape[0]):
        row = src[layer]
        if np.array_equal(row, np.arange(row.shape[0])):
            continue
        sched = lower_row_sources(row, num_shards)
        out.append((layer, CollectiveStats(
            rows_rewritten=sched.cross_rows + sched.local_rows,
            cross_rows=sched.cross_rows,
            local_rows=sched.local_rows,
            rounds=sched.num_rounds,
            payload_bytes=sched.cross_rows * row_bytes,
        )))
    return out


def _swap_tables(tables: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Router-table update for a permutation source map, on the tables'
    device: ``new_e2s[l, e] = inv_src[l, e2s[l, e]]`` with ``inv_src`` the
    per-layer inverse permutation (``inv_src[l, src[l, s]] = s``). Only
    valid when every layer's map is a permutation. The inverse is a
    ``scatter_`` that writes each index once, as the JAX scatter does."""
    L, S = src.shape
    slots = torch.arange(S, dtype=torch.int32, device=src.device)
    inv = torch.zeros((L, S), dtype=torch.int32, device=src.device)
    inv.scatter_(1, src.long(), slots.expand(L, S))
    return torch.gather(inv, 1, tables.long())


def _as_words(w: torch.Tensor) -> torch.Tensor:
    """``w`` viewed as the widest integer dtype whose size divides its last
    dimension's bytes (at least ``w``'s own element size)."""
    row_bytes = w.shape[-1] * w.element_size()
    for word in (torch.int64, torch.int32, torch.int16):
        if word.itemsize >= w.element_size() and row_bytes % word.itemsize == 0:
            return w.view(word)
    return w


def _exchange_layer(mesh, axis, src_l: np.ndarray, ins, outs, *,
                    skip_identity: bool) -> tuple[int, int]:
    """One layer of a sharded row exchange: ``outs[i]`` (this rank's
    ``(S_out/m, …)`` block, written in place) takes global row
    ``src_l[s]`` of the pool whose ``(S_in/m, …)`` blocks ``ins[i]`` hold.
    Every rank plans the same transfers from ``src_l``: each offers each
    peer the local rows that peer's slots want, in slot order, through one
    ``all_to_all_single`` (skipped when no row of the layer changes rank),
    and writes what it received and its own sources after the exchange.
    ``skip_identity`` leaves slots whose source is themselves untouched
    (``ins`` and ``outs`` the same tensors). Returns the rows this rank
    sent and received."""
    n, me = mesh.size(axis), mesh.index(axis)
    per_in, per_out = ins[0].shape[0], outs[0].shape[0]
    slots = np.arange(src_l.shape[0])
    own_src, own_dst = src_l // per_in, slots // per_out
    want = ~(skip_identity & (src_l == slots))
    cross = want & (own_src != own_dst)
    sends = np.nonzero(cross & (own_src == me))[0]  # slot order = peer order
    recvs = np.nonzero(cross & (own_dst == me))[0]
    recvs = recvs[np.lexsort((recvs, own_src[recvs]))]  # by sender, then slot
    local = np.nonzero(want & ~cross & (own_dst == me))[0]
    flat_in = [w.reshape(per_in, -1) for w in ins]
    flat_out = [w.reshape(per_out, -1) for w in outs]
    widths = [f.shape[1] for f in flat_in]
    dev = ins[0].device

    def index(a):
        return torch.as_tensor(a.astype(np.int64), device=dev)

    # every read before any write: the pre-batch double buffer
    payload = None
    if cross.any():
        rows = index(src_l[sends] - me * per_in)
        payload = torch.cat([f.index_select(0, rows) for f in flat_in], dim=1)
    own = None
    if local.size:
        rows = index(src_l[local] - me * per_in)
        own = [f.index_select(0, rows) for f in flat_in]
    if payload is not None:
        got = mesh.all_to_all_single(
            payload, axis,
            in_splits=np.bincount(own_dst[sends], minlength=n).tolist(),
            out_splits=np.bincount(own_src[recvs], minlength=n).tolist(),
        )
        if recvs.size:
            dst = index(recvs - me * per_out)
            for f, part in zip(flat_out, got.split(widths, dim=1)):
                f.index_copy_(0, dst, part)
    if own is not None:
        dst = index(local - me * per_out)
        for f, part in zip(flat_out, own):
            f.index_copy_(0, dst, part)
    return int(sends.size), int(recvs.size)


def gather_rows(mesh, axis: str, src, ins, outs) -> None:
    """``outs[i][l]`` ← rows ``src[l]`` of the pool sharded as ``ins[i]``
    (this rank's ``(L, S_in/m, …)`` blocks) into the pool sharded as
    ``outs[i]`` (``(L, S_out/m, …)``): a gather whose source and target
    pools may differ in size (the replicated pool's install). ``outs`` may
    be whole pools (``S_out`` rows on every rank, ``m`` taken as 1 for
    them): each rank then gathers every row it needs."""
    src = np.asarray(src, np.int64)
    if outs[0].shape[1] == src.shape[1]:  # the target is whole here
        full = [mesh.all_gather(w, axis).transpose(0, 1).flatten(1, 2)
                for w in ins]
        idx = torch.as_tensor(src, device=ins[0].device)
        for w, f in zip(outs, full):
            w.copy_(torch.take_along_dim(
                f, idx.reshape(*idx.shape, *([1] * (f.dim() - 2))), dim=1))
        return
    for layer in range(src.shape[0]):
        _exchange_layer(mesh, axis, src[layer],
                        [w[layer] for w in ins], [w[layer] for w in outs],
                        skip_identity=False)


class MigrationExecutable:
    """``__call__(src, tables, w_gate, w_up, w_down)`` rewrites the stacked
    ``(L, S, …)`` expert pool in place to ``new[l] = old[l][src[l]]`` and,
    when ``tables`` (the (L, E_v) expert→slot map) is given, computes the
    swapped tables on the device. Returns ``((w_gate, w_up, w_down),
    new_tables_or_None)``, the weights being the tensors passed in.

    With a ``mesh`` the weights are this rank's ``(L, S/m, …)`` blocks of
    a pool sharded over ``axis`` and ``src`` names global slots; each
    layer with a moved row is one exchange (:func:`_exchange_layer`), and
    every rank computes the same swapped tables. :attr:`sent_rows` and
    :attr:`received_rows` count the rows this rank shipped and took over
    the axis since construction."""

    def __init__(self, *, mesh=None, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.sent_rows = 0
        self.received_rows = 0

    def __call__(self, src, tables, w_gate, w_up, w_down):
        ws = (w_gate, w_up, w_down)
        src = np.asarray(src, np.int32)
        if src.ndim != 2:
            raise ValueError(f"row-source map must be (L, S), got {src.shape}")
        L, S = src.shape
        if src.size and not (0 <= src.min() and src.max() < S):
            raise ValueError(f"row sources must lie in [0, {S})")
        stored = S if self.mesh is None else S // self.mesh.size(self.axis)
        for w in ws:
            if tuple(w.shape[:2]) != (L, stored):
                raise ValueError(
                    f"weights {tuple(w.shape)} do not match the (L, S) = "
                    f"{(L, S)} row-source map"
                    + ("" if self.mesh is None else
                       f" sharded over {self.mesh.size(self.axis)} ranks")
                )
        layers, slots = np.nonzero(src != np.arange(S, dtype=np.int32))
        if layers.size and self.mesh is not None:
            words = [_as_words(w) for w in ws]
            for layer in np.unique(layers):
                sent, got = _exchange_layer(
                    self.mesh, self.axis, src[layer],
                    [w[layer] for w in words], [w[layer] for w in words],
                    skip_identity=True)
                self.sent_rows += sent
                self.received_rows += got
        elif layers.size:
            # one host-to-device copy of every moved (slot, source) pair;
            # each touched layer reads its span of it
            pairs = torch.as_tensor(
                np.stack([slots, src[layers, slots]]).astype(np.int64),
                device=w_gate.device,
            )
            bounds = np.searchsorted(layers, np.arange(L + 1))
            words = [_as_words(w) for w in ws]
            for layer in np.unique(layers):
                lo, hi = int(bounds[layer]), int(bounds[layer + 1])
                dst, rows = pairs[0, lo:hi], pairs[1, lo:hi]
                for w in words:
                    w[layer].index_copy_(0, dst, w[layer].index_select(0, rows))
        new_tables = None
        if tables is not None:
            new_tables = _swap_tables(
                tables, torch.as_tensor(src, device=tables.device))
        return ws, new_tables

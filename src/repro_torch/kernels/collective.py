"""Expert-row migration on one device: the host path of the JAX package's
``repro/kernels/collective.py`` (``MigrationExecutable(mesh=None)`` and
``_swap_tables``).

A migration batch is an (L, S) int32 row-source map ``src``: slot ``s`` of
layer ``l`` takes the row that slot ``src[l, s]`` held before the batch.
On the TPU this is an XLA gather outside any Pallas kernel, with the weight
buffers donated so that it rewrites them in place; here it is indexed
copies on the weights' device that touch only the rows that move. The
moved slots (``src[l, s] != s``) are found on the host; for each layer
that has any, and for each weight, the source rows of those slots are
gathered into scratch (``index_select``) and written into the moved slots
(``index_copy_``). The copies move bits, so each weight is viewed as the
widest integer words its rows divide into (8 bytes: four bf16 values),
which the index kernels move as one element. The scratch holds the
pre-batch rows, so swaps, cycles and one-to-many broadcasts are exact; an
identity layer issues no copy.
The extra memory is at most one layer's rows of one weight, and the caller
keeps the same tensor objects. An online batch of ``k`` swaps thus moves
``2k`` rows per weight instead of rewriting the pool.

:class:`CollectiveStats` and :func:`stats_for_dense_sources` are the JAX
module's traffic accounting, copied as they are: what a batch's minimal
row-level schedule (:func:`repro_torch.online.migration.lower_row_sources`)
ships between shards. On one card nothing crosses an interconnect, so the
serving engine only feeds them a measurement when rows are sharded over
devices; the exchange itself over a mesh waits for the multi-card port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..online.migration import lower_row_sources

__all__ = ["CollectiveStats", "MigrationExecutable", "stats_for_dense_sources"]


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


class MigrationExecutable:
    """``__call__(src, tables, w_gate, w_up, w_down)`` rewrites the stacked
    ``(L, S, …)`` expert pool in place to ``new[l] = old[l][src[l]]`` and,
    when ``tables`` (the (L, E_v) expert→slot map) is given, computes the
    swapped tables on the device. Returns ``((w_gate, w_up, w_down),
    new_tables_or_None)``, the weights being the tensors passed in."""

    def __call__(self, src, tables, w_gate, w_up, w_down):
        ws = (w_gate, w_up, w_down)
        src = np.asarray(src, np.int32)
        if src.ndim != 2:
            raise ValueError(f"row-source map must be (L, S), got {src.shape}")
        L, S = src.shape
        if src.size and not (0 <= src.min() and src.max() < S):
            raise ValueError(f"row sources must lie in [0, {S})")
        for w in ws:
            if tuple(w.shape[:2]) != (L, S):
                raise ValueError(
                    f"weights {tuple(w.shape)} do not match the (L, S) = "
                    f"{(L, S)} row-source map"
                )
        layers, slots = np.nonzero(src != np.arange(S, dtype=np.int32))
        if layers.size:
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

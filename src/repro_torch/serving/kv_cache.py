"""Paged KV cache pool: fixed-size blocks, free lists, per-request tables.

The engine's attention caches were allocated per *slot* at ``max_len`` —
every admitted request owned a full-length panel regardless of its actual
prompt/output lengths, so the physical cache bounded concurrency at
``max_batch × max_len`` tokens even when requests were short. This module
replaces that layout with vLLM-style paging:

  * the physical cache is a pool of ``num_blocks`` fixed-size blocks per
    layer, shaped ``(L, N, block_size, KV, hd)``;
  * each live request owns an ordered *block table* — the logical sequence
    ``[0, cur_len)`` maps to ``table[pos // block_size][pos % block_size]``;
  * blocks come from a free list; allocation is all-or-nothing, release
    returns every block, and a double release raises (the classic paged-KV
    corruption bug);
  * block 0 is reserved as the **null block**: inactive decode slots point
    every table entry at it, so their (masked, discarded) cache writes land
    somewhere harmless and no allocation is needed for idle slots. Active
    requests never own block 0, so a masked read of it is always invalid by
    construction.

All bookkeeping here is host-side Python/numpy — the data plane only
ever sees the dense ``(B, n_max)`` int32 block-table array built by
:meth:`PagedKVPool.slot_tables`.

``replica_slots_for_headroom`` closes the loop with the replication plane:
expert replica copies and KV blocks compete for the same HBM, so the
replica budget is *derived* from what the pool leaves free.

This is the port's own copy of ``repro/serving/kv_cache.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "PagedKVConfig",
    "PagedKVPool",
    "blocks_for_tokens",
    "kv_pool_bytes",
    "replica_slots_for_headroom",
]

NULL_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Engine-facing knobs for the paged KV plane.

    ``num_blocks=None`` lets the engine size the pool to exactly fit
    ``max_batch`` full-length requests (plus the null block) — the
    degenerate configuration in which admission can never fail and the
    paged engine behaves like the dense one. Smaller pools create real
    memory pressure: admission blocks on ``can_allocate`` and decode-time
    growth can preempt.
    """

    block_size: int = 16
    num_blocks: int | None = None
    # admission keeps this many blocks free as a decode-growth reserve so
    # a full pool preempts rarely instead of on the very next step
    watermark_blocks: int = 0

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        if self.watermark_blocks < 0:
            raise ValueError("watermark_blocks must be >= 0")


def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``num_tokens`` cache entries."""
    return max(0, -(-int(num_tokens) // int(block_size)))


class PagedKVPool:
    """Free-list allocator over ``num_blocks`` blocks (block 0 reserved)."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 watermark_blocks: int = 0):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.watermark_blocks = int(watermark_blocks)
        # LIFO stack initialised descending: allocation pops the lowest
        # free id first — deterministic layouts for reproducible tests
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: dict[int, list[int]] = {}  # uid → ordered blocks
        # observability (fig23's pool gate + test assertions)
        self.peak_used = 0
        self.alloc_failures = 0
        self.total_allocs = 0
        # optional repro.telemetry.Telemetry hub (the engine binds its
        # own): occupancy gauge (max = watermark) + failure counter
        self.telemetry = None

    # -- capacity ------------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus the null block

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - self.free_blocks

    def blocks_for(self, num_tokens: int) -> int:
        return blocks_for_tokens(num_tokens, self.block_size)

    def can_allocate(self, num_tokens: int, *, reserve: int | None = None
                     ) -> bool:
        """Would growing by ``num_tokens`` worth of blocks succeed, keeping
        ``reserve`` (default: the watermark) blocks free afterwards?"""
        keep = self.watermark_blocks if reserve is None else int(reserve)
        return self.blocks_for(num_tokens) <= self.free_blocks - keep

    # -- allocation ----------------------------------------------------
    def allocate(self, uid: int, num_tokens: int) -> bool:
        """Grow ``uid``'s table to cover ``num_tokens``. All-or-nothing:
        on failure nothing is allocated and False is returned."""
        table = self._tables.setdefault(uid, [])
        need = self.blocks_for(num_tokens) - len(table)
        if need <= 0:
            return True
        if need > self.free_blocks:
            self.alloc_failures += 1
            if self.telemetry is not None:
                self.telemetry.counter("kv.alloc_failures").inc()
            return False
        for _ in range(need):
            table.append(self._free.pop())
        self.total_allocs += need
        self.peak_used = max(self.peak_used, self.used_blocks)
        if self.telemetry is not None:
            self.telemetry.gauge("kv.used_blocks").set(self.used_blocks)
        return True

    def release(self, uid: int) -> int:
        """Return every block owned by ``uid``; raises on double release."""
        if uid not in self._tables:
            raise KeyError(f"release of unknown/already-released uid {uid}")
        blocks = self._tables.pop(uid)
        self._free.extend(reversed(blocks))
        if self.telemetry is not None:
            self.telemetry.gauge("kv.used_blocks").set(self.used_blocks)
        return len(blocks)

    def block_table(self, uid: int) -> list[int]:
        return list(self._tables.get(uid, []))

    def holds(self, uid: int) -> bool:
        return uid in self._tables

    # -- attention-side view -------------------------------------------
    def slot_tables(self, uid_by_slot: list[int | None], n_max: int
                    ) -> np.ndarray:
        """(B, n_max) int32 block tables for the decode batch.

        Slots without a live request — and table positions past a request's
        allocation — point at the null block, so the kernel's masked
        reads/writes stay in-bounds without per-slot branches.
        """
        out = np.full((len(uid_by_slot), n_max), NULL_BLOCK, dtype=np.int32)
        for slot, uid in enumerate(uid_by_slot):
            if uid is None:
                continue
            table = self._tables.get(uid, [])
            if len(table) > n_max:
                raise ValueError(
                    f"uid {uid} owns {len(table)} blocks > view width {n_max}"
                )
            out[slot, : len(table)] = table
        return out

    # -- invariants ----------------------------------------------------
    def check_invariants(self) -> None:
        """Conservation + exclusive ownership; raises AssertionError."""
        owned: list[int] = [b for t in self._tables.values() for b in t]
        assert NULL_BLOCK not in owned, "null block leaked into a table"
        assert NULL_BLOCK not in self._free, "null block leaked into free list"
        assert len(set(owned)) == len(owned), "block owned by two requests"
        assert not set(owned) & set(self._free), "block both free and owned"
        assert len(owned) + len(self._free) == self.usable_blocks, (
            f"block conservation violated: {len(owned)} owned + "
            f"{len(self._free)} free != {self.usable_blocks} usable"
        )

    def stats(self) -> dict[str, float]:
        return {
            "kv_num_blocks": float(self.usable_blocks),
            "kv_block_size": float(self.block_size),
            "kv_used_blocks": float(self.used_blocks),
            "kv_peak_used_blocks": float(self.peak_used),
            "kv_alloc_failures": float(self.alloc_failures),
            "kv_total_allocs": float(self.total_allocs),
        }


# ---------------------------------------------------------------------------
# Shared HBM budget: KV pool vs expert replicas
# ---------------------------------------------------------------------------

def kv_pool_bytes(num_blocks: int, block_size: int, num_layers: int,
                  num_kv_heads: int, head_dim: int, bytes_per_param: int
                  ) -> int:
    """Physical bytes of the paged pool: K and V, all layers, all blocks."""
    per_entry = num_kv_heads * head_dim * bytes_per_param
    return 2 * num_layers * num_blocks * block_size * per_entry


def replica_slots_for_headroom(
    headroom_bytes: float,
    *,
    d_model: int,
    expert_d_ff: int,
    num_layers: int,
    bytes_per_param: int,
) -> int:
    """Per-device replica slots affordable inside ``headroom_bytes``.

    One replica slot adds one expert row on *every* layer of one device:
    ``w_gate (D, Fv) + w_up (D, Fv) + w_down (Fv, D)`` = ``3·D·Fv`` params
    per layer. The headroom is what the HBM budget leaves after the paged
    KV pool (``kv_pool_bytes``) — replication and KV paging share one
    budget instead of two hand constants (ROADMAP carry-over).
    """
    if headroom_bytes <= 0:
        return 0
    slot_bytes = 3 * d_model * expert_d_ff * num_layers * bytes_per_param
    return int(headroom_bytes // slot_bytes)

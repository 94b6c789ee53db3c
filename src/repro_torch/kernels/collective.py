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
``2k`` rows per weight instead of rewriting the pool. The collective path
over a mesh (and with it ``CollectiveStats``) waits for the multi-device
port.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MigrationExecutable"]


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

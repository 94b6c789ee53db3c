"""Expert-row migration on one device: the host path of the JAX package's
``repro/kernels/collective.py`` (``MigrationExecutable(mesh=None)`` and
``_swap_tables``).

A migration batch is an (L, S) int32 row-source map ``src``: slot ``s`` of
layer ``l`` takes the row that slot ``src[l, s]`` held before the batch.
On the TPU this is an XLA gather outside any Pallas kernel, with the weight
buffers donated so that it rewrites them in place; here it is indexed
copies on the weights' device. A whole-stack gather would allocate a second
expert pool (6.0 GB for granite-moe-3b-a800m in bf16), so the rewrite runs
one layer and one weight at a time: gather the layer's rows into scratch,
copy them back. The extra memory is one layer's rows of one weight, and the
caller keeps the same tensor objects. The collective path over a mesh (and
with it ``CollectiveStats``) waits for the multi-device port.
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
        src = torch.as_tensor(src, device=w_gate.device)
        for w in ws:
            if tuple(w.shape[:2]) != (L, S):
                raise ValueError(
                    f"weights {tuple(w.shape)} do not match the (L, S) = "
                    f"{(L, S)} row-source map"
                )
        rows = src.long()
        for layer in range(L):
            for w in ws:
                w[layer].copy_(w[layer].index_select(0, rows[layer]))
        new_tables = None if tables is None else _swap_tables(tables, src)
        return ws, new_tables

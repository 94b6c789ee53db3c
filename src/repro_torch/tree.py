"""Nested dicts of tensors as the port's pytrees: leaves in the order
``jax.tree.leaves`` gives a dict (sorted keys), and a map that keeps the
nesting."""
from __future__ import annotations

__all__ = ["leaves", "tree_map"]


def leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order; None is no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)

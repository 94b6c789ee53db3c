"""Nested dicts of tensors as the port's pytrees: leaves in the order
``jax.tree.leaves`` gives a dict (sorted keys), and a map that keeps the
nesting."""
from __future__ import annotations

__all__ = ["leaf_paths", "leaves", "leaves_along", "tree_map", "unflatten"]


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


def leaf_paths(tree, path=()) -> list:
    """The key path (a tuple) of every leaf, in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k], path + (k,))]
    return [] if tree is None else [path]


def leaves_along(tree, mirror) -> list:
    """``mirror``'s entry at each leaf of ``tree``, in :func:`leaves`
    order: a tree of specs mirroring a tree of tensors, whose entries may
    be None (or ``mirror`` None: all None)."""
    if mirror is None:
        return [None] * len(leaves(tree))
    return [m for (m,) in leaves(tree_map(lambda _, m: (m,), tree, mirror))]


def unflatten(skeleton, flat: list):
    """Leaves in :func:`leaves` order → ``skeleton``'s nesting."""
    it = iter(flat)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return None if tree is None else next(it)

    return walk(skeleton)

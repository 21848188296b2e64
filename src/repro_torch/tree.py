"""Nested dicts of tensors as trees, in ``jax.tree``'s leaf order.

The port keeps parameters and optimizer states as nested dicts (the
reference's pytrees). JAX flattens a dict in sorted key order; so do
``leaves`` and ``unflatten`` here, so that a leaf's index is the same in
both packages (the global-norm sum of ``adamw_update`` runs in that
order, and a checkpoint's ``a{i}`` arrays are numbered by it).
"""
from __future__ import annotations

from typing import Callable


def leaves(tree) -> list:
    """The leaves of ``tree`` (dicts are nodes, anything else a leaf),
    dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    return [tree]


def unflatten(like, values) -> object:
    """A tree of ``like``'s structure holding ``values`` (an iterable in
    ``leaves`` order); raises when the counts differ."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer values than the tree has leaves") from None
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                  *map(leaves, rest))])


def structure(tree):
    """The tree's shape as JSON-ready data: a dict's keys map to their
    subtrees' structures, and leaf number i is the integer i."""
    counter = iter(range(len(leaves(tree))))

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(node[key]) for key in sorted(node)}
        return next(counter)
    return walk(tree)

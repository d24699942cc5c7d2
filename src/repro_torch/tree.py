"""Nested-dict parameter trees (the port's stand-in for JAX pytrees).

Parameters, optimizer moments and gradients are nested ``dict``s of tensors
with the JAX package's key names.  Leaves are visited in sorted-key order,
which is the order ``jax.tree_util`` flattens a dict in.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-shaped ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(flat "a/b" path, leaf)`` pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten_like(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)

"""Parameter trees (the port's stand-in for JAX pytrees).

Parameters, optimizer moments and gradients are nested ``dict``s, ``list``s
and ``tuple``s of tensors with the JAX package's key names (the decoder
keeps ``head_layers``, ``units`` and ``tail_layers`` as lists).  Leaves are
visited in the order ``jax.tree_util`` flattens the same structure: dict
keys sorted, sequences by index.  Flat paths are ``"a/b/0/c"``, the
reference's ``aggregation._path_str`` form.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-shaped ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *rest_leaves)`` leafwise, ``path`` as in
    ``tree_items``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      prefix=f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, *(r[i] for r in rest),
                                             prefix=f"{prefix}{i}/")
                          for i, t in enumerate(tree))
    return fn(prefix[:-1], tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(flat "a/b" path, leaf)`` pairs in flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_items(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten_like(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)

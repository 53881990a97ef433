"""Nested containers of tensors ("trees"), walked as ``jax.tree_util`` walks
a pytree, so that the port's parameter, optimizer and train-state trees
flatten to the JAX package's leaf order and key paths.

A tree is a dict (keys visited in sorted order), a list or tuple, a
dataclass instance (its fields in declaration order, keyed by name) or
``None`` (no leaves); anything else is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["flatten_with_path", "leaves", "tree_map", "tree_map_with_path"]


def _children(tree) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Yield (key path, leaf) in ``jax.tree_util`` order; ``None`` yields
    nothing."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from flatten_with_path(child, prefix + (key,))


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` on each leaf of ``tree`` and the matching
    parts of ``rest``.  The structure follows ``tree``; where ``tree`` has a
    leaf, the others pass their whole subtree there (``tree`` may be a
    structural prefix of them, as grads are of Adafactor's state)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``fn(key path, leaf)`` on each leaf, the structure kept
    (``jax.tree_util.tree_map_with_path``)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    mapped = {k: tree_map_with_path(fn, child, prefix + (k,)) for k, child in kids}
    if isinstance(tree, dict):
        return {k: mapped[str(k)] for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(mapped[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **mapped)

"""Trees of tensors: the port's stand-in for the ``jax.tree_util`` calls of
the reference's training path (optimizers, gradient compression,
checkpoints, the train step).

A tree is nested dicts and lists (tuples) with tensors (or any other
objects) at the leaves, and ``None`` as an empty subtree, as JAX treats it.
Leaves come in JAX's order: dict keys sorted, lists by index.  So a leaf's
path, joined by ``__``, is the reference's checkpoint key, and a sum over
leaves adds in the reference's order.
"""
from __future__ import annotations

__all__ = ["flatten_with_path", "leaves", "tree_map"]


def flatten_with_path(tree, path=()):
    """(path tuple, leaf) pairs in JAX's order; a dict key or a list index
    per level."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_path(tree[key], path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest`` (trees of the same structure), in the structure of ``tree``;
    called in the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)

"""Nested dicts, lists and tuples of tensors (the port's parameter and
optimizer trees), walked in the JAX package's pytree order: dict keys sorted,
sequences by index. A checkpoint's key paths and the optimizer's leaf order
follow it."""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """Every leaf with its key path (dict keys and sequence indices, as
    ``jax.tree_util.tree_flatten_with_path`` names them), in that order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in leaves_with_paths(tree[key],
                                                                          prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree) for item in leaves_with_paths(sub,
                                                                                prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure), as a tree of that structure; the leaves
    are visited in ``leaves`` order."""
    if isinstance(tree, dict):
        if any(set(other) != set(tree) for other in rest):
            raise ValueError("trees with different keys")
        return {key: tree_map(fn, tree[key], *(other[key] for other in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(len(other) != len(tree) for other in rest):
            raise ValueError("trees with different lengths")
        out = [tree_map(fn, sub, *(other[i] for other in rest)) for i, sub in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)

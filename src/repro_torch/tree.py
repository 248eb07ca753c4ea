"""Nested ``dict`` / ``list`` / ``tuple`` trees of tensors: the port's
counterpart of the ``jax.tree`` calls the reference makes on params,
gradients, optimizer state and checkpoints.

Leaves are visited as ``jax.tree_util`` visits them — dict keys sorted,
sequences in order — so the n-th leaf of a params tree, of its gradients
and of its optimizer moments is the same parameter.  A leaf's path is
rendered as ``jax.tree_util.keystr`` renders it (``['name']``, ``[0]``,
``['a'][1]``), the key of a checkpoint's leaf.  ``None`` holds no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kl for i, c in enumerate(tree)
                for kl in leaves_with_path(c, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> List[Any]:
    """The tree's leaves in ``jax.tree.leaves`` order."""
    return [x for _, x in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest, path: str = ""):
    """A tree of ``tree``'s nesting whose leaves are ``fn(path, leaf,
    *leaves at the same place in rest)``; dicts keep ``tree``'s key
    order, lists and tuples their type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=f"{path}[{k!r}]") for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, c, *(r[i] for r in rest),
                             path=f"{path}[{i}]") for i, c in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """:func:`map_with_path` without the path: ``fn(leaf, *rest leaves)``."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)

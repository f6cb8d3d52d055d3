"""Nested parameter trees: map, leaves, partition and merge.

The port keeps the JAX package's parameter layout (``conv{i}/conv/weight``
and so on) as plain nested dicts of tensors; tuples (``BatchNormState``,
``MAMLInferenceState``) are nodes too and keep their type. ``None`` marks
an empty position, as in JAX, where ``partition`` leaves ``None`` in the
half that does not hold a leaf (``howtotrainyourmamlpytorch_tpu/utils/
trees.py``).
"""

from __future__ import annotations

from typing import Any, Callable

Tree = Any


def _rebuild(node: tuple, items) -> tuple:
    return type(node)(*items) if hasattr(node, "_fields") else tuple(items)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Applies ``fn`` leafwise over same-structure trees. A position that is
    ``None`` in ``tree`` stays ``None`` without calling ``fn``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _rebuild(
            tree, (tree_map(fn, *nodes) for nodes in zip(tree, *rest))
        )
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The non-``None`` leaves, dicts in key-insertion order."""
    if isinstance(tree, (dict, tuple)):
        values = tree.values() if isinstance(tree, dict) else tree
        return [leaf for v in values for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its non-``None`` leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def partition(tree: Tree, mask: Tree) -> tuple[Tree, Tree]:
    """Splits ``tree`` into ``(selected, rest)`` by a same-structure boolean
    mask; unselected positions are ``None`` in ``selected`` and vice versa."""
    selected = tree_map(lambda m, x: x if m else None, mask, tree)
    rest = tree_map(lambda m, x: None if m else x, mask, tree)
    return selected, rest


def merge(*trees: Tree) -> Tree:
    """Merges complementary trees from :func:`partition` (first non-``None``
    leaf wins at each position)."""
    dicts = [t for t in trees if isinstance(t, dict)]
    if dicts:
        return {
            k: merge(*(t.get(k) if isinstance(t, dict) else None for t in trees))
            for k in dicts[0]
        }
    return next((leaf for leaf in trees if leaf is not None), None)

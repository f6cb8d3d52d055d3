"""Declarative sharding: regex partition rules -> spec trees -> shard/gather
(``howtotrainyourmamlpytorch_tpu/parallel/sharding.py``).

The layout policy is data: a rule table maps regex patterns over
"/"-joined tree paths to specs. Because the patterns ``re.search`` the
full path, one ``conv/weight$`` rule covers the backbone parameter and its
Adam moments (``opt_state/mu/theta/conv0/conv/weight``), so a whole train
state is laid out from one table.

A spec is a tuple with one entry per leading axis of the leaf: an axis
name (``"dp"``, ``"mp"``) or ``None``, trailing axes unnamed, as JAX's
``PartitionSpec`` is. Where JAX places a leaf on devices, a rank here
holds its block: ``shard_tree`` takes this rank's contiguous block of
every named axis, ``gather_tree`` all-gathers the blocks over the axis's
process group back to whole host tensors. The gathered tree is what a
checkpoint holds, so archives carry no layout: save on ``dp x mp`` ranks,
resume on one process, and the reverse.

JAX's ``batch_sharding_spec`` and ``chunked_batch_sharding`` are layout
hints to XLA for the task axis of the meta-batch. Here a rank's loader
synthesises only its dp index's slice (``mesh.host_batch_bounds`` over the
dp extent), and ``collectives.guard_task_chunk`` is JAX's
``guard_task_chunk``.

Divisibility guard: an axis whose size does not divide its mesh extent
is replicated for that leaf (``guard_divisible``), so a 5-way head does
not refuse an ``mp`` of 2.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import torch

from ..utils.trees import tree_map
from .mesh import DEFAULT_DATA_AXIS, DEFAULT_MODEL_AXIS, Mesh

Tree = Any
#: A leaf's layout: an axis name or ``None`` per leading axis.
Spec = tuple
#: ``(pattern, spec)``, ``spec`` a :data:`Spec` or a callable ``leaf ->
#: Spec`` (for specs that depend on the leaf's rank).
Rule = "tuple[str, Spec | Callable[[Any], Spec]]"

REPLICATED: Spec = ()


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, tuple, list)) and node is not None


def _children(node):
    """``(name, child)`` pairs of a tree node, named as JAX names its key
    paths: a dict's keys, a NamedTuple's fields, a tuple's indices."""
    if isinstance(node, dict):
        return list(node.items())
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return [(str(i), child) for i, child in enumerate(node)]


def _rebuild(node, items):
    if isinstance(node, dict):
        return dict(zip(node, items))
    if hasattr(node, "_fields"):
        return type(node)(*items)
    return type(node)(items)


def tree_path_name(path) -> str:
    """A path of names -> the ``"a/b/c"`` name the rules match."""
    return "/".join(str(entry) for entry in path)


def named_tree_map(fn: Callable[[str, Any], Any], tree: Tree, path: tuple = ()) -> Tree:
    """``fn(name, leaf)`` over the leaves of ``tree``, ``name`` the leaf's
    "/"-joined path; ``None`` stays ``None``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree_path_name(path), tree)
    return _rebuild(tree, [named_tree_map(fn, child, path + (name,))
                           for name, child in _children(tree)])


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def last_axis(axis_name: str) -> Callable[[Any], Spec]:
    """Rule spec: the leaf's last axis (per-step BN gamma/beta are ``(S,
    F)``, plain BN's ``(F,)``; the feature axis is last in both)."""

    def spec(leaf) -> Spec:
        return (None,) * (len(_shape(leaf)) - 1) + (axis_name,)

    return spec


def match_partition_rules(rules, tree: Tree) -> Tree:
    """The spec tree from the first rule whose pattern ``re.search``-es each
    leaf's path. Scalar and one-element leaves are never partitioned; a
    leaf no rule matches raises (end a table with ``(".*", ())``)."""

    def get_spec(name: str, leaf) -> Spec:
        shape = _shape(leaf)
        numel = 1
        for dim in shape:
            numel *= dim
        if not shape or numel == 1:
            return REPLICATED
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                return spec(leaf) if callable(spec) else spec
        raise ValueError(f"no partition rule matched leaf {name!r}")

    return named_tree_map(get_spec, tree)


def guard_divisible(mesh: Mesh, spec: Spec, leaf) -> Spec:
    """``spec`` with every named axis whose leaf dimension does not divide
    the mesh extent replaced by ``None`` (axis by axis)."""
    shape = _shape(leaf)
    return tuple(
        None if axis is not None and shape[i] % mesh.shape[axis] != 0 else axis
        for i, axis in enumerate(spec)
    )


def tree_shardings(mesh: Mesh, tree: Tree, rules) -> Tree:
    """The divisibility-guarded spec tree of ``tree`` under ``rules``."""
    specs = match_partition_rules(rules, tree)
    return _zip_specs(tree, specs, lambda leaf, spec: guard_divisible(mesh, spec, leaf))


def _zip_specs(tree, specs, fn):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree, in ``tree``'s
    structure (dicts matched by key)."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_specs(child, specs[k], fn) for k, child in tree.items()}
    return _rebuild(tree, [_zip_specs(child, spec, fn) for (_, child), (_, spec)
                           in zip(_children(tree), _children(specs))])


def map_with_specs(fn: Callable[[Any, Spec], Any], tree: Tree, specs: Tree) -> Tree:
    """``fn(leaf, spec)`` over ``tree`` and its spec tree."""
    return _zip_specs(tree, specs, fn)


def is_sharded(spec: Spec) -> bool:
    return any(axis is not None for axis in spec)


def _axis_group(mesh: Mesh, axis: str):
    """``(group, size, index)`` of this rank along ``axis``."""
    if axis == DEFAULT_MODEL_AXIS:
        return mesh.mp_group, mesh.mp, mesh.mp_index
    if axis == DEFAULT_DATA_AXIS:
        return mesh.dp_group, mesh.dp, mesh.dp_index
    raise ValueError(f"unknown mesh axis {axis!r}")


def shard_leaf(mesh: Mesh, spec: Spec, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``leaf`` along every named axis of
    ``spec``, in storage of its own (the leaf itself when nothing is
    named)."""
    out = leaf
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        _, size, index = _axis_group(mesh, axis)
        block = leaf.shape[dim] // size
        out = out.narrow(dim, index * block, block)
    return out if out is leaf else out.clone(memory_format=torch.contiguous_format)


def gather_leaf(mesh: Mesh, spec: Spec, leaf: torch.Tensor) -> torch.Tensor:
    """The whole leaf on the host: the blocks of every named axis of
    ``spec`` all-gathered over that axis's group, concatenated in rank
    order. A collective every rank of the group calls."""
    from .collectives import all_gather_cat

    out = leaf
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        group, size, _ = _axis_group(mesh, axis)
        out = all_gather_cat(out, dim, group, size)
    return out.detach().cpu()


def make_shard_and_gather_fns(mesh: Mesh, partition_specs: Tree, tree: Tree):
    """Per-leaf ``(shard_fns, gather_fns)`` for ``tree``'s structure from
    its spec tree. ``shard_fns``: a whole leaf -> this rank's block.
    ``gather_fns``: a rank's block -> the whole leaf on the host (the
    checkpoint side; the result does not depend on the layout)."""
    shard_fns = map_with_specs(
        lambda _, spec: (lambda leaf: shard_leaf(mesh, spec, leaf)), tree, partition_specs)
    gather_fns = map_with_specs(
        lambda _, spec: (lambda leaf: gather_leaf(mesh, spec, leaf)), tree, partition_specs)
    return shard_fns, gather_fns


def shard_tree(tree: Tree, shard_fns: Tree) -> Tree:
    return tree_map(lambda leaf, fn: fn(leaf), tree, shard_fns)


def gather_tree(tree: Tree, gather_fns: Tree) -> Tree:
    return tree_map(lambda leaf, fn: fn(leaf), tree, gather_fns)


# ---------------------------------------------------------------------------
# Rule tables (the layout policy, as data)
# ---------------------------------------------------------------------------

#: Data parallelism alone: every state leaf replicated.
DP_STATE_RULES = (
    (r".*", REPLICATED),
)

#: Tensor (``mp``) parallelism for the conv backbones, matched anywhere in
#: the path so optimizer moments follow their parameters:
#:
#: * conv filters and biases over output channels (axis 0); BN gamma/beta
#:   on their feature axis (last: ``(F,)`` or per-step ``(S, F)``); the
#:   layer norm's ``(C, H, W)`` weight/bias on the channel axis (first);
#: * the linear head row-parallel over its input features;
#: * LSLR tables and BN running statistics replicated.
MP_STATE_RULES = (
    (r"(^|/)lslr/", REPLICATED),
    (r"(^|/)bn_state(/|$)", REPLICATED),
    (r"conv/weight$", (DEFAULT_MODEL_AXIS,)),
    (r"conv/bias$", (DEFAULT_MODEL_AXIS,)),
    (r"norm/(gamma|beta)$", last_axis(DEFAULT_MODEL_AXIS)),
    (r"norm/(weight|bias)$", (DEFAULT_MODEL_AXIS,)),
    (r"linear/weight$", (None, DEFAULT_MODEL_AXIS)),
    (r"linear/bias$", REPLICATED),
    (r".*", REPLICATED),
)


def state_rules(shard_model: bool):
    """The rule table for a whole learner state."""
    return MP_STATE_RULES if shard_model else DP_STATE_RULES


def state_shardings(mesh: Mesh, state: Tree, shard_model: bool = False) -> Tree:
    """The guarded spec tree of a learner state (parameters, LSLR, BN
    statistics, optimizer moments, counters) under its rule table."""
    return tree_shardings(mesh, state, state_rules(shard_model))

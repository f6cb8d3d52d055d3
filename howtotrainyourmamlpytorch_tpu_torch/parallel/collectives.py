"""Flat-bucket cross-rank reductions
(``howtotrainyourmamlpytorch_tpu/parallel/collectives.py``).

A per-leaf all-reduce of the meta-gradient is one collective per
parameter tensor, each paying the transport's latency floor. The bucketed
form concatenates the leaves into one flat buffer per dtype and reduces
each buffer once: the payload is the same, the latency is paid once per
dtype. ``fused_psum`` is that reduction; ``per_leaf_psum`` the per-leaf
form (``MAMLConfig.collective_fusion = "per_leaf"``). Both are the same
elementwise sums, so leaf values are bit-identical between them.

Where the group's backend is gloo and a buffer lies on a card, the buffer
is reduced through the host: copied to the CPU (which waits for the
work queued on the card before it), all-reduced there, and copied back.
``collective_counts`` counts the collectives this process issued, by kind.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

from ..utils.trees import tree_leaves, tree_map, tree_unflatten
from .mesh import DEFAULT_DATA_AXIS, Mesh

Tree = Any

#: Collectives this process issued, by kind (``all_reduce``, ``broadcast``).
collective_counts: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The recipe that rebuilds a tree from its dtype buckets: ``treedef``
    (the tree's structure) and, per leaf in order, ``(dtype name, offset,
    shape)``."""

    treedef: Any
    leaves: tuple[tuple[str, int, tuple[int, ...]], ...]

    @property
    def dtypes(self) -> tuple[str, ...]:
        """Bucket dtype names in first-seen leaf order."""
        seen: list[str] = []
        for dtype_name, _, _ in self.leaves:
            if dtype_name not in seen:
                seen.append(dtype_name)
        return tuple(seen)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def flatten_buckets(tree: Tree) -> tuple[dict[str, torch.Tensor], BucketSpec]:
    """``(buckets, spec)``: one contiguous 1-D buffer per leaf dtype, the
    leaves in the tree's own order (so every rank lays them out alike), and
    the exact inverse recipe for :func:`unflatten_buckets`."""
    pieces: dict[str, list[torch.Tensor]] = {}
    offsets: dict[str, int] = {}
    leaves = []
    for leaf in tree_leaves(tree):
        name = _dtype_name(leaf.dtype)
        offset = offsets.get(name, 0)
        leaves.append((name, offset, tuple(leaf.shape)))
        pieces.setdefault(name, []).append(leaf.reshape(-1))
        offsets[name] = offset + leaf.numel()
    buckets = {name: torch.cat(parts) for name, parts in pieces.items()}
    return buckets, BucketSpec(treedef=tree_map(lambda _: 0, tree),
                               leaves=tuple(leaves))


def unflatten_buckets(buckets: dict[str, torch.Tensor], spec: BucketSpec) -> Tree:
    """The inverse of :func:`flatten_buckets`: views of the buffers."""
    leaves = []
    for name, offset, shape in spec.leaves:
        size = 1
        for dim in shape:
            size *= dim
        leaves.append(buckets[name][offset:offset + size].view(shape))
    return tree_unflatten(spec.treedef, leaves)


def _through_host(tensor: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return tensor.device.type != "cpu" and dist.get_backend(group) != "nccl"


def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sums ``tensor`` over the group's ranks, in place; returns it."""
    import torch.distributed as dist

    collective_counts["all_reduce"] += 1
    if _through_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=group)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` into every rank's, in place; returns it."""
    import torch.distributed as dist

    collective_counts["broadcast"] += 1
    if _through_host(tensor, group):
        host = tensor.cpu()
        dist.broadcast(host, src=src, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src=src, group=group)
    return tensor


def fused_psum(tree: Tree, group=None) -> Tree:
    """The sum over ranks of every leaf of ``tree`` through one all-reduce
    per dtype bucket. Bit-identical to :func:`per_leaf_psum` leaf for
    leaf."""
    buckets, spec = flatten_buckets(tree)
    for buf in buckets.values():
        all_reduce_(buf, group)
    return unflatten_buckets(buckets, spec)


def per_leaf_psum(tree: Tree, group=None) -> Tree:
    """One all-reduce per leaf, on a copy of each."""
    return tree_map(lambda leaf: all_reduce_(leaf.clone(), group), tree)


def reduce_fn(collective_fusion: str):
    """The reduction ``MAMLConfig.collective_fusion`` selects."""
    return fused_psum if collective_fusion == "bucketed" else per_leaf_psum


def broadcast_tree(tree: Tree, src: int = 0, group=None) -> Tree:
    """Rank ``src``'s values of ``tree``, on every rank, through one
    broadcast per dtype bucket (new tensors; ``tree`` is not written)."""
    buckets, spec = flatten_buckets(tree)
    for buf in buckets.values():
        broadcast_(buf, src, group)
    return tree_map(torch.clone, unflatten_buckets(buckets, spec))


def guard_task_chunk(mesh: Mesh | None, task_chunk: int) -> None:
    """Refuses a ``task_chunk`` that is not a multiple of the dp extent:
    each rank runs ``task_chunk / dp`` tasks a chunk (JAX
    ``parallel/sharding.py:254``). No-op off-mesh or with chunking off."""
    if mesh is None or task_chunk <= 0:
        return
    dp = mesh.shape.get(DEFAULT_DATA_AXIS, 1)
    if dp > 1 and task_chunk % dp != 0:
        raise ValueError(
            f"--task_chunk {task_chunk} must be a multiple of the mesh's "
            f"dp extent {dp} (each scan step shards its chunk of tasks "
            "over 'dp')"
        )

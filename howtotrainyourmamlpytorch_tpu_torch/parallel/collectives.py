"""Cross-rank reductions of the dp half and the differentiable collectives
of the tp half (``howtotrainyourmamlpytorch_tpu/parallel/collectives.py``).

Data parallel. A per-leaf all-reduce of the meta-gradient is one
collective per parameter tensor, each paying the transport's latency
floor. The bucketed form concatenates the leaves into one flat buffer per
dtype and reduces each buffer once: the payload is the same, the latency
is paid once per dtype. ``fused_psum`` is that reduction; ``per_leaf_psum``
the per-leaf form (``MAMLConfig.collective_fusion = "per_leaf"``). Both
are the same elementwise sums, so leaf values are bit-identical between
them.

Tensor parallel. Four ``torch.autograd.Function``s over the mp group, each
of whose backward calls its partner, so they compose to any order under
``create_graph=True`` (the torch form of a recursive ``custom_jvp``):

* ``AllGather``: this rank's block -> the blocks of every rank
  concatenated on an axis; backward ``ReduceScatter``;
* ``ReduceScatter``: the sum over ranks, this rank's block of it;
  backward ``AllGather``;
* ``AllReduce``: the sum of partial sums; backward ``CopyToShards``;
* ``CopyToShards``: the identity on a replicated input entering sharded
  work; backward ``AllReduce``, so its gradient is summed over the ranks
  once.

``ModelShard`` applies them to the task-folded ``(N, T*C, H, W)``
activations of the backbones, gathering per task.

Where the group's backend is gloo and a buffer lies on a card, the buffer
goes through the host: copied to the CPU (which waits for the work queued
on the card before it), reduced there, and copied back. ``ReduceScatter`` is an all-reduce and a
slice on every backend (gloo has no reduce-scatter).
``collective_counts`` counts the collectives this process issued, by kind,
and ``collective_seconds`` the host seconds they took.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import torch

from ..utils.trees import tree_leaves, tree_map, tree_unflatten
from .mesh import DEFAULT_DATA_AXIS, Mesh

Tree = Any

#: Collectives this process issued, by kind (``all_reduce``, ``broadcast``,
#: ``all_gather``, ``reduce_scatter``).
collective_counts: collections.Counter = collections.Counter()
#: Host seconds the collectives took, by kind (host copies included).
collective_seconds: collections.Counter = collections.Counter()


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
    t0 = time.perf_counter()
    if _through_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=group)
    collective_seconds["all_reduce"] += time.perf_counter() - t0
    return tensor


def all_gather_cat(tensor: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's ``tensor`` of the group concatenated on ``dim`` in rank
    order (a new tensor on ``tensor``'s device)."""
    import torch.distributed as dist

    collective_counts["all_gather"] += 1
    t0 = time.perf_counter()
    src = tensor.detach().contiguous()
    if _through_host(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(tensor.device)
    collective_seconds["all_gather"] += time.perf_counter() - t0
    return out


def reduce_scatter_block(tensor: torch.Tensor, dim: int, group, size: int,
                         index: int) -> torch.Tensor:
    """Block ``index`` (of ``size`` on ``dim``) of the sum of ``tensor`` over
    the group's ranks: an all-reduce and a slice, on any backend."""
    import torch.distributed as dist

    collective_counts["reduce_scatter"] += 1
    t0 = time.perf_counter()
    src = tensor.detach()
    summed = src.cpu() if _through_host(src, group) else src.clone()
    dist.all_reduce(summed, group=group)
    block = summed.shape[dim] // size
    out = summed.narrow(dim, index * block, block).contiguous().to(tensor.device)
    collective_seconds["reduce_scatter"] += time.perf_counter() - t0
    return out


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


class AllGather(torch.autograd.Function):
    """This rank's block -> every rank's blocks concatenated on ``dim``;
    backward: ``ReduceScatter`` of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.args = (dim, group, size, index)
        return all_gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        return ReduceScatter.apply(grad, *ctx.args), None, None, None, None


class ReduceScatter(torch.autograd.Function):
    """The sum over ranks, this rank's block of it on ``dim``; backward:
    ``AllGather`` of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.args = (dim, group, size, index)
        return reduce_scatter_block(x, dim, group, size, index)

    @staticmethod
    def backward(ctx, grad):
        return AllGather.apply(grad, *ctx.args), None, None, None, None


class AllReduce(torch.autograd.Function):
    """The sum over ranks of partial sums; backward: ``CopyToShards`` of
    the gradient (every rank's partial gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return CopyToShards.apply(grad, ctx.group), None


class CopyToShards(torch.autograd.Function):
    """The identity on a replicated input of sharded work; backward:
    ``AllReduce`` of the gradient (each rank's part of it is summed
    once)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return AllReduce.apply(grad, ctx.group), None


class ModelShard:
    """A rank's place in its mp group, and the collectives of the sharded
    backbones over it. Activations are task-folded ``(N, T*C, H, W)``; a
    sharded one holds this rank's block of each task's channels, ``(N,
    T*C/mp, H, W)``, so gathers and splits run per task."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def divides(self, width: int) -> bool:
        """Whether a layer of ``width`` output channels is sharded
        (``sharding.guard_divisible``); one that is not computes all of
        its channels on every rank."""
        return width % self.size == 0

    def block(self, width: int) -> tuple[int, int]:
        """``[lo, hi)`` of this rank's block of ``width`` channels."""
        block = width // self.size
        return self.index * block, (self.index + 1) * block

    def gather(self, x: torch.Tensor, tasks: int) -> torch.Tensor:
        """A sharded activation -> the whole one, for sharded work (each
        rank's gradient of it is a partial sum: ``AllGather``)."""
        n, _, *rest = x.shape
        full = AllGather.apply(x.reshape(n, tasks, -1, *rest), 2, self.group,
                               self.size, self.index)
        return full.reshape(n, -1, *rest)

    def gather_replicated(self, x: torch.Tensor, tasks: int) -> torch.Tensor:
        """A sharded activation -> the whole one, for replicated work: every
        rank's gradient of it is whole, so each keeps its own block's
        (the other blocks enter without a graph; each rank differentiates
        its own through the same replicated work)."""
        n, _, *rest = x.shape
        own = x.reshape(n, tasks, 1, -1, *rest)
        full = all_gather_cat(own, 2, self.group, self.size)
        full = torch.cat([full[:, :, :self.index], own, full[:, :, self.index + 1:]], 2)
        return full.reshape(n, -1, *rest)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering sharded work."""
        return CopyToShards.apply(x, self.group)

    def split(self, x: torch.Tensor, tasks: int) -> torch.Tensor:
        """This rank's block of each task's channels of a replicated
        activation ``(N, T*C, ...)``, entering sharded work."""
        n, _, *rest = x.shape
        per_task = self.copy(x).reshape(n, tasks, -1, *rest)
        lo, hi = self.block(per_task.shape[2])
        return per_task[:, :, lo:hi].reshape(n, -1, *rest)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of partial sums, for replicated work."""
        return AllReduce.apply(x, self.group)


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

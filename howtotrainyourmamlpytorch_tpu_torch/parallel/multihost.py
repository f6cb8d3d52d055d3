"""Cross-process fences and gathers for a multi-process run
(``howtotrainyourmamlpytorch_tpu/parallel/multihost.py``).

* :func:`barrier`: every rank blocks until all arrive; the fence of the
  single-writer checkpoints (rank 0 drains its writer, then all ranks
  barrier, then any may read). On gloo it is ``monitored_barrier`` with a
  timeout, so a dead peer raises, naming the rank, instead of parking.
* :func:`gather_global` / :func:`allgather_host`: a rank's shard of a
  result (a tensor, or a host array such as its slice of the episode
  targets) comes back as every rank's shards concatenated on axis 0, the
  same on every rank; the ensemble test scores global predictions against
  global targets with them.

JAX's ``process_local_put`` has no counterpart: it assembles one global
array from each host's shard, and here a rank only ever holds its own
shard (the learner reduces what crosses ranks).

Single-process inputs pass straight through, so callers need not check.
"""

from __future__ import annotations

import datetime

import numpy as np

#: Seconds a barrier waits for the slowest rank before it raises.
DEFAULT_BARRIER_TIMEOUT_S = 300.0


def is_multiprocess() -> bool:
    """Whether the process group spans more than one process."""
    from .distributed import process_count

    return process_count() > 1


def _backend() -> str:
    import torch.distributed as dist

    return dist.get_backend()


def barrier(tag: str, timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S) -> None:
    """Blocks until every rank reaches the barrier ``tag`` (no-op on one
    process); raises ``RuntimeError`` naming ``tag`` when a peer does not
    arrive within ``timeout_s``."""
    if not is_multiprocess():
        return
    import torch.distributed as dist

    try:
        if _backend() == "gloo":
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {tag!r} failed: {exc}") from exc


def _allgather(tensor, replicas: int = 1):
    import torch
    import torch.distributed as dist

    from .collectives import collective_counts

    tensor = tensor.detach().contiguous()
    if _backend() == "nccl":
        tensor = tensor.cuda()
    else:
        tensor = tensor.cpu()
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size())]
    collective_counts["all_gather"] += 1
    dist.all_gather(parts, tensor)
    return torch.cat(parts[::replicas]).cpu().numpy()


def gather_global(tensor, replicas: int = 1) -> np.ndarray:
    """This rank's shard of a task-split tensor -> every rank's shards
    concatenated on axis 0, as host numpy, identical on every rank. With
    ``replicas`` consecutive ranks holding the same shard (an mp group),
    one rank's of each."""
    if not is_multiprocess():
        return tensor.detach().cpu().numpy()
    return _allgather(tensor, replicas)


def allgather_host(array, replicas: int = 1) -> np.ndarray:
    """A host-local numpy shard -> every rank's shards concatenated on axis
    0, identical on every rank (the identity on one process); ``replicas``
    as in :func:`gather_global`."""
    if not is_multiprocess():
        return np.asarray(array)
    import torch

    return _allgather(torch.from_numpy(np.ascontiguousarray(array)), replicas)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (the identity on one
    process)."""
    if not is_multiprocess():
        return obj
    import torch.distributed as dist

    from .collectives import collective_counts

    box = [obj]
    collective_counts["broadcast_object"] += 1
    dist.broadcast_object_list(box, src=src)
    return box[0]

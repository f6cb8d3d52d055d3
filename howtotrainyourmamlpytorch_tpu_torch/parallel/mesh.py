"""The data-parallel layout: one rank per process, the task axis of the
meta-batch split over ranks (``howtotrainyourmamlpytorch_tpu/parallel/mesh.py``,
its dp half).

JAX builds a ``(dp, mp)`` device mesh inside one process and lets XLA
insert the outer-gradient all-reduce. Here the dp extent is the process
group's size: each rank adapts its own contiguous slice of the tasks
(``host_batch_bounds``) and the learner all-reduces the meta-gradient
(``parallel/collectives.py``). So JAX's in-process dp ladder (8 -> 4 -> 2
-> 1) is a process-count ladder here, and ``degraded_dp_extent`` and
``degraded_process_count`` are the same host arithmetic as JAX's.

A rank's device is ``cuda:<local rank mod device count>`` unless the caller
asks for the CPU; the backend is ``nccl`` when every rank of the host has a
card of its own, ``gloo`` when ranks share a card or run on the CPU
(NCCL refuses two ranks on one device). The tensor-parallel half
(``--model_parallel_devices > 1``) is ROADMAP A10.2 and raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_DATA_AXIS = "dp"
DEFAULT_MODEL_AXIS = "mp"

#: What the tensor-parallel half's refusals cite.
TENSOR_PARALLEL_ITEM = "ROADMAP item A10.2"


class Mesh(NamedTuple):
    """A data-parallel layout: the dp and mp extents, this process's rank
    and the group's size, and this rank's device."""

    dp: int
    mp: int
    rank: int
    world: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{"dp": dp, "mp": mp}``, JAX's ``mesh.shape``."""
        return {DEFAULT_DATA_AXIS: self.dp, DEFAULT_MODEL_AXIS: self.mp}


def choose_backend(world: int, device_count: int, cpu: bool = False) -> str:
    """``nccl`` when each of the ``world`` ranks (one host) has a card of its
    own, else ``gloo``."""
    if cpu or device_count < 1 or world > device_count:
        return "gloo"
    return "nccl"


def rank_device(rank: int, device=None) -> torch.device:
    """A rank's device: ``device`` when the caller names one with an index
    or the CPU, else ``cuda:<rank mod device count>`` (which raises where
    there is no card)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def refuse_tensor_parallel(model_parallel: int) -> None:
    if model_parallel < 1:
        raise ValueError(f"model_parallel_devices must be >= 1, got {model_parallel}")
    if model_parallel > 1:
        raise NotImplementedError(
            f"--model_parallel_devices {model_parallel}: the tensor-parallel "
            f"half (a convolution sharded over its channels under second-order "
            f"autograd) is {TENSOR_PARALLEL_ITEM}"
        )


def make_mesh(data_parallel: int | None = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The layout over the current process group: ``dp`` ranks (default:
    the group's size) of this process's device."""
    from .distributed import local_rank, process_count, process_index

    refuse_tensor_parallel(model_parallel)
    world = process_count()
    dp = world if data_parallel is None else int(data_parallel)
    if dp * model_parallel != world:
        raise ValueError(
            f"{dp} x {model_parallel} != {world} processes: the dp extent is "
            "the process count (--num_processes)"
        )
    return Mesh(dp=dp, mp=model_parallel, rank=process_index(), world=world,
                device=rank_device(local_rank(), device))


def host_batch_bounds(
    global_batch: int, process_index: int, process_count: int
) -> tuple[int, int]:
    """The ``[lo, hi)`` slice of the global meta-batch's task axis that rank
    ``process_index`` owns."""
    if global_batch % process_count != 0:
        raise ValueError(
            f"global meta-batch {global_batch} not divisible by "
            f"{process_count} processes — per-host data planes slice whole "
            "episodes"
        )
    per_host = global_batch // process_count
    return process_index * per_host, (process_index + 1) * per_host


def global_batch_of(args) -> int:
    """Episodes per meta-batch: ``num_of_gpus * batch_size *
    samples_per_iter`` (``data/loader.py``'s ``global_batch``)."""
    return (
        int(getattr(args, "num_of_gpus", 1))
        * int(args.batch_size)
        * int(getattr(args, "samples_per_iter", 1))
    )


def default_mesh_from_args(args, device=None) -> Mesh | None:
    """The layout of a command line: ``None`` on one process; else the dp
    layout over the process group, whose size must be the config's
    ``data_parallel_devices`` (0 fills it). ``data_parallel_devices`` N > 1
    without a group of N processes raises, naming ``--num_processes``. The
    global meta-batch must divide over the processes."""
    from .distributed import process_count

    mp = int(getattr(args, "model_parallel_devices", 1) or 1)
    refuse_tensor_parallel(mp)
    n = int(getattr(args, "data_parallel_devices", 0) or 0)
    world = process_count()
    if n <= 0:
        n = world
    if n != world:
        raise ValueError(
            f"data_parallel_devices {n} needs {n} processes, one rank each "
            f"(--num_processes {n} with --coordinator_address and --process_id, "
            f"or the dispatcher); this process group has {world}"
        )
    if n == 1:
        return None
    batch = global_batch_of(args)
    if batch % n != 0:
        raise ValueError(
            f"global meta-batch {batch} not divisible by {n} dp mesh devices"
        )
    host_batch_bounds(batch, 0, world)  # the divisibility guard
    return make_mesh(data_parallel=n, model_parallel=mp, device=device)


def degraded_dp_extent(
    dp: int, *, global_batch: int, task_chunk: int = 0
) -> int | None:
    """The next smaller viable dp extent after a hang: half-steps 8 -> 4 ->
    2 -> 1, skipping extents the global meta-batch cannot divide over or
    that an active ``task_chunk`` is not a multiple of; ``None`` when none
    is left."""
    n = int(dp) // 2
    while n >= 1:
        if global_batch % n == 0 and (task_chunk <= 0 or task_chunk % n == 0):
            return n
        n //= 2
    return None


def degraded_process_count(
    num_processes: int,
    *,
    global_batch: int,
    local_devices: int = 1,
    task_chunk: int = 0,
) -> int | None:
    """``degraded_dp_extent`` at host granularity, after a host loss: the
    next smaller process count whose dp extent (``n * local_devices``) and
    process count both divide the global meta-batch, honouring an active
    ``task_chunk``; ``None`` when none is left."""
    local = max(int(local_devices), 1)
    n = int(num_processes) // 2
    while n >= 1:
        dp = n * local
        if (
            global_batch % dp == 0
            and global_batch % n == 0
            and (task_chunk <= 0 or task_chunk % dp == 0)
        ):
            return n
        n //= 2
    return None

"""The ``(dp, mp)`` layout: one rank per process
(``howtotrainyourmamlpytorch_tpu/parallel/mesh.py``).

JAX builds a ``(dp, mp)`` device mesh inside one process and lets XLA
insert the collectives. Here a rank is a process, and a layout has
``world = dp x mp`` ranks:

* an mp group is ``mp`` consecutive ranks (one host's, as JAX's
  ``multihost_device_order`` keeps an mp group inside a host); rank ``r``
  has mp index ``r % mp`` and dp index ``r // mp``;
* the task axis of the meta-batch is split over the dp index only
  (``host_batch_bounds``): every rank of an mp group sees the same tasks
  and holds one contiguous channel block of each sharded leaf
  (``parallel/sharding.py``);
* the learner all-reduces the meta-gradient over the dp group, the ranks
  of one mp index (``parallel/collectives.py``), and the backbone's
  collectives run over the mp group.

JAX's in-process dp ladder (8 -> 4 -> 2 -> 1) is a process-count ladder
here, and ``degraded_dp_extent`` and ``degraded_process_count`` are the
same host arithmetic as JAX's.

A rank's device is ``cuda:<local rank mod device count>`` unless the caller
asks for the CPU; the backend is ``nccl`` when every rank of the host has a
card of its own, ``gloo`` when ranks share a card or run on the CPU
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

DEFAULT_DATA_AXIS = "dp"
DEFAULT_MODEL_AXIS = "mp"


class Mesh(NamedTuple):
    """A ``(dp, mp)`` layout: the extents, this process's rank and the
    group's size, this rank's device, and its two process groups: the dp
    group (the ranks of its mp index; ``None``, the whole group, when
    ``mp`` is 1) and the mp group (the ``mp`` consecutive ranks of its dp
    index; ``None`` when ``mp`` is 1)."""

    dp: int
    mp: int
    rank: int
    world: int
    device: torch.device
    dp_group: Any = None
    mp_group: Any = None

    @property
    def shape(self) -> dict:
        """``{"dp": dp, "mp": mp}``, JAX's ``mesh.shape``."""
        return {DEFAULT_DATA_AXIS: self.dp, DEFAULT_MODEL_AXIS: self.mp}

    @property
    def dp_index(self) -> int:
        """This rank's slice of the task axis."""
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        """This rank's channel block."""
        return self.rank % self.mp


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


def _process_groups(dp: int, mp: int, rank: int):
    """``(dp_group, mp_group)`` of ``rank``. ``torch.distributed.new_group``
    is collective: every rank makes every group, in the same order."""
    if mp == 1:
        return None, None
    import torch.distributed as dist

    dp_group = mp_group = None
    for d in range(dp):
        group = dist.new_group(list(range(d * mp, (d + 1) * mp)))
        if rank // mp == d:
            mp_group = group
    for m in range(mp):
        group = dist.new_group(list(range(m, dp * mp, mp)))
        if rank % mp == m:
            dp_group = group
    return dp_group, mp_group


def make_mesh(data_parallel: int | None = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The layout over the current process group: ``data_parallel`` x
    ``model_parallel`` ranks (dp default: the group's size over mp) of this
    process's device."""
    from .distributed import local_rank, process_count, process_index

    if model_parallel < 1:
        raise ValueError(f"model_parallel_devices must be >= 1, got {model_parallel}")
    world = process_count()
    dp = world // model_parallel if data_parallel is None else int(data_parallel)
    if dp * model_parallel != world:
        raise ValueError(
            f"{dp} x {model_parallel} != {world} processes: a layout of dp x mp "
            "ranks needs dp x mp processes (--num_processes)"
        )
    rank = process_index()
    dp_group, mp_group = _process_groups(dp, model_parallel, rank)
    return Mesh(dp=dp, mp=model_parallel, rank=rank, world=world,
                device=rank_device(local_rank(), device),
                dp_group=dp_group, mp_group=mp_group)


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
    """The layout of a command line (JAX's arithmetic and errors): ``None``
    on one process without tensor parallelism; else ``data_parallel_devices``
    x ``model_parallel_devices`` ranks over the process group (dp 0 fills
    it: the group's size over mp). ``mp < 1`` raises; an mp the group
    cannot hold raises "exceeds"; dp x mp must be the process count, and
    the error names ``--num_processes``. The global meta-batch must divide
    over dp."""
    from .distributed import process_count

    mp = int(getattr(args, "model_parallel_devices", 1) or 1)
    if mp < 1:
        raise ValueError(f"model_parallel_devices must be >= 1, got {mp}")
    n = int(getattr(args, "data_parallel_devices", 0) or 0)
    world = process_count()
    if n <= 0:
        n = world // mp
        if n < 1:
            raise ValueError(
                f"model_parallel_devices {mp} exceeds the {world} process(es) "
                f"of this group — no dp extent fits (--num_processes {mp} with "
                "--coordinator_address and --process_id, or the dispatcher)"
            )
    if n * mp != world:
        raise ValueError(
            f"data_parallel_devices {n} x model_parallel_devices {mp} needs "
            f"{n * mp} processes, one rank each (--num_processes {n * mp} with "
            "--coordinator_address and --process_id, or the dispatcher); this "
            f"process group has {world}"
        )
    if n * mp == 1:
        return None
    batch = global_batch_of(args)
    if batch % n != 0:
        raise ValueError(
            f"global meta-batch {batch} not divisible by {n} dp mesh devices"
        )
    host_batch_bounds(batch, 0, n)  # the divisibility guard
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


def param_shardings(mesh: Mesh, params: Any, shard_model: bool = False) -> Any:
    """The spec tree of backbone parameters: with ``shard_model`` the
    ``MP_STATE_RULES`` layout (conv filters over ``mp`` output channels, BN
    gamma/beta on their feature axis, the layer norm's weight/bias on their
    channel axis, the head row-parallel), non-divisible axes replicated;
    otherwise every leaf replicated (``parallel/sharding.py``)."""
    from .sharding import state_rules, tree_shardings

    return tree_shardings(mesh, params, state_rules(shard_model))

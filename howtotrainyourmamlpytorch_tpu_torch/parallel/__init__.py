"""Data- and tensor-parallel meta-training across processes
(``howtotrainyourmamlpytorch_tpu/parallel/``).

The reference trains with single-process ``nn.DataParallel``; the JAX
package shards the task axis of the meta-batch over a device mesh's
``dp`` axis and, optionally, the conv channels over its ``mp`` axis. Here
a rank is a process: a layout has ``dp x mp`` of them. Each mp group
adapts its own slice of the tasks, each rank of it holding one channel
block of every sharded leaf (``sharding.py``); the meta-gradient is
all-reduced over the dp group as one flat buffer per dtype.
"""

from .collectives import (
    BucketSpec,
    ModelShard,
    broadcast_tree,
    flatten_buckets,
    fused_psum,
    guard_task_chunk,
    per_leaf_psum,
    unflatten_buckets,
)
from .distributed import (
    DistributedInitError,
    find_free_port,
    initialize_distributed,
    initialize_distributed_from_argv,
    process_count,
    process_index,
)
from .mesh import (
    DEFAULT_DATA_AXIS,
    DEFAULT_MODEL_AXIS,
    Mesh,
    choose_backend,
    default_mesh_from_args,
    degraded_dp_extent,
    degraded_process_count,
    host_batch_bounds,
    make_mesh,
    param_shardings,
)
from .multihost import allgather_host, barrier, gather_global, is_multiprocess

__all__ = [
    "BucketSpec",
    "DEFAULT_DATA_AXIS",
    "DEFAULT_MODEL_AXIS",
    "DistributedInitError",
    "Mesh",
    "allgather_host",
    "barrier",
    "broadcast_tree",
    "choose_backend",
    "default_mesh_from_args",
    "degraded_dp_extent",
    "degraded_process_count",
    "find_free_port",
    "flatten_buckets",
    "fused_psum",
    "gather_global",
    "guard_task_chunk",
    "host_batch_bounds",
    "initialize_distributed",
    "initialize_distributed_from_argv",
    "is_multiprocess",
    "make_mesh",
    "ModelShard",
    "param_shardings",
    "per_leaf_psum",
    "process_count",
    "process_index",
    "unflatten_buckets",
]

"""The durable serving tier (``howtotrainyourmamlpytorch_tpu/serve/tier/``):
the crash-consistent artifact spill, the fenced executable cache (the
port's fused-norm kernel library) and the consistent-hash ring the pool
routes by. Each module's docstring states its contract."""

from .atomic import (
    ExecCacheStaleError,
    TierCorruptError,
    TierError,
    atomic_write_bytes,
    quarantine,
)
from .execcache import ExecutableCache, build_fence, serialization_available
from .ring import HashRing
from .spill import ArtifactSpill

__all__ = [
    "ArtifactSpill",
    "ExecCacheStaleError",
    "ExecutableCache",
    "HashRing",
    "TierCorruptError",
    "TierError",
    "atomic_write_bytes",
    "build_fence",
    "quarantine",
    "serialization_available",
]

"""Fused batch norm (batch statistics) + LeakyReLU: Hopper kernels, their
plain PyTorch version, and the autograd Function that joins them.

This replaces the three ops of the JAX package's
``howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py``, whose nine
Pallas kernel bodies (the kernel table in PERF.md) become four CUDA kernels
in ``csrc/fused_norm.cu``:

=====================  ==========================================  =========
kernel                 replaces (pallas_fused_norm.py)             bytes
=====================  ==========================================  =========
``bn_stats_act``       ``_fwd_kernel`` (:93),                      8·R·C
                       ``_stats_block_kernel`` (:183) +
                       ``_apply_block_kernel`` (:194)
``bn_stats``           ``_fwd_pool_kernel`` stats half (:147),     4·R·C
                       ``_stats_pool_block_kernel`` (:248)
``bn_act_bwd``         ``_bwd_kernel`` (:113),                     12·R·C
                       ``_bwd_stats_block_kernel`` (:206) +
                       ``_bwd_apply_block_kernel`` (:226)
``bn_act_pool_apply``  ``_fwd_pool_kernel`` apply half (:147),     5·R·C
                       ``_apply_pool_block_kernel`` (:267)
=====================  ==========================================  =========

R = N·H·W; the bytes are float32's, half of them in bfloat16. Each kernel
streams its tensors once at a few flops per element, so memory bandwidth
bounds it (3.35 TB/s on an H100 SXM); at the flagship shapes launch latency
dominates.

Element types. ``x``, ``y``, the cotangent and ``dx`` are float32 or
bfloat16 (the learner's compute dtype, as the Pallas bodies load any dtype
and store ``y`` and ``dx`` in the input's); the statistics, ``gamma``,
``beta``, ``dgamma`` and ``dbeta`` are float32 in both. Every kernel and
every plain version computes in float32 and rounds its full-size output
once; the any-order Functions' backward computes in float32 and returns
the cotangents in each input's dtype, as JAX's ``_stat_tangents`` and
``_norm_act_tangent`` do (:606-658). Any other dtype raises. ``bn_stats``, ``bn_stats_act``
and ``bn_act_bwd`` share one design: a grid over channels, each channel
reduced by a thread-block cluster that stages it in shared memory (x, and
for the backward the cotangent too) and adds its blocks' partial sums
through distributed shared memory in rank order, in one launch. :func:`_plan`
picks the cluster size, the channels per block and the staged or streamed
path from the shape, the staged bytes a row and the device. The CUDA
source says what the design does about the launch floor and the re-read,
how the reductions stay deterministic (no float atomics), and which
variance formula each path uses (two-pass staged, shifted single pass
streamed).

Three entry points, one per JAX op:

- ``fused_bn_leaky_relu`` (``custom_vjp``, :555): one reverse level, the
  eval path. A CPU tensor runs the plain version differentiated by
  autograd; a CUDA tensor runs ``FusedBNLeakyReLU`` (``bn_stats_act``
  forward, ``bn_act_bwd`` backward).
- ``fused_bn_leaky_relu_ho`` (recursive ``custom_jvp``, :633): any order,
  the train path. ``FusedBNLeakyReLUHO`` runs ``bn_stats_act`` forward;
  its backward is differentiable torch ops, as the JAX op's tangents are
  lax.
- ``fused_bn_leaky_relu_pool`` (``custom_jvp``, :666): the same with the
  2x2 max pool fused in, ``bn_stats`` + K5 forward (``FusedBNLeakyReLUPool``).

The two any-order Functions save their ``mean``/``var`` outputs and read
them in the backward, so a second differentiation routes the statistics'
cotangents back through the same backward: the torch form of the JAX op's
recursion (its primal re-enters the op, :652). For a CPU tensor they run
the plain bodies in place of the kernels, so the CPU tests exercise their
autograd structure; any other device than the CPU or CUDA raises. There is
no fallback from one to the other. Each kernel wrapper counts its launches
in ``launch_counts``: one device launch per call.

The library is built with ``nvcc`` on first use into ``_build/`` next to the
package (listed in ``.gitignore``), keyed by a hash of the source and the
flags, and loaded with ``ctypes``; a serving engine with a durable tier
loads it from its executable cache instead (``serve/tier/execcache.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-5
SLOPE = 0.01

KERNELS = ("bn_stats", "bn_stats_act", "bn_act_bwd", "bn_act_pool_apply")

#: Launches per kernel since the last ``reset_launch_counts``. Only the
#: kernel wrappers below add to it, once per call of their C entry; every
#: entry is one device launch.
launch_counts: dict[str, int] = dict.fromkeys(KERNELS, 0)

#: Every ``(shape, slope)`` each kernel launched at in this process, with
#: ``"bfloat16"`` after them for a bfloat16 input (``slope`` is None for
#: ``bn_stats``); cleared by ``reset_launch_shapes``. A serving worker
#: started with ``--debug_kernels`` reports it on ``GET /debug/kernels``,
#: so a script can check that every shape a worker ran was held to the
#: plain version.
launch_shapes: dict[str, set] = {name: set() for name in KERNELS}

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "fused_norm.cu")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def reset_launch_shapes() -> None:
    for shapes in launch_shapes.values():
        shapes.clear()


def launch_record() -> dict:
    """The launch counts and shapes, JSON-ready (shapes as lists)."""
    return {"launches": dict(launch_counts),
            "shapes": {name: sorted(keys, key=repr) for name, keys in launch_shapes.items()}}


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def _wide(t):
    """``t`` widened to float32 where it is bfloat16; float32 (and the
    float64 of the gradient checks) as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def plain_stats(x):
    """Per-channel mean and biased variance over (N, H, W), two-pass, in
    float32 for a bfloat16 ``x``."""
    x = _wide(x)
    mean = x.mean(dim=(0, 2, 3))
    var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    return mean, var


def _xhat_pre(x, mean, var, gamma, beta, eps):
    """x-hat, the pre-activation and rsqrt(var + eps), in float32 for a
    bfloat16 ``x``."""
    b = lambda a: a[None, :, None, None]  # noqa: E731
    x = _wide(x)
    inv = torch.rsqrt(var + eps)
    xhat = (x - b(mean)) * b(inv)
    return xhat, xhat * b(gamma) + b(beta), inv


def plain_apply(x, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """LeakyReLU((x - mean) * rsqrt(var + eps) * gamma + beta), with the
    positive branch at ``pre >= 0`` (``F.leaky_relu``'s backward takes the
    slope branch at 0, so it is not used). Computed in float32, rounded
    once to ``x``'s dtype."""
    _, pre, _ = _xhat_pre(x, mean, var, gamma, beta, eps)
    return torch.where(pre >= 0, pre, slope * pre).to(x.dtype)


def plain_bwd_reduce(x, g, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """``(dgamma, dbeta)`` = per-channel (sum dpre * xhat, sum dpre), in
    float32."""
    xhat, pre, _ = _xhat_pre(x, mean, var, gamma, beta, eps)
    g = _wide(g)
    dpre = torch.where(pre >= 0, g, slope * g)
    return (dpre * xhat).sum(dim=(0, 2, 3)), dpre.sum(dim=(0, 2, 3))


def plain_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta, eps=EPS,
                    slope=SLOPE):
    """dx of the batch-statistics norm + LeakyReLU, from the reduce totals;
    computed in float32, rounded once to ``x``'s dtype."""
    b = lambda a: a[None, :, None, None]  # noqa: E731
    xhat, pre, inv = _xhat_pre(x, mean, var, gamma, beta, eps)
    g = _wide(g)
    dpre = torch.where(pre >= 0, g, slope * g)
    inv_n = 1.0 / (x.shape[0] * x.shape[2] * x.shape[3])
    ga = b(gamma)
    return (b(inv) * (
        dpre * ga - inv_n * ga * b(dbeta) - xhat * inv_n * ga * b(dgamma)
    )).to(x.dtype)


def plain_bwd(x, g, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """``(dx, dgamma, dbeta)`` of the batch-statistics norm + LeakyReLU:
    ``plain_bwd_reduce``, then ``plain_bwd_apply`` with its totals."""
    dgamma, dbeta = plain_bwd_reduce(x, g, mean, var, gamma, beta, eps, slope)
    dx = plain_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta, eps, slope)
    return dx, dgamma, dbeta


def _pool_views(x):
    """The four strided views partitioning the 2x2/2 windows, in the JAX
    op's order (``pallas_fused_norm.py:540-547``)."""
    return (
        x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2],
        x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2],
    )


def plain_pool_apply(x, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """``plain_apply`` followed by the 2x2/2 max pool, as the max over the
    four views: ``(N, C, H/2, W/2)``. Rounding is monotone, so the max of
    the rounded views is the rounded max."""
    views = _pool_views(plain_apply(x, mean, var, gamma, beta, eps, slope))
    return functools.reduce(torch.maximum, views)


def fused_bn_leaky_relu_reference(x, gamma, beta, eps=EPS, slope=SLOPE):
    """The plain version of the whole op, differentiated by autograd:
    ``(y, mean, var)`` with ``mean``/``var`` detached, as the kernels'
    Function marks them non-differentiable. ``x`` is widened to float32
    once, so that its gradient is summed in float32 and rounded once, as
    the backward kernel's."""
    xf = _wide(x)
    mean, var = plain_stats(xf)
    y = plain_apply(xf, mean, var, gamma, beta, eps, slope).to(x.dtype)
    return y, mean.detach(), var.detach()


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the fused-norm kernels cannot be built"
    )


def library_digest() -> str:
    """sha256 of the kernel source and the nvcc flags: the library's
    identity (its file name under ``_build/`` and its key in the serving
    tier's executable cache)."""
    with open(SOURCE, "rb") as f:
        return hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"fused_norm_{library_digest()[:16]}.so")


#: nvcc runs in this process and their seconds; and where the loaded
#: library came from (``"nvcc"``, ``"build_dir"`` or ``"exec_cache"``).
build_stats = {"nvcc_builds": 0, "nvcc_s": 0.0, "library_source": None}


def build(fresh: bool = False) -> tuple[str, float, str]:
    """Compiles ``csrc/fused_norm.cu`` unless this source's library exists
    (``fresh`` compiles it anyway and replaces it). Returns ``(path,
    seconds, compiler output)``; raises if nvcc fails."""
    path = library_path()
    if os.path.exists(path) and not fresh:
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, path)
    build_stats["nvcc_builds"] += 1
    build_stats["nvcc_s"] += seconds
    return path, seconds, proc.stdout + proc.stderr


def dlopen_bytes(payload: bytes) -> ctypes.CDLL:
    """Loads a shared library from its bytes through an anonymous memory
    file, so the bytes loaded are the bytes the caller verified."""
    fd = os.memfd_create("fused_norm.so")
    try:
        os.write(fd, payload)
        return ctypes.CDLL(f"/proc/self/fd/{fd}")
    finally:
        os.close(fd)


def load_library(payload: bytes | None = None) -> str:
    """Loads the kernel library into this process: from ``payload`` (the
    verified bytes of the serving tier's executable cache) or, with none,
    from ``build()``. Returns where the loaded library came from; a
    library loaded before stays (same source digest, same kernels). A
    library that does not load raises: nothing falls back."""
    global _lib
    with _lib_lock:
        if _lib is None:
            if payload is not None:
                lib, source = dlopen_bytes(payload), "exec_cache"
            else:
                before = build_stats["nvcc_builds"]
                lib = ctypes.CDLL(build()[0])
                source = "nvcc" if build_stats["nvcc_builds"] > before else "build_dir"
            _bind(lib)
            _lib = lib
            build_stats["library_source"] = source
        return build_stats["library_source"]


def _load():
    if _lib is None:
        load_library()
    return _lib


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [i, i, i, i, i, i]  # cluster, cpb, staged, threads, blocks, smem
    signatures = {
        "bn_fwd_setup": [p, p],
        "bn_fwd_active_clusters": [i, i, i, i, p],
    }
    for suffix in _SUFFIX.values():
        signatures.update({
            f"bn_stats{suffix}": [p, p, p, i, i, i, *plan, p],
            f"bn_stats_act{suffix}": [p, p, p, p, p, p, i, i, i, f, f, *plan, p],
            f"bn_act_bwd{suffix}": [p, p, p, p, p, p, p, p, p, i, i, i, f, f,
                                    *plan, p],
            f"bn_act_pool_apply{suffix}": [p, p, p, p, p, p, i, i, i, i, f, f,
                                           i, p],
        })
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


#: The element types of x, y, the cotangent and dx, and each one's suffix
#: of the C entries.
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check(x, *vecs):
    if x.device.type != "cuda":
        raise ValueError(f"fused-norm kernels take CUDA tensors, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(
            f"fused-norm kernels take float32 or bfloat16, got {x.dtype}"
        )
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(
            f"fused-norm kernels take a non-empty contiguous NCHW tensor, got "
            f"shape {tuple(x.shape)}, contiguous={x.is_contiguous()}"
        )
    c = x.shape[1]
    for v in vecs:
        if (
            v.device != x.device or v.dtype != torch.float32
            or v.shape != (c,) or not v.is_contiguous()
        ):
            raise ValueError(
                f"per-channel operand must be contiguous float32 ({c},) on "
                f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}"
            )


def _check_like(g, x):
    _check(g)
    if g.shape != x.shape or g.device != x.device or g.dtype != x.dtype:
        raise ValueError(
            f"cotangent {g.dtype} {tuple(g.shape)} on {g.device} does not "
            f"match the input {x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _launch(name, x, *args, slope=None):
    """One launch of kernel ``name`` on ``x``'s element type."""
    symbol = name + _SUFFIX[x.dtype]
    rc = getattr(_load(), symbol)(*args)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
    launch_counts[name] += 1
    key = (tuple(x.shape), slope)
    launch_shapes[name].add(key + ("bfloat16",) if x.dtype == torch.bfloat16 else key)


def _dims(x):
    n, c, h, w = x.shape
    return n, c, h * w


def _elementwise_blocks(x) -> int:
    return max(1, min(-(-x.numel() // 256), 8 * _limits(x.device)[0]))


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# The launch plan of the cluster kernels
# ---------------------------------------------------------------------------

#: Cluster sizes the plan takes; 16 is non-portable (opted into at load).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: A channel of at most this many rows (N·H·W) is taken by one warp.
WARP_ROWS = 2048
#: Staged bytes per block the plan aims under, so that two blocks share an
#: SM and one loads while the other reduces.
BLOCK_SLICE_BYTES = 96 * 1024
FWD_THREADS = 256
#: Shared-memory bytes a staged row takes: x for the forward, x and the
#: cotangent for the backward, staged as float32 whatever the element type
#: (a bfloat16 element is widened as it is staged).
FWD_ROW_BYTES, BWD_ROW_BYTES = 4, 8
#: The planned kernels, numbered as ``bn_fwd_active_clusters`` takes them
#: on float32; their bfloat16 instances follow, ``len(_PLANNED)`` on.
_PLANNED = {"bn_stats": 0, "bn_stats_act": 1, "bn_act_bwd": 2}


class Plan(NamedTuple):
    """How one launch of a cluster kernel covers an ``(N, C, H, W)`` tensor.

    ``cluster`` blocks reduce one channel (``channels_per_block`` is then
    1), or, with ``cluster`` 1, each warp of a block of
    ``channels_per_block`` warps takes a channel. ``staged``: each block
    holds its slice of the channel in ``smem_bytes`` of shared memory;
    otherwise it streams its slice from device memory twice."""

    cluster: int
    channels_per_block: int
    staged: bool
    smem_bytes: int
    threads: int
    blocks: int


def _slice_floats(rows: int, cluster: int) -> int:
    """Rows of a channel per block, rounded up to 4 (the kernel's ``per``)."""
    return (-(-rows // cluster) + 3) // 4 * 4


def _staged_plan(shape, cluster: int, row_bytes: int = FWD_ROW_BYTES) -> Plan:
    """The staged plan of ``cluster`` blocks a channel, one channel a block,
    ``row_bytes`` of shared memory a row."""
    n, c, h, w = shape
    return Plan(cluster, 1, True, row_bytes * _slice_floats(n * h * w, cluster),
                FWD_THREADS, c * cluster)


def _plan(shape, sm_count: int, max_smem: int, row_bytes: int = FWD_ROW_BYTES,
          max_cluster: int = 16, streamed: bool = False) -> Plan:
    """The launch plan of a cluster kernel for ``shape``: ``bn_stats`` and
    ``bn_stats_act`` stage ``FWD_ROW_BYTES`` a row, ``bn_act_bwd``
    ``BWD_ROW_BYTES``.

    ``max_smem`` is the dynamic shared memory a block may take and
    ``max_cluster`` the largest cluster the card can hold at that size.
    ``streamed=True`` forces the streamed path (for tests). A channel of at
    most ``WARP_ROWS`` rows goes to a warp, ``min(8, C // sm_count)``
    channels to a block. A larger one is staged by the smallest cluster up
    to ``max_cluster`` whose slices fit ``BLOCK_SLICE_BYTES``, else by the
    smallest whose slices fit ``max_smem``: the backward at (25, 96, 84, 84)
    takes 16 blocks of 88 KB, which an H100 ran 10% faster than 8 of 176 KB
    (PERF.md), and the forward's north-star target stage (75, 96, 84, 84),
    2.1 MB a channel, 16 blocks of 129 KB, which keeps x read once, where
    the streamed path would read it twice. Past that it streams (the
    backward at that stage: 4.2 MB a channel), with enough clusters for two
    blocks per SM where the channels allow."""
    n, c, h, w = shape
    rows = n * h * w
    if rows <= WARP_ROWS and not streamed:
        cpb = max(1, min(8, c // sm_count))
        return Plan(1, cpb, True, row_bytes * cpb * _slice_floats(rows, 1),
                    32 * cpb, -(-c // cpb))
    if not streamed:
        sizes = [k for k in CLUSTER_SIZES if k <= max_cluster]
        for limit in (min(BLOCK_SLICE_BYTES, max_smem), max_smem):
            for k in sizes:
                plan = _staged_plan(shape, k, row_bytes)
                if plan.smem_bytes <= limit:
                    return plan
    k = next((k for k in CLUSTER_SIZES[:4] if c * k >= 2 * sm_count), 8)
    return Plan(k, 1, False, 0, FWD_THREADS, c * k)


_device_limits: dict[int, tuple[int, int]] = {}
_checked_plans: dict[tuple, int] = {}
_plans: dict[tuple, Plan] = {}


def _limits(device) -> tuple[int, int]:
    """``(sm_count, max dynamic shared memory)`` of the card, from the
    library's one-time set-up, which also sets the planned kernels'
    attributes."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _device_limits:
        sm, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            rc = _load().bn_fwd_setup(ctypes.byref(sm), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"bn_fwd_setup failed: cudaError {rc}")
        _device_limits[index] = (sm.value, smem.value)
    return _device_limits[index]


def _active_clusters(device, plan: Plan, name: str,
                     dtype=torch.float32) -> int:
    """Clusters of ``plan`` the card holds at once for kernel ``name`` on
    ``dtype``, asked once per plan."""
    key = (device.index, plan, name, dtype)
    if key not in _checked_plans:
        _limits(device)  # the kernels' attributes are set before the query
        active = ctypes.c_int()
        kernel = _PLANNED[name] + (len(_PLANNED) if dtype == torch.bfloat16 else 0)
        with torch.cuda.device(device):
            rc = _load().bn_fwd_active_clusters(
                kernel, plan.cluster, plan.threads, plan.smem_bytes,
                ctypes.byref(active),
            )
        if rc != 0:
            raise RuntimeError(
                f"bn_fwd_active_clusters failed for {name} {plan}: cudaError {rc}"
            )
        _checked_plans[key] = active.value
    return _checked_plans[key]


def _card_plan(x, streamed: bool, names: tuple[str, ...], row_bytes: int) -> Plan:
    """``_plan`` on this card's limits for CUDA tensor ``x``, with a
    16-block cluster only where the card holds one of each kernel of
    ``names`` on ``x``'s element type at its shared memory, checked once per
    shape and type."""
    key = (x.device.index, tuple(x.shape), streamed, row_bytes, x.dtype)
    plan = _plans.get(key)
    if plan is None:
        sm, smem = _limits(x.device)
        plan = _plan(x.shape, sm, smem, row_bytes, 16, streamed)
        if plan.cluster == 16 and min(
            _active_clusters(x.device, plan, n, x.dtype) for n in names
        ) == 0:
            plan = _plan(x.shape, sm, smem, row_bytes, 8, streamed)
        _plans[key] = plan
    return plan


def fwd_plan(x, streamed: bool = False) -> Plan:
    """The plan ``bn_stats`` and ``bn_stats_act`` take for ``x``: one plan,
    so that both give the same statistics."""
    return _card_plan(x, streamed, ("bn_stats", "bn_stats_act"), FWD_ROW_BYTES)


def bwd_plan(x, streamed: bool = False) -> Plan:
    """The plan ``bn_act_bwd`` takes for ``x``."""
    return _card_plan(x, streamed, ("bn_act_bwd",), BWD_ROW_BYTES)


def _check_plan(name, x, plan, row_bytes):
    n, c, hw = _dims(x)
    if n * hw >= 2**31:
        raise ValueError(f"{name}: a channel of {n * hw} elements exceeds int32")
    k, cpb = plan.cluster, plan.channels_per_block
    staged = row_bytes * cpb * _slice_floats(n * hw, k)
    if (
        k not in CLUSTER_SIZES or (k > 1 and cpb != 1)
        or plan.threads % (32 * cpb) or plan.threads > FWD_THREADS
        or plan.blocks != (c * k if k > 1 else -(-c // cpb))
        or (plan.staged and plan.smem_bytes < staged)
    ):
        raise ValueError(f"{name}: {plan} does not cover {tuple(x.shape)}")
    if _active_clusters(x.device, plan, name, x.dtype) == 0:
        raise RuntimeError(f"{name}: the card holds no cluster of {plan}")


def _plan_args(plan):
    return (plan.cluster, plan.channels_per_block, int(plan.staged),
            plan.threads, plan.blocks, plan.smem_bytes)


def bn_stats(x, plan: Plan | None = None):
    """Per-channel ``(mean, biased var)`` of NCHW ``x``: one launch of the
    forward template without the apply. ``plan`` overrides
    :func:`fwd_plan` (tests force the streamed path with it)."""
    _check(x)
    n, c, hw = _dims(x)
    plan = plan or fwd_plan(x)
    _check_plan("bn_stats", x, plan, FWD_ROW_BYTES)
    mean = torch.empty(c, device=x.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        _launch("bn_stats", x, _ptr(x), _ptr(mean), _ptr(var), n, c, hw,
                *_plan_args(plan), _stream(x))
    return mean, var


def bn_stats_act(x, gamma, beta, eps=EPS, slope=SLOPE, plan: Plan | None = None):
    """``(y, mean, var)`` in one launch: ``bn_stats``'s statistics, bitwise,
    and ``plain_apply`` with them."""
    _check(x, gamma, beta)
    n, c, hw = _dims(x)
    plan = plan or fwd_plan(x)
    _check_plan("bn_stats_act", x, plan, FWD_ROW_BYTES)
    y = torch.empty_like(x)
    mean = torch.empty(c, device=x.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        _launch("bn_stats_act", x, _ptr(x), _ptr(gamma), _ptr(beta), _ptr(y),
                _ptr(mean), _ptr(var), n, c, hw, eps, slope,
                *_plan_args(plan), _stream(x), slope=slope)
    return y, mean, var


def bn_act_bwd(x, g, mean, var, gamma, beta, eps=EPS, slope=SLOPE,
               plan: Plan | None = None):
    """``plain_bwd`` on the card -> ``(dx, dgamma, dbeta)``, in one launch.
    ``g`` is the cotangent of ``y``; ``mean``/``var`` the forward's
    statistics. ``plan`` overrides :func:`bwd_plan`."""
    _check(x, mean, var, gamma, beta)
    _check_like(g, x)
    n, c, hw = _dims(x)
    plan = plan or bwd_plan(x)
    _check_plan("bn_act_bwd", x, plan, BWD_ROW_BYTES)
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, device=x.device, dtype=torch.float32)
    dbeta = torch.empty_like(dgamma)
    with torch.cuda.device(x.device):
        _launch("bn_act_bwd", x, _ptr(x), _ptr(g), _ptr(mean), _ptr(var),
                _ptr(gamma), _ptr(beta), _ptr(dx), _ptr(dgamma), _ptr(dbeta),
                n, c, hw, eps, slope, *_plan_args(plan), _stream(x), slope=slope)
    return dx, dgamma, dbeta


def _check_even(x):
    h, w = x.shape[2:]
    if h % 2 or w % 2:
        raise ValueError(
            f"the pooled fused norm needs even H, W (got {h}x{w}); use "
            "fused_bn_leaky_relu_ho + max_pool2d for odd stages"
        )


def bn_act_pool_apply(x, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """Kernel K5: ``plain_pool_apply`` on the card -> ``(N, C, H/2, W/2)``."""
    _check(x, mean, var, gamma, beta)
    _check_even(x)
    pair = 2 * x.element_size()
    if x.data_ptr() % pair:
        raise ValueError(f"bn_act_pool_apply reads pairs: x must be "
                         f"{pair}-byte aligned")
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // 2, w // 2), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        _launch("bn_act_pool_apply", x, _ptr(x), _ptr(mean), _ptr(var),
                _ptr(gamma), _ptr(beta), _ptr(y), n, c, h, w, eps, slope,
                _elementwise_blocks(y), _stream(x), slope=slope)
    return y


class FusedBNLeakyReLU(torch.autograd.Function):
    """``bn_stats_act`` forward, ``bn_act_bwd`` backward. One level of
    reverse mode, the contract of the JAX ``custom_vjp``; the batch
    statistics are outputs without gradient, as ``_fused_vjp_bwd`` drops
    their cotangents."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope):
        y, mean, var = bn_stats_act(x, gamma, beta, eps, slope)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.slope = eps, slope
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = bn_act_bwd(
            x, gy.contiguous(), mean, var, gamma, beta, ctx.eps, ctx.slope
        )
        return dx, dgamma, dbeta, None, None


def fused_bn_leaky_relu(x, gamma, beta, eps=EPS, slope=SLOPE):
    """``leaky_relu(batch_norm(x) * gamma + beta)`` and the batch statistics.

    ``x``: ``(N, C, H, W)``; ``gamma``/``beta``: ``(C,)`` (per-step row
    already selected). Returns ``(y, mean, var)`` with ``var`` biased.
    A CPU tensor takes the plain version; a CUDA tensor the kernels."""
    if x.device.type == "cpu":
        return fused_bn_leaky_relu_reference(x, gamma, beta, eps, slope)
    return FusedBNLeakyReLU.apply(x, gamma, beta, eps, slope)


# ---------------------------------------------------------------------------
# Any-order Functions (the train path)
# ---------------------------------------------------------------------------


def _stats(x):
    """``bn_stats`` on the card; the plain statistics for a CPU tensor only."""
    return plain_stats(x) if x.device.type == "cpu" else bn_stats(x)


def _first_max_route(y, gyp):
    """Sends each pooled cotangent to the first maximum of its 2x2 window
    of ``y``, in the view order of :func:`_pool_views` (row-major), and
    zero elsewhere: the JAX op's tangent selection (:712-718) transposed."""
    n, c, h, w = y.shape
    windows = (
        y.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
        .reshape(n, c, h // 2, w // 2, 4)
    )
    # argmax returns the first maximal index. (A cumsum over the 4-wide
    # axis took 60 ms of device time per flagship train step on an H100.)
    first = windows.argmax(dim=-1, keepdim=True)
    lanes = torch.arange(4, device=y.device)
    g = torch.where(lanes == first, gyp[..., None], 0.0)
    return (
        g.reshape(n, c, h // 2, w // 2, 2, 2).permute(0, 1, 2, 4, 3, 5)
        .reshape(n, c, h, w)
    )


def _norm_act_vjp(x, gamma, beta, mean, var, gy, gmean, gvar, eps, slope,
                  pooled):
    """``(dx, dgamma, dbeta)`` of ``(y, mean, var)`` in differentiable torch
    ops: the transpose of the JAX op's tangents (``_stat_tangents`` and
    ``_norm_act_tangent``, :606-630). The LeakyReLU mask (and, when
    ``pooled``, each window's winner) comes from the pre-activation
    recomputed here, as JAX takes it from its lax recomputation.

    ``mean``/``var`` are the Function's own outputs: differentiating this
    again sends their cotangents back through the Function, which is how
    the second derivative sees the statistics' dependence on ``x``.

    Computed in float32 for bfloat16 ``x`` and ``gy`` (widened; other
    dtypes as they are); ``dx`` is returned in ``x``'s dtype."""
    b = lambda a: a[None, :, None, None]  # noqa: E731
    dims = (0, 2, 3)
    in_dtype = x.dtype
    x, gy = _wide(x), _wide(gy)
    n = x.numel() // x.shape[1]
    xc = x - b(mean)
    inv = torch.rsqrt(var + eps)
    xhat = xc * b(inv)
    pre = xhat * b(gamma) + b(beta)
    pos = pre >= 0
    if pooled:
        gy = _first_max_route(torch.where(pos, pre, slope * pre).detach(), gy)
    dpre = torch.where(pos, gy, slope * gy)
    dgamma = (dpre * xhat).sum(dims)
    dbeta = dpre.sum(dims)
    dxhat = dpre * b(gamma)
    # Cotangents of the statistics: from y through x-hat, plus their own.
    gmean = gmean - dxhat.sum(dims) * inv
    gvar = gvar - 0.5 * inv * inv * inv * (dxhat * xc).sum(dims)
    dx = dxhat * b(inv) + b(gmean / n) + xc * b(gvar * (2.0 / n))
    return dx.to(in_dtype), dgamma, dbeta


class FusedBNLeakyReLUHO(torch.autograd.Function):
    """``bn_stats_act`` forward, differentiable to any order: the counterpart of
    ``fused_bn_leaky_relu_ho`` (``pallas_fused_norm.py:633-658``). ``mean``
    and ``var`` are differentiable outputs, as they carry tangents there."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope):
        if x.device.type == "cpu":
            mean, var = plain_stats(x)
            y = plain_apply(x, mean, var, gamma, beta, eps, slope)
        else:
            y, mean, var = bn_stats_act(x, gamma, beta, eps, slope)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.slope = eps, slope
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        return (*_norm_act_vjp(x, gamma, beta, mean, var, gy, gmean, gvar,
                               ctx.eps, ctx.slope, pooled=False), None, None)


class FusedBNLeakyReLUPool(torch.autograd.Function):
    """``bn_stats`` over the whole pre-pool ``x`` + K5 forward, differentiable to any
    order: the counterpart of ``fused_bn_leaky_relu_pool``
    (``pallas_fused_norm.py:666-719``). H and W must be even."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope):
        _check_even(x)
        mean, var = _stats(x)
        if x.device.type == "cpu":
            y = plain_pool_apply(x, mean, var, gamma, beta, eps, slope)
        else:
            y = bn_act_pool_apply(x, mean, var, gamma, beta, eps, slope)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.slope = eps, slope
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        return (*_norm_act_vjp(x, gamma, beta, mean, var, gy, gmean, gvar,
                               ctx.eps, ctx.slope, pooled=True), None, None)


def fused_bn_leaky_relu_ho(x, gamma, beta, eps=EPS, slope=SLOPE):
    """``fused_bn_leaky_relu``'s any-order twin: the same ``(y, mean,
    var)``, differentiable under ``create_graph=True`` and again."""
    return FusedBNLeakyReLUHO.apply(x, gamma, beta, eps, slope)


def fused_bn_leaky_relu_pool(x, gamma, beta, eps=EPS, slope=SLOPE):
    """``max_pool2d(leaky_relu(bn(x) * gamma + beta), 2, 2)`` and the batch
    statistics of the whole ``x``; any order. Needs even H and W: floor-mode
    pooling drops an odd trailing row or column that the statistics still
    cover, so odd stages take the ``_ho`` op and a separate pool."""
    return FusedBNLeakyReLUPool.apply(x, gamma, beta, eps, slope)

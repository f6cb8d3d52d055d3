"""Fused batch norm (batch statistics) + LeakyReLU: Hopper kernels, their
plain PyTorch version, and the autograd Function that joins them.

This replaces the three ops of the JAX package's
``howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py``, whose nine
Pallas kernel bodies (the kernel table in PERF.md) become five CUDA kernels
in ``csrc/fused_norm.cu``:

=====================  ==========================================  =========
kernel                 replaces (pallas_fused_norm.py)             bytes
=====================  ==========================================  =========
``bn_stats``           ``_fwd_kernel`` stats half (:93),           4·R·C
                       ``_stats_block_kernel`` (:183),
                       ``_fwd_pool_kernel`` stats half (:147),
                       ``_stats_pool_block_kernel`` (:248)
``bn_act_apply``       ``_fwd_kernel`` apply half (:93),           8·R·C
                       ``_apply_block_kernel`` (:194)
``bn_act_bwd_reduce``  ``_bwd_kernel`` reduce half (:113),         8·R·C
                       ``_bwd_stats_block_kernel`` (:206)
``bn_act_bwd_apply``   ``_bwd_kernel`` apply half (:113),          12·R·C
                       ``_bwd_apply_block_kernel`` (:226)
``bn_act_pool_apply``  ``_fwd_pool_kernel`` apply half (:147),     5·R·C
                       ``_apply_pool_block_kernel`` (:267)
=====================  ==========================================  =========

R = N·H·W, float32. Each kernel streams its tensors once at a few flops per
element, so memory bandwidth bounds it (3.35 TB/s on an H100 SXM); at the
flagship shapes launch latency dominates. The CUDA source says what the
design does about both, how its reductions stay deterministic (no float
atomics: per-channel partials and a fixed-order second pass), and which
variance formula it uses (a shifted single pass).

Three entry points, one per JAX op:

- ``fused_bn_leaky_relu`` (``custom_vjp``, :555): one reverse level, the
  eval path. A CPU tensor runs the plain version differentiated by
  autograd; a CUDA tensor runs ``FusedBNLeakyReLU`` (K1 + K2 forward, K3 +
  K4 backward).
- ``fused_bn_leaky_relu_ho`` (recursive ``custom_jvp``, :633): any order,
  the train path. ``FusedBNLeakyReLUHO`` runs K1 + K2 forward; its backward
  is differentiable torch ops, as the JAX op's tangents are lax.
- ``fused_bn_leaky_relu_pool`` (``custom_jvp``, :666): the same with the
  2x2 max pool fused in, K1 + K5 forward (``FusedBNLeakyReLUPool``).

The two any-order Functions save their ``mean``/``var`` outputs and read
them in the backward, so a second differentiation routes the statistics'
cotangents back through the same backward: the torch form of the JAX op's
recursion (its primal re-enters the op, :652). For a CPU tensor they run
the plain bodies in place of the kernels, so the CPU tests exercise their
autograd structure; any other device than the CPU or CUDA raises. There is
no fallback from one to the other. Each kernel wrapper counts its launches
in ``launch_counts``.

The library is built with ``nvcc`` on first use into ``_build/`` next to the
package (listed in ``.gitignore``), keyed by a hash of the source and the
flags, and loaded with ``ctypes``.
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

import torch
from torch.autograd.function import once_differentiable

EPS = 1e-5
SLOPE = 0.01

KERNELS = (
    "bn_stats", "bn_act_apply", "bn_act_bwd_reduce", "bn_act_bwd_apply",
    "bn_act_pool_apply",
)

#: Launches per kernel since the last ``reset_launch_counts``. Only the
#: kernel wrappers below add to it, once per launch of their C entry.
launch_counts: dict[str, int] = dict.fromkeys(KERNELS, 0)

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


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the yardstick the kernels are held to)
# ---------------------------------------------------------------------------


def plain_stats(x):
    """Per-channel mean and biased variance over (N, H, W), two-pass."""
    mean = x.mean(dim=(0, 2, 3))
    var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    return mean, var


def _xhat_pre(x, mean, var, gamma, beta, eps):
    b = lambda a: a[None, :, None, None]  # noqa: E731
    inv = torch.rsqrt(var + eps)
    xhat = (x - b(mean)) * b(inv)
    return xhat, xhat * b(gamma) + b(beta), inv


def plain_apply(x, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """LeakyReLU((x - mean) * rsqrt(var + eps) * gamma + beta), with the
    positive branch at ``pre >= 0`` (``F.leaky_relu``'s backward takes the
    slope branch at 0, so it is not used)."""
    _, pre, _ = _xhat_pre(x, mean, var, gamma, beta, eps)
    return torch.where(pre >= 0, pre, slope * pre)


def plain_bwd_reduce(x, g, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """``(dgamma, dbeta)`` = per-channel (sum dpre * xhat, sum dpre)."""
    xhat, pre, _ = _xhat_pre(x, mean, var, gamma, beta, eps)
    dpre = torch.where(pre >= 0, g, slope * g)
    return (dpre * xhat).sum(dim=(0, 2, 3)), dpre.sum(dim=(0, 2, 3))


def plain_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta, eps=EPS,
                    slope=SLOPE):
    """dx of the batch-statistics norm + LeakyReLU, from the reduce totals."""
    b = lambda a: a[None, :, None, None]  # noqa: E731
    xhat, pre, inv = _xhat_pre(x, mean, var, gamma, beta, eps)
    dpre = torch.where(pre >= 0, g, slope * g)
    inv_n = 1.0 / (x.shape[0] * x.shape[2] * x.shape[3])
    ga = b(gamma)
    return b(inv) * (
        dpre * ga - inv_n * ga * b(dbeta) - xhat * inv_n * ga * b(dgamma)
    )


def _pool_views(x):
    """The four strided views partitioning the 2x2/2 windows, in the JAX
    op's order (``pallas_fused_norm.py:540-547``)."""
    return (
        x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2],
        x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2],
    )


def plain_pool_apply(x, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """``plain_apply`` followed by the 2x2/2 max pool, as the max over the
    four views: ``(N, C, H/2, W/2)``."""
    views = _pool_views(plain_apply(x, mean, var, gamma, beta, eps, slope))
    return functools.reduce(torch.maximum, views)


def fused_bn_leaky_relu_reference(x, gamma, beta, eps=EPS, slope=SLOPE):
    """The plain version of the whole op, differentiated by autograd:
    ``(y, mean, var)`` with ``mean``/``var`` detached, as the kernels'
    Function marks them non-differentiable."""
    mean, var = plain_stats(x)
    y = plain_apply(x, mean, var, gamma, beta, eps, slope)
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


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"fused_norm_{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Compiles ``csrc/fused_norm.cu`` unless this source's library exists.
    Returns ``(path, seconds, compiler output)``; raises if nvcc fails."""
    path = library_path()
    if os.path.exists(path):
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
    return path, seconds, proc.stdout + proc.stderr


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build()[0])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        signatures = {
            "bn_stats": [p, p, p, p, i, i, i, i, p],
            "bn_act_apply": [p, p, p, p, p, p, i, i, i, f, f, i, p],
            "bn_act_bwd_reduce": [p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, p],
            "bn_act_bwd_apply": [p, p, p, p, p, p, p, p, p, i, i, i, f, f, i, p],
            "bn_act_pool_apply": [p, p, p, p, p, p, i, i, i, i, f, f, i, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _check(x, *vecs):
    if x.device.type != "cuda":
        raise ValueError(f"fused-norm kernels take CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(
            f"fused-norm kernels take float32, got {x.dtype} "
            "(bfloat16 is ROADMAP item A8)"
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
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(
            f"cotangent {tuple(g.shape)} on {g.device} does not match the "
            f"input {tuple(x.shape)} on {x.device}"
        )


def _launch(name, *args):
    rc = getattr(_load(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launch_counts[name] += 1


def _dims(x):
    n, c, h, w = x.shape
    return n, c, h * w


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(x) -> int:
    """Row splits per channel: enough blocks for ~4 per SM, each block over
    at least 2048 rows."""
    n, c, hw = _dims(x)
    want_blocks = 4 * _sm_count(x.device)
    return max(1, min(-(-want_blocks // c), -(-(n * hw) // 2048)))


def _elementwise_blocks(x) -> int:
    return max(1, min(-(-x.numel() // 256), 8 * _sm_count(x.device)))


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def bn_stats(x):
    """Kernel K1: per-channel ``(mean, biased var)`` of NCHW ``x``."""
    _check(x)
    n, c, hw = _dims(x)
    splits = _splits(x)
    mean = torch.empty(c, device=x.device, dtype=torch.float32)
    var = torch.empty_like(mean)
    partials = torch.empty((c, splits, 2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _launch("bn_stats", _ptr(x), _ptr(mean), _ptr(var), _ptr(partials),
                n, c, hw, splits, _stream(x))
    return mean, var


def bn_act_apply(x, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """Kernel K2: ``plain_apply`` on the card."""
    _check(x, mean, var, gamma, beta)
    n, c, hw = _dims(x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("bn_act_apply", _ptr(x), _ptr(mean), _ptr(var), _ptr(gamma),
                _ptr(beta), _ptr(y), n, c, hw, eps, slope,
                _elementwise_blocks(x), _stream(x))
    return y


def bn_act_bwd_reduce(x, g, mean, var, gamma, beta, eps=EPS, slope=SLOPE):
    """Kernel K3: ``plain_bwd_reduce`` on the card -> ``(dgamma, dbeta)``."""
    _check(x, mean, var, gamma, beta)
    _check_like(g, x)
    n, c, hw = _dims(x)
    splits = _splits(x)
    dgamma = torch.empty(c, device=x.device, dtype=torch.float32)
    dbeta = torch.empty_like(dgamma)
    partials = torch.empty((c, splits, 2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _launch("bn_act_bwd_reduce", _ptr(x), _ptr(g), _ptr(mean), _ptr(var),
                _ptr(gamma), _ptr(beta), _ptr(dgamma), _ptr(dbeta),
                _ptr(partials), n, c, hw, splits, eps, slope, _stream(x))
    return dgamma, dbeta


def bn_act_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta, eps=EPS,
                     slope=SLOPE):
    """Kernel K4: ``plain_bwd_apply`` on the card -> dx."""
    _check(x, mean, var, gamma, beta, dgamma, dbeta)
    _check_like(g, x)
    n, c, hw = _dims(x)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("bn_act_bwd_apply", _ptr(x), _ptr(g), _ptr(mean), _ptr(var),
                _ptr(gamma), _ptr(beta), _ptr(dgamma), _ptr(dbeta), _ptr(dx),
                n, c, hw, eps, slope, _elementwise_blocks(x), _stream(x))
    return dx


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
    if x.data_ptr() % 8:
        raise ValueError("bn_act_pool_apply reads float2 pairs: x must be "
                         "8-byte aligned")
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // 2, w // 2), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        _launch("bn_act_pool_apply", _ptr(x), _ptr(mean), _ptr(var),
                _ptr(gamma), _ptr(beta), _ptr(y), n, c, h, w, eps, slope,
                _elementwise_blocks(y), _stream(x))
    return y


class FusedBNLeakyReLU(torch.autograd.Function):
    """K1 + K2 forward, K3 + K4 backward. One level of reverse mode, the
    contract of the JAX ``custom_vjp``; the batch statistics are outputs
    without gradient, as ``_fused_vjp_bwd`` drops their cotangents."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope):
        mean, var = bn_stats(x)
        y = bn_act_apply(x, mean, var, gamma, beta, eps, slope)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.slope = eps, slope
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        g = gy.contiguous()
        dgamma, dbeta = bn_act_bwd_reduce(
            x, g, mean, var, gamma, beta, ctx.eps, ctx.slope
        )
        dx = bn_act_bwd_apply(
            x, g, mean, var, gamma, beta, dgamma, dbeta, ctx.eps, ctx.slope
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
    """K1 on the card; the plain statistics for a CPU tensor only."""
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
    the second derivative sees the statistics' dependence on ``x``."""
    b = lambda a: a[None, :, None, None]  # noqa: E731
    dims = (0, 2, 3)
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
    return dx, dgamma, dbeta


class FusedBNLeakyReLUHO(torch.autograd.Function):
    """K1 + K2 forward, differentiable to any order: the counterpart of
    ``fused_bn_leaky_relu_ho`` (``pallas_fused_norm.py:633-658``). ``mean``
    and ``var`` are differentiable outputs, as they carry tangents there."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, slope):
        mean, var = _stats(x)
        if x.device.type == "cpu":
            y = plain_apply(x, mean, var, gamma, beta, eps, slope)
        else:
            y = bn_act_apply(x, mean, var, gamma, beta, eps, slope)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.slope = eps, slope
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        return (*_norm_act_vjp(x, gamma, beta, mean, var, gy, gmean, gvar,
                               ctx.eps, ctx.slope, pooled=False), None, None)


class FusedBNLeakyReLUPool(torch.autograd.Function):
    """K1 over the whole pre-pool ``x`` + K5 forward, differentiable to any
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

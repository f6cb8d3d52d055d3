"""Episode assembly for RAM-preloaded datasets whose transforms draw no RNG
(``howtotrainyourmamlpytorch_tpu/data/fast_synth.py``).

``gather_rot_chw(src, idx, k)`` gathers ``src[idx]`` from a class store
``(S, H, W, C)`` float32, rotates by ``k * 90`` degrees (``numpy.rot90``,
Omniglot's class-level augmentation) and returns ``(M, C, H, W)`` float32:
what the per-image ``augment_image`` loop of ``get_set`` gives, in one
pass. The C source ``native/episode_synth.c`` does it when a compiler is
found (the call releases the GIL, so loader threads scale); otherwise a
vectorised NumPy path gives the same bits. The library is built on the
first call, not at import.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..native import load_native_library

_lock = threading.Lock()
_state: dict = {}


def _lib():
    """The loaded, typed ``episode_synth`` library, or None."""
    with _lock:
        if "lib" not in _state:
            lib = load_native_library("episode_synth")
            if lib is not None:
                lib.gather_rot_chw.argtypes = [
                    ctypes.c_void_p,  # src
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # H, W, C
                    ctypes.c_void_p,  # idx
                    ctypes.c_int64,  # M
                    ctypes.c_int,  # k
                    ctypes.c_void_p,  # dst
                ]
                lib.gather_rot_chw.restype = None
                lib.assemble_episode.argtypes = [
                    ctypes.c_void_p,  # src_ptrs (int64[N])
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # H, W, C
                    ctypes.c_void_p,  # idx (int64[N, M])
                    ctypes.c_void_p,  # ks (int32[N])
                    ctypes.c_int64, ctypes.c_int64,  # N, M
                    ctypes.c_void_p,  # dst (float32[N, M, C, H, W])
                ]
                lib.assemble_episode.restype = None
            _state["lib"] = lib
        return _state["lib"]


def native_available() -> bool:
    return _lib() is not None


def _gather_rot_chw_numpy(src: np.ndarray, idx: np.ndarray, k: int) -> np.ndarray:
    out = src[idx]  # (M, H, W, C)
    if k % 4:
        out = np.rot90(out, k=k, axes=(1, 2))
    return np.ascontiguousarray(np.transpose(out, (0, 3, 1, 2)))


def gather_rot_chw(src: np.ndarray, idx: np.ndarray, k: int) -> np.ndarray:
    """``(M, C, H, W)`` float32: ``rot90(src[idx], k)`` transposed to CHW."""
    k = int(k) % 4
    _, H, W, C = src.shape
    lib = _lib()
    if (
        lib is None
        or (k % 2 and H != W)
        or not src.flags.c_contiguous
        or src.dtype != np.float32
    ):
        return _gather_rot_chw_numpy(src, np.asarray(idx, np.int64), k)
    idx = np.ascontiguousarray(idx, np.int64)
    dst = np.empty((len(idx), C, H, W), np.float32)
    lib.gather_rot_chw(src.ctypes.data, H, W, C, idx.ctypes.data, len(idx), k,
                       dst.ctypes.data)
    return dst


def assemble_episode_native(
    src_addrs: np.ndarray,  # (N,) int64 class-store base addresses
    shape_hwc: tuple,  # (H, W, C) of one image
    idx: np.ndarray,  # (N, M) int64 sample indices
    ks: np.ndarray,  # (N,) int32 rotation quarter-turns
) -> np.ndarray | None:
    """``(N, M, C, H, W)`` float32 in one native call, or None without the
    library. The caller guarantees that every class store is C-contiguous
    float32 ``(S, H, W, C)`` and stays alive, and that H == W when any of
    ``ks`` is odd."""
    lib = _lib()
    if lib is None:
        return None
    H, W, C = shape_hwc
    n, m = idx.shape
    dst = np.empty((n, m, C, H, W), np.float32)
    lib.assemble_episode(
        src_addrs.ctypes.data, H, W, C, idx.ctypes.data, ks.ctypes.data,
        n, m, dst.ctypes.data,
    )
    return dst

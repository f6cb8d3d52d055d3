"""Lazy ctypes build and load of the package's host C sources.

The sources have a plain C ABI over raw buffers, so one ``cc -O3 -shared
-fPIC`` per source is the whole build, and ctypes releases the GIL for
the call (the loader's synthesis threads run in parallel).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}


def _compiler() -> str | None:
    for cc in ("cc", "gcc", "clang"):
        if shutil.which(cc):
            return cc
    return None


def load_native_library(name: str) -> ctypes.CDLL | None:
    """Compiles ``<name>.c`` (once; the result is cached on disk and in the
    process) and returns the loaded library, or None when no compiler is
    found or the compile fails: the caller then takes its NumPy path."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = os.path.join(_DIR, f"{name}.c")
        out = os.path.join(BUILD_DIR, f"{name}.so")
        lib = None
        try:
            if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
                cc = _compiler()
                if cc is None:
                    raise RuntimeError("no C compiler on PATH")
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = out + f".tmp{os.getpid()}"
                # The lock serialises concurrent builds: a second thread
                # must not load the output before the compiler is done.
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", src, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
        except (OSError, RuntimeError, subprocess.CalledProcessError) as exc:
            detail = getattr(exc, "stderr", None)
            if isinstance(detail, bytes):
                detail = detail.decode(errors="replace")
            suffix = f": {detail.strip()}" if detail else ""
            print(f"native {name} unavailable ({exc}{suffix}); using NumPy")
            lib = None
        _cache[name] = lib
        return lib

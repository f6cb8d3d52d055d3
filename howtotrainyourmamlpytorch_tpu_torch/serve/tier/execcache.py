"""Integrity-fenced executable cache: durable warmup
(``howtotrainyourmamlpytorch_tpu/serve/tier/execcache.py``).

The JAX cache serializes the warmed XLA executables so that a respawned
replica loads instead of compiling. The port compiles one artifact: the
fused-norm library that ``ops/fused_norm.build()`` makes with nvcc. This
cache stores that library's bytes, so a replica respawned on a tier that
holds a verified library for its fence loads it and runs no nvcc build:
the port's form of "zero compiles on a warm respawn".

Key and fence, as in JAX:

* the **key** (file name) hashes the lookup identity: the program
  (``fused_norm``), its signature (the source-and-flags digest,
  ``fused_norm.library_digest()``) and the device name;
* the **fence**, stored in the envelope and checked on every load, holds
  the build's provenance: torch, the CUDA runtime, the driver, the device
  name and its sm, and the nvcc flags. Drift the key cannot see (a torch
  or driver upgrade) is rejected as stale (typed ``ExecCacheStaleError``,
  a ``tier_exec_stale`` event) and the caller rebuilds and overwrites.

The cache can only make a start faster: a corrupt envelope is quarantined,
a stale fence refused, and the caller builds. ``put`` and ``get`` move
bytes, so the mechanics run anywhere; ``serialization_available()`` says
whether this process has a library to store (a CUDA card: on the CPU the
port runs no kernel library).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import threading

import torch

from ...telemetry import events as telemetry_events
from ...utils import faultinject
from .atomic import (
    ExecCacheStaleError,
    TierCorruptError,
    TierError,
    atomic_write_bytes,
    crc32_bytes,
    quarantine,
)

SCHEMA = 1
_SUFFIX = ".exec.bin"
#: The one program the port compiles.
PROGRAM = "fused_norm"


def serialization_available() -> bool:
    """True where there is a kernel library to store: a CUDA card."""
    return torch.cuda.is_available()


def _driver_version() -> str:
    """The CUDA driver's version (``cuDriverGetVersion``), or ``"none"``."""
    try:
        version = ctypes.c_int()
        if ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version)) == 0:
            return str(version.value)
    except OSError:
        pass
    return "none"


def build_fence(program: str, signature: str, device=None) -> dict:
    """The full build provenance of one stored library on ``device`` (the
    card by default where there is one)."""
    from ...ops.fused_norm import NVCC_FLAGS

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        sm = "sm_{}{}".format(*torch.cuda.get_device_capability(device))
    else:
        name = sm = device.type
    return {
        "schema": SCHEMA,
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
        "driver": _driver_version() if device.type == "cuda" else "none",
        "device_name": name,
        "sm": sm,
        "nvcc_flags": " ".join(NVCC_FLAGS),
        "program": str(program),
        "signature": str(signature),
    }


class ExecutableCache:
    """Durable store of the port's compiled kernel library, fenced."""

    def __init__(self, root: str, device=None):
        self.root = str(root)
        self.device = device
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.stats = {
            "hits": 0,
            "misses": 0,
            "stale": 0,
            "corrupt_quarantined": 0,
            "io_errors": 0,
            "writes": 0,
        }

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def fence(self, program: str, signature: str) -> dict:
        return build_fence(program, signature, self.device)

    def path_for(self, program: str, signature: str) -> str:
        fence = self.fence(program, signature)
        key = hashlib.sha256("|".join(
            (fence["program"], fence["signature"], fence["device_name"])
        ).encode()).hexdigest()
        return os.path.join(self.root, key + _SUFFIX)

    def has(self, program: str, signature: str) -> bool:
        return os.path.exists(self.path_for(program, signature))

    # -- write path ------------------------------------------------------

    def put(self, program: str, signature: str, payload: bytes) -> bool:
        """Publishes ``payload`` under its fence (best-effort)."""
        header = json.dumps({
            "schema": SCHEMA,
            "fence": self.fence(program, signature),
            "payload_crc32": crc32_bytes(payload),
        }).encode()
        try:
            atomic_write_bytes(self.path_for(program, signature), header + b"\n" + payload)
        except (OSError, TierError):
            self._count("io_errors")
            return False
        self._count("writes")
        return True

    # -- read path -------------------------------------------------------

    def get(self, program: str, signature: str) -> bytes | None:
        """The verified payload, or None: corrupt is quarantined, a stale
        fence refused (the file kept until the rebuild overwrites it), both
        with an event."""
        path = self.path_for(program, signature)
        if not os.path.exists(path):
            self._count("misses")
            return None
        try:
            payload = self._load_verified(path, program, signature)
        except ExecCacheStaleError as exc:
            self._count("stale")
            telemetry_events.emit("tier_exec_stale", program=program, reason=str(exc))
            return None
        except TierCorruptError as exc:
            quarantine(path, reason=str(exc), kind="executable")
            self._count("corrupt_quarantined")
            return None
        except OSError:
            self._count("io_errors")
            return None
        self._count("hits")
        telemetry_events.emit("tier_exec_cache_hit", program=program)
        return payload

    def _load_verified(self, path: str, program: str, signature: str) -> bytes:
        with open(path, "rb") as f:
            raw = f.read()
        header_line, sep, payload = raw.partition(b"\n")
        if not sep:
            raise TierCorruptError("executable envelope has no header")
        try:
            header = json.loads(header_line.decode())
        except Exception as exc:
            raise TierCorruptError(f"undecodable header: {exc}") from exc
        if int(header.get("schema", -1)) != SCHEMA:
            raise TierCorruptError(f"schema {header.get('schema')!r}")
        if crc32_bytes(payload) != int(header.get("payload_crc32", -1)):
            raise TierCorruptError("payload CRC mismatch")
        stored = faultinject.stale_exec_cache(dict(header.get("fence", {})))
        expected = self.fence(program, signature)
        drift = {k: (stored.get(k), v) for k, v in expected.items() if stored.get(k) != v}
        if drift:
            raise ExecCacheStaleError(f"fence drift: {drift}")
        return payload

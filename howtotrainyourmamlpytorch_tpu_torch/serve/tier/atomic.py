"""Crash-consistent publish for the durable serving tier
(``howtotrainyourmamlpytorch_tpu/serve/tier/atomic.py``).

Every byte the tier persists goes through :func:`atomic_write_bytes`:
write a temporary file in the same directory, ``fsync`` it, ``os.replace``
it onto the final name and ``fsync`` the directory. A reader sees no
file, the previous whole file or the new whole file, never a torn prefix
(unless the ``torn_spill_write_at`` fault forges one).

The typed errors:

* :class:`TierError` - transient I/O (disk full, permission): the tier
  degrades to its cold path;
* :class:`TierCorruptError` - an integrity failure (CRC, parse,
  truncation): the entry is quarantined (renamed ``*.corrupt``), read once
  and kept for forensics;
* :class:`ExecCacheStaleError` - an intact kernel library built under
  another fence (torch, CUDA, driver, device, flags): rebuilt and
  overwritten.

A stored identity that differs from the one asked for (learner family or
``state_version``) is a plain ``ValueError``.
"""

from __future__ import annotations

import os
import tempfile
import zlib

from ...telemetry import events as telemetry_events
from ...utils import faultinject


class TierError(Exception):
    """Transient durable-tier I/O failure (degrade to the cold path)."""


class TierCorruptError(TierError):
    """Integrity-check failure: quarantine the entry, serve cold."""


class ExecCacheStaleError(TierError):
    """The stored kernel library was built under another fence."""


def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Publishes ``data`` at ``path`` (temporary file, fsync, rename, fsync
    of the directory). The ``torn_spill_write`` hook may cut the payload,
    as a crash after a rename whose data fsync the drive forged would."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    payload = faultinject.torn_spill_write(data)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(parent)


def _fsync_dir(parent: str) -> None:
    # Best-effort: losing it only widens the crash window to "entry
    # absent", which readers take as a miss.
    try:
        dfd = os.open(parent, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def quarantine(path: str, *, reason: str, kind: str) -> str:
    """Renames a failed entry to ``*.corrupt`` and emits
    ``tier_quarantined``; returns the quarantine path. Best-effort: a
    second reader racing the rename sees a miss."""
    dest = path + ".corrupt"
    try:
        os.replace(path, dest)
    except OSError:
        pass
    telemetry_events.emit("tier_quarantined", path=path, reason=reason, kind=kind)
    return dest

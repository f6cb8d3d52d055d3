"""LRU cache of adapted fast weights keyed by a support-set digest
(``howtotrainyourmamlpytorch_tpu/serve/cache.py``).

Adaptation is a pure function of ``(served state, support set)``, so a query
against a support set already seen skips the inner loop and pays only the
classify forward. The digest covers the support bytes with their dtype and
shape, the labels, the geometry mask where there is one, the learner
family and a state version the owner bumps on a checkpoint swap.

With a durable tier attached (``attach_spill``) the LRU is the RAM front of
a two-level cache: ``put`` writes through to the disk spill and ``get``
falls back to a verified disk read on a RAM miss, promoting the entry
into RAM. The write-through runs on a writer thread of the cache: the
artifact's copy from the card to the host and the disk I/O stay off the
dispatch path, and every spill failure reads as a miss. The engine's
entries are ``(state_version, artifact)`` pairs; the spill stores the
artifact under that version.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Any

import numpy as np


def support_digest(
    x_support: np.ndarray,
    y_support: np.ndarray,
    *,
    learner: str,
    state_version: int,
    mask: np.ndarray | None = None,
) -> str:
    """Content hash of one episode's support set under one served model;
    byte-for-byte the JAX package's digest. ``mask`` is the geometry
    support mask of a coarsened episode: hashing it keeps a padded episode
    from colliding with a real one whose tail rows are zero images of
    label 0."""
    h = hashlib.sha256()
    h.update(f"{learner}|v{state_version}|".encode())
    x = np.ascontiguousarray(x_support)
    y = np.ascontiguousarray(y_support)
    h.update(str(x.dtype).encode() + b"|" + str(x.shape).encode() + b"|")
    h.update(x.tobytes())
    h.update(str(y.dtype).encode() + b"|" + str(y.shape).encode() + b"|")
    h.update(y.tobytes())
    if mask is not None:
        m = np.ascontiguousarray(mask)
        h.update(b"mask|" + str(m.shape).encode() + b"|")
        h.update(m.tobytes())
    return h.hexdigest()


def routing_digest(x_support: np.ndarray, y_support: np.ndarray) -> str:
    """Support hash without the learner and state version, for routing an
    episode to the same replica across swaps (``serve/pool.py``)."""
    return support_digest(x_support, y_support, learner="", state_version=0)


class AdaptedParamsCache:
    """Thread-safe LRU over adapted fast-weight trees, ``capacity`` episodes
    (0 disables it). ``get`` refreshes recency; ``put`` evicts the least
    recently used entry past capacity."""

    def __init__(self, capacity: int = 256):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, Any] = OrderedDict()
        self.evictions = 0
        self._spill = None  # ArtifactSpill when a durable tier is attached
        self._spill_learner: str | None = None
        self._spill_version = 0
        self.spill_hits = 0
        #: Seconds the writer thread spent on write-throughs (the copy to
        #: the host, the encode and the disk), off the dispatch path.
        self.spill_write_s = 0.0
        self._writes: queue.Queue | None = None
        self._writer: threading.Thread | None = None

    def attach_spill(self, spill, *, learner: str, state_version: int) -> None:
        """Attaches (or re-keys, after a publish) the disk tier: spill reads
        verify against ``(learner, state_version)``, so rehydrated entries
        never cross a version."""
        with self._lock:
            self._spill = spill
            self._spill_learner = str(learner)
            self._spill_version = int(state_version)
            if self._writer is None:
                self._writes = queue.Queue()
                self._writer = threading.Thread(
                    target=self._write_loop, name="spill-writer", daemon=True)
                self._writer.start()

    def get(self, digest: str):
        """The cached entry, or None; refreshes recency on a hit. On a RAM
        miss with a spill attached, a verified disk read (outside the lock)
        is promoted into RAM."""
        with self._lock:
            if digest in self._entries:
                self._entries.move_to_end(digest)
                return self._entries[digest]
            spill, learner, version = self._spill, self._spill_learner, self._spill_version
        if spill is None:
            return None
        artifact = spill.get(digest, learner=learner, state_version=version)
        if artifact is None:
            return None
        entry = (version, artifact)
        with self._lock:
            self.spill_hits += 1
        self.put_ram(digest, entry)
        return entry

    def put(self, digest: str, entry: Any) -> None:
        """Inserts ``entry`` (the engine's ``(state_version, artifact)``)
        and queues its write-through to the spill."""
        self.put_ram(digest, entry)
        if self._writes is not None:
            self._writes.put((digest, entry))

    def _write_loop(self) -> None:
        while True:
            item = self._writes.get()
            try:
                if item is None:
                    return
                digest, (version, artifact) = item
                with self._lock:
                    spill, learner = self._spill, self._spill_learner
                t0 = time.perf_counter()
                # The spill swallows I/O failures into its stats.
                spill.put(digest, artifact, learner=learner, state_version=version)
                self.spill_write_s += time.perf_counter() - t0
            finally:
                self._writes.task_done()

    def flush_spill(self) -> None:
        """Waits until every queued write-through has landed."""
        if self._writes is not None:
            self._writes.join()

    def close(self) -> None:
        """Lands the queued write-throughs and stops the writer thread."""
        if self._writer is not None:
            self._writes.put(None)
            self._writer.join()
            self._writer = self._writes = None

    def put_ram(self, digest: str, entry: Any) -> None:
        """The RAM insert without write-through: the rehydration path,
        where the entry just came from the spill."""
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[digest] = entry
            self._entries.move_to_end(digest)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, digest: str) -> bool:
        with self._lock:
            if digest in self._entries:
                return True
            spill = self._spill
        # Existence only (no verify): it feeds the pre-dispatch cache-hit
        # flag; the dispatch verifies.
        return spill is not None and os.path.exists(spill.path_for(digest))

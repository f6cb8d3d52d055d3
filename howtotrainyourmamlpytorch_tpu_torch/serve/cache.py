"""LRU cache of adapted fast weights keyed by a support-set digest
(``howtotrainyourmamlpytorch_tpu/serve/cache.py:41-180``, RAM only; the
durable disk tier comes with the later serving slice).

Adaptation is a pure function of ``(served state, support set)``, so a query
against a support set already seen skips the inner loop and pays only the
classify forward. The digest covers the support bytes with their dtype and
shape, the labels, the learner family and a state version the owner bumps
on a checkpoint swap.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any

import numpy as np


def support_digest(
    x_support: np.ndarray,
    y_support: np.ndarray,
    *,
    learner: str,
    state_version: int,
) -> str:
    """Content hash of one episode's support set under one served model;
    byte-for-byte the JAX package's digest of an episode without geometry
    padding."""
    h = hashlib.sha256()
    h.update(f"{learner}|v{state_version}|".encode())
    x = np.ascontiguousarray(x_support)
    y = np.ascontiguousarray(y_support)
    h.update(str(x.dtype).encode() + b"|" + str(x.shape).encode() + b"|")
    h.update(x.tobytes())
    h.update(str(y.dtype).encode() + b"|" + str(y.shape).encode() + b"|")
    h.update(y.tobytes())
    return h.hexdigest()


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

    def get(self, digest: str):
        with self._lock:
            if digest in self._entries:
                self._entries.move_to_end(digest)
                return self._entries[digest]
        return None

    def put(self, digest: str, artifact: Any) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._entries[digest] = artifact
            self._entries.move_to_end(digest)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

"""Consistent-hash ring for routing episodes by digest
(``howtotrainyourmamlpytorch_tpu/serve/tier/ring.py``).

The pool sends each episode to the replica that owns its routing digest
on the ring, so the replicas' hot sets (RAM LRU and disk spill) are
disjoint and the fleet's cache grows with its size. Each replica has
``vnodes`` points (64 by default); points are sha256, so placement is the
same in every process and in the JAX package: the same node ids and keys
route to the same owners. Callers serialise access (the pool holds its
lock).
"""

from __future__ import annotations

import bisect
import hashlib


def _point(token: str) -> int:
    return int(hashlib.sha256(token.encode()).hexdigest()[:16], 16)


class HashRing:
    """A consistent-hash ring over hashable node ids."""

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: list[int] = []  # sorted vnode positions
        self._owner: dict[int, object] = {}  # position -> node id
        self._nodes: set = set()

    def __contains__(self, node) -> bool:
        return node in self._nodes

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def nodes(self) -> set:
        return set(self._nodes)

    def _vnode_points(self, node) -> list[int]:
        return [_point(f"{node}#{i}") for i in range(self.vnodes)]

    def add(self, node) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for pos in self._vnode_points(node):
            if pos not in self._owner:
                bisect.insort(self._points, pos)
            self._owner[pos] = node  # a sha256 collision: the last add wins

    def remove(self, node) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for pos in self._vnode_points(node):
            if self._owner.get(pos) == node:
                del self._owner[pos]
                idx = bisect.bisect_left(self._points, pos)
                if idx < len(self._points) and self._points[idx] == pos:
                    del self._points[idx]

    def route(self, key: str):
        """The owner of ``key``: the first vnode clockwise of its point."""
        return self._route_point(_point(str(key)))

    def _route_point(self, pos: int):
        if not self._points:
            return None
        idx = bisect.bisect_right(self._points, pos)
        if idx == len(self._points):
            idx = 0  # wrap
        return self._owner[self._points[idx]]

    def successor(self, node):
        """The member that inherits ``node``'s first arc once ``node`` has
        left the ring: the pool asks it to adopt the dead replica's
        spill."""
        return self._route_point(_point(f"{node}#0"))

"""Runtime lock-order sanitizer (``howtotrainyourmamlpytorch_tpu/utils/locksan.py``).

While active it replaces the ``threading.Lock`` / ``threading.RLock``
factories with instrumented wrappers (``Condition`` and ``queue.Queue``
build on those factories, so they are covered too) and records, per
creation site:

* the **acquisition-order graph**: every time a thread acquires lock B
  while holding lock A, the edge ``site(A) -> site(B)``. A cycle in that
  graph is a potential deadlock that really happened in this process's
  interleavings: the two halves of an AB/BA inversion each record their
  edge the first time they run, even if they never overlap;
* **hold times**: wall seconds between acquire and release, the largest
  per site, so a hot-path lock held across blocking work shows up as a
  number.

Only locks created while the sanitizer is active are instrumented: a lock
made before (a module-level lock, made at import) keeps its native type
and is not covered. ``sanitized`` is the form a test module's autouse
fixture wraps: the port's serve suites run under it at a 2.0 s hold
budget on the locks created under ``howtotrainyourmamlpytorch_tpu_torch/serve``,
and fail on any cycle.

Locks are aggregated by creation site (file:line), not instance: two
replicas' pool locks are the same "lock class", the granularity deadlock
ordering is about. Edges between two instances from the same site are
dropped: two replicas locked in sequence is not an inversion.

The cost is a few dict and list operations per acquire and release (no
locking of its own: per-thread state lives in ``threading.local`` and the
shared tables rely on the GIL's per-operation atomicity). Host Python
only: this module imports no torch.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_THIS_FILE = os.path.normpath(__file__)

#: The serve suites' hold budget (the JAX suites' own): the serving hot
#: path's critical sections are dict and list operations (the batcher
#: dispatches outside its lock), orders of magnitude under it.
SERVE_HOLD_BUDGET_S = 2.0
#: The creation sites the serve suites' budget applies to.
SERVE_MATCH = os.path.join("howtotrainyourmamlpytorch_tpu_torch", "serve")


def _creation_site() -> str:
    """``file.py:line`` of the frame that constructed the lock — first
    frame outside this module and outside ``threading``/``queue``
    internals (a ``queue.Queue``'s mutex should attribute to whoever
    built the queue, not to the stdlib)."""
    frame = sys._getframe(2)
    while frame is not None:
        path = os.path.normpath(frame.f_code.co_filename)
        base = os.path.basename(path)
        if path != _THIS_FILE and base not in ("threading.py", "queue.py"):
            return f"{path}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class _InstrumentedLock:
    """API-complete stand-in for a ``threading.Lock``/``RLock``. The
    RLock flavor forwards ``_release_save``/``_acquire_restore``/
    ``_is_owned`` so ``threading.Condition`` keeps its exact semantics
    (including wait() releasing the lock — which the sanitizer observes
    as a release, so hold times never include condition waits)."""

    __slots__ = ("_san", "_real", "site", "_reentrant")

    def __init__(self, san: "LockSanitizer", real, site: str, reentrant: bool):
        self._san = san
        self._real = real
        self.site = site
        self._reentrant = reentrant

    # -- core lock protocol -------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._real.acquire(blocking, timeout)
        if got:
            self._san._note_acquire(self)
        return got

    def release(self):
        self._san._note_release(self)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def __getattr__(self, name):
        # Full API parity with the native lock (``_at_fork_reinit``,
        # version-specific internals): anything not instrumented
        # delegates straight through.
        return getattr(self._real, name)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<locksan {'RLock' if self._reentrant else 'Lock'} {self.site}>"

    # -- Condition integration (RLock surface) ------------------------

    def _release_save(self):
        self._san._note_release(self, full=True)
        if hasattr(self._real, "_release_save"):
            return self._real._release_save()
        self._real.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(state)
        else:
            self._real.acquire()
        self._san._note_acquire(self)

    def _is_owned(self):
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        # Plain-lock heuristic (mirrors threading.Condition's fallback).
        if self._real.acquire(False):
            self._real.release()
            return False
        return True


class LockSanitizer:
    """Records the acquisition-order graph + hold times while active.

    Use as a context manager (``with LockSanitizer() as san: ...``) or
    via ``activate()``/``deactivate()``. Only locks CREATED while active
    are instrumented — pre-existing locks keep their native type, so
    activation mid-process can never break a held lock.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._tls = threading.local()
        #: (src_site, dst_site) -> occurrence count.
        self.edges: dict[tuple[str, str], int] = {}
        #: site -> max observed hold seconds.
        self.max_hold_s: dict[str, float] = {}
        #: site -> acquisition count.
        self.acquisitions: dict[str, int] = {}
        self._active = False
        self._prev_lock = _REAL_LOCK
        self._prev_rlock = _REAL_RLOCK

    # -- bookkeeping (called from instrumented locks) ------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, lock: _InstrumentedLock) -> None:
        held = self._held()
        # Prune entries released by ANOTHER thread: unlike RLock, a plain
        # Lock may legally be released cross-thread (one-shot signal
        # idiom), which leaves the acquirer's entry stale — and a stale
        # entry would mint bogus ordering edges (false cycles) on every
        # later acquisition from this thread.
        held[:] = [
            e for e in held
            if e[0]._reentrant or e[0]._real.locked()
        ]
        for entry in held:
            if entry[0] is lock:  # reentrant re-acquire: count depth only
                entry[2] += 1
                return
        site = lock.site
        self.acquisitions[site] = self.acquisitions.get(site, 0) + 1
        for other, _t0, _depth in held:
            if other.site != site:
                key = (other.site, site)
                self.edges[key] = self.edges.get(key, 0) + 1
        held.append([lock, self._clock(), 1])

    def _note_release(self, lock: _InstrumentedLock, full: bool = False) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry[0] is lock:
                entry[2] -= 1
                if full or entry[2] <= 0:
                    hold = self._clock() - entry[1]
                    site = lock.site
                    if hold > self.max_hold_s.get(site, 0.0):
                        self.max_hold_s[site] = hold
                    del held[i]
                return
        # Released a lock this thread never acquired: either acquired
        # before activation, or a plain Lock released cross-thread (legal
        # for Lock — the acquirer's stale entry is pruned at its next
        # acquire). Nothing to record here.

    # -- activation ----------------------------------------------------

    def _make_factory(self, reentrant: bool):
        san = self

        def factory():
            real = _REAL_RLOCK() if reentrant else _REAL_LOCK()
            return _InstrumentedLock(san, real, _creation_site(), reentrant)

        return factory

    def activate(self) -> "LockSanitizer":
        if self._active:
            return self
        self._active = True
        # Restore-on-exit keeps nested sanitizers honest: an inner
        # sanitizer (a test's own inside a sanitized suite) hands the
        # factories back to the outer one, not to the native ones, or
        # the outer one would pass while instrumenting nothing.
        self._prev_lock = threading.Lock
        self._prev_rlock = threading.RLock
        threading.Lock = self._make_factory(reentrant=False)
        threading.RLock = self._make_factory(reentrant=True)
        return self

    def deactivate(self) -> None:
        if not self._active:
            return
        self._active = False
        threading.Lock = self._prev_lock
        threading.RLock = self._prev_rlock

    def __enter__(self) -> "LockSanitizer":
        return self.activate()

    def __exit__(self, *exc):
        self.deactivate()
        return False

    # -- verdicts ------------------------------------------------------

    def cycles(self) -> list[list[str]]:
        """Site cycles in the observed acquisition-order graph (each as
        the list of sites in one strongly-connected component). The edge
        table is SNAPSHOT first: instrumented locks keep recording even
        after deactivation, so a still-running background thread (pool
        supervisor, batcher worker) may insert a first-time edge while
        we iterate."""
        from .algo import tarjan_scc

        adj: dict[str, set] = {}
        for src, dst in list(self.edges):
            adj.setdefault(src, set()).add(dst)
        return tarjan_scc(adj)

    def over_budget(
        self, budget_s: float, match: str = ""
    ) -> dict[str, float]:
        """Sites (filtered by substring) whose max hold exceeded the
        budget — the hot-path hold-time verdict."""
        return {
            site: hold
            for site, hold in sorted(list(self.max_hold_s.items()))
            if hold > budget_s and (not match or match in site)
        }

    def assert_clean(
        self, hold_budget_s: float | None = None, match: str = ""
    ) -> None:
        """Raises ``AssertionError`` on observed cycles (always) and on
        over-budget holds (when a budget is given)."""
        cycles = self.cycles()
        if cycles:
            lines = []
            for component in cycles:
                lines.append(" <-> ".join(component))
                for (src, dst), n in sorted(list(self.edges.items())):
                    if src in component and dst in component:
                        lines.append(f"  {src} -> {dst} (x{n})")
            raise AssertionError(
                "locksan: cyclic lock-acquisition order observed at "
                "runtime (potential deadlock):\n" + "\n".join(lines)
            )
        if hold_budget_s is not None:
            over = self.over_budget(hold_budget_s, match)
            if over:
                detail = ", ".join(
                    f"{site} held {hold:.3f}s" for site, hold in over.items()
                )
                raise AssertionError(
                    f"locksan: lock hold time over the {hold_budget_s:.3f}s "
                    f"budget: {detail}"
                )

    def report(self) -> dict:
        """Snapshot for debugging and for the card's sanitized serve run."""
        return {
            "sites": len(self.acquisitions),
            "acquisitions": sum(list(self.acquisitions.values())),
            "edges": {
                f"{s} -> {d}": n for (s, d), n in list(self.edges.items())
            },
            "max_hold_s": dict(list(self.max_hold_s.items())),
            "cycles": self.cycles(),
        }


def longest_hold(san: LockSanitizer, match: str = "") -> tuple[str | None, float]:
    """The site (filtered by substring) with the longest hold and its
    seconds; ``(None, 0.0)`` when none was held."""
    holds = [(hold, site) for site, hold in list(san.max_hold_s.items())
             if not match or match in site]
    if not holds:
        return None, 0.0
    hold, site = max(holds)
    return site, hold


@contextlib.contextmanager
def sanitized(hold_budget_s: float | None = SERVE_HOLD_BUDGET_S,
              match: str = SERVE_MATCH):
    """A ``LockSanitizer`` active for the block, then ``assert_clean``:
    any cycle, or a hold of a ``match`` site over ``hold_budget_s``,
    raises ``AssertionError``. A test module's autouse fixture wraps its
    tests in it."""
    with LockSanitizer() as san:
        yield san
    san.assert_clean(hold_budget_s=hold_budget_s, match=match)

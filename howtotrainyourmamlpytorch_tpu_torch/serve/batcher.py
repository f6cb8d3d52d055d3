"""Deadline micro-batching (``howtotrainyourmamlpytorch_tpu/serve/batcher.py``).

Each episode joins the pending group of its bucket (under a geometry
lattice, the coarsened one). A group flushes when it holds
``meta_batch_size`` episodes, when its oldest request has waited
``max_wait_ms``, or early, so that its tightest member deadline can still
be met. Callers block on a ``concurrent.futures.Future``.

One worker thread does all of the device work: every dispatch, and the
callables handed to ``call`` (the API's promotions and raw swaps), so no
HTTP handler thread touches a tensor on the card. Dispatch runs outside
the queue lock.

The worker is fenced: an exception in a group's dispatch fails that
group's futures with ``DispatchFailedError`` and the worker serves on.
Episodes already past their deadline are failed with
``DeadlineExceededError`` and not dispatched. ``close`` drains the pending
groups.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from typing import Callable

from .engine import EpisodeRequest, ServingEngine
from .errors import DeadlineExceededError, DispatchFailedError


class _Group:
    """Pending episodes of one bucket and the flush deadline (the earlier of
    oldest arrival + max_wait and the tightest member's deadline)."""

    __slots__ = ("episodes", "futures", "deadline", "created")

    def __init__(self, deadline: float, created: float):
        self.episodes: list[EpisodeRequest] = []
        self.futures: list[Future] = []
        self.deadline = deadline
        self.created = created


def _fail(future: Future, exc: Exception) -> None:
    """Fails a future the caller may have cancelled on its timeout."""
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


def _resolve(future: Future, result) -> None:
    try:
        future.set_result(result)
    except InvalidStateError:
        pass


class MicroBatcher:
    """Collates concurrent same-bucket episodes into engine dispatches on
    one worker thread."""

    #: How long a computed dispatch margin stays fresh.
    MARGIN_TTL_S = 0.5

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self.metrics = engine.metrics
        self.max_batch = engine.config.meta_batch_size
        self.max_wait_s = engine.config.max_wait_ms / 1e3
        self._lock = threading.Condition()
        # Insertion-ordered, so ties flush the oldest group first.
        self._groups: OrderedDict[tuple, _Group] = OrderedDict()
        self._calls: list[tuple[Callable, Future]] = []
        self._closed = False
        self._last_dispatch_at = time.monotonic()
        self._margin_cache = (-self.MARGIN_TTL_S, 0.01)
        self._worker = threading.Thread(
            target=self._run, name="serve-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # Producer side
    # ------------------------------------------------------------------

    def submit(self, episode: EpisodeRequest) -> Future:
        """Enqueues one prepared episode; the Future resolves to its ``(Q,
        num_classes)`` logits or raises the typed dispatch error."""
        future: Future = Future()
        margin_s = self._dispatch_margin_s() if episode.deadline is not None else 0.0
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            now = time.monotonic()
            group = self._groups.get(episode.bucket)
            if group is None:
                group = _Group(now + self.max_wait_s, now)
                self._groups[episode.bucket] = group
            if episode.deadline is not None:
                # Flush a dispatch's time before the deadline: flushing at
                # it would have the episode dropped as expired.
                group.deadline = min(group.deadline, max(now, episode.deadline - margin_s))
            group.episodes.append(episode)
            group.futures.append(future)
            self._lock.notify()
        return future

    def call(self, fn: Callable[[], object]) -> Future:
        """Runs ``fn()`` on the worker thread, between dispatches; the
        Future gives its result or raises its exception unchanged."""
        future: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._calls.append((fn, future))
            self._lock.notify()
        return future

    def _dispatch_margin_s(self) -> float:
        """The observed adapt + classify medians (10 ms before any), kept
        for ``MARGIN_TTL_S``."""
        now = time.monotonic()
        computed_at, value = self._margin_cache
        if now - computed_at >= self.MARGIN_TTL_S:
            margin_ms = (self.metrics.adapt_latency.percentile(50)
                         + self.metrics.classify_latency.percentile(50))
            value = max(0.01, margin_ms / 1e3)
            self._margin_cache = (now, value)
        return value

    def queue_depth(self) -> int:
        with self._lock:
            return sum(len(g.episodes) for g in self._groups.values())

    def oldest_pending_age_s(self) -> float:
        """Age of the oldest queued group (0.0 when idle)."""
        with self._lock:
            if not self._groups:
                return 0.0
            oldest = min(g.created for g in self._groups.values())
        return max(0.0, time.monotonic() - oldest)

    def last_dispatch_age_s(self) -> float:
        """Seconds since the worker last finished a group."""
        return max(0.0, time.monotonic() - self._last_dispatch_at)

    def close(self, timeout: float = 5.0) -> None:
        """Stops the worker after draining the pending groups and calls."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout)

    # ------------------------------------------------------------------
    # Worker side
    # ------------------------------------------------------------------

    def _take_ready(self) -> list[_Group]:
        """Pops every group that is full or past its deadline (lock held);
        all of them once closed."""
        now = time.monotonic()
        ready = []
        for key in list(self._groups):
            group = self._groups[key]
            if (len(group.episodes) >= self.max_batch or now >= group.deadline
                    or self._closed):
                ready.append(self._groups.pop(key))
        return ready

    def _run(self) -> None:
        while True:
            with self._lock:
                while True:
                    ready = self._take_ready()
                    calls, self._calls = self._calls, []
                    if ready or calls or self._closed:
                        break
                    if self._groups:
                        next_deadline = min(g.deadline for g in self._groups.values())
                        self._lock.wait(max(0.0, next_deadline - time.monotonic()))
                    else:
                        self._lock.wait()
                drained = self._closed
            for fn, future in calls:
                try:
                    result = fn()
                except Exception as exc:  # handed to the caller
                    _fail(future, exc)
                else:
                    _resolve(future, result)
            for group in ready:
                # The fence: nothing a group does may end the worker.
                try:
                    self._dispatch(group)
                except Exception as exc:
                    failure = DispatchFailedError(
                        f"dispatch worker error: {type(exc).__name__}: {exc}"
                    )
                    failure.__cause__ = exc
                    for future in group.futures:
                        _fail(future, failure)
                self._last_dispatch_at = time.monotonic()
            if drained:
                return

    def _split_expired(self, group: _Group):
        """Fails the futures of expired episodes; returns the live rest."""
        now = time.monotonic()
        live_eps, live_futures = [], []
        for episode, future in zip(group.episodes, group.futures):
            if episode.expired(now):
                if not future.cancelled():
                    # A cancelled future: the caller's wait timed out and
                    # counted this deadline already.
                    self.metrics.deadline_exceeded_total.inc()
                _fail(future, DeadlineExceededError(
                    "request deadline expired in the batcher queue before dispatch"
                ))
            else:
                live_eps.append(episode)
                live_futures.append(future)
        return live_eps, live_futures

    def _dispatch(self, group: _Group) -> None:
        episodes, futures = self._split_expired(group)
        if not episodes:
            return
        try:
            results = self.engine.dispatch(episodes)
        except Exception as exc:
            failure = DispatchFailedError(
                f"engine dispatch failed: {type(exc).__name__}: {exc}"
            )
            failure.__cause__ = exc
            for future in futures:
                _fail(future, failure)
            return
        if len(results) != len(episodes):
            for future in futures:
                _fail(future, DispatchFailedError(
                    f"engine returned {len(results)} results for "
                    f"{len(episodes)} episodes"
                ))
            return
        for future, logits in zip(futures, results):
            _resolve(future, logits)

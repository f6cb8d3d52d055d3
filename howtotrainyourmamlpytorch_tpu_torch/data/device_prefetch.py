"""Device-side prefetch: episode batches staged onto the learner's device
whole dispatch groups ahead of the train loop
(``howtotrainyourmamlpytorch_tpu/data/device_prefetch.py``).

A stager thread pulls samples from the loader's generator, runs
``prepare_batch`` on each, stacks a dispatch group into page-locked host
memory and issues its copy to the card ``non_blocking`` on a copy stream
of its own, then records an event. The train loop pops a
:class:`~..models.common.StagedBatch` whose tensors are already on the card
or in flight: its stream waits on the event (on the device, not the host)
and the tensors are marked as used by it (``record_stream``), so the
allocator does not hand their memory back to the copy stream before the
train step has read them.

* **Dispatch groups.** ``group=K`` stages a K-iteration dispatch, the
  pre-stacked form ``run_train_iters`` takes (K = 1 too). Groups never
  straddle an epoch boundary (``epoch_len``): an epoch's last group may be
  shorter.
* **Bounded memory.** At most ``depth`` staged groups exist at once, plus
  the one the consumer holds. ``depth=AUTO_DEPTH`` starts double-buffered
  and deepens one group at a time, up to ``MAX_AUTO_DEPTH``, when the
  consumer keeps waiting for groups.
* **Fault quarantine.** With ``fault_budget > 0`` a producer exception
  (a loader I/O error, one corrupt episode) skips that batch window with a
  warning, up to the budget; past it, or for a non-``Exception`` error,
  the original exception reaches the consumer chained under
  :class:`DataPipelineError`.
* **Waits.** ``pop_waits`` splits the time the stager spent blocked on the
  loader from the time the consumer spent blocked on the stager.
* **Lifecycle.** ``close`` (idempotent) stops the thread and drops every
  unconsumed staged group.

On the CPU (the tests) a group is the stacked NumPy arrays as tensors: no
page-locked memory, no stream, no event. On a card those are required.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from ..models.common import StagedBatch, to_device


class DataPipelineError(RuntimeError):
    """The stager died or spent its fault budget. The producer's exception
    is chained as ``__cause__``, with its traceback from the stager
    thread."""


#: ``depth`` sentinel: start at DEFAULT_DEPTH, grow to MAX_AUTO_DEPTH when
#: the consumer's measured waits say staging cannot keep up.
AUTO_DEPTH = -1

#: Double buffering: one group in flight while the consumer runs another.
DEFAULT_DEPTH = 2

#: Auto-depth ceiling: past a few groups the buffer only adds memory.
MAX_AUTO_DEPTH = 4

#: A consumer pop blocked longer than this counts as a starvation sample.
_STARVE_S = 5e-4

#: Starvation samples before auto mode deepens by one group.
_STARVES_PER_GROWTH = 8


class _Staged:
    """A staged group and the event its copy completes at (None on the
    CPU)."""

    def __init__(self, batch: StagedBatch, ready):
        self.batch = batch
        self.ready = ready


class DevicePrefetcher:
    """Iterator of :class:`StagedBatch` over a generator of loader samples
    ``(xs, xt, ys, yt, seed)``; ``prepare`` is the learner's
    codec-aware ``prepare_batch``, called in the stager thread."""

    def __init__(self, source, prepare, device, depth: int = AUTO_DEPTH,
                 group: int = 1, start_iter: int = 0,
                 epoch_len: int | None = None, fault_budget: int = 0):
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self._auto = depth == AUTO_DEPTH
        self._capacity = DEFAULT_DEPTH if self._auto else int(depth)
        if self._capacity < 1:
            raise ValueError(f"device prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._prepare = prepare
        self._device = torch.device(device)
        if self._device.type not in ("cpu", "cuda"):
            raise ValueError(f"the prefetcher stages to cuda or cpu, got {device}")
        self._copy_stream = (
            torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        )
        self._group = int(group)
        self._epoch_len = int(epoch_len) if epoch_len else None
        self._next_iter = int(start_iter)
        self._fault_budget = int(fault_budget)
        self.faults_quarantined = 0

        # One lock, two wait-sets.
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._buffer: list[_Staged] = []
        self._error: BaseException | None = None
        self._closed = False
        self._finished = False
        self._data_wait_s = 0.0
        self._stage_wait_s = 0.0
        self._starves = 0
        self.released_buffers = 0
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetch-stager", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # Producer (stager thread)
    # ------------------------------------------------------------------

    def _pull_group(self):
        """The next group's samples and its first iteration; shorter than
        ``group`` at an epoch's end or the stream's, empty at its end."""
        first = self._next_iter
        want = self._group
        if self._epoch_len:
            want = min(want, self._epoch_len - first % self._epoch_len)
        samples = []
        for _ in range(want):
            t0 = time.perf_counter()
            try:
                sample = next(self._source)
            except StopIteration:
                break
            finally:
                waited = time.perf_counter() - t0
                with self._lock:
                    self._data_wait_s += waited
            samples.append(sample)
        self._next_iter = first + len(samples)
        return samples, first

    def _stage(self, samples, first_iter: int) -> _Staged:
        """``prepare`` each sample, stack the group, copy it to the device
        on the copy stream."""
        # A loader sample is (xs, xt, ys, yt, seed[, aug]): the seed stays
        # on the host, the augmentation operand is staged with the images.
        prepared = [self._prepare(tuple(s[:4]) + tuple(s[5:])) for s in samples]
        if self._copy_stream is None:
            arrays, ready = to_device(prepared, self._device), None
        else:
            with torch.cuda.stream(self._copy_stream):
                arrays = to_device(prepared, self._device)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return _Staged(StagedBatch(arrays, len(samples), first_iter), ready)

    def _quarantine(self, exc: BaseException, first_iter: int) -> bool:
        """True: skip the failed window and go on (within the budget).
        False: fail fast (budget spent, or not an ``Exception``)."""
        fatal = (
            not isinstance(exc, Exception)
            or self.faults_quarantined >= self._fault_budget
        )
        if not fatal:
            self.faults_quarantined += 1
            print(f"WARNING: data fault at iteration {first_iter} quarantined "
                  f"({self.faults_quarantined}/{self._fault_budget}): "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        return not fatal

    def _produce(self) -> None:
        try:
            while True:
                with self._lock:
                    while len(self._buffer) >= self._capacity and not self._closed:
                        self._not_full.wait()
                    if self._closed:
                        return
                planned_first = self._next_iter
                try:
                    samples, first = self._pull_group()
                    if not samples:
                        break
                    staged = self._stage(samples, first)
                except BaseException as exc:  # noqa: BLE001 - quarantine gate
                    if not self._quarantine(exc, planned_first):
                        raise
                    # The skipped window's iteration numbers go to the next
                    # pull, so epoch-boundary grouping is unchanged; the
                    # loop receives one batch fewer.
                    self._next_iter = planned_first
                    continue
                with self._lock:
                    if self._closed:
                        self.released_buffers += 1
                        return
                    self._buffer.append(staged)
                    self._not_empty.notify()
        except BaseException as exc:  # noqa: BLE001 - forwarded to the consumer
            with self._lock:
                if not self._closed:
                    self._error = exc
        finally:
            with self._lock:
                self._finished = True
                self._not_empty.notify_all()

    # ------------------------------------------------------------------
    # Consumer
    # ------------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> StagedBatch:
        t0 = time.perf_counter()
        with self._not_empty:
            while not self._buffer and not self._finished and not self._closed:
                self._not_empty.wait()
            waited = time.perf_counter() - t0
            self._stage_wait_s += waited
            if self._buffer:
                staged = self._buffer.pop(0)
                self._maybe_deepen(waited)
                self._not_full.notify()
            elif self._error is not None:
                error, self._error = self._error, None
                raise DataPipelineError(
                    "device-prefetch producer died: "
                    f"{type(error).__name__}: {error} (producer traceback "
                    "chained below)"
                ) from error
            else:
                raise StopIteration
        if staged.ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(staged.ready)
            for tensor in staged.batch.arrays:
                tensor.record_stream(stream)
        return staged.batch

    def _maybe_deepen(self, waited: float) -> None:
        """Auto depth, under the lock: repeated consumer starvation deepens
        the buffer by one group, up to the ceiling."""
        if not self._auto or self._capacity >= MAX_AUTO_DEPTH:
            return
        if waited >= _STARVE_S:
            self._starves += 1
            if self._starves >= _STARVES_PER_GROWTH:
                self._starves = 0
                self._capacity += 1
                self._not_full.notify()

    @property
    def depth(self) -> int:
        """Current staged-group capacity (grows in auto mode)."""
        return self._capacity

    @property
    def closed(self) -> bool:
        return self._closed

    def pop_waits(self) -> tuple[float, float]:
        """Returns and resets ``(data_wait_s, stage_wait_s)`` since the last
        call: seconds the stager spent blocked on the loader, and seconds
        the consumer spent blocked on the stager."""
        with self._lock:
            waits = (self._data_wait_s, self._stage_wait_s)
            self._data_wait_s = self._stage_wait_s = 0.0
        return waits

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Stops the stager thread and drops every unconsumed staged group
        (their device memory returns to the allocator). Idempotent; safe
        from any thread. A producer parked inside ``next(source)`` cannot
        be woken: the join is short, and the daemon thread stops at its
        next check of the flag, dropping what it staged meanwhile."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()
        self._thread.join(timeout=2.0)
        with self._lock:
            dropped, self._buffer = self._buffer, []
            self.released_buffers += len(dropped)
        if not self._thread.is_alive():
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except RuntimeError:
                    pass

    def __del__(self):  # best effort: close() is the contract
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

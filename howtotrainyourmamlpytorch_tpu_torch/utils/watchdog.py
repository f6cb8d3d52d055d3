"""Dispatch hang watchdog for the training loop
(``howtotrainyourmamlpytorch_tpu/utils/watchdog.py``).

A wedged dispatch (a kernel that never ends, a host thread parked in a
read of the card) neither crashes nor progresses. The watchdog makes it
an event with a diagnostic and an exit code:

* :class:`DispatchWatchdog` owns one monitor thread. The loop arms it
  around every dispatch (``with watchdog.armed(iter):``) and it fires when
  a window outlives its deadline, ``max(min_deadline_s, factor * p95)`` of
  the observed dispatch times.
* Samples that carry one-off work are kept out of the p95: the first armed
  window of the process (the kernels' first build and load), and every
  window in which the learner captured a CUDA graph. A capture happens at
  the first dispatch of each (second-order, final-only) branch and batch
  shape, so also mid-run at the MSL horizon; ``capture_count`` (a
  callable returning the number of captures so far) tells the watchdog
  whether a window captured.
* On expiry it dumps every thread's stack to ``<logs>/hang_stacks.txt``,
  emits a ``hang`` event, runs the owner's ``on_hang`` unwind (audit row,
  telemetry flush) on a helper thread bounded by ``UNWIND_BUDGET_S``, and
  exits through ``exit_fn`` with :data:`HANG_EXIT_CODE`. The exit comes
  from the monitor thread (``os._exit``): the main thread is the wedged
  one, and a graph in flight on the card cannot be interrupted.

76 is not the preemption code (75): a preempted run resumes as it was, a
hung one makes the device suspect (on one card the dispatcher resumes on
the same device; a smaller mesh is ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback

from ..telemetry import events as telemetry_events

HANG_EXIT_CODE = 76

#: Samples kept for the deadline's p95.
_MAX_SAMPLES = 256

#: Characters of the stack dump carried in the ``hang`` event.
_EVENT_STACK_CHARS = 2000

#: Seconds the unwind (stack file, ``on_hang``) may take before the exit.
UNWIND_BUDGET_S = 60.0


def dump_all_stacks() -> str:
    """The formatted stack of every live thread."""
    lines = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        lines.extend(line.rstrip("\n") for line in traceback.format_stack(frame))
    return "\n".join(lines) + "\n"


class DispatchWatchdog:
    """Arms a deadline around each dispatch; fires on expiry."""

    def __init__(
        self,
        *,
        min_deadline_s: float = 600.0,
        factor: float = 20.0,
        logs_dir: str | None = None,
        on_hang=None,
        exit_fn=os._exit,
        clock=time.monotonic,
        identity: dict | None = None,
        capture_count=None,
    ):
        if min_deadline_s <= 0:
            raise ValueError(
                f"watchdog min_deadline_s must be > 0, got {min_deadline_s}"
            )
        self.min_deadline_s = float(min_deadline_s)
        self.factor = float(factor)
        self.logs_dir = logs_dir
        self._on_hang = on_hang
        self._exit_fn = exit_fn
        self._clock = clock
        self._identity = dict(identity or {})
        self._capture_count = capture_count
        self._cond = threading.Condition()
        self._samples: list[float] = []
        self._warmed = False  # the first armed sample is dropped
        self._armed_at: float | None = None
        self._armed_iter = 0
        self._armed_deadline_s = self.min_deadline_s
        self._generation = 0
        self._closed = False
        self.fired = False
        self._thread = threading.Thread(
            target=self._monitor, name="dispatch-watchdog", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # Deadline model
    # ------------------------------------------------------------------

    def observe(self, step_s: float) -> None:
        """One completed window's seconds into the distribution; the first
        of the process is dropped."""
        with self._cond:
            if not self._warmed:
                self._warmed = True
                return
            self._samples.append(float(step_s))
            if len(self._samples) > _MAX_SAMPLES:
                del self._samples[:-_MAX_SAMPLES]

    def deadline_s(self, scale: float = 1.0) -> float:
        """``max(min_deadline_s, factor * p95 * max(scale, 1))``."""
        with self._cond:
            samples = sorted(self._samples)
        if not samples:
            return self.min_deadline_s
        p95 = samples[min(int(0.95 * len(samples)), len(samples) - 1)]
        return max(self.min_deadline_s, self.factor * p95 * max(scale, 1.0))

    def _captures(self) -> int:
        return 0 if self._capture_count is None else int(self._capture_count())

    # ------------------------------------------------------------------
    # Arming
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def armed(self, current_iter: int = 0, observe: bool = True, scale: float = 1.0):
        """Arms the deadline around one window; a clean exit disarms and,
        with ``observe`` and no capture in the window, feeds its seconds
        back. ``observe=False`` is for windows that are not a dispatch
        (the epoch boundary); ``scale`` stretches the p95 part of the
        deadline for windows worth many dispatches."""
        deadline = self.deadline_s(scale)
        captures = self._captures() if observe else 0
        with self._cond:
            self._armed_at = self._clock()
            self._armed_iter = int(current_iter)
            self._armed_deadline_s = deadline
            self._generation += 1
            self._cond.notify_all()
        try:
            yield
        finally:
            with self._cond:
                elapsed = (self._clock() - self._armed_at
                           if self._armed_at is not None else 0.0)
                self._armed_at = None
                self._cond.notify_all()
            if observe:
                if self._captures() != captures:
                    # A capture (and its eager warm-up) is one-off work;
                    # it also stands for the first window JAX drops.
                    with self._cond:
                        self._warmed = True
                else:
                    self.observe(elapsed)

    # ------------------------------------------------------------------
    # Monitor thread
    # ------------------------------------------------------------------

    def _monitor(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                if self._armed_at is None:
                    self._cond.wait()
                    continue
                remaining = self._armed_at + self._armed_deadline_s - self._clock()
                if remaining > 0:
                    self._cond.wait(timeout=remaining)
                    continue
                generation = self._generation
                diag = {
                    "iter": self._armed_iter,
                    "deadline_s": self._armed_deadline_s,
                    "elapsed_s": self._clock() - self._armed_at,
                }
                self._armed_at = None  # a test exit_fn must not refire
            if self._fire(diag, generation):
                return

    def _fire(self, diag: dict, generation: int) -> bool:
        """Stacks, the ``hang`` event, the bounded unwind, the exit. Only
        in-memory work runs on this thread; the file write, the stderr
        line and ``on_hang`` run on a helper thread joined with
        ``UNWIND_BUDGET_S``."""
        with self._cond:
            if self._closed or self._generation != generation:
                return False  # disarmed or re-armed meanwhile
            self.fired = True
        stacks = dump_all_stacks()
        stack_path = (os.path.join(self.logs_dir, "hang_stacks.txt")
                      if self.logs_dir else None)
        diag = dict(diag, stacks=stacks, stack_path=stack_path)
        telemetry_events.emit(
            "hang",
            iter=diag["iter"],
            dispatch_id=diag["iter"],
            deadline_s=diag["deadline_s"],
            elapsed_s=diag["elapsed_s"],
            stack_path=stack_path,
            stacks=stacks[:_EVENT_STACK_CHARS],
            exit_code=HANG_EXIT_CODE,
            **self._identity,
        )
        unwind = threading.Thread(target=self._unwind, args=(diag, stack_path, stacks),
                                  name="watchdog-unwind", daemon=True)
        unwind.start()
        unwind.join(timeout=UNWIND_BUDGET_S)
        self._exit_fn(HANG_EXIT_CODE)
        return True  # only with a test exit_fn that returns

    def _unwind(self, diag: dict, stack_path: str | None, stacks: str) -> None:
        if stack_path is not None:
            try:
                with open(stack_path, "w") as f:
                    f.write(
                        f"dispatch hang at iteration {diag['iter']}: no progress "
                        f"within {diag['deadline_s']:.1f}s (elapsed "
                        f"{diag['elapsed_s']:.1f}s)\n\n" + stacks
                    )
            except OSError:
                pass
        print(
            f"WATCHDOG: dispatch at iteration {diag['iter']} exceeded its "
            f"{diag['deadline_s']:.1f}s deadline; thread stacks in "
            f"{stack_path or '(telemetry event only)'}; exiting with code "
            f"{HANG_EXIT_CODE}",
            file=sys.stderr, flush=True,
        )
        if self._on_hang is not None:
            try:
                self._on_hang(diag)
            except Exception:  # noqa: BLE001 - the unwind must not block the exit
                traceback.print_exc()

    def state(self) -> dict:
        """Armed or not, the window's iteration and deadline, fired or not
        (for the heartbeat; safe from any thread)."""
        with self._cond:
            return {
                "armed": self._armed_at is not None,
                "armed_iter": self._armed_iter,
                "deadline_s": round(self._armed_deadline_s, 3),
                "fired": self.fired,
            }

    def close(self) -> None:
        """Stops and joins the monitor thread. Idempotent."""
        with self._cond:
            self._closed = True
            self._armed_at = None
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

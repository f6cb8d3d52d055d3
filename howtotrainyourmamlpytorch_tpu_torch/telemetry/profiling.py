"""On-demand bounded ``torch.profiler`` captures of a live training run
(``howtotrainyourmamlpytorch_tpu/telemetry/profiling.py``).

The controller takes the start-of-run one-shot (``--profile_trace_path``:
the first ``num_iters`` iterations) and, mid-run, a bounded capture of the
next ``num_iters`` iterations from two triggers:

* a file: touching ``<experiment>/logs/profile_trigger`` (or
  ``--profile_trigger_path``); it is consumed, and polled only at the log
  cadence's forced-read boundaries;
* ``SIGUSR1`` (installed by ``TrainTelemetry.activate``); the handler only
  sets a flag, and the next dispatch starts the capture.

Each triggered capture goes to its own ``on_demand_<n>`` directory, as a
Chrome trace (``trace.json``). ``stop()`` is idempotent and runs on every
exit path, the requeue exit included, so an interrupted capture still
lands. A trace of a CUDA-graph replay shows the replay, not a count of
the kernels inside it: launch counts stay with the graph's nodes.
"""

from __future__ import annotations

import os

from . import events as telemetry_events


class ProfilerController:
    """The bounded-capture state machine; one per training run."""

    def __init__(self, *, trace_path: str = "", num_iters: int = 20,
                 trigger_path: str = "", default_trace_dir: str = ""):
        self.trace_path = str(trace_path or "")
        self.num_iters = max(int(num_iters or 1), 1)
        self.trigger_path = str(trigger_path or "")
        self.default_trace_dir = str(default_trace_dir or "profiler_trace")
        self._armed_at_start = bool(self.trace_path)
        #: Set by request(): one attribute write, safe in a signal handler.
        self._pending_reason: str | None = None
        self._profiler = None
        self._iters_this_capture = 0
        self._captures = 0
        self._active_path: str | None = None

    def request(self, reason: str = "signal") -> None:
        """Arms a capture from the next dispatch."""
        self._pending_reason = reason

    def poll_trigger(self) -> None:
        """The file trigger; call at forced-read boundaries only."""
        if not self.trigger_path or not os.path.exists(self.trigger_path):
            return
        try:
            os.remove(self.trigger_path)
        except OSError:
            pass
        self._pending_reason = "file"

    @property
    def active(self) -> bool:
        return self._profiler is not None

    def tick(self, n_iters: int = 1) -> None:
        """One dispatch of ``n_iters`` iterations: starts a pending
        capture, stops a full one."""
        if self._profiler is None:
            if self._armed_at_start:
                self._armed_at_start = False
                self._begin(self.trace_path, reason="start_flag")
            elif self._pending_reason is not None:
                reason, self._pending_reason = self._pending_reason, None
                base = self.trace_path or self.default_trace_dir
                self._begin(os.path.join(base, f"on_demand_{self._captures}"), reason)
        if self._profiler is not None:
            self._iters_this_capture += n_iters
            if self._iters_this_capture >= self.num_iters:
                self.stop()

    def _begin(self, path: str, reason: str) -> None:
        import torch

        os.makedirs(path, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()
        self._iters_this_capture = 0
        self._captures += 1
        self._active_path = path
        telemetry_events.emit("profile_start", path=path, num_iters=self.num_iters,
                              reason=reason)
        print(f"profiler trace started ({reason}) -> {path}", flush=True)

    def stop(self) -> None:
        """Ends an in-flight capture and writes its trace; idempotent."""
        if self._profiler is None:
            return
        profiler, self._profiler = self._profiler, None
        profiler.stop()
        trace = os.path.join(self._active_path, "trace.json")
        profiler.export_chrome_trace(trace)
        telemetry_events.emit("profile_stop", path=self._active_path,
                              iters=self._iters_this_capture)
        print("profiler trace stopped ->", self._active_path, flush=True)
        self._active_path = None

"""``TrainTelemetry``: the trainer's observability in one object
(``howtotrainyourmamlpytorch_tpu/telemetry/runtime.py``).

It owns the run's event log (``logs/telemetry.jsonl``), a metrics registry,
the profiler controller, the anomaly detectors, the heartbeat and the
program ledger, and gives the experiment builder its hooks:

* ``record_dispatch``: one dispatch's wall time, split into the input
  waits and the rest (``device_s``); buffers a ``step`` event and feeds the
  anomaly detector. Host arithmetic only: no read of a tensor, no I/O.
* ``boundary``: the log cadence's forced read; records its cost, polls the
  profiler's file trigger, flushes the events and writes the heartbeat.
* ``epoch_stats``: the epoch's step-time, data-wait and stage-wait p50/p95
  for the summary CSV (the JAX column names), and an ``epoch_summary``
  event.
* ``ingest_train_program``: the program ledger's rows after a dispatch
  (``telemetry/device.py``; their FLOPs were counted at the warm-up before
  a capture).
* ``activate``: installs the event sink, the run's ``trace_id`` (from the
  dispatcher's ``MAML_TRACE_ID`` when it set one) and
  ``config_fingerprint`` (``tune/space.py``) as the event context, the ledger's warm-up
  hook and the ``SIGUSR1`` profile trigger; ``shutdown`` (idempotent, on
  every exit path) stops the profiler and flushes.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time

import numpy as np

from ..models import step_graph
from ..models.common import dispatch_multiplier
from . import device as device_ledger
from . import events as telemetry_events
from .anomaly import MemoryGrowthDetector, RollingAnomalyDetector
from .events import EventLog
from .heartbeat import HeartbeatWriter, heartbeat_path
from .profiling import ProfilerController
from .registry import MetricsRegistry

#: The summary CSV's per-epoch timing columns, ``{phase}_<kind>_p50|p95``.
TIMING_KINDS = ("step_time", "data_wait", "stage_wait")


class TrainTelemetry:
    """One per ``ExperimentBuilder``. With ``enabled=False`` the CSV
    timing columns and profiling still work; there is no JSONL, no
    heartbeat, no ledger and no global sink."""

    def __init__(self, logs_dir: str, *, enabled: bool = True,
                 profile_trace_path: str = "", profile_num_iters: int = 20,
                 profile_trigger_path: str = "", trace_id: str | None = None,
                 peak_flops: float | None = None,
                 config_fingerprint: str | None = None,
                 process_index: int = 0, process_count: int = 1):
        self.enabled = bool(enabled)
        self.logs_dir = logs_dir
        # The resolved knob set's id (``tune.space.config_fingerprint``),
        # on the event context (so on every event, ``step`` included) and
        # in every heartbeat.
        self.config_fingerprint = str(config_fingerprint) if config_fingerprint else None
        self.trace_id = str(trace_id or os.environ.get(telemetry_events.TRACE_ID_ENV)
                            or telemetry_events.new_trace_id())
        # The JAX package's topology columns: one card a rank, the dp
        # extent the process count.
        self.process_index, self.process_count = int(process_index), int(process_count)
        self.n_devices, self.mesh_dp, self.mesh_mp = self.process_count, self.process_count, 1
        self.mesh_shape = (
            "single" if self.process_count == 1 else f"dp{self.process_count}xmp1"
        )
        self.events: EventLog | None = (
            EventLog(os.path.join(logs_dir, "telemetry.jsonl")) if self.enabled else None
        )
        self.registry = MetricsRegistry()
        self.profiler = ProfilerController(
            trace_path=profile_trace_path, num_iters=profile_num_iters,
            trigger_path=profile_trigger_path or os.path.join(logs_dir, "profile_trigger"),
            default_trace_dir=os.path.join(logs_dir, "profiler_trace"),
        )
        self._last_dispatch_t: float | None = None
        self._step_times: list[float] = []
        self._data_waits: list[float] = []
        self._stage_waits: list[float] = []
        self._ended = False
        self.anomaly = RollingAnomalyDetector()
        self.memory_growth = MemoryGrowthDetector()
        self.ledger = (device_ledger.ProgramLedger(peak_flops=peak_flops)
                       if self.enabled else None)
        self._heartbeat = (HeartbeatWriter(heartbeat_path(logs_dir, self.process_index))
                           if self.enabled else None)
        #: The builder's extra heartbeat fields (a cheap callable, host only).
        self.heartbeat_extra = None
        self._epoch = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def sink(self):
        """This run's event log as the process's sink, with the trace
        context, for the block (the builder's resume: its
        ``checkpoint_load`` is this run's event)."""
        if not self.enabled:
            yield self
            return
        previous_sink = telemetry_events.install(self.events)
        previous_context = telemetry_events.set_context(
            trace_id=self.trace_id, process_index=self.process_index,
            process_count=self.process_count,
            config_fingerprint=self.config_fingerprint,
        )
        try:
            yield self
        finally:
            telemetry_events.restore_context(previous_context)
            telemetry_events.install(previous_sink)

    @contextlib.contextmanager
    def activate(self):
        """The sink, the trace context, the ledger's warm-up hook and the
        ``SIGUSR1`` trigger for a run; ``shutdown`` on every exit."""
        if not self.enabled:
            try:
                yield self
            finally:
                self.profiler.stop()
            return
        with self.sink():
            self.events.emit("run_start", pid=os.getpid(),
                             process_index=self.process_index,
                             process_count=self.process_count)
            previous_usr1 = self._install_usr1()
            step_graph.warmup_hooks.append(self.ledger.warmup_hook)
            try:
                yield self
            finally:
                step_graph.warmup_hooks.remove(self.ledger.warmup_hook)
                self.shutdown()
                if previous_usr1 is not None:
                    try:
                        signal.signal(signal.SIGUSR1, previous_usr1)
                    except (ValueError, OSError):
                        pass

    def _install_usr1(self):
        if threading.current_thread() is not threading.main_thread():
            return None
        try:
            return signal.signal(signal.SIGUSR1,
                                 lambda signum, frame: self.profiler.request("signal"))
        except (ValueError, OSError, AttributeError):
            return None

    def shutdown(self) -> None:
        """Stops an in-flight capture and flushes; idempotent."""
        self.profiler.stop()
        if self.events is not None:
            if not self._ended:
                self._ended = True
                self.event("run_end")
            self.events.flush()

    # ------------------------------------------------------------------
    # Hot path: buffers only
    # ------------------------------------------------------------------

    def event(self, event_type: str, **fields) -> None:
        if self.events is not None:
            fields.setdefault("process_index", self.process_index)
            fields.setdefault("process_count", self.process_count)
            self.events.emit(event_type, **fields)

    def record_dispatch(self, upto_iter: int, n_iters: int = 1,
                        data_wait_s: float = 0.0, stage_wait_s: float = 0.0,
                        staged: bool = False) -> None:
        """One dispatch of ``n_iters`` meta-updates that ended at
        ``upto_iter``. The first after an epoch boundary only sets the
        anchor. Staged, only the stage wait blocked the loop; unstaged, the
        data wait did."""
        now = time.perf_counter()
        self.registry.gauge("current_iter").set(upto_iter)
        if self._last_dispatch_t is not None:
            total_s = now - self._last_dispatch_t
            blocking_s = stage_wait_s if staged else data_wait_s + stage_wait_s
            device_s = max(total_s - blocking_s, 0.0)
            self._step_times.extend([total_s / n_iters] * n_iters)
            self._data_waits.extend([data_wait_s / n_iters] * n_iters)
            self._stage_waits.extend([stage_wait_s / n_iters] * n_iters)
            self.registry.window("step_time_ms").observe(1e3 * total_s / n_iters)
            self.registry.window("data_wait_ms").observe(1e3 * data_wait_s / n_iters)
            self.registry.window("stage_wait_ms").observe(1e3 * stage_wait_s / n_iters)
            self.registry.counter("train_dispatches").inc()
            if self.events is not None:
                self.events.emit(
                    "step", iter=int(upto_iter), dispatch_id=int(upto_iter),
                    k=int(n_iters), step_s=total_s, data_wait_s=data_wait_s,
                    stage_wait_s=stage_wait_s, staged=bool(staged), device_s=device_s,
                    n_devices=self.n_devices, mesh_shape=self.mesh_shape,
                    process_index=self.process_index, process_count=self.process_count,
                )
            self._observe_anomaly("step_time", total_s / n_iters, upto_iter)
            self._observe_anomaly("data_wait", data_wait_s / n_iters, upto_iter)
            self._observe_anomaly("stage_wait", stage_wait_s / n_iters, upto_iter)
        self._last_dispatch_t = now
        self.profiler.tick(n_iters)

    def _observe_anomaly(self, kind: str, value_s: float, upto_iter: int) -> None:
        fired = self.anomaly.observe(kind, value_s)
        if fired is not None:
            self.registry.counter("anomalies").inc()
            self.event("anomaly", iter=int(upto_iter), dispatch_id=int(upto_iter), **fired)

    def ingest_train_program(self, data_batches) -> None:
        """After a dispatch: the ledger's newest row takes this dispatch's
        declared multiplier, and rows captured since are emitted."""
        if self.ledger is not None:
            self.ledger.note_dispatch(dispatch_multiplier(data_batches))

    # ------------------------------------------------------------------
    # Forced-read boundaries: the only I/O
    # ------------------------------------------------------------------

    def boundary(self, current_iter: int, sync_s: float, reason: str) -> None:
        """A point that already read the card: its cost, the profiler's
        file trigger, the flush, the heartbeat."""
        self.registry.window("host_sync_ms").observe(1e3 * sync_s)
        self.event("host_sync", iter=int(current_iter), sync_s=sync_s, reason=reason)
        self.profiler.poll_trigger()
        self.flush()
        self.write_heartbeat(current_iter)

    def write_heartbeat(self, current_iter: int) -> None:
        """Replaces ``logs/status.json`` with last-known progress and the
        telemetry's windows (host values only)."""
        if self._heartbeat is None:
            return
        payload = {
            "trace_id": self.trace_id, "pid": os.getpid(),
            "process_index": self.process_index, "process_count": self.process_count,
            "n_devices": self.n_devices, "mesh_dp": self.mesh_dp,
            "mesh_mp": self.mesh_mp, "current_iter": int(current_iter),
            "epoch": self._epoch, "anomalies": self.anomaly.reports,
        }
        if self.config_fingerprint is not None:
            payload["config_fingerprint"] = self.config_fingerprint
        steps = self.anomaly.window_stats("step_time")
        if steps is not None and steps["sum_s"] > 0:
            rate = steps["count"] / steps["sum_s"]
            payload["meta_iters_per_s"] = round(rate, 4)
            payload["step_time_p95_s"] = round(steps["p95_s"], 6)
            for kind in ("data_wait", "stage_wait"):
                waits = self.anomaly.window_stats(kind)
                if waits is not None:
                    payload[f"{kind}_frac"] = round(waits["sum_s"] / steps["sum_s"], 6)
            if self.ledger is not None:
                mfu = self.ledger.mfu_pct(rate)
                if mfu is not None:
                    payload["mfu_pct"] = float(f"{mfu:.6g}")
                    payload["peak_flops"] = self.ledger.peak_flops()
                entry = self.ledger.train_entry()
                if entry is not None and entry.hbm_peak_bytes is not None:
                    payload["hbm_peak_bytes"] = entry.hbm_peak_bytes
        self._observe_memory(payload, current_iter)
        if self.heartbeat_extra is not None:
            try:
                extra = self.heartbeat_extra()
            except Exception:  # noqa: BLE001 - introspection must not kill the run
                extra = None
            if isinstance(extra, dict):
                payload.update(extra)
        if payload.get("epoch") is not None:
            self._epoch = payload["epoch"]
        self._heartbeat.write(payload)

    def _observe_memory(self, payload: dict, current_iter: int) -> None:
        """The card's allocator counters at the heartbeat (none on the
        CPU): a ``memory`` event, and the growth detector."""
        try:
            watermarks = device_ledger.sample_memory_stats()
        except Exception:  # noqa: BLE001 - introspection must not kill the run
            watermarks = None
        if not watermarks:
            return
        payload["memory"] = watermarks
        total_in_use = sum(w.get("bytes_in_use", 0) for w in watermarks)
        peak = max((w.get("peak_bytes_in_use", 0) for w in watermarks), default=0)
        self.event("memory", iter=int(current_iter), devices=watermarks,
                   bytes_in_use_total=total_in_use, peak_bytes_in_use_max=peak)
        fired = self.memory_growth.observe(total_in_use)
        if fired is not None:
            self.registry.counter("anomalies").inc()
            self.anomaly.reports += 1
            self.event("anomaly", iter=int(current_iter), dispatch_id=int(current_iter),
                       **fired)

    def epoch_stats(self, phase: str = "train", epoch: int | None = None) -> dict:
        """Pops the epoch's samples into the summary CSV's keys (NaN when
        the epoch had fewer than two dispatches), and the topology
        columns."""
        self._last_dispatch_t = None
        if epoch is not None:
            self._epoch = int(epoch)
        series = {"step_time": self._step_times, "data_wait": self._data_waits,
                  "stage_wait": self._stage_waits}
        steps = len(self._step_times)
        self._step_times, self._data_waits, self._stage_waits = [], [], []
        stats = {}
        for kind in TIMING_KINDS:
            values = np.asarray(series[kind])
            for q in (50, 95):
                stats[f"{phase}_{kind}_p{q}"] = (
                    float(np.percentile(values, q)) if steps else float("nan")
                )
        stats.update(n_devices=self.n_devices, mesh_dp=self.mesh_dp,
                     mesh_mp=self.mesh_mp, process_index=self.process_index,
                     process_count=self.process_count)
        if self.events is not None:
            self.events.emit("epoch_summary", epoch=epoch, iters=steps,
                             metrics=self.registry.snapshot(), **stats)
        return stats

    def reset_window(self) -> None:
        """After a rollback: the partial epoch's samples and the anchor go."""
        self._last_dispatch_t = None
        self._step_times, self._data_waits, self._stage_waits = [], [], []

    def flush(self) -> None:
        if self.events is not None:
            self.events.flush()

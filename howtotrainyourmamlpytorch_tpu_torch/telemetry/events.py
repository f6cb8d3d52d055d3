"""Structured run events: a host-buffered JSONL log
(``howtotrainyourmamlpytorch_tpu/telemetry/events.py``: ``emit``, the
``EventLog`` sink, the event context and ``read_events``).

One line per event, ``{"t": <unix seconds>, "type": <str>, ...fields}``,
after a ``{"type": "schema", "version": 1}`` line. ``emit`` only appends a
dict to a buffer: no I/O, no device read (fields are host values).
``flush`` appends the buffer to the file: a serving process flushes from a
thread of its own (``serve_maml --telemetry``), a training run at the
loop's log and epoch boundaries and on every exit path
(``runtime.TrainTelemetry``). With no sink installed ``emit`` is one
``None`` check, so library code pays nothing outside an instrumented run.

The training events and their fields are the JAX package's: ``step``,
``host_sync``, ``checkpoint_save`` / ``checkpoint_load`` /
``checkpoint_submit`` / ``checkpoint_interval``, ``nonfinite_trip``,
``rollback``, ``preemption``, ``requeue_exit``, ``hang``, ``oom``,
``data_fault``, ``anomaly``, ``memory``, ``epoch_summary``,
``program_profile``, ``profile_start`` / ``profile_stop``, ``run_start`` /
``run_end``.

A process-wide context (``set_context``: the run's ``trace_id``) is merged
into every event, whichever thread emits it. The dispatcher hands one
trace id to every phase it starts in ``MAML_TRACE_ID``. Non-finite floats
are written as ``null``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
import uuid

SCHEMA_VERSION = 1
TRACE_ID_ENV = "MAML_TRACE_ID"

_context: dict = {}


def new_trace_id() -> str:
    """A fresh 16-hex run-scoped trace id."""
    return uuid.uuid4().hex[:16]


def set_context(**fields) -> dict:
    """Replaces the context merged into every event (fields that are None
    are left out); returns the previous one for ``restore_context``."""
    global _context
    previous = _context
    _context = {key: value for key, value in fields.items() if value is not None}
    return previous


def restore_context(previous: dict) -> None:
    global _context
    _context = dict(previous)


def ensure_trace_id() -> str:
    """The context's trace id, set first from ``MAML_TRACE_ID`` or a fresh
    16-hex id when there is none."""
    trace_id = _context.get("trace_id")
    if not trace_id:
        trace_id = os.environ.get(TRACE_ID_ENV) or new_trace_id()
        _context["trace_id"] = trace_id
    return str(trace_id)


def _jsonable(value):
    """Host values as JSON takes them: numpy scalars as Python numbers,
    non-finite floats as ``None``, through dicts, lists and tuples."""
    if isinstance(value, dict):
        return {key: _jsonable(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(item) for item in value]
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


class EventLog:
    """Append-only buffered JSONL event log."""

    def __init__(self, path: str, clock=time.time):
        self.path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._buffer: list[dict] = []
        self._wrote_header = False

    def emit(self, event_type: str, **fields) -> None:
        """Buffers one event; explicit fields win over the context's."""
        record = {"t": self._clock(), "type": str(event_type), **_context}
        for key, value in fields.items():
            record[key] = _jsonable(value)
        with self._lock:
            self._buffer.append(record)

    def flush(self) -> int:
        """Appends every buffered event to ``path``; returns the lines
        written. An I/O failure drops the batch with one warning on stderr:
        telemetry never stops the server."""
        with self._lock:
            batch, self._buffer = self._buffer, []
            if not batch:
                return 0
            header_due = not self._wrote_header
            self._wrote_header = True
        lines = []
        if header_due:
            lines.append(json.dumps({"t": self._clock(), "type": "schema",
                                     "version": SCHEMA_VERSION}))
        for record in batch:
            try:
                lines.append(json.dumps(record, allow_nan=False))
            except (TypeError, ValueError):
                print(f"WARNING: dropped a telemetry event of type "
                      f"{record['type']!r} with a non-JSON field", file=sys.stderr)
        try:
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError as exc:
            with self._lock:
                if header_due:
                    self._wrote_header = False
            print(f"WARNING: telemetry flush to {self.path} failed ({exc}); "
                  f"dropped {len(batch)} event(s)", file=sys.stderr)
            return 0
        return len(lines)


def read_events(path: str, since: float | None = None) -> list[dict]:
    """The events of a JSONL file, a complete last line without its newline
    (a killed writer's) included; an unparseable line is skipped with a
    warning. ``since`` drops events stamped before that unix time."""
    events, torn = [], 0
    try:
        with open(path, "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    for line in lines:
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except ValueError:
            torn += 1
            continue
        if (since is not None and record.get("type") != "schema"
                and float(record.get("t", 0.0)) < since):
            continue
        events.append(record)
    if torn:
        print(f"WARNING: skipped {torn} unparseable line(s) in {path}",
              file=sys.stderr)
    return events


_active: EventLog | None = None


def install(log: EventLog | None) -> EventLog | None:
    """Makes ``log`` the process-wide sink; returns the one it replaces."""
    global _active
    previous = _active
    _active = log
    return previous


def active() -> EventLog | None:
    """The installed sink, or ``None``."""
    return _active


def emit(event_type: str, **fields) -> None:
    """Publishes to the installed sink; nothing without one."""
    if _active is not None:
        _active.emit(event_type, **fields)

"""Structured run events: a host-buffered JSONL log
(``howtotrainyourmamlpytorch_tpu/telemetry/events.py``: ``emit``, the
``EventLog`` sink, the event context, ``EventReader`` and ``read_events``).

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
``run_end``; and the port's ``capture`` (a train step's CUDA-graph
capture, where the JAX package emits ``compile``) and ``reduce`` (a
fleet rank's all-reduces of one dispatch: seconds, K, bytes a step).

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


class EventReader:
    """Incremental reader of a telemetry JSONL file (JAX
    ``telemetry/events.EventReader``): ``read`` resumes from ``offset``,
    where the previous call stopped, so a supervisor can follow a live run
    and a report can stream a long one.

    A line that does not parse mid-file is skipped and counted in
    ``torn_lines`` (concurrent appends can tear one), with a warning. A
    last line without its newline (a writer mid-append) is not consumed;
    with ``include_tail`` it is yielded when it is complete JSON, but the
    offset stays before it. A schema line newer than ``SCHEMA_VERSION``
    raises ``ValueError``."""

    def __init__(self, path: str, offset: int = 0):
        self.path = path
        self.offset = int(offset)
        self.torn_lines = 0

    def _parse(self, line: bytes, since: float | None) -> dict | None:
        """One line as an event, or None (torn, or before ``since``; schema
        lines always pass)."""
        try:
            record = json.loads(line)
        except ValueError:
            self.torn_lines += 1
            return None
        if record.get("type") == "schema":
            version = int(record.get("version", -1))
            if version > SCHEMA_VERSION:
                raise ValueError(
                    f"{self.path}: telemetry schema {version} is newer than "
                    f"this build reads (up to {SCHEMA_VERSION})")
        elif since is not None and float(record.get("t", 0.0)) < since:
            return None
        return record

    def iter_events(self, since: float | None = None,
                    include_tail: bool = False):
        """Yields the events from ``offset`` on, moving ``offset`` past each
        line that ends in a newline."""
        torn_before = self.torn_lines
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            tail = b""
            for raw in f:
                if not raw.endswith(b"\n"):
                    tail = raw
                    break
                self.offset += len(raw)
                line = raw.strip()
                if not line:
                    continue
                record = self._parse(line, since)
                if record is not None:
                    yield record
        if include_tail and tail.strip():
            torn_seen = self.torn_lines
            record = self._parse(tail.strip(), since)
            if record is not None:
                yield record
            else:
                self.torn_lines = torn_seen  # a writer mid-append, not torn
        torn = self.torn_lines - torn_before
        if torn:
            print(f"WARNING: skipped {torn} unparseable line(s) in "
                  f"{self.path}", file=sys.stderr)

    def read(self, since: float | None = None,
             include_tail: bool = False) -> list[dict]:
        return list(self.iter_events(since=since, include_tail=include_tail))


def read_events(path: str, since: float | None = None) -> list[dict]:
    """The events of a JSONL file: ``EventReader``'s one-shot form, a
    complete last line without its newline (a killed writer's) included.
    ``since`` drops events stamped before that unix time. A missing file
    reads as no events."""
    if not os.path.exists(path):
        return []
    return EventReader(path).read(since=since, include_tail=True)


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

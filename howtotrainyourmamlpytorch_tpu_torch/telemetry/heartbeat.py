"""The trainer's heartbeat, ``logs/status.json``
(``howtotrainyourmamlpytorch_tpu/telemetry/heartbeat.py``).

One small JSON document, replaced atomically at the loop's existing
forced-read boundaries (the log cadence and the epoch summary): last-known
progress (epoch, iteration), the windowed meta-iterations/s, the input
waits' shares, checkpoint age and the watchdog's state. The dispatcher
reads it for its audit rows.

* No new synchronisation: it is written only where the loop already read
  the card, from host values the telemetry holds.
* Atomic: a pid-unique temporary file renamed over the target, so a
  reader never sees a torn document.
* Never fatal: an I/O failure drops the beat with one warning.

Every rank of a multi-process run writes its own file, so no two race
one rename target: rank 0 ``status.json`` (what the dispatcher reads),
rank k ``status.r<k>.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

HEARTBEAT_SCHEMA = 1


def heartbeat_path(logs_dir: str, process_index: int = 0) -> str:
    """Rank ``process_index``'s heartbeat file in ``logs_dir``."""
    return os.path.join(
        logs_dir, "status.json" if process_index == 0 else f"status.r{process_index}.json"
    )


class HeartbeatWriter:
    """Atomic temporary-file-and-rename writer of one run's heartbeat."""

    def __init__(self, path: str, clock=time.time):
        self.path = path
        self._clock = clock
        self._tmp = f"{path}.tmp.{os.getpid()}"
        self._write_failures = 0

    def write(self, payload: dict) -> bool:
        """Replaces the heartbeat with ``payload`` and the ``schema``/``t``
        stamps; False (after one warning a run) on failure."""
        doc = {"schema": HEARTBEAT_SCHEMA, "t": self._clock(), **payload}
        try:
            with open(self._tmp, "w") as f:
                json.dump(doc, f)
            os.replace(self._tmp, self.path)
        except (OSError, TypeError, ValueError) as exc:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            self._write_failures += 1
            if self._write_failures == 1:
                print(f"WARNING: heartbeat write to {self.path} failed ({exc}); "
                      "training continues", file=sys.stderr)
            return False
        return True


def read_heartbeat(path: str) -> dict | None:
    """The heartbeat, or None when it is absent or unreadable."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None

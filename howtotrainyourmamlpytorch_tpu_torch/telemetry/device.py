"""Device resources of a training run: the program ledger, the MFU peak,
memory watermarks and OOM forensics
(``howtotrainyourmamlpytorch_tpu/telemetry/device.py``).

* :class:`ProgramLedger`: one row per captured train-step program (its
  ``(second_order, final_only)`` branch, batch shape and dtype). FLOPs per
  iteration come from ``torch.utils.flop_counter.FlopCounterMode`` around
  the eager warm-up step that precedes each capture
  (``models/step_graph.warmup_hooks``), never inside a capture, divided by
  the warm-up steps. Memory is the caching allocator's counters
  (``torch.cuda.memory_stats``) after that warm-up. A dispatch's FLOPs are
  the row's times the learner's declared ``dispatch_multiplier`` K. The
  ledger adds no step, no capture and no synchronisation.
* :func:`resolve_peak_flops`: the MFU denominator, ``--peak_flops`` first,
  then ``MAML_PEAK_FLOPS``, then a table keyed by
  ``torch.cuda.get_device_name()``. An unknown card gives no peak, and so
  no MFU. The f32 train step runs with TF32 off
  (``utils/platform.set_f32_numerics``), so its peak is the f32 rate
  outside the tensor cores.
* OOM: :func:`is_resource_exhausted` recognises ``torch.OutOfMemoryError``;
  :func:`write_oom_report` writes ``logs/oom_report.json`` with the JAX
  report's keys; the run then exits with :data:`OOM_EXIT_CODE`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import threading
import time

from . import events as telemetry_events

#: Dense peak rates of the cards the port runs on, FLOP/s by compute dtype:
#: NVIDIA's H100 data sheet, SXM part at its 700 W limit (f32 outside the
#: tensor cores; bf16 on the tensor cores, without sparsity). Matched by
#: substring of ``torch.cuda.get_device_name()``; a card set below 700 W
#: (``nvidia-smi --query-gpu=power.limit``) runs below these.
PEAK_FLOPS_BY_DEVICE = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12},
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12},
}

PEAK_FLOPS_ENV = "MAML_PEAK_FLOPS"

OOM_EXIT_CODE = 77

OOM_REPORT_SCHEMA = 1


def resolve_peak_flops(device_name: str | None, compute_dtype: str = "float32",
                       override: float | None = None) -> float | None:
    """The MFU denominator: ``override``, then ``MAML_PEAK_FLOPS``, then the
    table row of ``device_name`` for ``compute_dtype``; None when the card
    is not in the table."""
    if override:
        return float(override)
    env = os.environ.get(PEAK_FLOPS_ENV, "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            print(f"WARNING: ignoring malformed {PEAK_FLOPS_ENV}={env!r}",
                  file=sys.stderr)
    for name, peaks in PEAK_FLOPS_BY_DEVICE.items():
        if device_name and name.lower() in device_name.lower():
            return peaks.get(str(compute_dtype))
    return None


def sample_memory_stats() -> list[dict] | None:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` (the
    card's total) per visible card, from the caching allocator's counters
    (no synchronisation); None without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return None
    rows = []
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        rows.append({
            "device": index,
            "kind": torch.cuda.get_device_name(index),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(index).total_memory),
        })
    return rows


@dataclasses.dataclass
class ProgramEntry:
    """One captured program's row (host values only). ``flops`` is per
    iteration; ``dispatch_flops`` is ``k`` (the last dispatch's declared
    multiplier) times it."""

    name: str
    role: str = "train"
    signature: str = ""
    k: int = 1
    flops: float | None = None
    dispatch_flops: float | None = None
    hbm_peak_bytes: int | None = None
    bytes_in_use: int | None = None
    device_kind: str = ""
    compute_dtype: str = "float32"
    t: float = 0.0

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


class ProgramLedger:
    """The captured programs' rows, keyed by name and signature.
    Thread-safe; each new row is emitted once as a ``program_profile``
    event (buffered)."""

    def __init__(self, peak_flops: float | None = None, emit_events: bool = True):
        self._peak_override = peak_flops
        self.emit_events = bool(emit_events)
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], ProgramEntry] = {}
        self._pending: list[ProgramEntry] = []

    # -- the warm-up hook -------------------------------------------------

    @contextlib.contextmanager
    def warmup_hook(self, key, steps: int = 1):
        """Around the eager warm-up of a capture: counts its FLOPs and
        reads the allocator's counters after it. ``key`` is the graph's
        ``(second_order, final_only, shapes-and-dtypes)``."""
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            yield
        second_order, final_only, shapes = key if key is not None else (True, False, ())
        entry = ProgramEntry(
            name=f"train_step[{'second' if second_order else 'first'}_order"
                 f"{',final_only' if final_only else ''}]",
            signature=str([list(s) for s, _ in shapes])[:160],
            flops=float(counter.get_total_flops()) / max(int(steps), 1),
            compute_dtype="bfloat16" if "bfloat16" in str(shapes) else "float32",
            t=time.time(),
        )
        if torch.cuda.is_available():
            stats = torch.cuda.memory_stats()
            entry.device_kind = torch.cuda.get_device_name()
            entry.hbm_peak_bytes = int(stats.get("allocated_bytes.all.peak", 0))
            entry.bytes_in_use = int(stats.get("allocated_bytes.all.current", 0))
        entry.dispatch_flops = entry.flops
        with self._lock:
            self._entries[(entry.name, entry.signature)] = entry
            self._pending.append(entry)

    # -- per dispatch -----------------------------------------------------

    def note_dispatch(self, k: int) -> None:
        """The newest row's dispatch multiplier, and the events of rows
        recorded since the last call (host arithmetic only)."""
        with self._lock:
            pending, self._pending = self._pending, []
            entry = self.train_entry_locked()
            if entry is not None:
                entry.k = max(int(k), 1)
                entry.dispatch_flops = (None if entry.flops is None
                                        else entry.k * entry.flops)
        if self.emit_events:
            for row in pending:
                telemetry_events.emit(
                    "program_profile", peak_flops=self.peak_flops(row),
                    **{key: value for key, value in row.as_row().items() if key != "t"},
                )

    # -- queries ------------------------------------------------------------

    def peak_flops(self, entry: ProgramEntry | None = None) -> float | None:
        entry = entry or self.train_entry()
        if entry is None:
            return self._peak_override or None
        return resolve_peak_flops(entry.device_kind, entry.compute_dtype,
                                  self._peak_override)

    def entries(self) -> list[ProgramEntry]:
        with self._lock:
            return sorted(self._entries.values(), key=lambda e: (e.role, e.name))

    def table(self) -> list[dict]:
        return [entry.as_row() for entry in self.entries()]

    def train_entry_locked(self) -> ProgramEntry | None:
        trains = [e for e in self._entries.values() if e.role == "train"]
        return max(trains, key=lambda e: e.t) if trains else None

    def train_entry(self) -> ProgramEntry | None:
        """The newest train-step row: the heartbeat's MFU numerator."""
        with self._lock:
            return self.train_entry_locked()

    def mfu_pct(self, iters_per_s: float) -> float | None:
        """Model FLOPs utilisation at ``iters_per_s``; None without a row,
        its FLOPs or a known peak."""
        entry = self.train_entry()
        if entry is None or not entry.flops or iters_per_s <= 0:
            return None
        peak = self.peak_flops(entry)
        return None if not peak else 100.0 * iters_per_s * entry.flops / peak

    def top_by_temp_bytes(self, n: int = 8) -> list[dict]:
        """Rows by the allocator's peak after their warm-up, largest
        first: the OOM report's table."""
        rows = [e.as_row() for e in self.entries() if e.hbm_peak_bytes is not None]
        rows.sort(key=lambda row: -(row["hbm_peak_bytes"] or 0))
        return rows[:n]


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------


def is_resource_exhausted(exc: BaseException) -> bool:
    """Whether ``exc`` is a failed device allocation."""
    import torch

    return isinstance(exc, torch.OutOfMemoryError)


def write_oom_report(path: str, *, ledger: ProgramLedger | None = None,
                     error: BaseException | None = None,
                     config_levers: dict | None = None,
                     current_iter: int | None = None) -> dict:
    """Writes ``logs/oom_report.json`` atomically (the JAX report's keys,
    plus the error's class) and returns it; a failed write warns and
    returns the document."""
    try:
        watermarks = sample_memory_stats()
    except Exception:  # noqa: BLE001 - forensics must not mask the OOM
        watermarks = None
    doc = {
        "schema": OOM_REPORT_SCHEMA,
        "t": time.time(),
        "exit_code": OOM_EXIT_CODE,
        "error": str(error)[:2000] if error is not None else None,
        "error_type": (f"{type(error).__module__}.{type(error).__qualname__}"
                       if error is not None else None),
        "current_iter": current_iter,
        "memory_watermarks": watermarks,
        "top_programs_by_temp_bytes": (
            ledger.top_by_temp_bytes() if ledger is not None else []
        ),
        "programs_recorded": len(ledger.entries()) if ledger else 0,
        "config_levers": dict(config_levers or {}),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
    except OSError as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        print(f"WARNING: could not write OOM report to {path} ({exc})", file=sys.stderr)
    return doc

"""Device resources of a training run: the program ledger, the MFU peak,
memory watermarks and OOM forensics
(``howtotrainyourmamlpytorch_tpu/telemetry/device.py``).

* :class:`ProgramLedger`: one row per captured train-step program (its
  ``(second_order, final_only)`` branch, batch shape and dtype), and in a
  serving engine one per bucket's adapt and classify programs
  (``record``, from its warmup). FLOPs per
  iteration come from ``torch.utils.flop_counter.FlopCounterMode``
  (:func:`flop_counter`) around
  the eager warm-up step that precedes each capture
  (``models/step_graph.warmup_hooks``), never inside a capture, divided by
  the warm-up steps. Memory is the caching allocator's counters
  (``torch.cuda.memory_stats``) after that warm-up. A dispatch's FLOPs are
  the row's times the learner's declared ``dispatch_multiplier`` K. The
  ledger adds no step, no capture and no synchronisation.
* The roofline inputs: ``bytes_accessed`` is counted over the same
  warm-up by :func:`byte_counter`, each dispatched aten op's operand and
  result bytes, over exactly the ops the FLOP counter executes (it sits
  under the FLOP counter, so it sees the ops after the FLOP counter's
  decompositions); ops that only alias (views, reshapes, ``expand``) or
  only allocate move nothing. ``arithmetic_intensity`` is FLOPs over those
  bytes. It is a count before fusion: every intermediate is written and
  read again, where XLA's ``bytes accessed`` in the JAX ledger is counted
  after fusion. The fused-norm kernels, launched through ctypes, are in
  neither count.
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


def flop_counter():
    """A ``FlopCounterMode`` that prints no table and whose dispatch does
    not import ``torch._dynamo``. Its ``__torch_dispatch__`` is wrapped to
    disable dynamo, and the wrapper imports dynamo, and the compiler stack
    behind it, at its first call: seconds on the CPU, more on a card's
    installation, paid by every trainer and serving worker at its first
    count. Nothing in this package compiles with dynamo, so the wrapped
    function may run as it is: it is given as its own disabled form, the
    cache the wrapper reads first."""
    from torch.utils import flop_counter as counter

    dispatch = getattr(counter, "_FlopCounterMode", None)
    raw = getattr(getattr(dispatch, "__torch_dispatch__", None), "__wrapped__", None)
    if raw is not None and getattr(raw, "__dynamo_disable", None) is None:
        raw.__dynamo_disable = raw
    return counter.FlopCounterMode(display=False)


#: Allocations: they write no byte a later op reads before it is written.
_ALLOCATING_OPS = ("empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided")


def _moves_bytes(func) -> bool:
    """Whether an aten op moves bytes: not a view (``is_view``: ``view``,
    ``expand``, ``transpose``, ``detach``, ...), not ``_unsafe_view`` (the
    alias a ``reshape`` ends in) and not an allocation."""
    name = func._overloadpacket.__name__
    return not (getattr(func, "is_view", False) or name == "_unsafe_view"
                or name in _ALLOCATING_OPS)


def byte_counter():
    """A dispatch mode whose ``bytes`` sums, over each aten op it sees that
    returns a tensor and moves bytes (:func:`_moves_bytes`), the bytes of
    its tensor operands and results (``numel * element_size``, a broadcast
    operand at its broadcast size). Entered before :func:`flop_counter`,
    so it sees the ops the FLOP counter runs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def tensor_bytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if _moves_bytes(func):
                written = tensor_bytes(out)
                if written:
                    self.bytes += written + tensor_bytes((args, kwargs))
            return out

    return ByteCounter()


def program_name(second_order: bool, final_only: bool) -> str:
    """A captured train step's name in the ledger and its ``capture`` event."""
    return (f"train_step[{'second' if second_order else 'first'}_order"
            f"{',final_only' if final_only else ''}]")


def program_signature(shapes) -> str:
    """A captured step's batch shapes (``((shape, dtype), ...)``) as the
    ledger's signature string."""
    return str([list(s) for s, _ in shapes])[:160]


@dataclasses.dataclass
class ProgramEntry:
    """One captured program's row (host values only). ``flops`` and
    ``bytes_accessed`` are per iteration; ``dispatch_flops`` is ``k`` (the
    last dispatch's declared multiplier) times the FLOPs;
    ``arithmetic_intensity`` is FLOPs per byte."""

    name: str
    role: str = "train"
    signature: str = ""
    k: int = 1
    flops: float | None = None
    dispatch_flops: float | None = None
    bytes_accessed: float | None = None
    arithmetic_intensity: float | None = None
    hbm_peak_bytes: int | None = None
    bytes_in_use: int | None = None
    device_kind: str = ""
    compute_dtype: str = "float32"
    bucket: str | None = None
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
        bytes and reads the allocator's counters after it. ``key`` is the
        graph's ``(second_order, final_only, shapes-and-dtypes)``."""
        import torch

        moved, counter = byte_counter(), flop_counter()
        with moved, counter:
            yield
        second_order, final_only, shapes = key if key is not None else (True, False, ())
        steps = max(int(steps), 1)
        entry = ProgramEntry(
            name=program_name(second_order, final_only),
            signature=program_signature(shapes),
            flops=float(counter.get_total_flops()) / steps,
            bytes_accessed=float(moved.bytes) / steps,
            compute_dtype="bfloat16" if "bfloat16" in str(shapes) else "float32",
            t=time.time(),
        )
        if entry.flops and entry.bytes_accessed:
            entry.arithmetic_intensity = entry.flops / entry.bytes_accessed
        if torch.cuda.is_available():
            stats = torch.cuda.memory_stats()
            entry.device_kind = torch.cuda.get_device_name()
            entry.hbm_peak_bytes = int(stats.get("allocated_bytes.all.peak", 0))
            entry.bytes_in_use = int(stats.get("allocated_bytes.all.current", 0))
        entry.dispatch_flops = entry.flops
        with self._lock:
            self._entries[(entry.name, entry.signature)] = entry
            self._pending.append(entry)

    # -- a serve program ---------------------------------------------------

    def record(self, name: str, *, role: str, flops: float | None,
               hbm_peak_bytes: int | None = None, device_kind: str = "",
               bucket: str | None = None, signature: str = "") -> ProgramEntry:
        """One measured program's row (the serving engine's adapt and
        classify programs, ``k`` 1), emitted at once as ``program_profile``."""
        entry = ProgramEntry(
            name=str(name), role=str(role), signature=str(signature)[:160],
            flops=None if flops is None else float(flops),
            hbm_peak_bytes=hbm_peak_bytes, device_kind=str(device_kind),
            bucket=bucket, t=time.time(),
        )
        entry.dispatch_flops = entry.flops
        with self._lock:
            self._entries[(entry.name, entry.signature)] = entry
        if self.emit_events:
            telemetry_events.emit(
                "program_profile", peak_flops=self.peak_flops(entry),
                **{key: value for key, value in entry.as_row().items() if key != "t"},
            )
        return entry

    def has_entry(self, name: str) -> bool:
        with self._lock:
            return any(key[0] == name for key in self._entries)

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

"""Rolling step-time and input-wait anomaly detection, and device memory
growth (``howtotrainyourmamlpytorch_tpu/telemetry/anomaly.py``).

:class:`RollingAnomalyDetector` keeps a bounded window of recent
per-iteration samples per kind (``step_time``, ``data_wait``,
``stage_wait``). After ``warmup`` samples, a sample beyond ``factor`` x
the window's p95 and ``p95 + min_delta_s`` fires a typed ``anomaly``
payload and is not added to the window. Pure host arithmetic, safe on
the hot path.

:class:`MemoryGrowthDetector` watches device memory in use across
forced-read boundaries (``torch.cuda.memory_allocated`` sampled at each
heartbeat) and fires when ``consecutive`` samples each rose and the rise
clears an absolute and a relative floor: a leak never spikes, it only
never comes back down.
"""

from __future__ import annotations

from collections import deque

#: Rolling-window length (samples) the p95 is computed over.
DEFAULT_WINDOW = 128

#: Samples required before detection arms (the first build, capture and
#: cold start stay out).
DEFAULT_WARMUP = 16

#: Relative threshold: a sample beyond this multiple of the window p95.
DEFAULT_FACTOR = 3.0

#: Absolute floor added to the p95 before a sample can fire — µs-scale
#: jitter on a fast program is noise, not an anomaly.
DEFAULT_MIN_DELTA_S = 0.05

#: Hard cap on anomalies reported per detector (JSONL flood guard).
DEFAULT_MAX_REPORTS = 100


class RollingAnomalyDetector:
    """Per-kind rolling windows + the threshold rule above."""

    def __init__(
        self,
        window: int = DEFAULT_WINDOW,
        warmup: int = DEFAULT_WARMUP,
        factor: float = DEFAULT_FACTOR,
        min_delta_s: float = DEFAULT_MIN_DELTA_S,
        max_reports: int = DEFAULT_MAX_REPORTS,
    ):
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        self.window = int(window)
        self.warmup = int(warmup)
        self.factor = float(factor)
        self.min_delta_s = float(min_delta_s)
        self.max_reports = int(max_reports)
        self.reports = 0
        self._windows: dict[str, deque[float]] = {}

    def _p95(self, samples: deque[float]) -> float:
        ordered = sorted(samples)
        return ordered[min(int(0.95 * len(ordered)), len(ordered) - 1)]

    def observe(self, kind: str, value_s: float) -> dict | None:
        """Feeds one per-iteration sample; returns the anomaly payload when
        it fires (caller emits the typed event), else ``None``."""
        value_s = float(value_s)
        samples = self._windows.get(kind)
        if samples is None:
            samples = self._windows[kind] = deque(maxlen=self.window)
        if len(samples) >= self.warmup:
            p95 = self._p95(samples)
            if (
                value_s > self.factor * p95
                and value_s > p95 + self.min_delta_s
            ):
                self.reports += 1
                payload = None
                if self.reports <= self.max_reports:
                    payload = {
                        "kind": kind,
                        "value_s": value_s,
                        "window_p95_s": p95,
                        "factor": round(value_s / p95, 2) if p95 > 0 else None,
                        "threshold_factor": self.factor,
                        "window": len(samples),
                    }
                # The outlier never joins the window: one hang must not
                # raise the p95 and mask its successors.
                return payload
        samples.append(value_s)
        return None

    def window_stats(self, kind: str) -> dict | None:
        """Host-side summary of one kind's current window — the heartbeat's
        "windowed" figures read exactly this."""
        samples = self._windows.get(kind)
        if not samples:
            return None
        total = sum(samples)
        return {
            "count": len(samples),
            "sum_s": total,
            "mean_s": total / len(samples),
            "p95_s": self._p95(samples),
        }


#: Consecutive rising boundary samples before memory growth can fire.
MEMORY_GROWTH_WINDOWS = 6

#: Absolute floor on the rise (allocator jitter on a healthy run rounds
#: to megabytes; a real leak climbs by buffers).
MEMORY_GROWTH_MIN_DELTA_BYTES = 64 << 20

#: Relative floor: the rise must also exceed this fraction of the value
#: at the start of the rising run (a 64 MB climb on a 60 GB-resident
#: program is still worth flagging only once it compounds).
MEMORY_GROWTH_MIN_FRAC = 0.02

#: Report cap (JSONL flood guard, like the rolling detector's).
MEMORY_GROWTH_MAX_REPORTS = 20


class MemoryGrowthDetector:
    """Monotonic ``bytes_in_use`` growth across forced-read windows.

    Fed one sample per heartbeat boundary (``TrainTelemetry`` reads
    ``torch.cuda.memory_allocated``, the caching allocator's host-side
    counter: no synchronisation; never fed on the CPU).
    Fires a typed ``memory_growth`` anomaly payload when ``consecutive``
    successive samples each rose AND the total rise clears both the
    absolute and relative floors; after firing, the rise anchor resets so
    a continuing leak fires again only after another full climb."""

    def __init__(
        self,
        consecutive: int = MEMORY_GROWTH_WINDOWS,
        min_delta_bytes: int = MEMORY_GROWTH_MIN_DELTA_BYTES,
        min_frac: float = MEMORY_GROWTH_MIN_FRAC,
        max_reports: int = MEMORY_GROWTH_MAX_REPORTS,
    ):
        if consecutive < 2:
            raise ValueError(f"consecutive must be >= 2, got {consecutive}")
        self.consecutive = int(consecutive)
        self.min_delta_bytes = int(min_delta_bytes)
        self.min_frac = float(min_frac)
        self.max_reports = int(max_reports)
        self.reports = 0
        self._last: int | None = None
        self._anchor: int | None = None  # bytes at the start of the rise
        self._rising = 0

    def observe(self, bytes_in_use: int) -> dict | None:
        """Feeds one boundary sample; returns the anomaly payload when the
        monotonic-rise rule fires (caller emits the typed event)."""
        value = int(bytes_in_use)
        if self._last is None or value <= self._last:
            # Flat or falling: a healthy steady state — reset the run.
            self._last = value
            self._anchor = value
            self._rising = 0
            return None
        self._rising += 1
        self._last = value
        anchor = self._anchor if self._anchor is not None else value
        rise = value - anchor
        if (
            self._rising >= self.consecutive
            and rise >= self.min_delta_bytes
            and rise >= self.min_frac * max(anchor, 1)
        ):
            self.reports += 1
            payload = None
            if self.reports <= self.max_reports:
                payload = {
                    "kind": "memory_growth",
                    "bytes_in_use": value,
                    "rise_bytes": rise,
                    "windows": self._rising,
                    "anchor_bytes": anchor,
                }
            # Re-arm: a continuing leak must climb a full delta again
            # before the next report (bounded JSONL, unbounded leak).
            self._anchor = value
            self._rising = 0
            return payload
        return None

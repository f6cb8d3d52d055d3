"""Metric primitives: counters, gauges and exact-window latency quantiles
(``howtotrainyourmamlpytorch_tpu/telemetry/registry.py``): the serving
metrics' primitives and the trainer's ``MetricsRegistry``.

Percentiles are exact over a bounded ring of recent samples, not read off
fixed histogram buckets; the cumulative ``count`` and ``sum`` cover the
whole process, so rates over scrapes stay right. Every primitive is
thread-safe: HTTP scrape threads read while the batcher's worker records.
"""

from __future__ import annotations

import threading
from collections import deque


class LatencyStat:
    """Cumulative count and sum plus exact percentiles over a recent
    window."""

    def __init__(self, name: str, window: int = 2048):
        self.name = name
        self._lock = threading.Lock()
        self._recent: deque[float] = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0

    def observe(self, value_ms: float) -> None:
        with self._lock:
            self._recent.append(float(value_ms))
            self._count += 1
            self._sum += float(value_ms)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile of the recent window; 0.0 when empty."""
        with self._lock:
            if not self._recent:
                return 0.0
            ordered = sorted(self._recent)
        rank = min(len(ordered) - 1, max(0, round(p / 100.0 * (len(ordered) - 1))))
        return ordered[rank]

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum_ms": total,
            "p50_ms": self.percentile(50),
            "p99_ms": self.percentile(99),
        }

    def quantile_snapshot(self, quantiles=(50, 95, 99)) -> dict:
        """``snapshot`` with the caller's quantiles."""
        with self._lock:
            count, total = self._count, self._sum
        out = {"count": count, "sum_ms": total}
        for q in quantiles:
            out[f"p{q:g}_ms"] = self.percentile(q)
        return out


class Counter:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A point-in-time value."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Named get-or-create store of the three primitives (the trainer's
    distributions); ``snapshot`` renders them for the event log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._windows: dict[str, LatencyStat] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name))

    def window(self, name: str, window: int = 2048) -> LatencyStat:
        with self._lock:
            if name not in self._windows:
                self._windows[name] = LatencyStat(name, window=window)
            return self._windows[name]

    def snapshot(self) -> dict:
        with self._lock:
            counters, gauges = dict(self._counters), dict(self._gauges)
            windows = dict(self._windows)
        return {
            "counters": {name: c.value for name, c in counters.items()},
            "gauges": {name: g.value for name, g in gauges.items()},
            "windows": {name: w.quantile_snapshot() for name, w in windows.items()},
        }

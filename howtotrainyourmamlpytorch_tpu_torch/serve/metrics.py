"""Serving metrics: latency quantiles, counters and Prometheus text
(``howtotrainyourmamlpytorch_tpu/serve/metrics.py``).

The metric names and the text ``/metrics`` serves are the JAX server's,
with two differences:

- ``maml_serve_program_compiles{program=...}`` counts the first dispatch
  of each ``(kind, shape)`` signature (``adapt:BxS``, ``classify:BxQ``),
  where JAX counts the XLA traces of its jitted serve programs. The port
  compiles nothing per signature; the count keeps the dashboard's
  guarantee (a mixed stream under a geometry lattice mints at most the
  lattice's signatures) checkable.
- Of the program ledger's rows, ``maml_serve_program_flops`` and
  ``maml_serve_program_hbm_peak_bytes`` are served (per program and bucket,
  recorded at warmup; the peak on a card only). ``_bytes_accessed``,
  ``_arithmetic_intensity`` and ``_temp_bytes`` come from XLA's analysis
  of a compiled program and are left out.

Everything here is thread-safe.
"""

from __future__ import annotations

import threading

from ..telemetry.registry import Counter, Gauge, LatencyStat

__all__ = ["Counter", "Gauge", "LatencyStat", "ServeMetrics"]


class ServeMetrics:
    """The serving runtime's metric registry, one per engine.
    ``render_prometheus`` gives ``/metrics``; ``snapshot`` the same as a
    dict."""

    PREFIX = "maml_serve"

    def __init__(self):
        self.adapt_latency = LatencyStat("adapt")
        self.classify_latency = LatencyStat("classify")
        self.request_latency = LatencyStat("request")
        self.requests_total = Counter("requests_total")
        self.request_errors = Counter("request_errors")
        self.episodes_served = Counter("episodes_served")
        self.cache_hits = Counter("cache_hits")
        self.cache_misses = Counter("cache_misses")
        self.batches_dispatched = Counter("batches_dispatched")
        self.padded_tasks = Counter("padded_tasks")
        self.shed_total = Counter("shed_total")
        self.deadline_exceeded_total = Counter("deadline_exceeded_total")
        self.swaps_total = Counter("swaps_total")
        self.swap_rejected_total = Counter("swap_rejected_total")
        # Episodes with any non-finite logit over their real slice.
        self.nonfinite_logits_total = Counter("nonfinite_logits_total")
        # Episodes padded up onto a geometry bucket, and episodes no
        # bucket could hold (a 400, not overload).
        self.geometry_coarsened_total = Counter("geometry_coarsened_total")
        self.geometry_rejected_total = Counter("geometry_rejected_total")
        self.degraded = Gauge("degraded")
        self._lock = threading.Lock()
        self._buckets: dict[tuple, dict] = {}

    def record_bucket_dispatch(self, key: tuple, episodes: int) -> None:
        with self._lock:
            row = self._buckets.setdefault(key, {"dispatches": 0, "episodes": 0})
            row["dispatches"] += 1
            row["episodes"] += episodes

    def bucket_table(self) -> dict[tuple, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._buckets.items()}

    def cache_hit_rate(self) -> float:
        hits, misses = self.cache_hits.value, self.cache_misses.value
        total = hits + misses
        return hits / total if total else 0.0

    def snapshot(self, *, queue_depth: int = 0, compile_table: dict | None = None,
                 program_table: list | None = None) -> dict:
        """``compile_table``: the engine's ``{signature: 1}`` table;
        ``program_table``: its ledger's rows."""
        return {
            "requests_total": self.requests_total.value,
            "request_errors": self.request_errors.value,
            "episodes_served": self.episodes_served.value,
            "batches_dispatched": self.batches_dispatched.value,
            "padded_tasks": self.padded_tasks.value,
            "shed_total": self.shed_total.value,
            "deadline_exceeded_total": self.deadline_exceeded_total.value,
            "swaps_total": self.swaps_total.value,
            "swap_rejected_total": self.swap_rejected_total.value,
            "nonfinite_logits_total": self.nonfinite_logits_total.value,
            "geometry_coarsened_total": self.geometry_coarsened_total.value,
            "geometry_rejected_total": self.geometry_rejected_total.value,
            "degraded": bool(self.degraded.value),
            "queue_depth": queue_depth,
            "cache": {
                "hits": self.cache_hits.value,
                "misses": self.cache_misses.value,
                "hit_rate": self.cache_hit_rate(),
            },
            "latency_ms": {
                "adapt": self.adapt_latency.snapshot(),
                "classify": self.classify_latency.snapshot(),
                "request": self.request_latency.snapshot(),
            },
            "buckets": {
                "x".join(str(d) for d in key): dict(row)
                for key, row in self.bucket_table().items()
            },
            "compiles": dict(compile_table or {}),
            "programs": [dict(row) for row in (program_table or [])],
        }

    def render_prometheus(self, *, queue_depth: int = 0,
                          compile_table: dict | None = None,
                          program_table: list | None = None) -> str:
        p = self.PREFIX
        counters = (
            ("requests_total", self.requests_total),
            ("request_errors_total", self.request_errors),
            ("episodes_served_total", self.episodes_served),
            ("batches_dispatched_total", self.batches_dispatched),
            ("padded_tasks_total", self.padded_tasks),
            ("shed_total", self.shed_total),
            ("deadline_exceeded_total", self.deadline_exceeded_total),
            ("swaps_total", self.swaps_total),
            ("swap_rejected_total", self.swap_rejected_total),
            ("nonfinite_logits_total", self.nonfinite_logits_total),
            ("geometry_coarsened_total", self.geometry_coarsened_total),
            ("geometry_rejected_total", self.geometry_rejected_total),
        )
        lines = []
        for name, counter in counters:
            lines += [f"# TYPE {p}_{name} counter", f"{p}_{name} {counter.value}"]
        lines += [
            f"# TYPE {p}_degraded gauge",
            f"{p}_degraded {int(self.degraded.value)}",
            f"# TYPE {p}_queue_depth gauge",
            f"{p}_queue_depth {queue_depth}",
            f"# TYPE {p}_cache_hits_total counter",
            f"{p}_cache_hits_total {self.cache_hits.value}",
            f"# TYPE {p}_cache_misses_total counter",
            f"{p}_cache_misses_total {self.cache_misses.value}",
            f"# TYPE {p}_cache_hit_rate gauge",
            f"{p}_cache_hit_rate {self.cache_hit_rate():.6f}",
        ]
        for stage, stat in (
            ("adapt", self.adapt_latency),
            ("classify", self.classify_latency),
            ("request", self.request_latency),
        ):
            snap = stat.snapshot()
            lines += [
                f"# TYPE {p}_{stage}_latency_ms summary",
                f'{p}_{stage}_latency_ms{{quantile="0.5"}} {snap["p50_ms"]:.6f}',
                f'{p}_{stage}_latency_ms{{quantile="0.99"}} {snap["p99_ms"]:.6f}',
                f"{p}_{stage}_latency_ms_count {snap['count']}",
                f"{p}_{stage}_latency_ms_sum {snap['sum_ms']:.6f}",
            ]
        lines.append(f"# TYPE {p}_bucket_episodes_total counter")
        for key, row in sorted(self.bucket_table().items()):
            label = "x".join(str(d) for d in key)
            lines.append(
                f'{p}_bucket_episodes_total{{bucket="{label}"}} {row["episodes"]}'
            )
        lines.append(f"# TYPE {p}_program_compiles counter")
        for label, count in sorted((compile_table or {}).items()):
            lines.append(f'{p}_program_compiles{{program="{label}"}} {count}')
        for metric, field in (("program_flops", "flops"),
                              ("program_hbm_peak_bytes", "hbm_peak_bytes")):
            rows = [row for row in (program_table or []) if row.get(field) is not None]
            if not rows:
                continue
            lines.append(f"# TYPE {p}_{metric} gauge")
            for row in sorted(rows, key=lambda r: str(r.get("name"))):
                lines.append(f'{p}_{metric}{{program="{row.get("name", "?")}",'
                             f'bucket="{row.get("bucket") or ""}"}} {row[field]:g}')
        return "\n".join(lines) + "\n"

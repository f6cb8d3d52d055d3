"""Admission control: bounded queues, graceful degradation, early 503s
(``howtotrainyourmamlpytorch_tpu/serve/resilience/admission.py``).

* Hard limit (``max_queue_depth``): at this many queued episodes every
  request is shed with ``OverloadedError`` (503 + ``Retry-After``).
* Degraded (``degrade_queue_depth``, or the oldest queued request older
  than ``max_queue_age_ms``): only cache-hit traffic is admitted. A
  cache miss pays the whole inner loop; shedding it first keeps the cheap
  classify tier at its latency.

Pure policy over two live signals; it owns no thread and no device state.
"""

from __future__ import annotations

from ..engine import ServeConfig
from ..errors import OverloadedError
from ..metrics import ServeMetrics


class AdmissionController:
    """Shed-or-admit, evaluated at the front door of every request."""

    def __init__(self, config: ServeConfig, metrics: ServeMetrics):
        self.config = config
        self.metrics = metrics

    def degraded(self, queue_depth: int, oldest_age_s: float) -> bool:
        cfg = self.config
        if 0 < cfg.degrade_queue_depth <= queue_depth:
            return True
        return oldest_age_s * 1e3 >= cfg.max_queue_age_ms > 0

    def admit(self, *, queue_depth: int, oldest_age_s: float, cache_hit: bool) -> None:
        """Raises ``OverloadedError`` when the request must be shed; sets
        the ``degraded`` gauge and counts ``shed_total``."""
        cfg = self.config
        degraded = self.degraded(queue_depth, oldest_age_s)
        self.metrics.degraded.set(1.0 if degraded else 0.0)
        if queue_depth >= cfg.max_queue_depth:
            self.metrics.shed_total.inc()
            raise OverloadedError(
                f"queue depth {queue_depth} at the {cfg.max_queue_depth} "
                "hard limit — request shed",
                retry_after_s=cfg.retry_after_s,
            )
        if degraded and not cache_hit:
            self.metrics.shed_total.inc()
            raise OverloadedError(
                f"server degraded (queue depth {queue_depth}, oldest wait "
                f"{oldest_age_s * 1e3:.0f} ms) — cold-adapt request shed; "
                "cached support sets still served",
                retry_after_s=cfg.retry_after_s,
            )

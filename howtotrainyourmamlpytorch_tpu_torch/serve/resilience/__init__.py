"""The serving runtime's fault tolerance
(``howtotrainyourmamlpytorch_tpu/serve/resilience/``):

* ``admission`` - bounded queues: shed with 503 + ``Retry-After`` before
  the queue melts, cache-miss traffic first when degraded;
* ``swap`` - safe hot swap: verify the checkpoint, canary every warmed
  bucket against the candidate state, then publish;
* ``replica`` - the replica flavours ``serve/pool.py`` supervises
  (in-process, behind a URL, a worker process);
* ``promotion`` - the control plane's promotion daemon: it watches the
  trainer's checkpoints, stages, verifies and gates each candidate,
  promotes it canary-first, journals every phase and rolls back when the
  post-publish SLO watch sees live traffic regress;
* ``autoscaler`` - the fleet's size from a declared policy over
  ``/healthz`` and ``/metrics``, journaled before each resize.

The two daemons are plain Python over HTTP and files; their command lines
are the package's ``promotion_daemon`` and ``autoscaler_daemon``.
"""

import importlib

#: Each public name and the submodule that defines it, loaded on first use
#: (the daemons import no torch; see ``serve/__init__.py``).
_EXPORTS = {
    "AdmissionController": "admission",
    "Replica": "replica",
    "LocalReplica": "replica",
    "HttpReplica": "replica",
    "SubprocessReplica": "replica",
    "SwapResult": "swap",
    "promote_checkpoint": "swap",
    "promote_state": "swap",
    "PromotionConfig": "promotion",
    "PromotionDaemon": "promotion",
    "PromotionJournal": "promotion",
    "SloWatch": "promotion",
    "AutoscalerConfig": "autoscaler",
    "AutoscalerDaemon": "autoscaler",
    "AutoscalerPolicy": "autoscaler",
    "Observation": "autoscaler",
    "decide": "autoscaler",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value

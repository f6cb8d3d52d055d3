"""The serving runtime's fault tolerance
(``howtotrainyourmamlpytorch_tpu/serve/resilience/``):

* ``admission`` - bounded queues: shed with 503 + ``Retry-After`` before
  the queue melts, cache-miss traffic first when degraded;
* ``swap`` - safe hot swap: verify the checkpoint, canary every warmed
  bucket against the candidate state, then publish;
* ``replica`` - the replica flavours ``serve/pool.py`` supervises
  (in-process, behind a URL, a worker process).

The promotion daemon and the autoscaler are ROADMAP A11.
"""

from .admission import AdmissionController
from .replica import HttpReplica, LocalReplica, Replica, SubprocessReplica
from .swap import SwapResult, promote_checkpoint, promote_state

__all__ = [
    "AdmissionController",
    "Replica",
    "LocalReplica",
    "HttpReplica",
    "SubprocessReplica",
    "SwapResult",
    "promote_checkpoint",
    "promote_state",
]

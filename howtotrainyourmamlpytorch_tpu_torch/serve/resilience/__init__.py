"""The serving runtime's fault tolerance
(``howtotrainyourmamlpytorch_tpu/serve/resilience/``), single process:

* ``admission`` - bounded queues: shed with 503 + ``Retry-After`` before
  the queue melts, cache-miss traffic first when degraded;
* ``swap`` - safe hot swap: verify the checkpoint, canary every warmed
  bucket against the candidate state, then publish.

The replica flavours, the promotion daemon and the autoscaler are ROADMAP
A11.
"""

from .admission import AdmissionController
from .swap import SwapResult, promote_checkpoint, promote_state

__all__ = ["AdmissionController", "SwapResult", "promote_checkpoint", "promote_state"]

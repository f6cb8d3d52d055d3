"""The port's few-shot serving runtime, single process
(``howtotrainyourmamlpytorch_tpu/serve/``): load a trained state, adapt to
a request's support set, answer its queries, on the card.

* ``engine``     - bucketed adapt + classify dispatches over a padded task
  axis, the atomic published state, warmup and the swap canary;
* ``batcher``    - deadline micro-batching on one fenced worker thread,
  which does all device work;
* ``cache``      - the LRU of adapted fast weights by support digest;
* ``geometry``   - coarsening mixed episode shapes onto a bucket lattice;
* ``metrics``    - latency quantiles, counters, Prometheus text;
* ``errors``     - the typed failures;
* ``resilience`` - admission control and the safe hot swap;
* ``api``        - ``ServingAPI`` and the HTTP front door.

Entry point: ``python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_maml``.
The replica pool, the durable tier and the control-plane daemons are
ROADMAP A11.
"""

from .api import ServingAPI, make_http_server
from .batcher import MicroBatcher
from .cache import AdaptedParamsCache, routing_digest, support_digest
from .engine import EpisodeRequest, ServeConfig, ServingEngine
from .errors import (
    DeadlineExceededError,
    DispatchFailedError,
    NoHealthyReplicaError,
    OverloadedError,
    ReplicaDeadError,
    ServeError,
    SwapRejectedError,
)
from .metrics import ServeMetrics

__all__ = [
    "ServingAPI",
    "make_http_server",
    "MicroBatcher",
    "AdaptedParamsCache",
    "routing_digest",
    "support_digest",
    "EpisodeRequest",
    "ServeConfig",
    "ServingEngine",
    "ServeMetrics",
    "ServeError",
    "OverloadedError",
    "NoHealthyReplicaError",
    "DeadlineExceededError",
    "DispatchFailedError",
    "ReplicaDeadError",
    "SwapRejectedError",
]

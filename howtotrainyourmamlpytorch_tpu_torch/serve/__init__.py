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
* ``resilience`` - admission control, the safe hot swap, the replica
  flavours the pool supervises, and the control plane's promotion daemon
  and autoscaler;
* ``pool``       - N replicas behind one front door: health-probed,
  restarted with backoff and a circuit breaker, re-dispatch on a death,
  routing by digest on a consistent-hash ring;
* ``tier``       - the durable serving state: the artifact spill under
  the LRU, the fenced executable cache of the kernel library, the ring;
* ``api``        - ``ServingAPI`` and the HTTP front door, over one engine
  or a pool.

Entry points: ``python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_maml``
(``--replicas N`` for a supervised pool), ``python3 -m
howtotrainyourmamlpytorch_tpu_torch.serve_loadtest`` (the open-loop SLO
verdict), and the control plane over a front door: ``python3 -m
howtotrainyourmamlpytorch_tpu_torch.promotion_daemon`` (the trainer's
checkpoints promoted, watched and rolled back) and ``python3 -m
howtotrainyourmamlpytorch_tpu_torch.autoscaler_daemon`` (the pool's size
from its load), both in ``resilience``.
"""

import importlib

#: Each public name and the submodule that defines it. The submodules load
#: on first use, so that the control plane's daemons, which need only
#: ``resilience.promotion``, ``resilience.autoscaler`` and ``errors``,
#: never import torch.
_EXPORTS = {
    "ServingAPI": "api",
    "make_http_server": "api",
    "MicroBatcher": "batcher",
    "AdaptedParamsCache": "cache",
    "routing_digest": "cache",
    "support_digest": "cache",
    "EpisodeRequest": "engine",
    "ServeConfig": "engine",
    "ServingEngine": "engine",
    "ServeMetrics": "metrics",
    "ServeError": "errors",
    "OverloadedError": "errors",
    "NoHealthyReplicaError": "errors",
    "DeadlineExceededError": "errors",
    "DispatchFailedError": "errors",
    "ReplicaDeadError": "errors",
    "SwapRejectedError": "errors",
    "PoolConfig": "pool",
    "ReplicaPool": "pool",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value

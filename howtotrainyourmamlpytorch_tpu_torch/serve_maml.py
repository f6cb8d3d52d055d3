"""Few-shot serving command line of the port (``tools/serve_maml.py``): an
experiment JSON and a checkpoint in, an HTTP endpoint out, on the card.

    python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_maml \\
        --config experiment_config/omniglot_maml++-omniglot_1_8_0.1_64_5_0.json \\
        (--checkpoint <experiment>/saved_models/train_model_latest | --init_from_scratch) \\
        [--learner maml|gradient_descent|matching_nets] \\
        [--host 127.0.0.1] [--port 8080] [--port_file <file>] \\
        [--max_batch 4] [--max_wait_ms 2.0] [--cache_capacity 256] \\
        [--max_queue_depth 64] [--degrade_queue_depth 16] \\
        [--max_queue_age_ms 2000] [--retry_after_s 1.0] \\
        [--warmup 5x1x15,5x5x15] [--telemetry serve_telemetry.jsonl] \\
        [--tier_dir <dir>] [--replicas 2] [--device cpu] [--debug_kernels] \\
        [--use_pallas_fused_norm True]

Then::

    curl localhost:8080/healthz
    curl -d @episode.json localhost:8080/v1/episode
    curl -d '{"checkpoint": "<path>"}' localhost:8080/admin/promote
    curl localhost:8080/metrics

The network comes from the same experiment JSON as the training run,
through the training command line's parser (``utils/parser_utils.get_args``);
flags this command does not know go to that parser, as on the training
command line (``--use_pallas_fused_norm True`` serves through the Hopper
norm kernels where the JSON leaves it unset). The weights come from a
verified checkpoint, parameters and BN statistics only
(``load_for_inference``), or fresh from seed 0 with ``--init_from_scratch``.
``--port 0`` binds an ephemeral port and ``--port_file`` names it once the
server listens. SIGTERM shuts the server down and exits 0. ``--tier_dir``
gives the engine a durable tier (the cache's disk spill and the kernel
library's executable cache, ``serve/tier/``).

``--replicas N`` (needs ``--warmup``) runs N worker processes of this
command, one engine each, under a ``serve/pool.ReplicaPool`` behind this
front door: health-probed every ``--health_interval_s``, restarted after
``--restart_backoff_s`` (doubling) and parked by the circuit breaker. With
``--tier_dir`` worker i keeps its tier at ``<tier_dir>/replica-<i>`` and
each support set is routed to one worker by digest, so that its spill
holds the set's artifact (and a dead worker's successor adopts it). A worker
killed by the ``replica_kill_at_request`` fault exits 86. SIGTERM drains
the pool: every worker is stopped before the front door exits.

It runs on the card and raises without one (``main(argv, device="cpu")``
or ``--device cpu`` for the CPU; with ``--replicas`` the workers get the
same ``--device``, and none without it, so each takes the card).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import threading

LEARNERS = ("maml", "gradient_descent", "matching_nets")


def parse_warmup(spec: str) -> list[tuple[int, int, int]]:
    """``"5x1x15,20x1x5"`` -> ``[(5, 1, 15), (20, 1, 5)]``."""
    buckets = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        dims = part.split("x")
        if len(dims) != 3:
            raise ValueError(
                f"warmup bucket {part!r} must be WAYxSHOTxQUERY (e.g. 5x1x15)"
            )
        buckets.append(tuple(int(d) for d in dims))
    return buckets


def build_learner(name: str, config_path: str, train_flags=(), device=None):
    """``(learner, device)`` from an experiment JSON through the training
    run's parser and ``args_to_maml_config``; ``train_flags`` are more
    training command-line flags."""
    from .models import GradientDescentLearner, MAMLFewShotLearner, MatchingNetsLearner
    from .utils.parser_utils import args_to_maml_config, get_args

    os.environ.setdefault("DATASET_DIR", "datasets")  # serving reads no data
    args, device = get_args(
        ["--name_of_args_json_file", config_path, *train_flags], device
    )
    cls = {
        "maml": MAMLFewShotLearner,
        "gradient_descent": GradientDescentLearner,
        "matching_nets": MatchingNetsLearner,
    }[name]
    return cls(args_to_maml_config(args)), device


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Few-shot serving on an NVIDIA GPU (PyTorch port)"
    )
    add = parser.add_argument
    add("--config", required=True, help="experiment config JSON (the training run's)")
    add("--checkpoint", default=None, help="checkpoint file (e.g. .../train_model_latest)")
    add("--learner", choices=LEARNERS, default="maml")
    add("--host", default="127.0.0.1")
    add("--port", type=int, default=8080)
    add("--port_file", default=None, help="write the bound port here once listening")
    add("--max_batch", type=int, default=4)
    add("--max_wait_ms", type=float, default=2.0)
    add("--cache_capacity", type=int, default=256)
    add("--max_queue_depth", type=int, default=64,
        help="admission hard limit: shed (503 + Retry-After) at this depth")
    add("--degrade_queue_depth", type=int, default=16,
        help="admission soft limit: shed cache-miss traffic past this depth (0 disables)")
    add("--max_queue_age_ms", type=float, default=2000.0)
    add("--retry_after_s", type=float, default=1.0)
    add("--warmup", default="",
        help="comma-separated WAYxSHOTxQUERY buckets to serve once before listening")
    add("--telemetry", default=None,
        help="append serve_dispatch / serve_compile / swap events to this JSONL")
    add("--init_from_scratch", action="store_true",
        help="serve fresh weights from seed 0 (no checkpoint)")
    add("--tier_dir", default=None,
        help="durable serving tier root (disk spill, kernel-library cache); "
             "with --replicas, worker i's is <tier_dir>/replica-<i> and "
             "support sets are routed to workers by digest")
    add("--replicas", type=int, default=0,
        help="run N supervised worker processes behind this front door "
             "(0 = single process)")
    add("--health_interval_s", type=float, default=0.5)
    add("--restart_backoff_s", type=float, default=1.0)
    add("--device", default=None,
        help="device of the engine (and of the workers); the card by default")
    add("--debug_kernels", action="store_true",
        help="serve GET /debug/kernels: the fused-norm kernels' launch counts "
             "and shapes in this process")
    return parser


def build_api(opts, train_flags=(), device=None, geometry_lattice=None):
    """The warmed ``ServingAPI`` ``opts`` describe (on ``device``, else
    ``opts.device``, else the card), and a line naming it.
    ``geometry_lattice``: the engine's ``(way, shot, query)`` buckets
    (``ServeConfig.geometry_lattice``), or None for exact buckets."""
    import torch

    from .serve import ServeConfig, ServingAPI

    if device is None:
        device = getattr(opts, "device", None)
    learner, device = build_learner(opts.learner, opts.config, train_flags, device)
    if opts.init_from_scratch:
        state, exp_state = (
            learner.init_inference_state(torch.Generator().manual_seed(0), device), {}
        )
    else:
        state, exp_state = learner.load_inference_state(opts.checkpoint, device)
    api = ServingAPI(
        learner, state,
        ServeConfig(
            meta_batch_size=opts.max_batch, max_wait_ms=opts.max_wait_ms,
            cache_capacity=opts.cache_capacity, max_queue_depth=opts.max_queue_depth,
            degrade_queue_depth=opts.degrade_queue_depth,
            max_queue_age_ms=opts.max_queue_age_ms, retry_after_s=opts.retry_after_s,
            tier_dir=getattr(opts, "tier_dir", None),
            geometry_lattice=tuple(geometry_lattice) if geometry_lattice else None,
        ),
        device=device,
    )
    if opts.warmup:
        buckets = parse_warmup(opts.warmup)
        print(f"warming {len(buckets)} bucket(s): {buckets}", flush=True)
        api.warmup(buckets)
    return api, (f"{opts.learner} on {device} "
                 f"(epoch state: {exp_state.get('current_iter', 'fresh')})")


def build_pool(opts, train_flags=(), device=None):
    """The ``--replicas N`` topology: N worker processes of this command
    under pool supervision, and a line naming it."""
    from .serve.pool import PoolConfig, ReplicaPool
    from .serve.resilience.replica import SubprocessReplica, serve_maml_argv

    run_dir = tempfile.mkdtemp(prefix="serve_pool_")
    tier_root = opts.tier_dir

    def factory(index: int) -> SubprocessReplica:
        port_file = os.path.join(run_dir, f"replica_{index}.port")
        try:
            os.remove(port_file)
        except OSError:
            pass
        argv = serve_maml_argv(
            opts.config, port_file=port_file, checkpoint=opts.checkpoint,
            learner=opts.learner, warmup=opts.warmup, telemetry=opts.telemetry,
            max_batch=opts.max_batch, max_wait_ms=opts.max_wait_ms,
            cache_capacity=opts.cache_capacity, max_queue_depth=opts.max_queue_depth,
            degrade_queue_depth=opts.degrade_queue_depth,
            max_queue_age_ms=opts.max_queue_age_ms, retry_after_s=opts.retry_after_s,
            tier_dir=tier_root and os.path.join(tier_root, f"replica-{index}"),
            device=device, train_flags=train_flags,
        )
        return SubprocessReplica(argv, replica_id=f"worker-{index}", port_file=port_file,
                                 log_path=os.path.join(run_dir, f"replica_{index}.log"))

    pool = ReplicaPool(factory, PoolConfig(
        n_replicas=opts.replicas, health_interval_s=opts.health_interval_s,
        restart_backoff_s=opts.restart_backoff_s,
        route_by_digest=bool(tier_root), tier_root=tier_root,
    ))
    return pool, f"{opts.replicas}-replica pool (worker logs in {run_dir})"


def main(argv=None, device=None) -> int:
    """Serves until SIGTERM (or Ctrl-C); returns 0. Raises without a CUDA
    device unless ``device`` (or ``--device``) names another."""
    parser = get_parser()
    opts, train_flags = parser.parse_known_args(argv)
    if not opts.checkpoint and not opts.init_from_scratch:
        parser.error("--checkpoint is required (or pass --init_from_scratch)")
    if opts.replicas > 0 and not opts.warmup:
        # A worker is routable once warm: one that never warms stays
        # STARTING and the pool would have no replica to route to.
        parser.error("--replicas requires --warmup WAYxSHOTxQUERY[,...]: pool "
                     "workers only become routable after warming their buckets")
    device = device if device is not None else opts.device
    from .serve import make_http_server
    from .telemetry import events

    sink, stop, flusher = None, threading.Event(), None
    if opts.telemetry:
        os.makedirs(os.path.dirname(os.path.abspath(opts.telemetry)), exist_ok=True)
        sink = events.EventLog(opts.telemetry)
        events.install(sink)

        def flush_loop():
            while not stop.wait(1.0):
                sink.flush()
            sink.flush()

        flusher = threading.Thread(target=flush_loop, name="serve-telemetry-flusher",
                                   daemon=True)
        flusher.start()
    api = server = None
    previous = None
    try:
        if opts.replicas > 0:
            api, detail = build_pool(opts, train_flags, device)
        else:
            api, detail = build_api(opts, train_flags, device)
        server = make_http_server(api, opts.host, opts.port, opts.debug_kernels)
        host, port = server.server_address[:2]
        if threading.current_thread() is threading.main_thread():
            # shutdown() waits for serve_forever, so it runs off this
            # thread. SIGTERM drains through the finally below, so a pool's
            # workers are stopped, never orphaned.
            previous = signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
                target=server.shutdown, daemon=True).start())
        if opts.port_file:
            tmp = opts.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, opts.port_file)
        print(f"serving {detail} on http://{host}:{port} — "
              "/v1/episode /admin/promote /healthz /metrics", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        if server is not None:
            server.server_close()
        if api is not None:
            api.close()
        if sink is not None:
            stop.set()
            flusher.join(timeout=10)
            events.install(None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

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
server listens. SIGTERM shuts the server down and exits 0.

It runs on the card and raises without one (``main(argv, device="cpu")``
for the CPU). ``--replicas N > 0``, a supervised replica pool, raises:
ROADMAP A11 (``--health_interval_s`` and ``--restart_backoff_s`` are its
flags).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
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
    add("--replicas", type=int, default=0,
        help="supervised worker replicas (0 = single process; > 0 is ROADMAP A11)")
    add("--health_interval_s", type=float, default=0.5)
    add("--restart_backoff_s", type=float, default=1.0)
    return parser


def build_api(opts, train_flags=(), device=None):
    """The warmed ``ServingAPI`` ``opts`` describe, and a line naming it."""
    import torch

    from .serve import ServeConfig, ServingAPI

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
        ),
        device=device,
    )
    if opts.warmup:
        buckets = parse_warmup(opts.warmup)
        print(f"warming {len(buckets)} bucket(s): {buckets}", flush=True)
        api.warmup(buckets)
    return api, (f"{opts.learner} on {device} "
                 f"(epoch state: {exp_state.get('current_iter', 'fresh')})")


def main(argv=None, device=None) -> int:
    """Serves until SIGTERM (or Ctrl-C); returns 0. Raises without a CUDA
    device unless ``device`` names another."""
    parser = get_parser()
    opts, train_flags = parser.parse_known_args(argv)
    if not opts.checkpoint and not opts.init_from_scratch:
        parser.error("--checkpoint is required (or pass --init_from_scratch)")
    if opts.replicas > 0:
        raise NotImplementedError(
            "--replicas (the supervised replica pool) is ROADMAP item A11"
        )
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
        api, detail = build_api(opts, train_flags, device)
        server = make_http_server(api, opts.host, opts.port)
        host, port = server.server_address[:2]
        if threading.current_thread() is threading.main_thread():
            # shutdown() waits for serve_forever, so it runs off this thread.
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

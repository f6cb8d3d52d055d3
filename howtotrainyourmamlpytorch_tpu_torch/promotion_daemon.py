"""The promotion daemon's command line (``tools/promotion_daemon.py``): the
continuous train-to-serve loop of the port.

Watches a trainer's ``saved_models/`` for published epoch checkpoints
(``.ready`` markers), stages, verifies and gates each candidate, drives
the fleet's canary-first ``/admin/promote`` with retries, journals every
phase to ``logs/promotions.jsonl`` (SIGKILLed at any boundary and
restarted, it resumes exactly once), and after each publish watches the
front door's ``/metrics``, rolling back to the retained last-known-good
checkpoint when live traffic regresses
(``serve/resilience/promotion.py``)::

    python3 -m howtotrainyourmamlpytorch_tpu_torch.promotion_daemon \\
        --watch <experiment>/saved_models --target http://127.0.0.1:8080 \\
        [--journal <experiment>/logs/promotions.jsonl] \\
        [--staging <experiment>/promotion_staging] \\
        [--telemetry <experiment>/logs/telemetry.jsonl | none] \\
        [--poll_interval_s 2.0] [--val_stat val_accuracy_mean] \\
        [--val_min_delta 0.0] [--allow_missing_val_stat] \\
        [--slo_watch_s 10] [--slo_poll_s 0.5] [--p99_budget_ms 30000] \\
        [--max_error_rate 0.05] [--max_new_nonfinite 0] [--min_requests 1] \\
        [--promote_retries 3] [--promote_backoff_s 0.5] \\
        [--max_promotions 0] [--once]

It runs until SIGTERM or SIGINT (a clean close that joins both of its
threads), for one pass with ``--once``, or until ``--max_promotions N``
publishes are resolved; the exit code is 0. It speaks HTTP and reads
files only: the fleet behind ``--target`` owns the card, and this process
imports no torch, so it holds no CUDA context.
Telemetry events (``promotion_promoted``, ``promotion_rejected``,
``slo_regression``, ``slo_rollback``, ...) go to the experiment's own
JSONL stream.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading


def build_daemon(opts):
    from .serve.resilience.promotion import (
        HttpTarget,
        PromotionConfig,
        PromotionDaemon,
    )

    watch_dir = os.path.abspath(opts.watch)
    exp_dir = os.path.dirname(watch_dir)
    journal = opts.journal or os.path.join(exp_dir, "logs", "promotions.jsonl")
    staging = opts.staging or os.path.join(exp_dir, "promotion_staging")
    config = PromotionConfig(
        watch_dir=watch_dir,
        journal_path=journal,
        staging_dir=staging,
        poll_interval_s=opts.poll_interval_s,
        val_stat_key=opts.val_stat,
        require_val_stat=not opts.allow_missing_val_stat,
        val_min_delta=opts.val_min_delta,
        promote_retries=opts.promote_retries,
        promote_backoff_s=opts.promote_backoff_s,
        slo_watch_s=opts.slo_watch_s,
        slo_poll_s=opts.slo_poll_s,
        p99_budget_ms=opts.p99_budget_ms,
        max_error_rate=opts.max_error_rate,
        max_new_nonfinite=opts.max_new_nonfinite,
        min_requests=opts.min_requests,
    )
    return PromotionDaemon(HttpTarget(opts.target), config)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add = parser.add_argument
    add("--watch", required=True, help="the trainer's checkpoint directory (.../saved_models)")
    add("--target", required=True, help="the serving front door's base URL (http://host:port)")
    add("--journal", default=None,
        help="the promotions journal (default <experiment>/logs/promotions.jsonl)")
    add("--staging", default=None,
        help="where staged candidates are kept (default <experiment>/promotion_staging)")
    add("--telemetry", default=None,
        help="telemetry JSONL for the daemon's events (default "
             "<experiment>/logs/telemetry.jsonl; 'none' disables)")
    add("--poll_interval_s", type=float, default=2.0)
    add("--val_stat", default="val_accuracy_mean",
        help="the experiment statistic the validation gate reads")
    add("--val_min_delta", type=float, default=None,
        help="a candidate must beat the last-known-good's statistic by this "
             "much (unset: the statistic must only be present)")
    add("--allow_missing_val_stat", action="store_true",
        help="promote candidates with no recorded statistic (default: reject)")
    add("--slo_watch_s", type=float, default=10.0)
    add("--slo_poll_s", type=float, default=0.5)
    add("--p99_budget_ms", type=float, default=30_000.0)
    add("--max_error_rate", type=float, default=0.05)
    add("--max_new_nonfinite", type=int, default=0)
    add("--min_requests", type=int, default=1)
    add("--promote_retries", type=int, default=3)
    add("--promote_backoff_s", type=float, default=0.5)
    add("--max_promotions", type=int, default=0,
        help="exit after N resolved publishes (0: run until signalled)")
    add("--once", action="store_true", help="one scan and process pass, then exit")
    return parser


def main(argv=None) -> int:
    opts = get_parser().parse_args(argv)
    from .telemetry import events as tel_events

    exp_dir = os.path.dirname(os.path.abspath(opts.watch))
    telemetry_path = opts.telemetry or os.path.join(exp_dir, "logs", "telemetry.jsonl")
    sink = None
    if telemetry_path != "none":
        os.makedirs(os.path.dirname(os.path.abspath(telemetry_path)), exist_ok=True)
        sink = tel_events.EventLog(telemetry_path)
        tel_events.install(sink)
        tel_events.ensure_trace_id()  # joins MAML_TRACE_ID when exported

    daemon = build_daemon(opts)
    stop = threading.Event()

    def _graceful(signum, frame):
        stop.set()

    previous = {}
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[signum] = signal.signal(signum, _graceful)
        except (ValueError, OSError):
            pass
    try:
        if opts.once:
            daemon.slo.start()
            daemon.run_once()
        else:
            daemon.start()
            print(f"promotion daemon watching {opts.watch} -> {opts.target} "
                  f"(journal {daemon.config.journal_path})", flush=True)
            while not stop.is_set():
                if opts.max_promotions and daemon.resolved_promotions >= opts.max_promotions:
                    break
                stop.wait(0.2)
    finally:
        daemon.close()
        if sink is not None:
            sink.flush()
            tel_events.install(None)
        for signum, handler in previous.items():
            try:
                signal.signal(signum, handler)
            except (ValueError, OSError):
                pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The autoscaler daemon's command line (``tools/autoscaler_daemon.py``):
a journal-backed replica count that follows load.

Watches a serving front door's ``/healthz`` and ``/metrics`` (and a
heartbeat ``status.json`` for device-memory watermarks) against a declared
policy, and resizes the replica pool through POST ``/admin/scale``; each
decision is journaled (``logs/autoscale.jsonl``) before the fleet is
touched, so a SIGKILL at any boundary resumes exactly once
(``serve/resilience/autoscaler.py``)::

    python3 -m howtotrainyourmamlpytorch_tpu_torch.autoscaler_daemon \\
        --target http://127.0.0.1:8080 --journal <experiment>/logs/autoscale.jsonl \\
        [--heartbeat <experiment>/logs/status.json] [--telemetry <path>] \\
        [--min-replicas 1] [--max-replicas 8] \\
        [--up-queue-per-replica 4.0] [--up-p99-ms 250] \\
        [--down-queue-per-replica 0.5] [--down-p99-ms 50] \\
        [--step-up 2] [--step-down 1] [--cooldown-s 5] \\
        [--settle-timeout-s 30] [--confirm-samples 2] \\
        [--poll-interval-s 1.0] [--once]

It runs until SIGTERM or SIGINT (exit 0); ``--once`` drives one observe,
decide, apply, settle pass. It speaks HTTP and reads files only: the
fleet owns the card, and this process imports no torch.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading


def build_daemon(opts):
    from .serve.resilience.autoscaler import (
        AutoscalerConfig,
        AutoscalerDaemon,
        AutoscalerPolicy,
        HttpScaleTarget,
    )

    policy = AutoscalerPolicy(
        min_replicas=opts.min_replicas,
        max_replicas=opts.max_replicas,
        up_queue_per_replica=opts.up_queue_per_replica,
        up_p99_ms=opts.up_p99_ms,
        down_queue_per_replica=opts.down_queue_per_replica,
        down_p99_ms=opts.down_p99_ms,
        step_up=opts.step_up,
        step_down=opts.step_down,
        cooldown_s=opts.cooldown_s,
        settle_timeout_s=opts.settle_timeout_s,
        confirm_samples=opts.confirm_samples,
    )
    config = AutoscalerConfig(
        journal_path=os.path.abspath(opts.journal),
        poll_interval_s=opts.poll_interval_s,
        heartbeat_path=opts.heartbeat,
    )
    return AutoscalerDaemon(HttpScaleTarget(opts.target), config, policy)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add = parser.add_argument
    add("--target", required=True, help="the serving front door's base URL (http://host:port)")
    add("--journal", required=True,
        help="the scale-decision journal (e.g. <experiment>/logs/autoscale.jsonl)")
    add("--heartbeat", default=None,
        help="a heartbeat status.json whose memory watermarks veto scale-ups")
    add("--telemetry", default=None,
        help="telemetry JSONL for the autoscale events ('none' or unset disables)")
    add("--min-replicas", type=int, default=1)
    add("--max-replicas", type=int, default=8)
    add("--up-queue-per-replica", type=float, default=4.0)
    add("--up-p99-ms", type=float, default=250.0)
    add("--down-queue-per-replica", type=float, default=0.5)
    add("--down-p99-ms", type=float, default=50.0)
    add("--step-up", type=int, default=2)
    add("--step-down", type=int, default=1)
    add("--cooldown-s", type=float, default=5.0)
    add("--settle-timeout-s", type=float, default=30.0)
    add("--confirm-samples", type=int, default=2)
    add("--poll-interval-s", type=float, default=1.0)
    add("--once", action="store_true", help="one observe/decide/apply pass, then exit")
    return parser


def main(argv=None) -> int:
    opts = get_parser().parse_args(argv)
    from .telemetry import events as tel_events

    sink = None
    if opts.telemetry and opts.telemetry != "none":
        os.makedirs(os.path.dirname(os.path.abspath(opts.telemetry)), exist_ok=True)
        sink = tel_events.EventLog(opts.telemetry)
        tel_events.install(sink)
        tel_events.ensure_trace_id()

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
            daemon.run_once()
        else:
            print(f"autoscaler watching {opts.target} "
                  f"(journal {daemon.config.journal_path})", flush=True)
            daemon.run(stop)
    finally:
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

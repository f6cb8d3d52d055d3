"""Telemetry report: a run's ``logs/telemetry.jsonl`` rendered, and the
telemetry overhead bench (``tools/telemetry_report.py`` of the JAX package).

Report mode: the step-time breakdown (data wait, stage wait, device
dispatch, host sync), the capture timeline, the device section (the
program ledger's rows from ``program_profile`` events, the windowed MFU,
the memory watermarks) and the other events::

    python -m howtotrainyourmamlpytorch_tpu_torch.telemetry_report <experiment-dir | telemetry.jsonl>
    python -m howtotrainyourmamlpytorch_tpu_torch.telemetry_report <run> --json
    python -m howtotrainyourmamlpytorch_tpu_torch.telemetry_report <run> --since <unix-s>

Where the JAX report reads XLA's ``compile`` events, this one reads the
port's counterparts: the ``capture`` events of the train step's CUDA
graphs (``models/step_graph.py``) and the serving engine's
``serve_compile``, in the timeline (under the JAX key ``compiles``), and
the ``program_profile`` rows (FLOPs from ``FlopCounterMode`` at each
capture's warm-up, the allocator's peak) in the device section. The
ledger's XLA-only columns (bytes accessed, arithmetic intensity, temp
bytes, collectives) keep their keys and read ``None``.

Fleet mode: several ranks' streams (files, or one file several ranks
append to) merged into one timeline with per-rank lanes, per-dispatch
slowest-rank attribution and cross-rank skew, correlated on the
run-scoped ``trace_id`` and each step's ``dispatch_id``::

    python -m howtotrainyourmamlpytorch_tpu_torch.telemetry_report --fleet <run-or-jsonl> [<run...>] [--json]

Report and fleet modes import no torch.

Overhead bench: the ``telemetry_overhead_pct`` key. It drives the real K=1
``run_train_iter`` loop of the MAML learner over paired, alternating
timing windows, once plain and once with the whole ``TrainTelemetry``
recording path (a ``step`` event a dispatch, the forced read, flush and
heartbeat at the trainer's ``TRAIN_LOG_EVERY`` cadence), and reports the
relative throughput cost. Both variants do the same device work and the
same forced reads, so the difference is what telemetry adds. It runs on
the card (flagship width unless ``--tiny``) and raises without one, unless
``measure_overhead`` is called with ``device="cpu"``::

    python -m howtotrainyourmamlpytorch_tpu_torch.telemetry_report --overhead-bench [--tiny] [--budget-s 6] [--windows 3]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np

from .telemetry.events import SCHEMA_VERSION, EventReader, read_events

#: The port's counterparts of the JAX report's compile events: a train
#: step's CUDA-graph capture and the serving engine's first dispatch of a
#: signature.
COMPILE_TYPES = ("capture", "serve_compile")

# ---------------------------------------------------------------------------
# Report mode
# ---------------------------------------------------------------------------


def resolve_jsonl(run: str) -> str:
    """Accepts the JSONL itself, an experiment dir, or its logs/ dir."""
    if os.path.isdir(run):
        for candidate in (
            os.path.join(run, "telemetry.jsonl"),
            os.path.join(run, "logs", "telemetry.jsonl"),
        ):
            if os.path.exists(candidate):
                return candidate
        raise FileNotFoundError(f"no telemetry.jsonl under {run}")
    return run


def _percentiles_ms(samples_s: list[float]) -> dict:
    arr = np.asarray(samples_s, dtype=np.float64) * 1e3
    return {
        "count": int(arr.size),
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
        "mean_ms": float(np.mean(arr)),
        "total_s": float(np.sum(arr) / 1e3),
    }


def summarize(events: list[dict]) -> dict:
    """The report's data model (the ``--json`` output): per-iteration step
    breakdown percentiles, the capture timeline (key ``compiles``), the
    device section and the other events."""
    # Timeline origin: the earliest stamp (the schema line is stamped at
    # first FLUSH, which can postdate run_start and the first compiles).
    t0 = min((float(e["t"]) for e in events), default=0.0)
    steps = [e for e in events if e.get("type") == "step"]
    per_iter: dict[str, list[float]] = {
        "step": [], "data_wait": [], "stage_wait": [], "device": [],
    }
    for e in steps:
        k = max(int(e.get("k", 1)), 1)
        per_iter["step"].extend([float(e["step_s"]) / k] * k)
        per_iter["data_wait"].extend([float(e["data_wait_s"]) / k] * k)
        # stage_wait: consumer blocked on a staged device buffer (absent
        # from pre-stager event logs — the row simply drops out then).
        per_iter["stage_wait"].extend(
            [float(e.get("stage_wait_s", 0.0)) / k] * k
        )
        per_iter["device"].extend([float(e["device_s"]) / k] * k)
    syncs = [
        float(e["sync_s"]) for e in events if e.get("type") == "host_sync"
    ]
    breakdown = {
        name: _percentiles_ms(samples)
        for name, samples in per_iter.items()
        if samples
    }
    if syncs:
        breakdown["host_sync"] = _percentiles_ms(syncs)

    compiles = [
        {
            "t_rel_s": round(float(e["t"]) - t0, 3),
            "kind": e["type"],
            "name": e.get("name") or e.get("program", "?"),
        }
        for e in events
        if e.get("type") in COMPILE_TYPES
    ]
    log = [
        {
            "t_rel_s": round(float(e["t"]) - t0, 3),
            **{k: v for k, v in e.items() if k not in ("t", "signature")},
        }
        for e in events
        if e.get("type") not in (
            "step", *COMPILE_TYPES, "program_profile", "memory",
        )
    ]
    device = _device_section(events, per_iter["step"])
    counts: dict[str, int] = {}
    for e in events:
        counts[e.get("type", "?")] = counts.get(e.get("type", "?"), 0) + 1
    # Mesh attribution: the topology the steps ran on, from the step
    # events themselves (streams without it default to 1/single).
    n_devices = max(
        (int(e.get("n_devices", 1)) for e in steps), default=1
    )
    mesh_shapes = sorted(
        {str(e.get("mesh_shape", "single")) for e in steps}
    ) or ["single"]
    # Host attribution (several ranks may append to one JSONL): which
    # ranks contributed events, out of how many; rank 0 of 1 by default.
    process_count = max(
        (int(e.get("process_count", 1)) for e in events), default=1
    )
    process_indices = sorted(
        {int(e.get("process_index", 0)) for e in events if "process_index" in e}
    ) or [0]
    return {
        "schema": SCHEMA_VERSION,
        "iters": len(per_iter["step"]),
        "n_devices": n_devices,
        "mesh_shape": "+".join(mesh_shapes),
        "process_count": process_count,
        "process_indices": process_indices,
        "breakdown": breakdown,
        "compiles": compiles,
        "device": device,
        "events": log,
        "event_counts": counts,
    }


def _device_section(events: list[dict], step_samples_s: list[float]):
    """The device section of a run's JSONL: the program ledger's rows
    (``program_profile`` events, the newest per program name), the last
    memory watermarks, and the run's MFU from the train program's FLOPs per
    iteration times the measured iteration rate over the peak stamped on
    the event. ``None`` when the stream has no ledger row and no memory
    sample."""
    profiles: dict[str, dict] = {}
    for e in events:
        if e.get("type") == "program_profile":
            profiles[str(e.get("name", "?"))] = e
    memories = [e for e in events if e.get("type") == "memory"]
    if not profiles and not memories:
        return None
    section: dict = {
        "programs": [
            {
                key: e.get(key)
                for key in (
                    "name", "role", "k", "flops", "dispatch_flops",
                    "bytes_accessed", "arithmetic_intensity",
                    "hbm_peak_bytes", "temp_bytes", "bucket",
                    "collective_count", "comm_bytes",
                    "device_kind",
                )
            }
            for e in sorted(
                profiles.values(),
                key=lambda p: (str(p.get("role")), str(p.get("name"))),
            )
        ]
    }
    trains = [e for e in profiles.values() if e.get("role") == "train"]
    if trains and step_samples_s and sum(step_samples_s) > 0:
        train = max(trains, key=lambda e: float(e.get("t", 0.0)))
        flops = train.get("flops")
        peak = train.get("peak_flops")
        if flops and peak:
            rate = len(step_samples_s) / sum(step_samples_s)
            # Significant digits, not decimal places: a small MFU must not
            # round to zero.
            section["mfu_pct"] = float(
                f"{100.0 * rate * flops / peak:.6g}"
            )
            section["peak_flops"] = peak
    if memories:
        last = memories[-1]
        section["memory"] = {
            "devices": last.get("devices"),
            "bytes_in_use_total": last.get("bytes_in_use_total"),
            "peak_bytes_in_use_max": last.get("peak_bytes_in_use_max"),
            "samples": len(memories),
        }
    return section


def render_text(summary: dict) -> str:
    lines = []
    ranks = summary.get("process_indices", [0])
    lines.append(
        f"telemetry report — {summary['iters']} train iterations, "
        f"schema v{summary['schema']}, "
        f"{summary.get('n_devices', 1)} device(s) "
        f"[{summary.get('mesh_shape', 'single')}], "
        f"rank(s) {'+'.join(str(r) for r in ranks)} of "
        f"{summary.get('process_count', 1)} process(es)"
    )
    lines.append("")
    lines.append("step-time breakdown (per iteration)")
    header = (
        f"  {'component':<12} {'count':>7} {'p50 ms':>10} {'p95 ms':>10} "
        f"{'p99 ms':>10} {'mean ms':>10} {'total s':>9}"
    )
    lines.append(header)
    lines.append("  " + "-" * (len(header) - 2))
    for name in ("step", "data_wait", "stage_wait", "device", "host_sync"):
        row = summary["breakdown"].get(name)
        if row is None:
            continue
        lines.append(
            f"  {name:<12} {row['count']:>7} {row['p50_ms']:>10.3f} "
            f"{row['p95_ms']:>10.3f} {row['p99_ms']:>10.3f} "
            f"{row['mean_ms']:>10.3f} {row['total_s']:>9.2f}"
        )
    lines.append("")
    lines.append(f"capture timeline ({len(summary['compiles'])} events)")
    for c in summary["compiles"]:
        lines.append(f"  +{c['t_rel_s']:>9.3f}s  {c['kind']:<14} {c['name']}")
    device = summary.get("device")
    if device:
        lines.append("")
        lines.append(
            f"device-resource ledger ({len(device['programs'])} program(s))"
        )
        dheader = (
            f"  {'program':<22} {'role':<14} {'K':>4} {'flops/iter':>12} "
            f"{'bytes/iter':>12} {'flops/B':>8} {'hbm peak':>12} "
            f"{'coll':>5} {'comm B/iter':>12}"
        )
        lines.append(dheader)
        lines.append("  " + "-" * (len(dheader) - 2))

        def num(value, fmt="{:.3e}"):
            return "—" if value is None else fmt.format(value)

        for row in device["programs"]:
            lines.append(
                f"  {str(row['name'])[:22]:<22} {str(row['role']):<14} "
                f"{row.get('k') or 1:>4} {num(row.get('flops')):>12} "
                f"{num(row.get('bytes_accessed')):>12} "
                f"{num(row.get('arithmetic_intensity'), '{:.2f}'):>8} "
                f"{num(row.get('hbm_peak_bytes')):>12} "
                f"{num(row.get('collective_count'), '{:d}'):>5} "
                f"{num(row.get('comm_bytes'), '{:d}'):>12}"
            )
        if device.get("mfu_pct") is not None:
            lines.append(
                f"  windowed MFU: {device['mfu_pct']:.4g}% of peak "
                f"{device['peak_flops']:.3e} FLOP/s"
            )
        memory = device.get("memory")
        if memory and memory.get("devices"):
            lines.append(
                f"  memory watermarks ({memory['samples']} sample(s)): "
                + ", ".join(
                    f"dev{d.get('device')} in_use="
                    f"{d.get('bytes_in_use', 0):.3e} "
                    f"peak={d.get('peak_bytes_in_use', 0):.3e}"
                    for d in memory["devices"]
                )
            )
    lines.append("")
    lines.append(f"event log ({len(summary['events'])} events)")
    for e in summary["events"]:
        fields = ", ".join(
            f"{k}={v}" for k, v in e.items() if k not in ("t_rel_s", "type")
        )
        lines.append(f"  +{e['t_rel_s']:>9.3f}s  {e['type']:<18} {fields}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Fleet mode: merged multi-rank timeline + cross-rank dispatch attribution
# ---------------------------------------------------------------------------

#: Event types folded into the per-rank step lanes rather than the merged
#: timeline (one line per dispatch would drown the event log).
_LANE_TYPES = ("step",)

#: Timeline length cap in the human rendering — a multi-GB run must not
#: print a multi-GB table.
_TIMELINE_LIMIT = 200

#: Non-step events RETAINED for the merged timeline (the newest ones — a
#: post-mortem reads from the end). Everything still counts into
#: ``event_counts``; bounding retention is what keeps the fleet summary's
#: memory and ``--json`` payload finite on multi-day runs, matching the
#: streaming reader underneath.
_JSON_TIMELINE_LIMIT = 5000


def _rank_of(event: dict, default: int = 0) -> int:
    return int(event.get("process_index", default))


def fleet_events(paths: list[str], since: float | None = None):
    """Streams the events of every run path (directories or JSONL files)
    through ``EventReader``, a killed writer's complete last line included:
    a long run's logs are iterated, not loaded whole. A rank may span files
    and a file may hold several ranks; each event's ``process_index`` is
    its lane either way."""
    for path in paths:
        reader = EventReader(resolve_jsonl(path))
        yield from reader.iter_events(since=since, include_tail=True)


def fleet_summarize(paths: list[str], since: float | None = None) -> dict:
    """The fleet report's data model (the ``--fleet --json`` schema):
    per-rank step lanes, per-dispatch slowest-rank attribution keyed on
    ``dispatch_id``, cross-rank skew percentiles, trace consistency, and
    the merged non-step timeline (newest ``_JSON_TIMELINE_LIMIT`` events
    retained)."""
    import collections

    lanes: dict[int, dict[str, list[float]]] = {}
    dispatches: dict[object, dict[int, list[dict]]] = {}
    # Ledger rows per (rank, program): every rank's program costs side by
    # side (identical on a healthy lockstep fleet; a divergent row is the
    # finding).
    programs: dict[tuple[int, str], dict] = {}
    timeline: collections.deque = collections.deque(
        maxlen=_JSON_TIMELINE_LIMIT
    )
    timeline_total = 0
    trace_ids: set[str] = set()
    counts: dict[str, int] = {}
    t0 = None
    for event in fleet_events(paths, since=since):
        etype = event.get("type", "?")
        counts[etype] = counts.get(etype, 0) + 1
        t = float(event.get("t", 0.0))
        t0 = t if t0 is None else min(t0, t)
        if "trace_id" in event:
            trace_ids.add(str(event["trace_id"]))
        if etype == "schema":
            continue
        rank = _rank_of(event)
        if etype in _LANE_TYPES:
            k = max(int(event.get("k", 1)), 1)
            lane = lanes.setdefault(
                rank, {"step": [], "data_wait": [], "stage_wait": [],
                       "device": []}
            )
            lane["step"].extend([float(event["step_s"]) / k] * k)
            lane["data_wait"].extend(
                [float(event.get("data_wait_s", 0.0)) / k] * k
            )
            lane["stage_wait"].extend(
                [float(event.get("stage_wait_s", 0.0)) / k] * k
            )
            lane["device"].extend(
                [float(event.get("device_s", 0.0)) / k] * k
            )
            dispatch_id = event.get("dispatch_id", event.get("iter"))
            if dispatch_id is not None:
                # A list of occurrences per rank, not one slot: a resumed
                # run replays iterations (the same dispatch_id, one trace),
                # and a replayed sample pairs with the peers' replay of that
                # iteration, not with a dead phase's entry.
                dispatches.setdefault(dispatch_id, {}).setdefault(
                    rank, []
                ).append({
                    "t": t,
                    "step_s": float(event["step_s"]),
                    "device_s": float(event.get("device_s", 0.0)),
                })
        elif etype == "program_profile":
            programs[(rank, str(event.get("name", "?")))] = {
                "rank": rank,
                **{
                    key: event.get(key)
                    for key in (
                        "name", "role", "k", "flops", "dispatch_flops",
                        "arithmetic_intensity", "hbm_peak_bytes", "bucket",
                    )
                },
            }
        else:
            timeline.append(event)
            timeline_total += 1

    timeline = sorted(timeline, key=lambda e: float(e.get("t", 0.0)))
    t0 = t0 or 0.0

    # Per-dispatch attribution: the i-th occurrence of a dispatch_id on
    # each rank is the same logical dispatch; one seen on two or more ranks
    # has a skew (the largest step time less the smallest), and the
    # slowest rank is the straggler it points at.
    skews, slowest_counts = [], {}
    for dispatch_id, per_rank in dispatches.items():
        for occurrence in range(max(len(rows) for rows in per_rank.values())):
            by_step = {
                rank: rows[occurrence]["step_s"]
                for rank, rows in per_rank.items()
                if occurrence < len(rows)
            }
            if len(by_step) < 2:
                continue
            slowest = max(by_step, key=by_step.get)
            skew_s = max(by_step.values()) - min(by_step.values())
            skews.append((dispatch_id, slowest, skew_s))
            slowest_counts[slowest] = slowest_counts.get(slowest, 0) + 1
    skew_values = np.asarray([s for _, _, s in skews], dtype=np.float64)
    skew_stats = (
        {
            "dispatches": int(skew_values.size),
            "p50_ms": float(np.percentile(skew_values, 50) * 1e3),
            "p95_ms": float(np.percentile(skew_values, 95) * 1e3),
            "max_ms": float(np.max(skew_values) * 1e3),
        }
        if skew_values.size
        else {"dispatches": 0}
    )
    worst = sorted(skews, key=lambda row: -row[2])[:5]

    lane_summaries = {
        rank: {
            name: _percentiles_ms(samples)
            for name, samples in lane.items()
            if samples
        }
        for rank, lane in sorted(lanes.items())
    }
    process_count = max(
        [int(e.get("process_count", 1)) for e in timeline] + [len(lanes), 1]
    )
    return {
        "schema": SCHEMA_VERSION,
        "sources": [resolve_jsonl(p) for p in paths],
        "ranks": sorted(lanes),
        "process_count": process_count,
        "trace_ids": sorted(trace_ids),
        # One run-scoped trace across every lane makes the merge a single
        # timeline rather than a coincidence of files.
        "trace_consistent": len(trace_ids) <= 1,
        "lanes": lane_summaries,
        "programs": [
            # A tuple sort on (rank, name): string keys would put rank 10
            # before rank 2.
            programs[key] for key in sorted(programs)
        ],
        "dispatch_skew": skew_stats,
        "slowest_rank_dispatches": {
            str(rank): n for rank, n in sorted(slowest_counts.items())
        },
        "worst_dispatches": [
            {
                "dispatch_id": dispatch_id,
                "slowest_rank": rank,
                "skew_ms": round(skew_s * 1e3, 3),
            }
            for dispatch_id, rank, skew_s in worst
        ],
        "t0": t0,
        "timeline_events_total": timeline_total,
        "timeline_truncated": timeline_total > len(timeline),
        "timeline": [
            {
                "t_rel_s": round(float(e.get("t", 0.0)) - t0, 3),
                "rank": _rank_of(e),
                **{
                    key: value
                    for key, value in e.items()
                    if key not in ("t", "signature", "stacks", "trace_id")
                },
            }
            for e in timeline
        ],
        "event_counts": counts,
    }


def render_fleet_text(summary: dict) -> str:
    lines = []
    ranks = summary["ranks"] or [0]
    trace = (
        summary["trace_ids"][0]
        if len(summary["trace_ids"]) == 1
        else f"INCONSISTENT {summary['trace_ids']}"
        if summary["trace_ids"]
        else "(unstamped)"
    )
    lines.append(
        f"fleet telemetry report — {len(summary['sources'])} source(s), "
        f"rank lane(s) {'+'.join(str(r) for r in ranks)} of "
        f"{summary['process_count']}, trace {trace}"
    )
    lines.append("")
    lines.append("per-rank step lanes (per iteration)")
    header = (
        f"  {'rank':<5} {'component':<12} {'count':>7} {'p50 ms':>10} "
        f"{'p95 ms':>10} {'mean ms':>10} {'total s':>9}"
    )
    lines.append(header)
    lines.append("  " + "-" * (len(header) - 2))
    for rank, lane in summary["lanes"].items():
        for name in ("step", "data_wait", "stage_wait", "device"):
            row = lane.get(name)
            if row is None:
                continue
            lines.append(
                f"  {rank:<5} {name:<12} {row['count']:>7} "
                f"{row['p50_ms']:>10.3f} {row['p95_ms']:>10.3f} "
                f"{row['mean_ms']:>10.3f} {row['total_s']:>9.2f}"
            )
    if summary.get("programs"):
        lines.append("")
        lines.append(
            f"device-resource ledger ({len(summary['programs'])} "
            "program row(s) across ranks)"
        )
        for row in summary["programs"]:
            flops = row.get("flops")
            lines.append(
                f"  r{row['rank']}  {str(row.get('name')):<22} "
                f"{str(row.get('role')):<12} K={row.get('k') or 1:<4} "
                + ("flops/iter %.3e" % flops if flops else "flops n/a")
            )
    skew = summary["dispatch_skew"]
    lines.append("")
    if skew.get("dispatches"):
        lines.append(
            f"cross-rank dispatch skew over {skew['dispatches']} shared "
            f"dispatches: p50 {skew['p50_ms']:.3f} ms, "
            f"p95 {skew['p95_ms']:.3f} ms, max {skew['max_ms']:.3f} ms"
        )
        shares = ", ".join(
            f"rank {rank}: {n}"
            for rank, n in summary["slowest_rank_dispatches"].items()
        )
        lines.append(f"slowest-rank attribution (dispatch counts): {shares}")
        for row in summary["worst_dispatches"]:
            lines.append(
                f"  dispatch {row['dispatch_id']}: rank "
                f"{row['slowest_rank']} slowest by {row['skew_ms']:.3f} ms"
            )
    else:
        lines.append(
            "cross-rank dispatch skew: no dispatch observed on >= 2 ranks "
            "(single-rank stream, or pre-dispatch_id logs)"
        )
    lines.append("")
    timeline = summary["timeline"]
    total = summary.get("timeline_events_total", len(timeline))
    shown = timeline[:_TIMELINE_LIMIT]
    lines.append(
        f"merged timeline ({total} events"
        + (f", {len(shown)} shown" if len(shown) < total else "")
        + ")"
    )
    for event in shown:
        fields = ", ".join(
            f"{key}={value}"
            for key, value in event.items()
            if key not in ("t_rel_s", "type", "rank", "metrics")
        )
        lines.append(
            f"  +{event['t_rel_s']:>9.3f}s  r{event['rank']}  "
            f"{event['type']:<18} {fields}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Overhead bench (the telemetry_overhead_pct key)
# ---------------------------------------------------------------------------


def _bench_learner(tiny: bool):
    from .models import BackboneConfig, MAMLConfig, MAMLFewShotLearner

    if tiny:
        cfg = MAMLConfig(
            backbone=BackboneConfig(
                num_stages=2, num_filters=8, image_height=14, image_width=14,
                num_classes=5, per_step_bn_statistics=True, num_steps=2,
            ),
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2,
        )
    else:
        # The flagship's widths: Omniglot 5-way, 64 filters, 5 inner steps,
        # per-step batch norm.
        cfg = MAMLConfig(
            backbone=BackboneConfig(
                num_stages=4, num_filters=64, image_height=28, image_width=28,
                num_classes=5, per_step_bn_statistics=True, num_steps=5,
            ),
            number_of_training_steps_per_iter=5,
            number_of_evaluation_steps_per_iter=5,
        )
    return MAMLFewShotLearner(cfg)


def _bench_batch(learner, batch_size: int, rng):
    bb = learner.cfg.backbone
    way = bb.num_classes
    img = (bb.image_channels, bb.image_height, bb.image_width)
    xs = rng.rand(batch_size, way, 1, *img).astype(np.float32)
    ys = np.tile(np.arange(way, dtype=np.int32)[None, :, None], (batch_size, 1, 1))
    return xs, xs.copy(), ys, ys.copy()


def measure_overhead(tiny: bool = True, budget_s: float = 6.0, windows: int = 3,
                     batch_size: int = 2, logs_dir: str | None = None,
                     device: str | None = None) -> dict:
    """Paired plain and telemetry timing windows over the real K=1 train
    step; returns the result (median rates and the median of the pairs'
    overheads). On the card unless ``device="cpu"``; raises without one."""
    import tempfile

    import torch

    from .experiment_builder import TRAIN_LOG_EVERY
    from .telemetry.runtime import TrainTelemetry
    from .utils.platform import resolve_device

    device = resolve_device(device)
    learner = _bench_learner(tiny)
    rng = np.random.RandomState(0)
    batch = _bench_batch(learner, batch_size, rng)
    state = learner.init_state(torch.Generator().manual_seed(0), device)
    telemetry = TrainTelemetry(
        logs_dir or tempfile.mkdtemp(prefix="telemetry_overhead_"), enabled=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with telemetry.activate():
        # The first dispatch captures the step's graph (its warm-up feeds
        # the ledger), outside the timed windows.
        state, losses = learner.run_train_iter(state, batch, epoch=0)
        sync()

        def run_window(seconds: float, recording: bool) -> float:
            nonlocal state
            n = 0
            loss = losses["loss"]
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                state, step_losses = learner.run_train_iter(state, batch, epoch=0)
                loss = step_losses["loss"]
                n += 1
                if recording:
                    telemetry.record_dispatch(n, n_iters=1, data_wait_s=0.0)
                if n % TRAIN_LOG_EVERY == 0:
                    # Both variants pay the loop's forced read at the same
                    # cadence; only the boundary's bookkeeping differs.
                    t_sync = time.perf_counter()
                    float(loss)
                    sync_s = time.perf_counter() - t_sync
                    if recording:
                        telemetry.boundary(n, sync_s, reason="log")
            sync()
            return n / (time.perf_counter() - t0)

        per_window = budget_s / (2 * windows)
        plain_rates, telemetry_rates, pair_overheads = [], [], []
        for w in range(windows):
            # Paired windows, back to back, their order alternating: slow
            # drift cancels across pairs, and the median of the pairs'
            # differences is read, not a difference of medians (the cost a
            # step is far below window-to-window noise on a shared host).
            pair = {}
            for recording in ((False, True) if w % 2 == 0 else (True, False)):
                rate = run_window(per_window, recording)
                (telemetry_rates if recording else plain_rates).append(rate)
                pair[recording] = rate
            pair_overheads.append((pair[False] - pair[True]) / pair[False] * 100.0)
    return {
        "metric": "telemetry_overhead_pct",
        "value": round(statistics.median(pair_overheads), 3),
        "unit": "%",
        "backend": device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "tiny": bool(tiny),
        "plain_iters_per_s": round(statistics.median(plain_rates), 3),
        "telemetry_iters_per_s": round(statistics.median(telemetry_rates), 3),
        "pair_overheads_pct": [round(o, 3) for o in pair_overheads],
        "windows": windows,
        "events_logged": os.path.exists(
            os.path.join(telemetry.logs_dir, "telemetry.jsonl")),
    }


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Render a run's telemetry JSONL, or measure the "
        "telemetry_overhead_pct bench key"
    )
    parser.add_argument("run", nargs="?", default=None,
                        help="experiment dir or telemetry.jsonl path")
    parser.add_argument("--fleet", nargs="+", metavar="RUN",
                        help="merge multiple ranks' runs/JSONLs into one "
                             "timeline with per-rank lanes, per-dispatch "
                             "slowest-rank attribution and skew stats")
    parser.add_argument("--since", type=float, default=None,
                        help="only events stamped at/after this unix time "
                             "(streams from the offset-aware reader)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable summary instead of tables")
    parser.add_argument("--overhead-bench", action="store_true",
                        help="measure telemetry_overhead_pct on the real "
                             "K=1 train step (one JSON line)")
    parser.add_argument("--tiny", action="store_true",
                        help="overhead bench: a 2-stage, 8-filter model "
                             "instead of the flagship's widths")
    parser.add_argument("--budget-s", type=float, default=6.0)
    parser.add_argument("--windows", type=int, default=3)
    opts = parser.parse_args(argv)

    if opts.overhead_bench:
        print(json.dumps(
            measure_overhead(
                tiny=opts.tiny, budget_s=opts.budget_s, windows=opts.windows
            )
        ))
        return 0
    if opts.fleet:
        paths = list(opts.fleet) + ([opts.run] if opts.run else [])
        summary = fleet_summarize(paths, since=opts.since)
        print(json.dumps(summary) if opts.json
              else render_fleet_text(summary))
        return 0
    if not opts.run:
        parser.error("a run path is required unless "
                     "--overhead-bench/--fleet")
    summary = summarize(
        read_events(resolve_jsonl(opts.run), since=opts.since)
    )
    if opts.json:
        print(json.dumps(summary))
    else:
        print(render_text(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's telemetry report (``telemetry_report.py``) against the JAX
package's ``tools/telemetry_report.py``, on the CPU: ``summarize`` and
``render_text`` on the same streams (a synthetic one, and the streams of
a port ``TrainTelemetry`` and a JAX one fed the same dispatches), the fleet
mode's ``fleet_summarize`` and ``render_fleet_text`` on the same multi-rank
files, and both command lines. The one field that differs by design is the
timeline of compile events (``compiles``, and with it the event log that
leaves them out): the JAX report reads XLA's ``compile`` events, the port's
its own counterpart, a step graph's ``capture``; both read
``serve_compile``. Then the overhead bench on the CPU, which needs
``device="cpu"`` to run there."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.telemetry import TrainTelemetry as JTrainTelemetry
from howtotrainyourmamlpytorch_tpu_torch import telemetry_report
from howtotrainyourmamlpytorch_tpu_torch.telemetry.runtime import TrainTelemetry
from tools import telemetry_report as jreport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The summary's keys that differ by design: the compile timeline and the
#: event log it is taken out of.
BY_DESIGN = ("compiles", "events")


def _step(rank, i, step_s, t, trace="tr1", k=1, **kw):
    return {"type": "step", "t": t, "iter": i, "dispatch_id": i, "k": k,
            "step_s": step_s, "data_wait_s": 0.01 * k, "stage_wait_s": 0.002,
            "device_s": step_s - 0.01 * k, "process_index": rank, "process_count": 2,
            "trace_id": trace, "n_devices": 1, "mesh_shape": "single", **kw}


def _synthetic(with_compiles: bool):
    rng = np.random.RandomState(3)
    events = [{"t": 100.0, "type": "schema", "version": 1},
              {"t": 99.5, "type": "run_start", "pid": 1, "process_index": 0,
               "process_count": 1}]
    for i in range(1, 30):
        k = 1 if i < 20 else 5
        events.append(_step(0, i, float(0.04 + 0.01 * rng.rand()) * k, 100.0 + i,
                            k=k, process_count=1))
        if i % 10 == 0:
            events.append({"t": 100.0 + i, "type": "host_sync", "iter": i,
                           "sync_s": 0.003, "reason": "log"})
    events += [
        {"t": 101.5, "type": "serve_compile", "program": "adapt:4x5", "family": "maml"},
        {"t": 102.0, "type": "program_profile", "name": "train_step[second_order]",
         "role": "train", "k": 1, "flops": 4.2e10, "dispatch_flops": 4.2e10,
         "hbm_peak_bytes": 5.1e8, "device_kind": "NVIDIA H100 80GB HBM3",
         "peak_flops": 6.7e13, "signature": "[[8, 5, 1, 1, 28, 28]]"},
        {"t": 103.0, "type": "program_profile", "name": "adapt:4x5", "role": "serve_adapt",
         "k": 1, "flops": 1.1e9, "bucket": "5x1x15", "peak_flops": None},
        {"t": 110.0, "type": "memory", "devices": [
            {"device": 0, "bytes_in_use": 1.5e8, "peak_bytes_in_use": 5.2e8}]},
        {"t": 120.0, "type": "checkpoint_save", "epoch": 0, "seconds": 0.2},
        {"t": 121.0, "type": "anomaly", "kind": "step_time", "value_s": 0.4},
        {"t": 130.0, "type": "run_end"},
    ]
    if with_compiles:
        events += [
            {"t": 100.7, "type": "compile", "name": "jit(train_step)", "seconds": 12.0},
            {"t": 100.8, "type": "capture", "name": "train_step[second_order]",
             "capture_s": 1.4, "launches": {"bn_stats": 20}},
        ]
    return events


def _write(path, events):
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(path)


def _without(summary, keys=BY_DESIGN):
    return {k: v for k, v in summary.items() if k not in keys}


def _recorded_streams(tmp_path):
    """A port and a JAX ``TrainTelemetry`` fed the same dispatches and
    boundaries, each writing its own stream."""
    paths = {}
    for name, cls in (("port", TrainTelemetry), ("jax", JTrainTelemetry)):
        logs = tmp_path / name
        logs.mkdir()
        telemetry = cls(str(logs), enabled=True, trace_id="sametrace")
        with telemetry.activate():
            for i in range(1, 12):
                telemetry.record_dispatch(i, n_iters=1, data_wait_s=0.001 * i)
                if i % 5 == 0:
                    telemetry.boundary(i, 0.002, reason="log")
        paths[name] = str(logs / "telemetry.jsonl")
    return paths


def test_summarize_and_render_equal_jax_without_compile_events(tmp_path):
    events = _synthetic(with_compiles=False)
    got, want = telemetry_report.summarize(events), jreport.summarize(events)
    assert got == want
    assert got["iters"] == 19 + 10 * 5
    assert got["device"]["mfu_pct"] == want["device"]["mfu_pct"] is not None
    assert telemetry_report.render_text(got) == \
        jreport.render_text(want).replace("compile timeline", "capture timeline")


def test_compile_timeline_reads_the_ports_capture_events(tmp_path):
    events = _synthetic(with_compiles=True)
    got, want = telemetry_report.summarize(events), jreport.summarize(events)
    assert _without(got) == _without(want)
    # In stream order, as both reports list them.
    assert [(c["kind"], c["name"]) for c in got["compiles"]] == [
        ("serve_compile", "adapt:4x5"), ("capture", "train_step[second_order]")]
    assert [(c["kind"], c["name"]) for c in want["compiles"]] == [
        ("serve_compile", "adapt:4x5"), ("compile", "jit(train_step)")]
    assert {e["type"] for e in got["events"]} ^ {e["type"] for e in want["events"]} == \
        {"compile", "capture"}
    text = telemetry_report.render_text(got)
    assert "capture timeline (2 events)" in text and "train_step[second_order]" in text


@pytest.mark.parametrize("source", ["port", "jax"])
def test_summaries_of_recorded_streams_equal_jax(tmp_path, source):
    path = _recorded_streams(tmp_path)[source]
    events = telemetry_report.read_events(path)
    got, want = telemetry_report.summarize(events), jreport.summarize(events)
    assert got == want
    assert got["iters"] == 10  # the first dispatch only anchors the clock
    assert telemetry_report.render_text(got) == \
        jreport.render_text(want).replace("compile timeline", "capture timeline")
    since = float(events[len(events) // 2]["t"])
    assert telemetry_report.summarize(telemetry_report.read_events(path, since=since)) == \
        jreport.summarize(jreport.read_events(path, since=since))


def _fleet_files(tmp_path):
    files = []
    for rank, slow in ((0, 0.10), (1, 0.13)):
        lines = [{"t": 0.0, "type": "schema", "version": 1}]
        for i in (1, 2, 3, 4):
            lines.append(_step(rank, i, slow if i == 2 else 0.1, t=float(i)))
        lines.append({"t": 5.0 + rank, "type": "program_profile", "process_index": rank,
                      "name": "train_step[second_order]", "role": "train", "k": 1,
                      "flops": 1e9 + rank, "trace_id": "tr1"})
        lines.append({"t": 10.0 + rank, "type": "run_end", "process_index": rank,
                      "process_count": 2, "trace_id": "tr1"})
        files.append(_write(tmp_path / f"rank{rank}.jsonl", lines))
    # A shared file both ranks appended to, with a replayed dispatch.
    shared = [_step(0, 7, 0.1, t=20.0), _step(1, 7, 0.1, t=20.0),
              _step(0, 7, 0.2, t=50.0), _step(1, 7, 0.9, t=50.0)]
    files.append(_write(tmp_path / "shared.jsonl", shared))
    foreign = _write(tmp_path / "foreign.jsonl", [_step(0, 9, 0.1, t=99.0, trace="OTHER")])
    return files, foreign


@pytest.mark.parametrize("case", ["ranks", "ranks_and_shared", "foreign", "since"])
def test_fleet_summarize_and_render_equal_jax(tmp_path, case):
    files, foreign = _fleet_files(tmp_path)
    paths = {"ranks": files[:2], "ranks_and_shared": files,
             "foreign": files + [foreign], "since": files}[case]
    since = 3.0 if case == "since" else None
    got = telemetry_report.fleet_summarize(paths, since=since)
    want = jreport.fleet_summarize(paths, since=since)
    assert got == want
    assert telemetry_report.render_fleet_text(got) == jreport.render_fleet_text(want)
    assert got["trace_consistent"] is (case != "foreign")
    if case == "ranks":
        assert got["dispatch_skew"]["max_ms"] == pytest.approx(30.0)
        assert got["worst_dispatches"][0] == {"dispatch_id": 2, "slowest_rank": 1,
                                              "skew_ms": 30.0}


def _cli(argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_command_lines_equal_jax(tmp_path):
    run = tmp_path / "exp" / "logs"
    run.mkdir(parents=True)
    _write(run / "telemetry.jsonl", _synthetic(with_compiles=True))
    files, _ = _fleet_files(tmp_path)
    port = ["-m", "howtotrainyourmamlpytorch_tpu_torch.telemetry_report"]
    jax_ = [os.path.join("tools", "telemetry_report.py")]
    for argv in ([str(tmp_path / "exp"), "--json"], [str(run), "--json", "--since", "110"]):
        got, want = json.loads(_cli(port + argv)), json.loads(_cli(jax_ + argv))
        assert _without(got) == _without(want)
    text = _cli(port + [str(tmp_path / "exp")])
    assert text.startswith("telemetry report — 69 train iterations")
    assert "capture timeline (2 events)" in text
    fleet = ["--fleet", *files, "--json"]
    assert json.loads(_cli(port + fleet)) == json.loads(_cli(jax_ + fleet))
    assert _cli(port + fleet[:-1]) == _cli(jax_ + fleet[:-1])


def test_overhead_bench_runs_on_the_cpu_only_when_asked(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry_report.measure_overhead(tiny=True, budget_s=0.1, windows=1)
    result = telemetry_report.measure_overhead(
        tiny=True, budget_s=1.0, windows=2, logs_dir=str(tmp_path), device="cpu")
    assert result["metric"] == "telemetry_overhead_pct" and result["unit"] == "%"
    assert result["backend"] == "cpu" and result["tiny"]
    assert np.isfinite(result["value"]) and len(result["pair_overheads_pct"]) == 2
    assert result["plain_iters_per_s"] > 0 and result["telemetry_iters_per_s"] > 0
    assert result["events_logged"]

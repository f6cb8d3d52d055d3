"""The port's trainer telemetry against the JAX package's, on the CPU:
one tiny run of each builder (2 epochs of 2 iterations, 4 filters) from
the same config. Every event type the port writes is one the JAX builder
writes, with the JAX fields; the summary CSV has the JAX columns, the
step-time, data-wait and stage-wait p50/p95 and the topology columns
included; the heartbeat has the JAX keys, save those whose mechanism is
not ported. The OOM report and the interruption row have the JAX keys.
Then the pieces alone: the program ledger on an eager step, the peak
table, ``--debug_nans`` and a file-triggered profiler capture."""

import json
import os

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.utils import faultinject as jfi
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.telemetry import device, events, profiling
from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject, sanitize
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import args_to_maml_config

from test_data import make_dataset_dir
from test_faultinject import _builder as jax_builder
from test_faultinject import _exp_args

#: JAX-only: XLA compile events and the CPU program ledger (the port counts
#: a program's FLOPs at the warm-up before a capture, on a card).
JAX_ONLY_EVENTS = {"compile", "program_profile"}
#: Heartbeat keys of mechanisms the port lacks on the CPU or at all: the
#: ledger's MFU and memory (a card), the collectives (A10), the tuner's
#: fingerprint (A12, tune/space.py).
JAX_ONLY_HEARTBEAT = {"mfu_pct", "peak_flops", "hbm_peak_bytes",
                      "comm_bytes_per_iter", "collectives_per_iter",
                      "config_fingerprint"}


def _port_builder(tmp, name, **overrides):
    args = _exp_args(tmp, name, watchdog=False, **overrides)
    return ExperimentBuilder(args=args, data=MetaLearningSystemDataLoader,
                             model=MAMLFewShotLearner(args_to_maml_config(args)),
                             device="cpu")


def _fields_by_type(path):
    out = {}
    for e in events.read_events(str(path)):
        out.setdefault(e["type"], set()).update(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry")
    make_dataset_dir(tmp / "omniglot_mini")
    env = pytest.MonkeyPatch()
    env.setenv("DATASET_DIR", str(tmp))
    faultinject.deactivate()
    jfi.deactivate()
    try:
        jax_builder(_exp_args(tmp, "jax", watchdog=False)).run_experiment()
        _port_builder(tmp, "port").run_experiment()
        for module, name, build in ((jfi, "jax_oom", lambda: jax_builder(
                _exp_args(tmp, "jax_oom", watchdog=False))),
                (faultinject, "port_oom", lambda: _port_builder(tmp, "port_oom"))):
            module.activate(module.FaultPlan(oom_at_iter=1))
            with pytest.raises(SystemExit) as exc:
                build().run_experiment()
            assert exc.value.code == 77
            module.deactivate()
        yield tmp
    finally:
        faultinject.reset()
        jfi.reset()
        env.undo()


def test_event_types_and_fields_are_the_jax_builders(runs):
    jax_ = _fields_by_type(runs / "jax" / "logs" / "telemetry.jsonl")
    port = _fields_by_type(runs / "port" / "logs" / "telemetry.jsonl")
    assert set(port) == set(jax_) - JAX_ONLY_EVENTS
    assert {"step", "host_sync", "epoch_summary", "checkpoint_save",
            "checkpoint_load", "run_start", "run_end"} <= set(port)
    for kind, fields in port.items():
        assert fields == jax_[kind] - {"config_fingerprint"}, kind
    trace_ids = {e["trace_id"] for e in
                 events.read_events(str(runs / "port" / "logs" / "telemetry.jsonl"))
                 if e["type"] != "schema"}
    assert len(trace_ids) == 1


def test_summary_columns_are_the_jax_columns(runs):
    def header(name):
        with open(runs / name / "logs" / "summary_statistics.csv") as f:
            return f.readline().strip().split(",")

    port = header("port")
    assert sorted(port) == sorted(header("jax"))
    assert {"train_step_time_p50", "train_step_time_p95", "train_data_wait_p50",
            "train_data_wait_p95", "train_stage_wait_p50",
            "train_stage_wait_p95", "n_devices", "mesh_dp"} <= set(port)
    with open(runs / "port" / "logs" / "summary_statistics.json") as f:
        stats = json.load(f)
    assert all(np.isfinite(stats["train_step_time_p50"]))


def test_heartbeat_has_the_jax_keys(runs):
    with open(runs / "jax" / "logs" / "status.json") as f:
        jax_ = json.load(f)
    with open(runs / "port" / "logs" / "status.json") as f:
        port = json.load(f)
    assert set(port) == set(jax_) - JAX_ONLY_HEARTBEAT
    assert port["current_iter"] == jax_["current_iter"] == 4
    assert port["epoch"] == jax_["epoch"]


def test_oom_report_event_and_row_have_the_jax_keys(runs):
    def read(name):
        with open(runs / name / "logs" / "oom_report.json") as f:
            report = json.load(f)
        oom = [e for e in events.read_events(str(runs / name / "logs" / "telemetry.jsonl"))
               if e["type"] == "oom"]
        with open(runs / name / "logs" / "interruptions.csv") as f:
            rows = f.read().splitlines()
        return report, oom, rows

    jax_report, jax_oom, jax_rows = read("jax_oom")
    report, oom, rows = read("port_oom")
    assert set(report) == set(jax_report) | {"error_type"}
    assert set(report["config_levers"]) == set(jax_report["config_levers"])
    assert report["error_type"] == "torch.OutOfMemoryError"
    assert report["exit_code"] == 77 and report["current_iter"] == 1
    assert set(oom[0]) == set(jax_oom[0]) - {"config_fingerprint"}
    assert rows[0] == jax_rows[0]
    assert rows[1].split(",")[1:] == jax_rows[1].split(",")[1:] == ["oom", "1", "0", "0", "1"]


def _step(learner, state, batch):
    return learner._train_step(state, learner._device_batch(state, batch),
                               learner._importance(state, learner._train_importance(0)),
                               second_order=True)


def _learner():
    from howtotrainyourmamlpytorch_tpu_torch.models import BackboneConfig, MAMLConfig

    return MAMLFewShotLearner(MAMLConfig(
        backbone=BackboneConfig(num_stages=2, num_filters=4, per_step_bn_statistics=True,
                                num_steps=2, num_classes=5),
        number_of_training_steps_per_iter=2, number_of_evaluation_steps_per_iter=2))


def _batch(rng, tasks=2):
    xs = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    ys = np.tile(np.arange(5)[None, :, None], (tasks, 1, 1))
    return xs, xs.copy(), ys, ys.copy()


def test_program_ledger_counts_the_warmup_step(tmp_path):
    learner = _learner()
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(np.random.RandomState(0))
    ledger = device.ProgramLedger(peak_flops=1e12)
    log = events.EventLog(str(tmp_path / "e.jsonl"))
    previous = events.install(log)
    try:
        key = (True, False, (((2, 5, 1, 28, 28), torch.float32),))
        with ledger.warmup_hook(key, steps=1):
            _step(learner, state, batch)
        ledger.note_dispatch(3)
    finally:
        events.install(previous)
    log.flush()
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        _step(learner, state, batch)
    (entry,) = ledger.entries()
    assert entry.flops == counter.get_total_flops() > 0
    assert entry.k == 3 and entry.dispatch_flops == 3 * entry.flops
    assert entry.name == "train_step[second_order]"
    assert ledger.mfu_pct(10.0) == pytest.approx(100 * 10 * entry.flops / 1e12)
    (profile,) = [e for e in events.read_events(str(tmp_path / "e.jsonl"))
                  if e["type"] == "program_profile"]
    assert profile["flops"] == entry.flops and profile["peak_flops"] == 1e12


def test_peak_flops_by_card_name():
    assert device.resolve_peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert device.resolve_peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert device.resolve_peak_flops("Some Other Card") is None
    assert device.resolve_peak_flops("Some Other Card", override=5e12) == 5e12
    assert device.is_resource_exhausted(torch.OutOfMemoryError("x"))
    assert not device.is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED"))


def test_debug_nans_raises_at_the_first_nan_operation():
    learner = _learner()
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    xs, xt, ys, yt = _batch(np.random.RandomState(1))
    with sanitize.nan_checks(True):
        _step(learner, state, (xs, xt, ys, yt))  # a finite step runs
        with pytest.raises(FloatingPointError, match="debug_nans"):
            _step(learner, state, (xs, np.full_like(xt, np.nan), ys, yt))
    _step(learner, state, (xs, np.full_like(xt, np.nan), ys, yt))  # off: no raise


def test_file_trigger_captures_a_bounded_trace(tmp_path):
    trigger = tmp_path / "profile_trigger"
    controller = profiling.ProfilerController(num_iters=2, trigger_path=str(trigger),
                                              default_trace_dir=str(tmp_path / "traces"))
    controller.poll_trigger()
    assert not controller.active
    trigger.write_text("")
    controller.poll_trigger()
    assert not trigger.exists()
    controller.tick(1)
    assert controller.active
    torch.ones(8).sum()
    controller.tick(1)
    assert not controller.active
    assert (tmp_path / "traces" / "on_demand_0" / "trace.json").exists()
    controller.stop()  # idempotent

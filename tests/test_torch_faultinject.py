"""The port's fault injection against the JAX package's
(``utils/faultinject.py``), and the faults through the port's builder on
the CPU: ``MAML_FAULTS`` parses to the same plan and the same errors for
every training, serve and tier key, each serve and tier hook fires at the
same count with the same events and effect, ``poison_batch`` poisons the
same bytes, the
checkpoint and stager hooks fire where the JAX package's do, and a
SIGTERM gives exit 75, an emergency checkpoint and an audit row, and the
requeued run ends bit for bit on the unbroken run's state."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.utils import faultinject as jfi
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.data.device_prefetch import DevicePrefetcher
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import (
    REQUEUE_EXIT_CODE,
    ExperimentBuilder,
)
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.utils import checkpoint, faultinject, storage
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import args_to_maml_config

from test_data import make_dataset_dir
from test_faultinject import _exp_args

TRAINING_KEYS = ("truncate_checkpoint_at", "fail_next_writes", "nan_at_iter",
                 "overflow_at_iter", "sigterm_at_iter", "sigkill_at_iter",
                 "hang_at_iter", "producer_fail_at_iter", "oom_at_iter",
                 "kill_trainer_mid_publish")


@pytest.fixture(autouse=True)
def _clean_plans():
    faultinject.deactivate()
    jfi.deactivate()
    yield
    faultinject.reset()
    jfi.reset()


def test_fault_plan_fields_are_the_jax_plans():
    assert ([f.name for f in dataclasses.fields(faultinject.FaultPlan)]
            == [f.name for f in dataclasses.fields(jfi.FaultPlan)])
    assert set(TRAINING_KEYS) | set(faultinject.SERVE_KEYS) | set(
        faultinject.CONTROL_PLANE_KEYS) == {f.name for f in dataclasses.fields(jfi.FaultPlan)}
    assert len(faultinject.CONTROL_PLANE_KEYS) == 4
    assert not hasattr(faultinject, "NOT_PORTED")


@pytest.mark.parametrize("spec", [
    *(f"{key}={v}" for v, key in enumerate(
        TRAINING_KEYS + faultinject.SERVE_KEYS + faultinject.CONTROL_PLANE_KEYS, start=3)),
    "nan_at_iter=5; fail_next_writes=2",
    " sigterm_at_iter = 7 ,hang_at_iter=9,",
    "",
])
def test_maml_faults_parse_as_in_jax(monkeypatch, spec):
    monkeypatch.setenv("MAML_FAULTS", spec)
    faultinject.reset()
    jfi.reset()
    got, want = faultinject.current_plan(), jfi.current_plan()
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("spec", ["explode_reactor=1", "nan_at_iter", "nan_at_iter=x"])
def test_bad_specs_raise_as_in_jax(monkeypatch, spec):
    monkeypatch.setenv("MAML_FAULTS", spec)
    faultinject.reset()
    jfi.reset()
    with pytest.raises(ValueError) as want:
        jfi.current_plan()
    with pytest.raises(ValueError) as got:
        faultinject.current_plan()
    assert str(got.value) == str(want.value)


def _fire_control(module, key, tmp_path):
    """Drives ``key``'s hook of ``module`` in this process: what each of
    three calls gave or left on disk, and the plan after."""
    if key == "regress_after_promote":
        out = []
        for _ in range(3):
            module.promotion_applied()
            out.append(module.current_plan().nan_next_logits)
        out.append([bool(np.isnan(module.poison_logits(np.ones((2, 3), np.float32))).all())
                    for _ in range(3)])
        return out
    root = tmp_path / module.__name__.split(".")[0]
    root.mkdir()
    out = []
    for i in range(3):
        path = root / f"staged_{i}"
        path.write_bytes(bytes(range(64)))
        module.candidate_checkpoint_loading(str(path))
        out.append(path.read_bytes())
    return out


@pytest.mark.parametrize("key", ["corrupt_candidate_at", "regress_after_promote"])
def test_control_plane_faults_fire_as_in_jax(monkeypatch, tmp_path, key):
    """``corrupt_candidate_at`` truncates the staged copy the daemon is
    about to verify, once; ``regress_after_promote`` becomes
    ``nan_next_logits`` at the first published promotion, once, and the
    next answers are NaN: the same effects and events as the JAX hooks."""
    monkeypatch.setenv("MAML_FAULTS", f"{key}=2")
    faultinject.reset()
    jfi.reset()
    assert dataclasses.asdict(faultinject.current_plan()) == dataclasses.asdict(
        jfi.current_plan())
    got, want = _fire_control(faultinject, key, tmp_path), _fire_control(jfi, key, tmp_path)
    assert got == want
    assert faultinject.events == jfi.events and len(faultinject.events) >= 1


_KILL_HOOK = """
import os, sys
from {package}.utils import faultinject
hook = getattr(faultinject, sys.argv[1])
for phase in (1, 2, 3, 4, 5):
    print(phase, flush=True)
    hook(phase)
print("survived", flush=True)
"""


@pytest.mark.parametrize("hook,key", [("daemon_phase", "daemon_kill_at_phase"),
                                      ("autoscaler_phase", "autoscaler_kill_at_phase")])
@pytest.mark.parametrize("package", ["howtotrainyourmamlpytorch_tpu_torch",
                                     "howtotrainyourmamlpytorch_tpu"])
def test_kill_hooks_sigkill_the_process_at_their_phase(package, hook, key):
    """A daemon's process armed through ``MAML_FAULTS`` dies by SIGKILL at
    the journal boundary its key names and not before, in the port as in
    the JAX package (each run in a subprocess)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "MAML_FAULTS": f"{key}=3",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _KILL_HOOK.format(package=package), hook],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert proc.stdout.split() == ["1", "2", "3"]


def _fire(module, key, tmp_path):
    """Drives ``key``'s hook of ``module`` three times; returns what each
    call gave (or left on disk)."""
    if key in ("replica_kill_at_request", "wedge_replica_at_request"):
        return [module.serve_request_fault() for _ in range(3)]
    if key == "nan_next_logits":
        return [np.isnan(module.poison_logits(np.ones((2, 3), np.float32))).all()
                for _ in range(3)]
    if key == "torn_spill_write_at":
        return [module.torn_spill_write(b"abcdefgh") for _ in range(3)]
    if key == "stale_exec_cache_at":
        return [module.stale_exec_cache({"schema": 1}) != {"schema": 1} for _ in range(3)]
    out, root = [], tmp_path / module.__name__.split(".")[0]
    root.mkdir()
    for i in range(3):
        path = root / f"entry_{i}.bin"
        path.write_bytes(bytes(range(64)))
        hook = (module.swap_checkpoint_loading if key == "corrupt_swap_at"
                else module.corrupt_cache_entry)
        hook(str(path))
        out.append(path.read_bytes())
    return out


@pytest.mark.parametrize("key", faultinject.SERVE_KEYS)
def test_serve_and_tier_faults_fire_as_in_jax(monkeypatch, tmp_path, key):
    """Each serve and tier key from ``MAML_FAULTS``: the same plan as the
    JAX parser's, its hook firing once at the same call with the same
    effect, and the same events (the stale fence drifts ``torch`` where
    JAX's drifts ``jaxlib``)."""
    monkeypatch.setenv("MAML_FAULTS", f"{key}=2")
    faultinject.reset()
    jfi.reset()
    assert dataclasses.asdict(faultinject.current_plan()) == dataclasses.asdict(
        jfi.current_plan())
    got, want = _fire(faultinject, key, tmp_path), _fire(jfi, key, tmp_path)
    assert got == want
    assert faultinject.events == jfi.events and len(faultinject.events) >= 1


@pytest.mark.parametrize("fault", ["nan_at_iter", "overflow_at_iter"])
def test_poison_batch_is_the_jax_poison(fault):
    rng = np.random.RandomState(0)
    sample = (rng.rand(2, 5, 1, 1, 28, 28).astype(np.float32),
              rng.rand(2, 5, 1, 1, 28, 28).astype(np.float32),
              np.zeros((2, 5, 1), np.int32), np.zeros((2, 5, 1), np.int32), 7)
    for module in (faultinject, jfi):
        module.activate(module.FaultPlan(**{fault: 3}))
    assert faultinject.poison_batch(sample, 2) is sample
    got = faultinject.poison_batches([sample, sample], 2)
    want = jfi.poison_batches([sample, sample], 2)
    assert faultinject.events == jfi.events == [f"{fault.split('_')[0]}:3"]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert faultinject.poison_batch(sample, 3) is sample  # one-shot


def test_checkpoint_hooks_retry_truncate_and_emit(tmp_path):
    """Two injected ENOSPC attempts are retried (``attempts`` 3 in the
    ``checkpoint_save`` event); the truncation lands on the next published
    file, which then fails its integrity check."""
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import events

    log = events.EventLog(str(tmp_path / "events.jsonl"))
    previous = events.install(log)
    try:
        faultinject.activate(faultinject.FaultPlan(fail_next_writes=2))
        leaves = [("a", torch.arange(4.0))]
        checkpoint.save_checkpoint(str(tmp_path / "ok"), leaves, {"current_iter": 1},
                                   backoff_s=0.0)
        assert faultinject.events == ["write-fail:ok", "write-fail:ok"]
        faultinject.activate(faultinject.FaultPlan(truncate_checkpoint_at=64))
        checkpoint.save_checkpoint(str(tmp_path / "torn"), leaves, {}, backoff_s=0.0)
        assert faultinject.events == ["truncate:torn@64"]
        with pytest.raises(checkpoint.CheckpointCorruptError):
            checkpoint.load_checkpoint(str(tmp_path / "torn"), leaves)
    finally:
        events.install(previous)
    log.flush()
    saves = [e for e in events.read_events(str(tmp_path / "events.jsonl"))
             if e["type"] == "checkpoint_save"]
    assert [e["attempts"] for e in saves] == [3, 1]


def test_producer_fault_is_quarantined_with_a_data_fault_event(tmp_path):
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import events

    log = events.EventLog(str(tmp_path / "events.jsonl"))
    previous = events.install(log)
    faultinject.activate(faultinject.FaultPlan(producer_fail_at_iter=1))
    samples = ((np.full((1, 2), i, np.float32),) * 4 + (i,) for i in range(4))
    stager = DevicePrefetcher(samples, lambda b: b[:4], "cpu", depth=1,
                              fault_budget=2)
    try:
        got = [int(s.arrays[0][0, 0, 0]) for s in stager]
    finally:
        stager.close()
        events.install(previous)
    log.flush()
    assert faultinject.events == ["producer-fail:1"]
    assert got == [0, 1, 2, 3]  # the fault came before the pull: nothing lost
    (fault,) = [e for e in events.read_events(str(tmp_path / "events.jsonl"))
                if e["type"] == "data_fault"]
    assert fault["iter"] == 1 and fault["fatal"] is False and fault["quarantined"] == 1


def test_oom_fault_raises_the_out_of_memory_class_on_the_cpu():
    faultinject.activate(faultinject.FaultPlan(oom_at_iter=2))
    faultinject.oom_due(1, "cpu")
    with pytest.raises(torch.OutOfMemoryError):
        faultinject.oom_due(2, "cpu")
    assert faultinject.events == ["oom:2"]
    faultinject.oom_due(5, "cpu")  # one-shot


def _builder(tmp_path, name, **overrides):
    args = _exp_args(tmp_path, name, watchdog=False, **overrides)
    return ExperimentBuilder(args=args, data=MetaLearningSystemDataLoader,
                             model=MAMLFewShotLearner(args_to_maml_config(args)),
                             device="cpu")


def _latest(tmp_path, name):
    with np.load(tmp_path / name / "saved_models" / "train_model_latest") as z:
        leaves = {k: z[k] for k in z.files if k.startswith("leaf_")}
        state = json.loads(bytes(z["__experiment_state__"]).decode())
    return leaves, state


def test_sigterm_requeues_and_the_resume_is_bitwise_the_unbroken_run(tmp_path,
                                                                      monkeypatch):
    make_dataset_dir(tmp_path / "omniglot_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as clean:
        _builder(tmp_path, "unbroken", total_epochs_before_pause=2).run_experiment()
    assert clean.value.code is None
    faultinject.activate(faultinject.FaultPlan(sigterm_at_iter=3))
    with pytest.raises(SystemExit) as requeue:
        _builder(tmp_path, "broken").run_experiment()
    assert requeue.value.code == REQUEUE_EXIT_CODE
    assert faultinject.events == ["sigterm:3"]
    assert signal.getsignal(signal.SIGTERM) == previous  # handlers restored
    assert _latest(tmp_path, "broken")[1]["current_iter"] == 3
    rows = storage.load_statistics(str(tmp_path / "broken" / "logs"),
                                   filename="interruptions.csv")
    assert rows["current_iter"] == ["3"] and rows["signal"] == [str(int(signal.SIGTERM))]
    assert list(rows) == ["timestamp", "signal", "current_iter", "epoch",
                          "process_index", "process_count"]
    faultinject.deactivate()
    with pytest.raises(SystemExit):
        _builder(tmp_path, "broken", total_epochs_before_pause=1).run_experiment()
    want, want_state = _latest(tmp_path, "unbroken")
    got, got_state = _latest(tmp_path, "broken")
    assert got_state["current_iter"] == want_state["current_iter"] == 4
    assert set(got) == set(want)
    for key in want:
        assert want[key].tobytes() == got[key].tobytes(), key
    events = [json.loads(line)["type"] for line in
              open(tmp_path / "broken" / "logs" / "telemetry.jsonl")]
    assert {"preemption", "requeue_exit", "checkpoint_load"} <= set(events)

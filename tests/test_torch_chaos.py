"""The port's chaos harness (``howtotrainyourmamlpytorch_tpu_torch/
chaos_train.py``) on the CPU: its schedule partition and per-phase fault
plans are the JAX harness's (``tools/chaos_train.py``), and a tiny
supervised run of ``enospc,sigterm,kill,hang`` through the port's
dispatcher recovers every fault and ends bit for bit on its unfaulted
twin (``train_model_latest`` and the summary CSV without its wall-clock
columns); ``oom`` ends a run with exit 77 and its report."""

import os
import subprocess
import sys

import pytest

from howtotrainyourmamlpytorch_tpu_torch import chaos_train
from tools import chaos_train as jax_chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEDULES = [
    ["enospc", "sigterm", "kill", "hang"],
    ["sigterm", "nan", "kill", "producer", "hang"],
    ["nan", "enospc", "hang", "producer"],
    ["kill"],
    [],
]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: "-".join(s) or "none")
def test_partition_and_plans_are_the_jax_harness(schedule):
    phases = chaos_train._partition_phases(schedule)
    assert phases == jax_chaos._partition_phases(schedule)
    for resume in (0, 1, 2, 5):
        for faults in phases:
            assert (chaos_train._plan_phase(faults, resume, 2, 6)
                    == jax_chaos._plan_phase(faults, resume, 2, 6))


def test_oom_is_terminal_and_last():
    assert chaos_train._partition_phases(["sigterm", "oom"]) == [["sigterm"], ["oom"]]
    assert chaos_train._plan_phase(["oom"], 2, 2, 6) == {"oom_at_iter": 4}
    with pytest.raises(ValueError, match="terminal"):
        chaos_train._partition_phases(["oom", "kill"])


def test_the_classes_are_the_jax_harness(tmp_path):
    assert chaos_train.FAULT_CLASSES == jax_chaos.FAULT_CLASSES
    assert chaos_train.SKIP_PATH == jax_chaos.SKIP_PATH
    assert chaos_train.STOPPING - set(chaos_train.TERMINAL) == jax_chaos.STOPPING
    import json

    with open(jax_chaos.tiny_config(str(tmp_path), "x")) as f:
        jax_cfg = json.load(f)
    port_cfg = chaos_train.tiny_config()
    for key, value in jax_cfg.items():
        if key != "experiment_name":
            assert port_cfg[key] == value, key


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("chaos")
    chaos_train.make_tiny_dataset(str(workdir / "omniglot_mini"))
    return workdir


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    """The training processes a run starts take one CPU thread each: the
    suite runs beside other workers, and a window the contention stretches
    past the tiny config's 10 s watchdog floor would read as a hang."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_a_supervised_schedule_recovers_bit_exact_against_its_twin(tiny):
    verdict = chaos_train.run_chaos(str(tiny), ["enospc", "sigterm", "kill", "hang"],
                                    baseline=True, device="cpu", verbose=False)
    assert verdict["ok"], verdict
    assert [p["rc"] for p in verdict["phases"]] == [75, -9, 76, 0]
    assert verdict["dispatcher_rc"] == 0 and verdict["completed"]
    assert verdict["bitexact_vs_baseline"] is True
    assert all(info["recovered"] for info in verdict["faults"].values())
    assert set(verdict["mttr_s"]) == {"sigterm", "kill", "hang"}
    assert all(t > 0 for t in verdict["mttr_s"].values())
    rows = chaos_train.summary_rows(str(tiny / "chaos_exp"))
    assert len(rows) == 3  # the kill's lost epoch was not written twice


def test_oom_ends_the_run_with_its_report(tmp_path):
    chaos_train.make_tiny_dataset(str(tmp_path / "omniglot_mini"))
    verdict = chaos_train.run_chaos(str(tmp_path), ["oom"], device="cpu", verbose=False)
    assert verdict["ok"], verdict
    assert verdict["dispatcher_rc"] == 77 and not verdict["completed"]
    assert verdict["faults"]["oom"]["report"]["error_type"] == "torch.OutOfMemoryError"


def test_the_command_line_refuses_a_mesh():
    proc = subprocess.run(
        [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.chaos_train",
         "--tiny", "--devices", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode != 0 and "A10" in proc.stderr

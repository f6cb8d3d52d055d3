"""The port's supervising dispatcher
(``howtotrainyourmamlpytorch_tpu_torch/train_maml_system_dispatch.py``)
on the harness of ``tests/test_dispatch_supervise.py``: a scripted stub
entry (``MAML_DISPATCH_ENTRY``) exits with planned codes and writes
planned progress. On one card a hang or two signal deaths rerun on the
same device (the JAX dispatcher's "no smaller viable mesh" branch), each
class on its own budget; 77 stops at once; the audit rows carry the
heartbeat's progress; one trace id reaches every phase; ``MAML_FAULTS``
only the first. A mesh's degrade and the fleet raise (A10)."""

import json
import os
import sys

import pytest

import train_maml_system_dispatch as jax_dispatch
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system_dispatch as dispatch
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import REQUEUE_EXIT_CODE
from howtotrainyourmamlpytorch_tpu_torch.telemetry.device import OOM_EXIT_CODE
from howtotrainyourmamlpytorch_tpu_torch.telemetry.events import TRACE_ID_ENV
from howtotrainyourmamlpytorch_tpu_torch.utils.watchdog import HANG_EXIT_CODE

from test_dispatch_supervise import STUB


@pytest.fixture
def harness(tmp_path, monkeypatch):
    """``run(plan, cfg_overrides, *argv)`` -> (exit code, invocations, audit
    rows), as the JAX dispatcher's harness."""
    monkeypatch.chdir(tmp_path)
    stub_path = tmp_path / "stub_entry.py"
    stub_path.write_text(STUB)
    monkeypatch.setenv(dispatch.ENTRY_ENV, str(stub_path))
    plan_path, log_path = tmp_path / "plan.json", tmp_path / "invocations.jsonl"
    monkeypatch.setenv("STUB_PLAN", str(plan_path))
    monkeypatch.setenv("STUB_LOG", str(log_path))
    (tmp_path / "experiment_config").mkdir()

    def run(plan, cfg_overrides=None, *argv):
        cfg = {"experiment_name": "exp", "total_epochs": 2, "num_of_gpus": 1,
               "batch_size": 4, "samples_per_iter": 1, "data_parallel_devices": 1}
        cfg.update(cfg_overrides or {})
        with open(tmp_path / "experiment_config" / "chaostest.json", "w") as f:
            json.dump(cfg, f)
        plan_path.write_text(json.dumps(plan))
        if log_path.exists():
            log_path.unlink()
        rc = dispatch.main(["chaostest", *argv])
        calls = ([json.loads(line) for line in log_path.read_text().splitlines()]
                 if log_path.exists() else [])
        audit_path = tmp_path / "exp" / "logs" / "interruptions.csv"
        audit = audit_path.read_text().splitlines()[1:] if audit_path.exists() else []
        return rc, calls, audit

    return run


def _kinds(audit):
    return [row.split(",")[1] for row in audit]


def test_exit_codes_are_the_runtimes_and_the_jax_dispatchers():
    assert (dispatch.REQUEUE_EXIT_CODE, HANG_EXIT_CODE, OOM_EXIT_CODE) == (75, 76, 77)
    assert dispatch.REQUEUE_EXIT_CODE == REQUEUE_EXIT_CODE == jax_dispatch.REQUEUE_EXIT_CODE
    assert HANG_EXIT_CODE == jax_dispatch.HANG_EXIT_CODE
    assert TRACE_ID_ENV == jax_dispatch.TRACE_ID_ENV
    assert dispatch.ENTRY_ENV == jax_dispatch.ENTRY_ENV


def test_hang_reruns_on_the_same_device_and_requeue_on_its_own_budget(harness):
    rc, calls, audit = harness([
        {"rc": REQUEUE_EXIT_CODE},
        {"rc": REQUEUE_EXIT_CODE},
        {"rc": REQUEUE_EXIT_CODE},
        {"rc": HANG_EXIT_CODE},
        {"rc": HANG_EXIT_CODE},
    ], None, "--max_hangs", "2")
    assert rc == HANG_EXIT_CODE
    assert len(calls) == 5 and [c["dp"] for c in calls] == [1] * 5
    assert _kinds(audit) == ["hang-requeue:dp1"] * 2


def test_a_hang_then_progress_finishes(harness):
    rc, calls, audit = harness([
        {"rc": HANG_EXIT_CODE},
        {"rc": 0, "epochs": 2, "test_eval": True},
    ], {"data_parallel_devices": 0})
    assert rc == 0 and len(calls) == 2
    assert _kinds(audit) == ["hang-requeue:dp1"]


def test_requeue_budget_bounds_a_preemption_loop(harness):
    rc, calls, _ = harness([{"rc": REQUEUE_EXIT_CODE}] * 3, None, "--max_requeues", "2")
    assert rc == REQUEUE_EXIT_CODE and len(calls) == 2


def test_repeated_signal_death_is_treated_like_a_hang(harness):
    rc, calls, audit = harness([
        {"rc": 137}, {"rc": 137}, {"rc": 0, "epochs": 2, "test_eval": True},
    ])
    assert rc == 0 and len(calls) == 3
    assert _kinds(audit) == ["repeated-signal-death-requeue:dp1"]


def test_out_of_memory_is_reported_and_not_retried(harness):
    rc, calls, audit = harness([
        {"rc": OOM_EXIT_CODE}, {"rc": 0, "epochs": 2, "test_eval": True},
    ])
    assert rc == OOM_EXIT_CODE and len(calls) == 1
    assert _kinds(audit) == ["oom-abort"]


def test_no_progress_across_two_phases_aborts(harness):
    rc, calls, _ = harness([{"rc": 1}, {"rc": 1}, {"rc": 0}])
    assert rc == 1 and len(calls) == 2


def test_audit_rows_carry_the_heartbeats_progress(harness, tmp_path):
    logs = tmp_path / "exp" / "logs"
    logs.mkdir(parents=True)
    (logs / "status.json").write_text(json.dumps({"schema": 1, "t": 1.0,
                                                  "current_iter": 137, "epoch": 4}))
    rc, _, audit = harness([{"rc": HANG_EXIT_CODE},
                            {"rc": 0, "epochs": 2, "test_eval": True}])
    assert rc == 0
    assert audit[0].split(",")[1:4] == ["hang-requeue:dp1", "137", "4"]


def test_audit_rows_without_a_heartbeat(harness):
    rc, _, audit = harness([{"rc": HANG_EXIT_CODE},
                            {"rc": 0, "epochs": 2, "test_eval": True}])
    assert rc == 0 and audit[0].split(",")[2:4] == ["", ""]


def test_one_trace_id_reaches_every_phase(harness, monkeypatch):
    monkeypatch.delenv(TRACE_ID_ENV, raising=False)
    seen = []
    real_run = dispatch.subprocess.run

    def spying_run(argv, check=False, env=None):
        seen.append((env or {}).get(TRACE_ID_ENV))
        return real_run(argv, check=check, env=env)

    monkeypatch.setattr(dispatch.subprocess, "run", spying_run)
    rc, _, _ = harness([{"rc": 0, "epochs": 1},
                        {"rc": 0, "epochs": 1, "test_eval": True}])
    assert rc == 0 and len(seen) == 2 and seen[0] and seen[0] == seen[1]
    import shutil

    shutil.rmtree("exp")
    seen.clear()
    monkeypatch.setenv(TRACE_ID_ENV, "operator-trace")
    rc, _, _ = harness([{"rc": 0, "epochs": 2, "test_eval": True}])
    assert rc == 0 and seen == ["operator-trace"]


def test_fault_plans_reach_the_first_phase_only(harness, monkeypatch):
    monkeypatch.setenv("MAML_FAULTS", "hang_at_iter=3")
    rc, calls, _ = harness([{"rc": HANG_EXIT_CODE},
                            {"rc": 0, "epochs": 2, "test_eval": True}])
    assert rc == 0
    assert [c["faults"] for c in calls] == ["hang_at_iter=3", None]


def test_pause_every_patches_the_config(harness):
    rc, calls, _ = harness([{"rc": 0, "epochs": 1},
                            {"rc": 0, "epochs": 1, "test_eval": True}],
                           {"total_epochs": 2}, "--pause_every", "1")
    assert rc == 0 and len(calls) == 2


def test_a_finished_run_is_left_alone(harness, tmp_path):
    (tmp_path / "exp" / "logs").mkdir(parents=True)
    (tmp_path / "exp" / "logs" / "test_summary.csv").write_text("ok\n")
    rc, calls, _ = harness([{"rc": 1}])
    assert rc == 0 and calls == []


@pytest.mark.parametrize("argv", [("--num_processes", "2"), ("--fault_rank", "0"),
                                  ("--fleet_grace_s", "5")])
def test_the_fleet_raises_naming_a10(harness, argv):
    with pytest.raises(NotImplementedError, match="A10"):
        harness([{"rc": 0}], None, *argv)


def test_a_hang_on_a_mesh_raises_naming_a10(harness):
    with pytest.raises(NotImplementedError, match="A10"):
        harness([{"rc": HANG_EXIT_CODE}], {"data_parallel_devices": 4})


@pytest.mark.parametrize("name, module", [
    ("omniglot_gradient-descent-omniglot_1_8_0.1_64_5_1", "train_gradient_descent_system"),
    ("omniglot_matching-nets-omniglot_1_8_0.1_64_5_1", "train_matching_nets_system"),
    ("omniglot_maml++-omniglot_1_8_0.1_64_5_1", "train_maml_system"),
])
def test_the_entry_follows_the_config_name_as_in_jax(monkeypatch, name, module):
    monkeypatch.delenv(dispatch.ENTRY_ENV, raising=False)
    command = dispatch.entry_command(name)
    assert command[:3] == [sys.executable, "-u", "-m"]
    assert command[3] == f"howtotrainyourmamlpytorch_tpu_torch.{module}"
    import importlib

    assert hasattr(importlib.import_module(command[3]), "main")

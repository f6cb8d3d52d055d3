"""A two-rank data-parallel fleet of the port end to end on the CPU, and
the dispatcher's fleet supervision (JAX ``tests/test_multihost.py:379-760``).

``fleet_run`` (one for the module): the tiny chaos config on two ranks
through the port's dispatcher (``--num_processes 2 --device cpu``), and its
twin, one process with ``task_chunk = B/2``. The fleet's final state is
the twin's bit for bit; both ranks are in the shared telemetry with the
one trace id (``telemetry_report --fleet`` reads it unchanged); each rank
beats its own heartbeat; rank 0 alone wrote the
checkpoints and the summaries; the fleet's checkpoint resumes on one
process.

The supervision policy on the JAX fleet harness's stub (``fleet_harness``
of ``tests/test_torch_dispatch.py``): a host loss shuts the survivors down
and resumes on one process with the ``host-loss:rank1`` row; a preemption
of every rank requeues the same fleet; a clean degraded phase probes the
full fleet; ``--fault_rank`` gives the fault plan to one rank.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch import chaos_train, telemetry_report
from howtotrainyourmamlpytorch_tpu_torch import train_maml_system_dispatch as dispatch
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.telemetry.events import read_events
from howtotrainyourmamlpytorch_tpu_torch.telemetry.heartbeat import read_heartbeat
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import args_to_maml_config

from test_torch_dispatch import fleet_harness  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "howtotrainyourmamlpytorch_tpu_torch.train_maml_system_dispatch"


def _dispatch(workdir, cfg_path, *argv):
    env = {**os.environ, "DATASET_DIR": str(workdir), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("MAML_FAULTS", None)
    proc = subprocess.run([sys.executable, "-u", "-m", MODULE, str(cfg_path), *argv,
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fleet")
    chaos_train.make_tiny_dataset(str(workdir / "omniglot_mini"), seed=11)
    runs = {}
    for name, overrides in (("fleet_exp", {"data_parallel_devices": 2}),
                            ("twin_exp", {"data_parallel_devices": 1, "task_chunk": 1})):
        cfg = {**chaos_train.tiny_config(), **overrides,
               "experiment_name": str(workdir / name)}
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(cfg))
        runs[name] = path
    log = _dispatch(workdir, runs["fleet_exp"], "--num_processes", "2",
                    "--fleet_grace_s", "25")
    _dispatch(workdir, runs["twin_exp"])
    return {"fleet": workdir / "fleet_exp", "twin": workdir / "twin_exp",
            "cfg": runs["fleet_exp"], "log": log.stdout}


def test_two_ranks_end_bitwise_equal_to_the_chunked_single_process(fleet_run):
    fleet = chaos_train.final_leaves(str(fleet_run["fleet"]))
    twin = chaos_train.final_leaves(str(fleet_run["twin"]))
    assert set(fleet) == set(twin) and len(fleet) > 50
    for key in fleet:
        np.testing.assert_array_equal(fleet[key], twin[key], err_msg=key)
    # The statistics too, but for the topology's columns.
    topology = ("n_devices", "mesh_dp", "process_count")
    rows = [[{k: v for k, v in row.items() if k not in topology}
             for row in chaos_train.summary_rows(str(fleet_run[name]))]
            for name in ("fleet", "twin")]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    assert "fleet rcs [0, 0] -> phase rc 0" in fleet_run["log"]


def test_both_ranks_are_in_the_telemetry_with_one_trace(fleet_run):
    events = read_events(str(fleet_run["fleet"] / "logs" / "telemetry.jsonl"))
    steps = [e for e in events if e.get("type") == "step"]
    assert {int(e["process_index"]) for e in steps} == {0, 1}
    assert all(int(e["process_count"]) == 2 and e["mesh_shape"] == "dp2xmp1"
               for e in steps)
    by_rank = {rank: sorted(e["dispatch_id"] for e in steps
                            if int(e["process_index"]) == rank) for rank in (0, 1)}
    assert by_rank[0] == by_rank[1] and by_rank[0]
    assert len({e["trace_id"] for e in events if "trace_id" in e}) == 1
    # The report's fleet mode reads the fleet's stream unchanged.
    summary = telemetry_report.fleet_summarize([str(fleet_run["fleet"])])
    assert summary["ranks"] == [0, 1] and summary["trace_consistent"]
    assert summary["dispatch_skew"]["dispatches"] == len(by_rank[0])
    assert "per-rank step lanes" in telemetry_report.render_fleet_text(summary)


def test_each_rank_beats_its_own_heartbeat(fleet_run):
    logs = fleet_run["fleet"] / "logs"
    chief = read_heartbeat(str(logs / "status.json"))
    peer = read_heartbeat(str(logs / "status.r1.json"))
    assert chief["process_index"] == 0 and peer["process_index"] == 1
    assert chief["trace_id"] == peer["trace_id"]
    assert chief["current_iter"] == peer["current_iter"] == 6


def test_rank_zero_is_the_single_writer(fleet_run):
    logs = fleet_run["fleet"] / "logs"
    with open(logs / "summary_statistics.csv") as f:
        assert len([line for line in f if line.strip()]) == 1 + 3  # header + epochs
    assert len((logs / "test_summary.csv").read_text().splitlines()) == 2
    saved = sorted(os.listdir(fleet_run["fleet"] / "saved_models"))
    assert saved == sorted(["train_model_1", "train_model_1.ready", "train_model_2",
                            "train_model_2.ready", "train_model_3",
                            "train_model_3.ready", "train_model_latest"])
    # Each epoch's checkpoint was submitted once, by rank 0.
    events = read_events(str(logs / "telemetry.jsonl"))
    submits = [e for e in events if e.get("type") == "checkpoint_submit"]
    assert len(submits) == 3 and {e["process_index"] for e in submits} == {0}


def test_the_fleets_checkpoint_resumes_on_one_process(fleet_run, tmp_path):
    """The archive holds no layout: a one-process learner loads it, saves
    it back bit for bit, and trains on."""
    with open(fleet_run["cfg"]) as f:
        cfg = args_to_maml_config(json.load(f))
    learner = MAMLFewShotLearner(cfg)  # no mesh: one process
    state, exp_state = learner.load_model(str(fleet_run["fleet"] / "saved_models"),
                                          "train_model", "latest", "cpu")
    assert int(exp_state["current_iter"]) == 6
    (tmp_path / "saved_models").mkdir()
    learner.save_model(str(tmp_path / "saved_models" / "train_model_latest"), state,
                       exp_state)
    archive = chaos_train.final_leaves(str(fleet_run["fleet"]))
    again = chaos_train.final_leaves(str(tmp_path))
    assert set(archive) == set(again)
    for key in archive:
        np.testing.assert_array_equal(again[key], archive[key], err_msg=key)
    _, losses = learner.run_train_iter(state, _batch(), epoch=3)
    assert torch.isfinite(losses["loss"])


def _batch():
    rng = np.random.RandomState(0)
    xs = rng.rand(2, 5, 1, 1, 28, 28).astype(np.float32)
    ys = np.tile(np.arange(5)[None, :, None], (2, 1, 1))
    return xs, xs.copy(), ys, ys.copy()


def test_interruption_rows_carry_the_rank(fleet_run, tmp_path):
    """A clean run writes no row; the builder's row has the identity
    columns, the rank's own (pinned on a fleet rank's builder row shape
    through the dispatcher's writer, which shares the header)."""
    assert not (fleet_run["fleet"] / "logs" / "interruptions.csv").exists()
    dispatch._audit_row(str(tmp_path), "host-loss:rank1-degrade:procs2->procs1",
                        current_iter=3, epoch=1, process_index=1, process_count=2,
                        when=12.5)
    with open(tmp_path / "logs" / "interruptions.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0][-2:] == ["process_index", "process_count"]
    assert rows[1] == ["12.5", "host-loss:rank1-degrade:procs2->procs1", "3", "1",
                       "1", "2"]


def test_host_loss_shuts_the_fleet_down_and_resumes_on_one_process(fleet_harness):
    rc, calls, audit = fleet_harness(
        {"rank0": [{"rc": 0, "sleep": 60}],    # the survivor would run on
         "rank1": [{"rc": 137, "sleep": 1}],   # the lost host
         "single": [{"rc": 0, "epochs": 2, "test_eval": True}]},
        None, "--num_processes", "2", "--fleet_grace_s", "2",
    )
    assert rc == 0
    assert calls["rank0"][0]["coordinator"].startswith("127.0.0.1:")
    assert calls["rank0"][0]["num_processes"] == "2" and calls["rank0"][0]["dp"] == 2
    assert calls["single"][0]["coordinator"] is None and calls["single"][0]["dp"] == 1
    kinds = [row.split(",")[1] for row in audit]
    assert kinds == ["host-loss:rank1-degrade:procs2->procs1"]
    assert audit[0].split(",")[4:6] == ["1", "2"]


def test_a_fleet_preemption_requeues_the_same_fleet_then_probes(fleet_harness):
    rc, calls, audit = fleet_harness(
        {"rank0": [{"rc": 75}, {"rc": 137, "sleep": 1},
                   {"rc": 0, "epochs": 1, "test_eval": True}],
         "rank1": [{"rc": 75}, {"rc": 0, "sleep": 60},
                   {"rc": 0, "test_eval": True}],
         "single": [{"rc": 0, "epochs": 1}]},
        None, "--num_processes", "2", "--fleet_grace_s", "2",
    )
    assert rc == 0
    assert len(calls["rank0"]) == 3 and len(calls["single"]) == 1
    kinds = [row.split(",")[1] for row in audit]
    assert kinds == ["host-loss:rank0-degrade:procs2->procs1", "probe-promote:procs2"]


def test_fault_rank_gives_the_plan_to_one_rank(fleet_harness, monkeypatch):
    monkeypatch.setenv("MAML_FAULTS", "sigkill_at_iter=3")
    rc, calls, _ = fleet_harness(
        {"rank0": [{"rc": 0, "epochs": 2, "test_eval": True}],
         "rank1": [{"rc": 0}]},
        None, "--num_processes", "2", "--fault_rank", "1",
    )
    assert rc == 0
    assert calls["rank0"][0]["faults"] is None
    assert calls["rank1"][0]["faults"] == "sigkill_at_iter=3"


def test_host_losses_draw_on_the_hang_budget(fleet_harness):
    """A batch of 2 on two ranks degrades to one; there a loss has nothing
    smaller and requeues, until ``--max_hangs`` stops the run."""
    lost = {"rc": 137, "sleep": 0.5}
    rc, calls, audit = fleet_harness(
        {"rank0": [{"rc": 0, "sleep": 60}], "rank1": [lost],
         "single": [{"rc": 1}, {"rc": 1}]},
        {"batch_size": 2}, "--num_processes", "2", "--fleet_grace_s", "1",
        "--max_hangs", "1",
    )
    assert rc != 0 and len(calls["rank0"]) == 1 and "single" not in calls
    assert [row.split(",")[1] for row in audit] == [
        "host-loss:rank1-degrade:procs2->procs1"]

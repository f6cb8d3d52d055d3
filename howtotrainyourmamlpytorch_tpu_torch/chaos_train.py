"""Chaos harness for the training runtime (``tools/chaos_train.py``, its
training half): a seeded fault schedule driven through the port's
dispatcher and training command line, with a verdict on every fault's
recovery and the seconds it took (``train_recovery_s``).

    python3 -m howtotrainyourmamlpytorch_tpu_torch.chaos_train --tiny \\
        --schedule enospc,sigterm,kill,hang --baseline --json [--device cpu]

=============  ==============================  ============================
class          injection (``MAML_FAULTS``)     documented recovery
=============  ==============================  ============================
``sigterm``    SIGTERM after a dispatch        emergency checkpoint, exit
                                               75, the dispatcher requeues,
                                               bit-exact replay
``kill``       SIGKILL                         no handler; the rerun
                                               replays from the last
                                               published checkpoint,
                                               bit-exact
``hang``       a wedged dispatch               the watchdog's stacks and
                                               exit 76; the dispatcher
                                               reruns on the same device
                                               (one card), bit-exact
``enospc``     ENOSPC on checkpoint writes     in-process write retry
``nan``        a NaN batch                     ``on_nonfinite skip`` on the
                                               card, finite and
                                               progressing
``producer``   a transient loader error        the stager's retry-then-skip
                                               and a ``data_fault`` event
``oom``        out of device memory            terminal, not recovered:
                                               ``oom_report.json``, exit
                                               77, the dispatcher stops
=============  ==============================  ============================

One supervised run: the dispatcher (``train_maml_system_dispatch``) starts
each phase through this module's phase runner (its ``ENTRY_ENV`` test
hook), which plans the phase's faults against the resume point
(``_partition_phases``, ``_plan_phase``, as in the JAX harness), runs the
training entry point with them and records its exit code and time. So
rc 75 and 76 are handled by the dispatcher's own policy.

``--baseline`` runs an unfaulted twin in another process first. For
schedules whose recovery replays the same trajectory (``sigterm``,
``kill``, ``hang``, ``enospc``) the final ``train_model_latest`` and the
``summary_statistics.csv`` rows (their wall-clock columns aside) must
equal the twin's bit for bit; with ``nan`` or ``producer`` the run must be
finite and complete instead. ``--devices N`` trains a dp-N fleet of N
ranks (the config's ``data_parallel_devices``; the dispatcher starts the
ranks and degrades the fleet on a hang). The runs' output goes to
``<workdir>/chaos_{exp,baseline}.log``; the verdict JSON to stdout; the
exit code is 0 iff it says ``ok``.

``--schedule killhost`` runs alone (``run_killhost_chaos``): a two-rank
fleet through the dispatcher (``--num_processes 2 --fault_rank 1``), rank
1 SIGKILLed at iteration 3 (a lost host). The survivor's collective fails
(or its watchdog fires, exit 76), the dispatcher shuts the fleet down,
writes the ``host-loss:rank1`` audit row stamped with the death's time and
resumes degraded on one process (``procs2->procs1``) from the last
checkpoint, and the run completes. ``multihost_recovery_s`` is the death
to the degraded phase's first checkpoint load; the verdict's keys are the
JAX harness's.

The serving control plane has two loops of its own, each run alone:

* ``--schedule promote`` (``run_promote_chaos``): a real trainer publishes
  epoch checkpoints while a two-replica in-process pool serves continuous
  load-test traffic behind its HTTP front door and the promotion daemon
  (its own process) promotes them. Faults: the trainer SIGKILLed between
  an archive and its marker; the daemon's first staged candidate
  truncated (``corrupt_candidate_at``, the daemon's ``MAML_FAULTS``); the
  daemon SIGKILLed after its first ``promoted`` row and restarted; a last
  candidate whose promotion turns the answers NaN
  (``regress_after_promote``, armed in this process). It must show at
  least 3 clean promotions, the corrupt candidate rejected, the rollback
  to the last-known-good digest, no digest promoted twice, 0 failed
  requests, and at least one hard episode mined from the serving
  process's telemetry (``episode_miner``; the load test tags its
  episodes ``seed:<n>``, and the events land in the trainer's
  ``logs/telemetry.jsonl``, as in the JAX loop).
* ``--schedule autoscale`` (``run_autoscale_chaos``): a one-replica pool
  and the autoscaler daemon (its own process, ``autoscaler_kill_at_phase=1``:
  killed with a scale-up journaled and the fleet untouched, then
  restarted) under an overload of distinct support sets, then cache hits
  with ``replica_kill_at_request``; the thresholds come from latencies
  probed on this machine. It must show a scale-up and a scale-down, each
  decided and settled, one resume with no replica spawned twice, and 0
  failed requests.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

PACKAGE = __package__ or "howtotrainyourmamlpytorch_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REQUEUE_EXIT_CODE = 75
HANG_EXIT_CODE = 76
OOM_EXIT_CODE = 77

FAULT_CLASSES = ("sigterm", "kill", "hang", "enospc", "nan", "producer")

#: Checked, not recovered: the run ends there.
TERMINAL = ("oom",)

#: Faults that end the training process; the others ride along in a phase.
STOPPING = {"sigterm", "kill", "hang", "oom"}

#: Recovery changes the trajectory by design: no bit-exact contract.
SKIP_PATH = {"nan", "producer"}

#: In-process faults whose evidence (buffered telemetry, end-of-epoch
#: state) a SIGKILL or the watchdog's exit would destroy: deferred past
#: such phases.
_EVIDENCE_RIDERS = {"nan", "enospc"}
_EVIDENCE_DESTROYING = {"kill", "hang"}

#: Seconds a supervised run (or the twin) may take.
RUN_TIMEOUT_S = 900

#: The phase runner's state file, set for the dispatcher's children.
PHASES_ENV = "MAML_CHAOS_PHASES"

#: The summary CSV's wall-clock columns, left out of the twin comparison.
WALL_CLOCK_COLUMNS = ("epoch_run_time", "_step_time_p", "_data_wait_p",
                      "_stage_wait_p")


def make_tiny_dataset(root: str, seed: int = 0) -> None:
    """The JAX harness's tiny Omniglot-layout tree: 4 alphabets x 5
    characters x 4 binary 28x28 PNGs."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    for a in range(4):
        for c in range(5):
            d = os.path.join(root, f"Alphabet{a}", f"character{c:02d}")
            os.makedirs(d, exist_ok=True)
            proto = rng.randint(0, 2, (28, 28)) * 255
            for i in range(4):
                img = proto.copy()
                flip = rng.rand(28, 28) < 0.05
                img[flip] = 255 - img[flip]
                Image.fromarray(img.astype(np.uint8), mode="L").convert("1").save(
                    os.path.join(d, f"{i}.png"))


def tiny_config(devices: int = 1) -> dict:
    """The JAX harness's tiny config (2-stage 4-filter MAML++, 3 epochs x 2
    iterations) with its resilience knobs, on a dp layout of ``devices``
    ranks; no ``experiment_name``."""
    return {
        "dataset_name": "omniglot_mini", "dataset_path": "omniglot_mini",
        "image_height": 28, "image_width": 28, "image_channels": 1,
        "reset_stored_filepaths": False, "reverse_channels": False,
        "labels_as_int": False, "sets_are_pre_split": False,
        "load_into_memory": False, "train_val_test_split": [0.5, 0.25, 0.25],
        "indexes_of_folders_indicating_class": [-3, -2],
        "num_dataprovider_workers": 2,
        "seed": 104, "train_seed": 1, "val_seed": 0,
        "num_of_gpus": 1, "batch_size": 2, "samples_per_iter": 1,
        "num_classes_per_set": 5, "num_samples_per_class": 1,
        "num_target_samples": 1,
        "total_epochs": 3, "total_iter_per_epoch": 2,
        "total_epochs_before_pause": 100,
        "num_evaluation_tasks": 4, "evaluate_on_test_set_only": False,
        "max_models_to_save": 5, "model": "maml++",
        "num_stages": 2, "cnn_num_filters": 4, "conv_padding": True,
        "max_pooling": True, "norm_layer": "batch_norm",
        "per_step_bn_statistics": True,
        "number_of_training_steps_per_iter": 2,
        "number_of_evaluation_steps_per_iter": 2,
        "second_order": False, "first_order_to_second_order_epoch": -1,
        "use_multi_step_loss_optimization": True, "multi_step_loss_num_epochs": 2,
        "learnable_per_layer_per_step_inner_loop_learning_rate": True,
        "enable_inner_loop_optimizable_bn_params": False,
        "learnable_bn_gamma": True, "learnable_bn_beta": True,
        "meta_learning_rate": 0.001, "min_learning_rate": 1e-5,
        "task_learning_rate": 0.1, "init_inner_loop_learning_rate": 0.1,
        # Under test; on_nonfinite skip is the identity on finite batches,
        # so the twin takes it too.
        "on_nonfinite": "skip",
        "watchdog": True, "watchdog_min_s": 10.0, "watchdog_factor": 3.0,
        "checkpoint_async": True, "data_fault_budget": 4,
        "data_parallel_devices": devices, "model_parallel_devices": 1,
    }


def _latest_state(exp_dir: str) -> dict:
    path = os.path.join(exp_dir, "saved_models", "train_model_latest")
    try:
        with np.load(path) as archive:
            return json.loads(bytes(archive["__experiment_state__"]).decode())
    except Exception:  # noqa: BLE001 - no checkpoint yet
        return {}


def _latest_iter(exp_dir: str) -> int:
    return int(_latest_state(exp_dir).get("current_iter", 0))


def final_leaves(exp_dir: str) -> dict:
    path = os.path.join(exp_dir, "saved_models", "train_model_latest")
    with np.load(path) as archive:
        return {k: archive[k] for k in archive.files if k.startswith("leaf_")}


def summary_rows(exp_dir: str) -> list[dict]:
    """The summary CSV's rows without its wall-clock columns."""
    with open(os.path.join(exp_dir, "logs", "summary_statistics.csv")) as f:
        rows = list(csv.DictReader(f))
    return [{k: v for k, v in row.items()
             if not any(part in k for part in WALL_CLOCK_COLUMNS)} for row in rows]


def _read_events(exp_dir: str) -> list[dict]:
    from .telemetry.events import read_events

    return read_events(os.path.join(exp_dir, "logs", "telemetry.jsonl"))


def _partition_phases(schedule: list[str]) -> list[list[str]]:
    """Per-process phases: in-process faults ride along until a stopping
    fault ends a phase; evidence riders are deferred past kill and hang;
    the rest join the last, clean-to-completion phase. ``oom`` ends the
    run."""
    if any(f in TERMINAL for f in schedule[:-1]):
        raise ValueError("oom is terminal: it must come last in a schedule")
    phases: list[list[str]] = []
    pending: list[str] = []
    for fault in schedule:
        if fault in STOPPING and fault in _EVIDENCE_DESTROYING:
            riders = [f for f in pending if f in _EVIDENCE_RIDERS]
            phases.append([f for f in pending if f not in _EVIDENCE_RIDERS] + [fault])
            pending = riders
        elif fault in STOPPING:
            phases.append(pending + [fault])
            pending = []
        else:
            pending.append(fault)
    if not (schedule and schedule[-1] in TERMINAL):
        phases.append(pending)
    return phases


def _plan_phase(faults: list[str], resume_iter: int, epoch_len: int,
                total_iters: int) -> dict:
    """This phase's ``MAML_FAULTS`` plan against the resume point. The
    stopping fault lands on the first epoch boundary after at least one
    dispatch (the watchdog's first window, and a capture, lie behind it);
    the in-process faults at the first dispatches."""
    stop_at = -(-(resume_iter + 1) // epoch_len) * epoch_len
    plan: dict = {}
    for fault in faults:
        if fault == "nan":
            plan["nan_at_iter"] = resume_iter
        elif fault == "producer":
            plan["producer_fail_at_iter"] = resume_iter + 1
        elif fault == "enospc":
            plan["fail_next_writes"] = 2
        elif fault == "sigterm":
            plan["sigterm_at_iter"] = stop_at
        elif fault == "kill":
            plan["sigkill_at_iter"] = stop_at
        elif fault == "hang":
            plan["hang_at_iter"] = min(stop_at, total_iters - 1)
        elif fault == "oom":
            plan["oom_at_iter"] = min(stop_at, total_iters - 1)
        else:
            raise ValueError(f"unknown fault class {fault!r}")
    return plan


def _claim_phase(state_path: str, argv: list[str]) -> tuple[dict, int]:
    """``(state, this phase's index)``. The ranks of one fleet phase share
    its coordinator address (a fresh port each phase): the first rank to
    arrive takes the next index, the others the one it took."""
    import fcntl

    key = None
    if "--coordinator_address" in argv:
        key = argv[argv.index("--coordinator_address") + 1]
    with open(state_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        with open(state_path) as f:
            state = json.load(f)
        claimed = state.setdefault("claimed", {})
        if key is not None and key in claimed:
            return state, claimed[key]
        index = state["next"]
        state["next"] = index + 1
        if key is not None:
            claimed[key] = index
        with open(state_path, "w") as f:
            json.dump(state, f)
    return state, index


def phase_main(argv: list[str]) -> int:
    """The dispatcher's entry under chaos: the next phase's faults planned
    against the resume point, the training entry point run with them, its
    rc and exit time recorded; the rc passed on (a signal death as
    128 + the signal). Every rank of a fleet phase runs the phase's plan;
    rank 0 records it."""
    state_path = os.environ[PHASES_ENV]
    state, index = _claim_phase(state_path, argv)
    faults = state["phases"][index] if index < len(state["phases"]) else []
    resume_iter = _latest_iter(state["exp_dir"])
    plan = _plan_phase(faults, resume_iter, state["epoch_len"], state["total_iters"])
    env = dict(os.environ)
    env.pop(PHASES_ENV, None)
    if plan:
        env["MAML_FAULTS"] = ",".join(f"{k}={v}" for k, v in plan.items())
    else:
        env.pop("MAML_FAULTS", None)
    t_start = time.time()
    rc = subprocess.run(
        [sys.executable, "-u", "-m", f"{PACKAGE}.train_maml_system", *argv],
        env=env, check=False,
    ).returncode
    rank = argv[argv.index("--process_id") + 1] if "--process_id" in argv else "0"
    if rank == "0":
        with open(state["log"], "a") as f:
            f.write(json.dumps({"phase": index, "faults": faults, "plan": plan,
                                "resume_iter": resume_iter, "rc": rc,
                                "t_start": t_start, "t_exit": time.time()}) + "\n")
    return 128 - rc if rc < 0 else rc


def _write_config(workdir: str, config: dict, name: str) -> str:
    path = os.path.join(workdir, f"{name}.json")
    with open(path, "w") as f:
        json.dump({**config, "experiment_name": os.path.join(workdir, name)}, f)
    return path


def _child_env(dataset_dir: str) -> dict:
    env = dict(os.environ)
    env["DATASET_DIR"] = dataset_dir
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MAML_FAULTS", None)
    return env


def run_chaos(workdir: str, schedule: list[str], *, config: dict | None = None,
              dataset_dir: str | None = None, baseline: bool = False,
              device: str | None = None, extra_argv: list[str] = (),
              verbose: bool = True) -> dict:
    """Runs ``schedule`` as one supervised run and returns the verdict.
    ``config``: the experiment JSON without ``experiment_name`` (the tiny
    config by default); ``dataset_dir``: ``DATASET_DIR`` (``workdir`` by
    default, which must then hold the tiny dataset); ``extra_argv`` and
    ``--device`` go to every training process."""
    for fault in schedule:
        if fault not in FAULT_CLASSES + TERMINAL:
            raise ValueError(f"unknown fault class {fault!r}; expected "
                             f"{FAULT_CLASSES + TERMINAL}")

    def log(msg):
        if verbose:
            print(f"chaos: {msg}", file=sys.stderr, flush=True)

    config = dict(config or tiny_config())
    env = _child_env(dataset_dir or workdir)
    argv = [*extra_argv, *(["--device", device] if device else [])]
    epoch_len = int(config["total_iter_per_epoch"])
    total_iters = int(config["total_epochs"]) * epoch_len
    verdict: dict = {"schedule": list(schedule),
                     "devices": max(int(config.get("data_parallel_devices", 1) or 1), 1)}

    base_exp = None
    if baseline:
        base_cfg = _write_config(workdir, config, "chaos_baseline")
        base_exp = os.path.join(workdir, "chaos_baseline")
        log(f"baseline: the unfaulted twin (output in {base_exp}.log)")
        t0 = time.time()
        with open(f"{base_exp}.log", "w") as out:
            base_rc = subprocess.run(
                [sys.executable, "-u", "-m", f"{PACKAGE}.train_maml_system",
                 "--name_of_args_json_file", base_cfg, *argv],
                env=env, check=False, timeout=RUN_TIMEOUT_S, stdout=out,
                stderr=subprocess.STDOUT,
            ).returncode
        verdict["baseline_rc"] = base_rc
        verdict["baseline_s"] = round(time.time() - t0, 3)

    cfg_path = _write_config(workdir, config, "chaos_exp")
    exp_dir = os.path.join(workdir, "chaos_exp")
    test_csv = os.path.join(exp_dir, "logs", "test_summary.csv")
    phases = _partition_phases(list(schedule))
    state_path = os.path.join(workdir, "chaos_phases.json")
    phase_log = os.path.join(workdir, "chaos_phases.jsonl")
    with open(state_path, "w") as f:
        json.dump({"phases": phases, "next": 0, "exp_dir": exp_dir,
                   "epoch_len": epoch_len, "total_iters": total_iters,
                   "log": phase_log}, f)
    log(f"supervised run, phases {phases} (output in {exp_dir}.log)")
    t0 = time.time()
    with open(f"{exp_dir}.log", "w") as out:
        dispatch_rc = subprocess.run(
            [sys.executable, "-u", "-m", f"{PACKAGE}.train_maml_system_dispatch",
             cfg_path, *argv],
            env={**env, PHASES_ENV: state_path,
                 "MAML_DISPATCH_ENTRY": f"{PACKAGE}.chaos_train"},
            check=False, timeout=RUN_TIMEOUT_S, stdout=out, stderr=subprocess.STDOUT,
        ).returncode
    verdict["supervised_s"] = round(time.time() - t0, 3)
    with open(phase_log) as f:
        ran = [json.loads(line) for line in f if line.strip()]
    log(f"dispatcher rc {dispatch_rc}; phases {[(p['faults'], p['rc']) for p in ran]}")
    events = _read_events(exp_dir)
    completed = os.path.exists(test_csv)

    faults: dict = {}
    recoveries: dict = {}
    for i, phase in enumerate(ran):
        for fault in phase["faults"]:
            faults.setdefault(fault, {})["rc"] = phase["rc"]
        stopper = next((f for f in phase["faults"] if f in STOPPING), None)
        if stopper is None:
            continue
        rc = phase["rc"]
        faults[stopper]["exit_as_documented"] = {
            "sigterm": rc == REQUEUE_EXIT_CODE, "kill": rc in (-9, 137),
            "hang": rc == HANG_EXIT_CODE, "oom": rc == OOM_EXIT_CODE,
        }[stopper]
        # Recovery: the faulted process's exit to the next process's first
        # checkpoint load (both on this host's clock).
        loads = [e["t"] for e in events
                 if e.get("type") == "checkpoint_load" and e["t"] >= phase["t_exit"]]
        if stopper != "oom" and loads and i + 1 < len(ran):
            recoveries[stopper] = round(min(loads) - phase["t_exit"], 3)
            faults[stopper]["recovery_s"] = recoveries[stopper]
    if "sigterm" in faults:
        faults["sigterm"]["recovered"] = bool(
            faults["sigterm"].get("exit_as_documented")
            and any(e.get("type") == "preemption" for e in events) and completed)
    if "kill" in faults:
        faults["kill"]["recovered"] = bool(
            faults["kill"].get("exit_as_documented") and completed)
    if "hang" in faults:
        faults["hang"]["recovered"] = bool(
            faults["hang"].get("exit_as_documented")
            and any(e.get("type") == "hang" for e in events)
            and os.path.exists(os.path.join(exp_dir, "logs", "hang_stacks.txt"))
            and completed)
    if "enospc" in faults:
        faults["enospc"]["recovered"] = any(
            e.get("type") == "checkpoint_save" and e.get("attempts", 1) > 1
            for e in events)
    if "producer" in faults:
        faults["producer"]["recovered"] = any(
            e.get("type") == "data_fault" and not e.get("fatal", True) for e in events)
    if "nan" in faults:
        faults["nan"]["recovered"] = (
            float(_latest_state(exp_dir).get("nonfinite_trips_total", 0.0)) > 0.0)
    if "oom" in faults:
        report = {}
        try:
            with open(os.path.join(exp_dir, "logs", "oom_report.json")) as f:
                report = json.load(f)
        except (OSError, ValueError):
            pass
        faults["oom"]["report"] = report
        faults["oom"]["checked"] = bool(
            faults["oom"].get("exit_as_documented") and dispatch_rc == OOM_EXIT_CODE
            and str(report.get("error_type", "")).endswith("OutOfMemoryError"))

    final_finite = None
    leaves = None
    try:
        leaves = final_leaves(exp_dir)
        final_finite = all(np.isfinite(np.asarray(a, np.float64)).all()
                           for a in leaves.values())
    except Exception:  # noqa: BLE001 - no final checkpoint
        pass
    bitexact = None
    if base_exp is not None and not set(schedule) & (SKIP_PATH | set(TERMINAL)):
        try:
            base = final_leaves(base_exp)
            bitexact = (leaves is not None and set(base) == set(leaves)
                        and all(np.array_equal(base[k], leaves[k]) for k in leaves)
                        and summary_rows(base_exp) == summary_rows(exp_dir))
        except Exception:  # noqa: BLE001 - the twin failed
            bitexact = False
    restarts = sorted(recoveries.values())
    terminal = bool(schedule) and schedule[-1] in TERMINAL
    recovered_all = all(info.get("recovered", False) for fault, info in faults.items()
                        if fault in FAULT_CLASSES)
    verdict.update({
        "dispatcher_rc": dispatch_rc,
        "phases": [{k: p[k] for k in ("faults", "plan", "resume_iter", "rc")}
                   for p in ran],
        "completed": completed,
        "faults": faults,
        "mttr_s": recoveries,
        "train_recovery_s": restarts[len(restarts) // 2] if restarts else None,
        "bitexact_vs_baseline": bitexact,
        "final_finite": final_finite,
    })
    if terminal:
        ok = bool(faults["oom"]["checked"]) and recovered_all
    else:
        ok = (completed and dispatch_rc == 0 and recovered_all
              and bitexact is not False and final_finite is not False)
    verdict["ok"] = bool(ok)
    return verdict


# ---------------------------------------------------------------------------
# The host-loss class: a rank of a fleet killed
# ---------------------------------------------------------------------------

#: Wall budget of the kill-a-host run (the fleet phase, the shutdown and
#: the degraded resume to completion).
KILLHOST_TIMEOUT_S = 900

#: The victim's plan: rank 1 SIGKILLed after its third meta-update.
KILLHOST_FAULTS = "sigkill_at_iter=3"


def run_killhost_chaos(workdir: str, *, config: dict | None = None,
                       dataset_dir: str | None = None, device: str | None = None,
                       extra_argv: list[str] = (), grace_s: float = 25.0,
                       verbose: bool = True) -> dict:
    """Kill-a-host (JAX ``tools/chaos_train.py:540-660``): a two-rank fleet
    through the port's dispatcher, rank 1 SIGKILLed at iteration 3; the
    run must complete degraded on one process with the host-loss row.
    ``config``: the experiment JSON without ``experiment_name`` (the tiny
    config on two ranks by default); ``extra_argv`` and ``--device`` go to
    every rank. Returns the verdict (JAX's keys)."""

    def log(msg):
        if verbose:
            print(f"chaos: {msg}", file=sys.stderr, flush=True)

    config = {**(config or tiny_config()), "data_parallel_devices": 2}
    cfg_path = _write_config(workdir, config, "chaos_killhost")
    exp_dir = os.path.join(workdir, "chaos_killhost")
    env = {**_child_env(dataset_dir or workdir), "MAML_FAULTS": KILLHOST_FAULTS}
    argv = [*extra_argv, *(["--device", device] if device else [])]
    log(f"kill-a-host: a 2-rank fleet through the dispatcher, rank 1 killed at "
        f"iteration 3 (output in {exp_dir}.log)")
    t0 = time.time()
    with open(f"{exp_dir}.log", "w") as out:
        dispatch_rc = subprocess.run(
            [sys.executable, "-u", "-m", f"{PACKAGE}.train_maml_system_dispatch",
             cfg_path, "--num_processes", "2", "--fault_rank", "1",
             "--fleet_grace_s", str(grace_s), "--max_hangs", "4", *argv],
            env=env, check=False, timeout=KILLHOST_TIMEOUT_S, stdout=out,
            stderr=subprocess.STDOUT,
        ).returncode
    wall_s = time.time() - t0
    log(f"dispatcher rc {dispatch_rc} after {wall_s:.1f} s")
    events = _read_events(exp_dir)
    # The survivor sees the loss as a failed collective (gloo: the peer's
    # connection closed) or as a silent one its watchdog ends (76): the
    # hang event is recorded when there is one, not required.
    hangs = [e for e in events
             if e.get("type") == "hang" and int(e.get("process_index", -1)) == 0]
    try:
        with open(os.path.join(exp_dir, "logs", "interruptions.csv")) as f:
            audit_rows = [line.strip() for line in f][1:]
    except OSError:
        audit_rows = []
    host_loss_rows = [r for r in audit_rows if "host-loss:rank1" in r]
    degrade_rows = [r for r in audit_rows if "procs2->procs1" in r]
    recovery_s = None
    if host_loss_rows:
        t_loss = min(float(r.split(",")[0]) for r in host_loss_rows)
        loads = [float(e["t"]) for e in events
                 if e.get("type") == "checkpoint_load" and float(e["t"]) >= t_loss]
        if loads:
            recovery_s = round(min(loads) - t_loss, 3)
    final_finite = None
    try:
        final_finite = all(np.isfinite(np.asarray(a, np.float64)).all()
                           for a in final_leaves(exp_dir).values())
    except Exception:  # noqa: BLE001 - no final checkpoint
        pass
    completed = os.path.exists(os.path.join(exp_dir, "logs", "test_summary.csv"))
    verdict = {
        "schedule": ["killhost"], "devices": 2, "num_processes": 2,
        "completed": completed,
        "dispatcher_rc": dispatch_rc,
        "survivor_hang_detected": bool(hangs),
        "host_loss_audit_rows": host_loss_rows,
        "degraded_to_one_process": bool(degrade_rows),
        "multihost_recovery_s": recovery_s,
        "final_finite": final_finite,
        "wall_s": round(wall_s, 1),
    }
    verdict["ok"] = bool(
        completed and dispatch_rc == 0 and host_loss_rows and degrade_rows
        and recovery_s is not None and final_finite is not False
    )
    if not verdict["ok"]:
        log(f"verdict: {json.dumps(verdict, indent=1)}")
    return verdict


# ---------------------------------------------------------------------------
# The serving control plane: the promote and autoscale loops
# ---------------------------------------------------------------------------

#: Wall budget of each control-plane loop.
PROMOTE_TIMEOUT_S = 600
AUTOSCALE_TIMEOUT_S = 600
#: The promote loop's epochs: the first is lost to the trainer's kill and
#: the next is the corrupt candidate, which leaves 3 to promote cleanly.
PROMOTE_EPOCHS = 5

#: The promotion daemon's settings in the promote loop (the JAX harness's):
#: a 0.3 s scan, a 2 s SLO window sampled every 0.2 s, retries 0.3 s apart.
PROMOTE_DAEMON = {"poll_interval_s": 0.3, "slo_watch_s": 2.0, "slo_poll_s": 0.2,
                  "min_requests": 1, "promote_retries": 4, "promote_backoff_s": 0.3}
#: What the regressing candidate's promotion turns NaN: the next K answers.
REGRESS_ANSWERS = 8
#: The promote loop's traffic: open-loop Poisson, in rounds of this length.
#: At 8 requests/s a 1 s SLO window misses every answer with probability
#: e^-8, so a regressing promotion is seen.
PROMOTE_TRAFFIC_QPS, PROMOTE_TRAFFIC_ROUND_S = 8.0, 2.0
#: The autoscaler's policy in the autoscale loop, bar the p99 thresholds,
#: which come from latencies probed on the machine that runs it.
AUTOSCALE_POLICY = {"min_replicas": 1, "max_replicas": 3, "step_up": 2, "step_down": 1,
                    "cooldown_s": 1.0, "confirm_samples": 2, "poll_interval_s": 0.25,
                    "settle_timeout_s": 120.0}
#: The cache-hit request that kills its replica in the autoscale loop.
AUTOSCALE_KILL_AT = 40
#: Closed-loop clients of the idle phase's cache hits. One: with several,
#: the interpreter lock shared by the clients and the replicas' batcher
#: threads, not the fleet, sets the tail (on an H100 three clients held
#: the p99 of 3.3 ms hits at 30-45 ms).
AUTOSCALE_FLUSH_CLIENTS = 1


class ControlPlaneMonitor:
    """Hooks of the promote and autoscale loops (no-ops here): a caller that
    checks more, such as ``chip_smoke.py``, overrides them. They run on the
    loop's threads; an exception in ``journal_row`` fails the loop once it
    has cleaned up."""

    def replica_built(self, index: int, api) -> None:
        """A replica's ``ServingAPI``, built, before its warmup."""

    def daemon_started(self, proc, name: str) -> None:
        """A daemon process (``promotion`` or ``autoscaler``) was started."""

    def journal_row(self, row: dict, pool) -> None:
        """Each row of the loop's journal, in order, soon after it lands."""


class _JournalFollower:
    """A thread that hands each new journal row to ``callback`` in order
    and keeps the first exception it raised."""

    def __init__(self, path: str, callback):
        import threading

        self.path, self.callback = path, callback
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._seen = 0
        self._thread = threading.Thread(target=self._run, name="journal-follower",
                                        daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        rows = _journal(self.path)
        for row in rows[self._seen:]:
            self._seen += 1
            if self.error is None:
                try:
                    self.callback(row)
                except BaseException as exc:  # noqa: BLE001 - raised by close()
                    self.error = exc

    def _run(self) -> None:
        while not self._stop.wait(0.1):
            self._drain()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=120)
        self._drain()
        if self.error is not None:
            raise self.error


def _journal(path: str) -> list[dict]:
    from .serve.resilience.promotion import PromotionJournal

    return PromotionJournal.load(path)


def _daemon_env(dataset_dir: str, faults: str | None) -> dict:
    env = _child_env(dataset_dir)
    if faults:
        env["MAML_FAULTS"] = faults
    return env


def _start_daemon(module: str, argv: list[str], env: dict, log_path: str, monitor,
                  name: str):
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", f"{PACKAGE}.{module}", *argv],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
        )
    monitor.daemon_started(proc, name)
    return proc


def _stop_process(proc) -> None:
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def _local_pool(cfg_path: str, n: int, bucket, *, serve_config: dict, train_flags,
                device, monitor, pool_config: dict):
    """A ``ReplicaPool`` of ``n`` in-process replicas, each its own learner
    and ``ServingAPI`` from seed 0, warmed at ``bucket``; returns the pool
    and the list of replica indices the factory built, in order."""
    import torch

    from .serve import ServeConfig, ServingAPI
    from .serve.pool import PoolConfig, ReplicaPool
    from .serve.resilience.replica import LocalReplica
    from .serve_maml import build_learner

    built: list[int] = []

    def factory(index: int) -> LocalReplica:
        learner, dev = build_learner("maml", cfg_path, train_flags, device)
        api = ServingAPI(
            learner, learner.init_inference_state(torch.Generator().manual_seed(0), dev),
            ServeConfig(**serve_config), device=dev,
        )
        monitor.replica_built(index, api)
        api.warmup([bucket])
        built.append(index)
        return LocalReplica(api, replica_id=f"local-{index}")

    pool = ReplicaPool(factory, PoolConfig(n_replicas=n, **pool_config))
    return pool, built


def _front_door(pool):
    import threading

    from .serve import make_http_server

    server = make_http_server(pool, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _close_front_door(server, thread) -> None:
    if server is not None:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _promotion_argv(exp_dir: str, url: str, settings: dict) -> list[str]:
    argv = ["--watch", os.path.join(exp_dir, "saved_models"), "--target", url,
            "--journal", os.path.join(exp_dir, "logs", "promotions.jsonl"),
            "--staging", os.path.join(exp_dir, "promotion_staging"),
            "--telemetry", os.path.join(exp_dir, "logs", "daemon_telemetry.jsonl")]
    for key, value in settings.items():
        argv += [f"--{key}", str(value)]
    return argv


def _marked_candidates(watch_dir: str) -> dict:
    """``{digest: path}`` of the epoch checkpoints with a ``.ready`` marker."""
    from .utils.checkpoint import read_done_marker

    out = {}
    try:
        names = os.listdir(watch_dir)
    except OSError:
        return out
    for name in names:
        suffix = name[len("train_model_"):]
        if name.startswith("train_model_") and suffix.isdigit():
            path = os.path.join(watch_dir, name)
            marker = read_done_marker(path)
            if marker is not None:
                out[str(marker["digest"])] = path
    return out


def _terminal_counts(rows: list[dict]) -> dict:
    from .serve.resilience.promotion import TERMINAL_PHASES

    counts: dict = {}
    for row in rows:
        digest = row.get("digest")
        if digest and row["phase"] not in ("retired", "deduped"):
            counts.setdefault(digest, 0)
            if row["phase"] in TERMINAL_PHASES:
                counts[digest] += 1
    return counts


def run_promote_chaos(workdir: str, *, config: dict | None = None,
                      dataset_dir: str | None = None, device: str | None = None,
                      train_flags=(), serve_flags=None, query: int | None = None,
                      serve_config: dict | None = None, daemon: dict | None = None,
                      monitor=None, beside=None, verbose: bool = True) -> dict:
    """The continuous train-to-serve loop, unattended (see the module
    docstring for its faults). ``config``: the experiment JSON without
    ``experiment_name`` (the tiny config by default), run for
    ``PROMOTE_EPOCHS`` epochs of one iteration; ``dataset_dir`` holds its tree (``workdir`` by
    default); ``train_flags`` go to the trainer, ``serve_flags`` (by
    default the same) to the serving learners, ``device`` to both;
    ``query`` sets the traffic's bucket ``5x1xquery`` (the config's target
    count by default); ``serve_config`` the replicas' ``ServeConfig``;
    ``daemon`` the daemon's settings over ``PROMOTE_DAEMON``. The first
    trainer run, the one killed mid-publish, starts before the pool and the
    daemon; ``beside``, when given, is called while it runs, before the
    pool is built, and its result is the verdict's ``beside``. Returns the
    verdict."""
    import threading

    import torch

    from .episode_miner import mine_events, select_hard_episodes
    from .serve_loadtest import run_loadtest, synth_episodes
    from .serve_maml import build_learner
    from .telemetry import events as tel_events
    from .utils import faultinject
    from .utils.checkpoint import publish_done_marker

    t0 = time.time()

    def log(msg):
        if verbose:
            print(f"chaos: {time.time() - t0:.1f} s: {msg}", file=sys.stderr, flush=True)

    monitor = monitor or ControlPlaneMonitor()
    config = dict(config or tiny_config())
    config.update(total_epochs=PROMOTE_EPOCHS, total_iter_per_epoch=1)
    dataset_dir = dataset_dir or workdir
    cfg_path = _write_config(workdir, config, "chaos_promote")
    exp_dir = os.path.join(workdir, "chaos_promote")
    os.makedirs(os.path.join(exp_dir, "logs"), exist_ok=True)
    watch_dir = os.path.join(exp_dir, "saved_models")
    journal_path = os.path.join(exp_dir, "logs", "promotions.jsonl")
    test_csv = os.path.join(exp_dir, "logs", "test_summary.csv")
    telemetry_path = os.path.join(exp_dir, "logs", "telemetry.jsonl")
    settings = {**PROMOTE_DAEMON, **(daemon or {})}
    way = int(config["num_classes_per_set"])
    query = int(query or config["num_target_samples"])
    bucket = (way, 1, query)
    device_argv = ["--device", device] if device else []
    serve_argv = [*(train_flags if serve_flags is None else serve_flags), *device_argv]
    trainer_argv = [sys.executable, "-u", "-m", f"{PACKAGE}.train_maml_system",
                    "--name_of_args_json_file", cfg_path, *train_flags, *device_argv]
    trainer_log = os.path.join(workdir, "chaos_promote.log")
    previous_dataset_dir = os.environ.get("DATASET_DIR")
    os.environ["DATASET_DIR"] = dataset_dir

    verdict: dict = {"schedule": ["promote"], "ok": False, "bucket": "x".join(map(str, bucket)),
                     "daemon_settings": settings, "telemetry": telemetry_path}
    log("trainer run 1 (kill_trainer_mid_publish=1)")
    with open(trainer_log, "a") as out:
        first_run = subprocess.Popen(
            trainer_argv, env=_daemon_env(dataset_dir, "kill_trainer_mid_publish=1"),
            stdout=out, stderr=subprocess.STDOUT)
    pool = server = thread = follower = sink = None
    previous_sink = None
    holder: dict = {"proc": None}
    stop_traffic = threading.Event()
    results: list[dict] = []
    traffic = killer = None
    try:
        if beside is not None:
            verdict["beside"] = beside()
            log("the work beside the first trainer run is done")
        # The serving side's events (``serve_dispatch`` with the traffic's
        # seed tags) go to the trainer's telemetry file, as in the JAX loop.
        sink = tel_events.EventLog(telemetry_path)
        previous_sink = tel_events.install(sink)
        pool, _ = _local_pool(
            cfg_path, 2, bucket,
            serve_config={"meta_batch_size": 2, "max_wait_ms": 0.0, **(serve_config or {})},
            train_flags=serve_argv, device=device, monitor=monitor,
            pool_config={"health_interval_s": 0.1, "restart_backoff_s": 0.2,
                         "min_uptime_s": 0.0},
        )
        if not pool.wait_ready(timeout=300.0):
            raise RuntimeError("the two-replica pool never became healthy")
        server, thread, url = _front_door(pool)
        follower = _JournalFollower(journal_path, lambda row: monitor.journal_row(row, pool))
        log(f"pool front door on {url}")
        learner, dev = build_learner("maml", cfg_path, serve_argv, device)
        bb = learner.cfg.backbone
        episodes = synth_episodes(16, way=way, shot=1, query=query,
                                  image_shape=(bb.image_channels, bb.image_height,
                                               bb.image_width), seed=3)

        def offer_traffic():
            while not stop_traffic.is_set():
                results.append(run_loadtest(
                    pool, episodes, rate_qps=PROMOTE_TRAFFIC_QPS,
                    duration_s=PROMOTE_TRAFFIC_ROUND_S, p99_budget_ms=5_000.0,
                    error_slo=0.0, timeout_s=30.0, seed=len(results),
                    sample_health=False, tag_seed_base=50_000,
                ))

        traffic = threading.Thread(target=offer_traffic, daemon=True)
        traffic.start()

        daemon_log = os.path.join(workdir, "chaos_promotion_daemon.log")
        argv = _promotion_argv(exp_dir, url, settings)
        holder["proc"] = _start_daemon(
            "promotion_daemon", argv, _daemon_env(dataset_dir, "corrupt_candidate_at=600"),
            daemon_log, monitor, "promotion")
        log("promotion daemon started (corrupt_candidate_at=600)")
        deadline = time.time() + PROMOTE_TIMEOUT_S

        def kill_and_restart():
            while time.time() < deadline and not stop_traffic.is_set():
                if any(r["phase"] == "promoted" for r in _journal(journal_path)):
                    log("SIGKILL the daemon after its first promoted row")
                    holder["proc"].kill()
                    holder["proc"].wait(timeout=30)
                    holder["proc"] = _start_daemon(
                        "promotion_daemon", argv, _daemon_env(dataset_dir, None),
                        daemon_log, monitor, "promotion")
                    verdict["daemon_killed_mid_run"] = True
                    return
                time.sleep(0.1)

        killer = threading.Thread(target=kill_and_restart, daemon=True)
        killer.start()

        runs = 1
        rc = first_run.wait(timeout=RUN_TIMEOUT_S)
        verdict["trainer_killed_mid_publish"] = rc in (-9, 137)
        while not os.path.exists(test_csv) and runs < 4:
            runs += 1
            log(f"trainer run {runs}")
            with open(trainer_log, "a") as out:
                subprocess.run(trainer_argv, env=_daemon_env(dataset_dir, None),
                               check=False, timeout=RUN_TIMEOUT_S, stdout=out,
                               stderr=subprocess.STDOUT)
        verdict["trainer_runs"] = runs
        verdict["trainer_completed"] = os.path.exists(test_csv)
        if not verdict["trainer_completed"]:
            raise RuntimeError(f"the trainer did not complete in {runs} runs (its "
                               f"output: {os.path.join(workdir, 'chaos_promote.log')})")

        # Every marked trainer candidate resolved, and the daemon restarted.
        killer.join(timeout=max(1.0, deadline - time.time()))
        while time.time() < deadline:
            terminal = {d for d, n in _terminal_counts(_journal(journal_path)).items() if n}
            if set(_marked_candidates(watch_dir)) <= terminal:
                break
            time.sleep(0.2)

        # The regression: armed here (the serving process) before the last
        # candidate exists; its promotion turns the next answers NaN.
        log(f"arming regress_after_promote={REGRESS_ANSWERS}, dropping the last candidate")
        faultinject.activate(faultinject.FaultPlan(regress_after_promote=REGRESS_ANSWERS))
        bad_path = os.path.join(watch_dir, f"train_model_{PROMOTE_EPOCHS + 40}")
        learner.save_model(
            bad_path, learner.init_state(torch.Generator().manual_seed(7), dev),
            {"current_iter": 999, "best_val_acc": 0.9,
             "per_epoch_statistics": {"val_accuracy_mean": [0.9]}},
        )
        publish_done_marker(bad_path)
        verdict["bad_candidate"] = os.path.basename(bad_path)
        rollback_seen = False
        while time.time() < deadline:
            if any(r["phase"] == "rolled_back" for r in _journal(journal_path)):
                rollback_seen = True
                break
            time.sleep(0.2)
        verdict["rollback_seen"] = rollback_seen
    finally:
        stop_traffic.set()
        faultinject.deactivate()
        _stop_process(first_run)
        _stop_process(holder["proc"])
        if traffic is not None:
            traffic.join(timeout=120)
        _close_front_door(server, thread)
        if pool is not None:
            pool.close()
        if sink is not None:
            tel_events.install(previous_sink)
            sink.flush()
        if previous_dataset_dir is None:
            os.environ.pop("DATASET_DIR", None)
        else:
            os.environ["DATASET_DIR"] = previous_dataset_dir
        if follower is not None:
            follower.close()
    verdict["wall_s"] = round(time.time() - t0, 3)
    # The feedback edge: the run's own telemetry mines into a replay manifest.
    verdict["mined_episodes"] = len(select_hard_episodes(
        mine_events(_read_events(exp_dir)), max_margin=1.0, top=64))

    rows = _journal(journal_path)
    start = {r["digest"]: r for r in rows if r["phase"] == "start"}
    promoted = [r for r in rows if r["phase"] == "promoted"]
    clean = [r["digest"] for r in rows if r["phase"] == "slo_ok"]
    rejected = [r for r in rows if r["phase"] == "rejected"]
    rolled = [r for r in rows if r["phase"] == "rolled_back"]
    counts: dict = {}
    for r in promoted:
        counts[r["digest"]] = counts.get(r["digest"], 0) + 1
    double = [d for d, n in counts.items() if n > 1 and not any(
        r.get("resumed") for r in promoted if r["digest"] == d)]
    terminal = _terminal_counts(rows)
    offered = sum(r["offered"] for r in results)
    answered = sum(r["completed_ok"] for r in results)
    corrupt = [r for r in rejected if r["reason"] in ("corrupt", "digest_mismatch")]
    publish_s = {}
    for r in promoted:
        path = start.get(r["digest"], {}).get("path")
        if path and os.path.exists(path + ".ready"):
            publish_s[os.path.basename(path)] = round(
                r["t"] - os.path.getmtime(path + ".ready"), 3)
    bad_digest = next((d for d, s in start.items()
                       if os.path.basename(str(s.get("path"))) == verdict.get("bad_candidate")),
                      None)
    bad_promoted = next((r["t"] for r in promoted if r["digest"] == bad_digest), None)
    bad_rollback = next((r for r in rows if r["phase"] == "rollback_start"
                         and r["digest"] == bad_digest), None)
    if bad_promoted is not None and rolled:
        verdict["regression_detect_s"] = round(bad_rollback["t"] - bad_promoted, 3)
        verdict["regression_to_rolled_back_s"] = round(rolled[-1]["t"] - bad_promoted, 3)
    verdict.update({
        "promotions": len(clean),
        "promoted_digests": sorted({r["digest"] for r in promoted}),
        "corrupt_rejected": len(corrupt),
        "rejected_reasons": sorted(r["reason"] for r in rejected),
        "rollback_to_lkg": bool(rolled and clean and rolled[-1].get("to") == clean[-1]
                                and rolled[-1]["digest"] == bad_digest),
        "double_promoted": double,
        "resumed_rows": sum(1 for r in rows if r["phase"] == "resumed"),
        "terminal_rows_per_digest": sorted(set(terminal.values())),
        "publish_to_promoted_s": publish_s,
        "loadtest_offered": offered,
        "loadtest_ok": answered,
        "loadtest_failed": offered - answered,
        "loadtest_slo_pass": bool(results) and all(r["slo_pass"] for r in results),
    })
    verdict["ok"] = bool(
        verdict.get("trainer_completed")
        and verdict.get("trainer_killed_mid_publish")
        and verdict.get("daemon_killed_mid_run")
        and len(clean) >= 3
        and corrupt
        and verdict.get("rollback_seen")
        and verdict["rollback_to_lkg"]
        and not double
        and verdict["terminal_rows_per_digest"] == [1]
        and verdict["loadtest_slo_pass"]
        and offered > 0
        and offered == answered
        and verdict["mined_episodes"] > 0
    )
    if not verdict["ok"]:
        log(f"verdict: {json.dumps(verdict, indent=1)}")
    return verdict


def _autoscaler_argv(journal_path: str, url: str, up_p99_ms: float, down_p99_ms: float,
                     telemetry: str) -> list[str]:
    p = AUTOSCALE_POLICY
    return ["--target", url, "--journal", journal_path, "--telemetry", telemetry,
            "--min-replicas", str(p["min_replicas"]), "--max-replicas", str(p["max_replicas"]),
            "--step-up", str(p["step_up"]), "--step-down", str(p["step_down"]),
            "--up-p99-ms", f"{up_p99_ms:.3f}", "--down-p99-ms", f"{down_p99_ms:.3f}",
            "--cooldown-s", str(p["cooldown_s"]), "--confirm-samples", str(p["confirm_samples"]),
            "--poll-interval-s", str(p["poll_interval_s"]),
            "--settle-timeout-s", str(p["settle_timeout_s"])]


def run_autoscale_chaos(workdir: str, *, config: dict | None = None,
                        device: str | None = None, serve_flags=(),
                        query: int | None = None, serve_config: dict | None = None,
                        down_floor_ms: float = 0.0, monitor=None,
                        verbose: bool = True) -> dict:
    """The self-driving fleet, unattended (see the module docstring for its
    faults). ``config``, ``serve_flags``, ``device``, ``query`` and
    ``serve_config`` as ``run_promote_chaos``'s; ``down_floor_ms`` puts a
    floor under the scale-down threshold (a slow CPU's jitter). Returns the
    verdict."""
    import math
    import threading

    from .serve.resilience.promotion import parse_prometheus
    from .serve_loadtest import run_loadtest, synth_episodes
    from .utils import faultinject

    t0 = time.time()

    def log(msg):
        if verbose:
            print(f"chaos: {time.time() - t0:.1f} s: {msg}", file=sys.stderr, flush=True)

    monitor = monitor or ControlPlaneMonitor()
    config = dict(config or tiny_config())
    cfg_path = _write_config(workdir, config, "chaos_autoscale")
    exp_dir = os.path.join(workdir, "chaos_autoscale")
    os.makedirs(os.path.join(exp_dir, "logs"), exist_ok=True)
    journal_path = os.path.join(exp_dir, "logs", "autoscale.jsonl")
    way = int(config["num_classes_per_set"])
    query = int(query or config["num_target_samples"])
    bucket = (way, 1, query)
    device_argv = ["--device", device] if device else []
    # The overload queues adapts on purpose: no soft shedding and no age
    # trip-wire (the hard depth limit stays), so the p99 rises with no
    # failed request.
    serve = {"meta_batch_size": 2, "max_wait_ms": 0.0, "degrade_queue_depth": 0,
             "max_queue_age_ms": 60_000.0, **(serve_config or {})}
    previous_dataset_dir = os.environ.get("DATASET_DIR")
    os.environ.setdefault("DATASET_DIR", workdir)
    pool, built = _local_pool(
        cfg_path, 1, bucket, serve_config=serve, train_flags=[*serve_flags, *device_argv],
        device=device, monitor=monitor,
        pool_config={"health_interval_s": 0.1, "restart_backoff_s": 0.2,
                     "min_uptime_s": 0.0, "dispatch_timeout_s": 60.0},
    )

    def deaths() -> float:
        return parse_prometheus(pool.metrics_text()).get(
            "maml_serve_pool_replica_deaths_total", 0.0)

    verdict: dict = {"schedule": ["autoscale"], "ok": False,
                     "bucket": "x".join(map(str, bucket))}
    server = thread = follower = None
    holder: dict = {"proc": None}
    flush_stop = threading.Event()
    flush_lock = threading.Lock()
    flush_counts = {"ok": 0, "err": 0}
    flushers: list = []
    overload: list[dict] = []
    try:
        if not pool.wait_ready(timeout=300.0):
            raise RuntimeError("the seed replica never became healthy")
        server, thread, url = _front_door(pool)
        follower = _JournalFollower(journal_path, lambda row: monitor.journal_row(row, pool))
        log(f"pool front door on {url} (1 replica)")
        image_shape = (int(config["image_channels"]), int(config["image_height"]),
                       int(config["image_width"]))
        flush_eps = synth_episodes(6, way=way, shot=1, query=query,
                                   image_shape=image_shape, seed=11)

        def timed(episode) -> float:
            t = time.perf_counter()
            pool.classify(*episode, timeout=120.0)
            return (time.perf_counter() - t) * 1e3

        adapts = [timed(ep) for ep in synth_episodes(
            6, way=way, shot=1, query=query, image_shape=image_shape, seed=5)][1:]
        timed(flush_eps[0])
        hits = [timed(flush_eps[0]) for _ in range(12)]
        adapt_ms, hit_ms = float(np.median(adapts)), float(np.median(hits))
        # As the JAX harness derives them: down at 6 cache hits, up at 2.2
        # times that or 1.5 adapts.
        down_p99 = max(down_floor_ms, 6.0 * hit_ms)
        up_p99 = max(2.2 * down_p99, 1.5 * adapt_ms)
        batch = int(serve["meta_batch_size"])
        # In flight, enough for the queue alone to hold the p99 at 2.5x the
        # scale-up threshold; arrivals at 1.5x one replica's capacity.
        in_flight = int(min(48, max(8, math.ceil(2.5 * up_p99 * batch / adapt_ms))))
        rate = 1.5 * batch * 1e3 / adapt_ms
        verdict["probes"] = {"adapt_ms": adapt_ms, "hit_ms": hit_ms, "up_p99_ms": up_p99,
                             "down_p99_ms": down_p99, "overload_in_flight": in_flight,
                             "overload_qps": rate, "policy": AUTOSCALE_POLICY}
        log(f"probes: adapt {adapt_ms:.1f} ms, cache hit {hit_ms:.1f} ms -> up above "
            f"{up_p99:.1f} ms, down below {down_p99:.1f} ms")

        daemon_log = os.path.join(workdir, "chaos_autoscaler_daemon.log")
        argv = _autoscaler_argv(journal_path, url, up_p99, down_p99,
                                os.path.join(exp_dir, "logs", "daemon_telemetry.jsonl"))
        holder["proc"] = _start_daemon(
            "autoscaler_daemon", argv, _daemon_env(workdir, "autoscaler_kill_at_phase=1"),
            daemon_log, monitor, "autoscaler")
        log("autoscaler started (autoscaler_kill_at_phase=1)")
        deadline = time.time() + AUTOSCALE_TIMEOUT_S

        # The overload: distinct support sets, so every request adapts.
        burst = 0
        while time.time() < deadline:
            burst += 1
            eps = synth_episodes(48, way=way, shot=1, query=query,
                                 image_shape=image_shape, seed=100 + burst)
            overload.append(run_loadtest(
                pool, eps, rate_qps=rate, duration_s=2.0, p99_budget_ms=1e9,
                error_slo=0.0, timeout_s=120.0, seed=burst, max_workers=in_flight,
                sample_health=False,
            ))
            if any(r["phase"] == "decided" for r in _journal(journal_path)):
                break
        if not any(r["phase"] == "decided" for r in _journal(journal_path)):
            raise RuntimeError("the overload never produced a journaled scale-up")
        try:
            rc = holder["proc"].wait(timeout=60)
        except subprocess.TimeoutExpired as exc:
            raise RuntimeError("the autoscaler outlived its armed kill point") from exc
        verdict["daemon_sigkilled"] = rc in (-9, 137)
        verdict["fleet_untouched_at_kill"] = pool.healthz()["pool_size"] == 1
        log(f"autoscaler killed (rc {rc}) with its decision journaled; pool size "
            f"{pool.healthz()['pool_size']}")

        holder["proc"] = _start_daemon("autoscaler_daemon", argv, _daemon_env(workdir, None),
                                       daemon_log, monitor, "autoscaler")
        settled_up = None
        while time.time() < deadline and settled_up is None:
            settled_up = next((r for r in _journal(journal_path)
                               if r["phase"] == "settled"), None)
            time.sleep(0.2)
        if settled_up is None:
            raise RuntimeError("the resumed scale-up never settled")
        verdict["resumed_settled_healthy"] = bool(settled_up.get("healthy"))
        after_up = pool.healthz()
        verdict["pool_size_after_up"] = after_up["pool_size"]
        spawned = len(built)
        again = pool.resize(after_up["pool_size"])  # the same target again
        time.sleep(0.5)
        verdict["second_resize_added"] = again["added"]
        verdict["second_resize_spawned"] = len(built) - spawned
        verdict["scale_up_settled_at_s"] = round(time.time() - t0, 3)
        log(f"scale-up settled: {after_up['pool_size']} replicas, "
            f"{after_up['healthy_replicas']} healthy; the same target again added "
            f"{again['added']}")

        # Cache hits, one replica killed: the p99 falls once fast samples
        # displace the overload's in the pool's window.
        deaths_before = deaths()
        faultinject.activate(faultinject.FaultPlan(replica_kill_at_request=AUTOSCALE_KILL_AT))

        def flush(start: int) -> None:
            i = start
            while not flush_stop.is_set():
                try:
                    pool.classify(*flush_eps[i % len(flush_eps)], timeout=60.0)
                    key = "ok"
                except Exception:  # noqa: BLE001 - any failure fails the verdict
                    key = "err"
                i += 1
                with flush_lock:
                    flush_counts[key] += 1

        flushers = [threading.Thread(target=flush, args=(w,), daemon=True)
                    for w in range(AUTOSCALE_FLUSH_CLIENTS)]
        for t in flushers:
            t.start()
        down_settled = None
        next_note = time.time() + 5.0
        while time.time() < deadline and down_settled is None:
            rows = _journal(journal_path)
            downs = {r["decision_id"] for r in rows if r["phase"] == "decided"
                     and r.get("to_size", 0) < r.get("from_size", 0)}
            down_settled = next((r for r in rows if r["phase"] == "settled"
                                 and r["decision_id"] in downs), None)
            if time.time() > next_note:
                next_note += 5.0
                health = pool.healthz()
                log(f"waiting for a scale-down: {health['healthy_replicas']} of "
                    f"{health['pool_size']} healthy, p99 "
                    f"{pool.metrics.request_latency.percentile(99):.1f} ms, {flush_counts}")
            time.sleep(0.2)
        flush_stop.set()
        for t in flushers:
            t.join(timeout=60)
        faultinject.deactivate()
        if down_settled is None:
            raise RuntimeError("the cache-hit traffic never produced a settled scale-down")
        verdict["replica_deaths"] = int(deaths() - deaths_before)
        log(f"scale-down settled ({down_settled['decision_id']} -> "
            f"{down_settled['to_size']}); flush {flush_counts}")
    finally:
        flush_stop.set()
        faultinject.deactivate()
        _stop_process(holder["proc"])
        for t in flushers:
            t.join(timeout=10)
        _close_front_door(server, thread)
        pool.close()
        if previous_dataset_dir is None:
            os.environ.pop("DATASET_DIR", None)
        else:
            os.environ["DATASET_DIR"] = previous_dataset_dir
        if follower is not None:
            follower.close()
    verdict["wall_s"] = round(time.time() - t0, 3)

    rows = _journal(journal_path)
    decided = [r for r in rows if r["phase"] == "decided"]
    ups = [r for r in decided if r["to_size"] > r["from_size"]]
    downs = [r for r in decided if r["to_size"] < r["from_size"]]
    by_id: dict = {}
    for r in rows:
        if r.get("decision_id"):
            by_id.setdefault(r["decision_id"], []).append(r)
    double = []
    settle_s = {}
    for did, drows in by_id.items():
        n_settled = sum(1 for r in drows if r["phase"] == "settled")
        applied = [r for r in drows if r["phase"] == "applied"]
        if n_settled > 1 or (len(applied) > 1 and not any(r.get("resumed") for r in applied)):
            double.append(did)
        t_dec = next((r["t"] for r in drows if r["phase"] == "decided"), None)
        t_set = next((r["t"] for r in drows if r["phase"] == "settled"), None)
        if t_dec is not None and t_set is not None:
            settle_s[did] = round(t_set - t_dec, 3)
    offered = sum(r["offered"] for r in overload) + sum(flush_counts.values())
    answered = sum(r["completed_ok"] for r in overload) + flush_counts["ok"]
    # Replicas built: the seed, the scale-up's new slots, one for each death.
    up_added = ups[0]["to_size"] - ups[0]["from_size"] if ups else 0
    verdict.update({
        "scale_ups": len(ups),
        "scale_downs": len(downs),
        "resumed_rows": sum(1 for r in rows if r["phase"] == "resumed"),
        "settled_rows": sum(1 for r in rows if r["phase"] == "settled"),
        "decided_to_settled_s": settle_s,
        "double_driven": double,
        "replicas_built": len(built),
        "replicas_expected": 1 + up_added + verdict.get("replica_deaths", 0),
        "requests_offered": offered,
        "requests_ok": answered,
        "requests_failed": offered - answered,
    })
    verdict["ok"] = bool(
        verdict.get("daemon_sigkilled")
        and verdict.get("fleet_untouched_at_kill")
        and ups and downs
        and verdict["resumed_rows"] == 1
        and verdict.get("resumed_settled_healthy")
        and verdict.get("pool_size_after_up") == 1 + up_added
        and verdict.get("second_resize_added") == 0
        and verdict.get("second_resize_spawned") == 0
        and verdict["replicas_built"] == verdict["replicas_expected"]
        and not double
        and verdict.get("replica_deaths", 0) >= 1
        and offered > 0 and offered == answered
    )
    if not verdict["ok"]:
        log(f"verdict: {json.dumps(verdict, indent=1)}")
    return verdict


def measure_recovery(seed: int = 0, device: str | None = None,
                     schedule=("sigterm", "kill", "hang")) -> dict:
    """``train_recovery_s`` per stopping class, from one supervised tiny
    run: ``{"value": median seconds, "mttr_s": {...}, "verdict": ...}``."""
    workdir = tempfile.mkdtemp(prefix="chaos_recovery_")
    try:
        make_tiny_dataset(os.path.join(workdir, "omniglot_mini"), seed=seed)
        verdict = run_chaos(workdir, list(schedule), device=device, verbose=False)
        return {"value": verdict["train_recovery_s"], "mttr_s": verdict["mttr_s"],
                "verdict": verdict}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiny", action="store_true",
                        help="write the tiny dataset and config into the workdir")
    parser.add_argument("--schedule", default="auto",
                        help=f"comma-separated classes of {FAULT_CLASSES + TERMINAL} "
                             "(oom last), 'auto': the six recoverable classes "
                             "shuffled by --seed; or, alone, 'promote' (the "
                             "train-to-serve loop: trainer, promotion daemon, "
                             "two-replica pool, load test), 'autoscale' (the "
                             "autoscaler over a one-replica pool under a load "
                             "swing) or 'killhost' (rank 1 of a two-rank fleet "
                             "killed, through the dispatcher)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--devices", type=int, default=1,
                        help="ranks of the dp fleet the schedule runs on (one "
                             "process each); a hang degrades it")
    parser.add_argument("--baseline", action="store_true",
                        help="also run an unfaulted twin and hold the replaying "
                             "classes to it bit for bit")
    parser.add_argument("--device", default=None,
                        help="passed on to the training runs (cpu); the card if unset")
    parser.add_argument("--json", action="store_true", help="the verdict JSON only")
    parser.add_argument("--workdir", default=None,
                        help="keep the runs here instead of a temporary directory")
    args = parser.parse_args(argv)
    if args.devices < 1:
        parser.error(f"--devices must be >= 1, got {args.devices}")
    if args.devices > 1 and args.baseline:
        parser.error("--baseline is a one-process twin; a fleet that degrades "
                     "sums its gradients in another order")
    if not args.tiny and args.workdir is None:
        parser.error("--tiny is required (or --workdir with a prepared dataset)")
    if args.schedule == "auto":
        schedule = list(FAULT_CLASSES)
        random.Random(args.seed).shuffle(schedule)
    else:
        schedule = [s.strip() for s in args.schedule.split(",") if s.strip()]
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_train_")
    try:
        dataset = os.path.join(workdir, "omniglot_mini")
        if not os.path.isdir(dataset):
            make_tiny_dataset(dataset, seed=args.seed)
        loops = {"promote": run_promote_chaos, "autoscale": run_autoscale_chaos,
                 "killhost": run_killhost_chaos}
        if len(schedule) == 1 and schedule[0] in loops:
            verdict = loops[schedule[0]](workdir, device=args.device,
                                         verbose=not args.json)
        elif set(schedule) & set(loops):
            parser.error("promote, autoscale and killhost each run alone")
        else:
            verdict = run_chaos(workdir, schedule, config=tiny_config(args.devices),
                                baseline=args.baseline, device=args.device,
                                verbose=not args.json)
        print(json.dumps(verdict))
        return 0 if verdict["ok"] else 2
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(phase_main(sys.argv[1:]) if os.environ.get(PHASES_ENV) else main())

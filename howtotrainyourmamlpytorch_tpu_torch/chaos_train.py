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
finite and complete instead. ``--devices`` takes 1 only; a mesh is
ROADMAP A10, and the promote/serve loop of the JAX harness is A11.
The runs' output goes to ``<workdir>/chaos_{exp,baseline}.log``; the
verdict JSON to stdout; the exit code is 0 iff it says ``ok``.
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


def tiny_config() -> dict:
    """The JAX harness's tiny config (2-stage 4-filter MAML++, 3 epochs x 2
    iterations) with its resilience knobs; no ``experiment_name``."""
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
        "data_parallel_devices": 1, "model_parallel_devices": 1,
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


def phase_main(argv: list[str]) -> int:
    """The dispatcher's entry under chaos: the next phase's faults planned
    against the resume point, the training entry point run with them, its
    rc and exit time recorded; the rc passed on (a signal death as
    128 + the signal)."""
    state_path = os.environ[PHASES_ENV]
    with open(state_path) as f:
        state = json.load(f)
    index = state["next"]
    faults = state["phases"][index] if index < len(state["phases"]) else []
    state["next"] = index + 1
    with open(state_path, "w") as f:
        json.dump(state, f)
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
    verdict: dict = {"schedule": list(schedule), "devices": 1}

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
                             "(oom last), or 'auto': the six recoverable classes "
                             "shuffled by --seed")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--devices", type=int, default=1,
                        help="1 only (a mesh is ROADMAP A10)")
    parser.add_argument("--baseline", action="store_true",
                        help="also run an unfaulted twin and hold the replaying "
                             "classes to it bit for bit")
    parser.add_argument("--device", default=None,
                        help="passed on to the training runs (cpu); the card if unset")
    parser.add_argument("--json", action="store_true", help="the verdict JSON only")
    parser.add_argument("--workdir", default=None,
                        help="keep the runs here instead of a temporary directory")
    args = parser.parse_args(argv)
    if args.devices != 1:
        raise NotImplementedError("--devices > 1 (a mesh) is ROADMAP item A10")
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
        verdict = run_chaos(workdir, schedule, baseline=args.baseline,
                            device=args.device, verbose=not args.json)
        print(json.dumps(verdict))
        return 0 if verdict["ok"] else 2
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(phase_main(sys.argv[1:]) if os.environ.get(PHASES_ENV) else main())

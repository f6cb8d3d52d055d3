"""The supervising dispatcher of the port (``train_maml_system_dispatch.py``
at the repository's root, its single-process half):

    python3 -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system_dispatch <cfg> \\
        [--pause_every N] [--max_requeues 100] [--max_hangs 8] [--device cpu] \\
        [flags for the entry point ...]

``<cfg>`` is a config name under ``experiment_config/`` or
``experiment_config_local/``, or a path to a JSON. The dispatcher runs the
config's entry point (``train_gradient_descent_system`` for a name with
``gradient-descent``, ``train_matching_nets_system`` for ``matching-nets``,
else ``train_maml_system``; the port's modules) in phases until
``logs/test_summary.csv`` exists:

* each phase is one process; the run resumes from ``latest`` (the
  config's ``continue_from_epoch``), so a phase that paused
  (``--pause_every N`` sets ``total_epochs_before_pause``) or died goes on
  where the last checkpoint left it;
* rc 75 (preemption: the child wrote an emergency checkpoint) reruns on
  its own budget, ``--max_requeues``;
* rc 76 (the hang watchdog) reruns on ``--max_hangs``; so do two signal
  deaths in a row. On one card there is no smaller mesh: the phase reruns
  on the same device, JAX's "no smaller viable mesh" branch, with an audit
  row ``hang-requeue:dp1``. A config of more than one data-parallel device
  would need the degrade ladder of ROADMAP A10, and raises;
* rc 77 (out of device memory; ``logs/oom_report.json``) is reported and
  not retried: the same config would run out again;
* any other rc counts a phase; two phases in a row without a new row of
  ``summary_statistics.csv`` abort.

Audit rows go to the experiment's ``logs/interruptions.csv`` with the last
progress the child's heartbeat (``logs/status.json``) recorded. One
``MAML_TRACE_ID`` is exported to every phase (an inherited one wins), and
``MAML_FAULTS`` reaches the first phase only. ``--num_processes``,
``--fault_rank`` and ``--fleet_grace_s`` (the multi-host fleet) raise
(ROADMAP A10). ``--device cpu`` is passed on to the entry point; without
it the children run on the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

from .telemetry.device import OOM_EXIT_CODE
from .telemetry.events import TRACE_ID_ENV, new_trace_id
from .telemetry.heartbeat import read_heartbeat
from .utils.watchdog import HANG_EXIT_CODE

#: The builder's ``REQUEUE_EXIT_CODE`` (the builder imports the learner
#: stack, which the dispatcher does not need).
REQUEUE_EXIT_CODE = 75

#: Test hook: the entry a phase runs, a script path (``.py``) or a module.
ENTRY_ENV = "MAML_DISPATCH_ENTRY"

PACKAGE = __package__ or "howtotrainyourmamlpytorch_tpu_torch"


def _pop_flag(extra, name, default, cast):
    if name in extra:
        i = extra.index(name)
        value = cast(extra[i + 1])
        del extra[i:i + 2]
        return value
    return default


def _heartbeat_progress(exp_name: str) -> tuple:
    """``(current_iter, epoch)`` as strings from the child's heartbeat;
    empty strings when there is none."""
    doc = read_heartbeat(os.path.join(exp_name, "logs", "status.json"))
    if not doc:
        return "", ""
    current_iter, epoch = doc.get("current_iter"), doc.get("epoch")
    return ("" if current_iter is None else str(current_iter),
            "" if epoch is None else str(epoch))


def _audit_row(exp_name: str, kind: str, current_iter="", epoch="") -> None:
    """A dispatcher row of ``logs/interruptions.csv`` (the builder's
    header), aligned to the file's columns."""
    import time

    logs = os.path.join(exp_name, "logs")
    header = "timestamp,signal,current_iter,epoch,process_index,process_count"
    try:
        os.makedirs(logs, exist_ok=True)
        path = os.path.join(logs, "interruptions.csv")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(header + "\n")
        with open(path) as f:
            n_cols = len(f.readline().rstrip("\n").split(","))
        row = [str(time.time()), str(kind), str(current_iter), str(epoch), "",
               ""][:max(n_cols, 4)]
        with open(path, "a") as f:
            f.write(",".join(row) + "\n")
    except OSError:
        pass  # auditing must not stop supervision


def entry_command(cfg: str) -> list[str]:
    """The interpreter command of a phase's entry point."""
    entry = os.environ.get(ENTRY_ENV) or (
        "train_gradient_descent_system" if "gradient-descent" in cfg
        else "train_matching_nets_system" if "matching-nets" in cfg
        else "train_maml_system")
    if entry.endswith(".py"):
        return [sys.executable, "-u", entry]
    if "." not in entry:
        entry = f"{PACKAGE}.{entry}"
    return [sys.executable, "-u", "-m", entry]


def resolve_config(cfg: str) -> str:
    if cfg.endswith(".json") and os.path.exists(cfg):
        return cfg
    for d in ("experiment_config", "experiment_config_local"):
        path = os.path.join(d, f"{cfg}.json")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no config named {cfg} in experiment_config{{,_local}}/")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, extra = argv[0], list(argv[1:])
    pause_every = _pop_flag(extra, "--pause_every", None, int)
    if pause_every is not None and pause_every < 1:
        raise SystemExit(f"--pause_every must be >= 1, got {pause_every}")
    max_requeues = _pop_flag(extra, "--max_requeues", 100, int)
    max_hangs = _pop_flag(extra, "--max_hangs", 8, int)
    for fleet_flag in ("--num_processes", "--fault_rank", "--fleet_grace_s"):
        if fleet_flag in extra:
            raise NotImplementedError(
                f"{fleet_flag}: multi-host fleet supervision is ROADMAP item A10"
            )
    command = entry_command(cfg)
    cfg_path = resolve_config(cfg)
    with open(cfg_path) as f:
        cfg_dict = json.load(f)
    dp = int(cfg_dict.get("data_parallel_devices", 0) or 0)
    if "--data_parallel_devices" in extra:
        dp = int(extra[extra.index("--data_parallel_devices") + 1])
    exp_name = cfg_dict["experiment_name"]
    total_epochs = int(cfg_dict.get("total_epochs", 100))
    summary_csv = os.path.join(exp_name, "logs", "summary_statistics.csv")
    test_csv = os.path.join(exp_name, "logs", "test_summary.csv")

    def epochs_logged() -> int:
        try:
            with open(summary_csv) as f:
                return max(sum(1 for _ in f) - 1, 0)
        except OSError:
            return 0

    if os.path.exists(test_csv):
        print(f"--- {cfg}: test eval already present at {test_csv}; nothing to run",
              flush=True)
        return 0

    # Config keys go into a patched copy: the JSON wins over flags.
    run_cfg_path, patched_path = cfg_path, None
    if pause_every is not None:
        with tempfile.NamedTemporaryFile(
            "w", suffix=f"_{os.path.splitext(os.path.basename(cfg))[0]}.json",
            delete=False,
        ) as patched:
            json.dump({**cfg_dict, "total_epochs_before_pause": pause_every}, patched)
        run_cfg_path = patched_path = patched.name

    try:
        max_phases = 2 * (total_epochs // (pause_every or total_epochs) + 2)
        stalled = phase = requeues = hangs = signal_deaths = 0
        child_env = dict(os.environ)
        child_env.setdefault(TRACE_ID_ENV, new_trace_id())
        rc = 0
        while phase < max_phases and requeues < max_requeues and hangs < max_hangs:
            before = epochs_logged()
            print(f"--- {cfg}: phase {phase} via {' '.join(command[2:])} "
                  f"(epochs logged: {before}/{total_epochs})", flush=True)
            rc = subprocess.run(
                [*command, "--name_of_args_json_file", run_cfg_path, *extra],
                check=False, env=child_env,
            ).returncode
            # Fault plans are one-shot per supervised run.
            child_env.pop("MAML_FAULTS", None)
            if os.path.exists(test_csv):
                break
            if rc == REQUEUE_EXIT_CODE:
                stalled = signal_deaths = 0
                requeues += 1
                continue
            if rc == OOM_EXIT_CODE:
                hb_iter, hb_epoch = _heartbeat_progress(exp_name)
                _audit_row(exp_name, "oom-abort", current_iter=hb_iter, epoch=hb_epoch)
                print(f"--- {cfg}: out of device memory (rc {rc}); forensics in "
                      f"{os.path.join(exp_name, 'logs', 'oom_report.json')}; not "
                      "retried, the same config would run out again", flush=True)
                return rc
            died_by_signal = rc < 0 or rc > 128
            signal_deaths = signal_deaths + 1 if died_by_signal else 0
            if rc == HANG_EXIT_CODE or signal_deaths >= 2:
                hangs += 1
                stalled = signal_deaths = 0
                if dp > 1:
                    raise NotImplementedError(
                        f"a hang on a {dp}-device mesh resumes on a smaller mesh: "
                        "ROADMAP item A10"
                    )
                hb_iter, hb_epoch = _heartbeat_progress(exp_name)
                why = "hang" if rc == HANG_EXIT_CODE else "repeated-signal-death"
                _audit_row(exp_name, f"{why}-requeue:dp{max(dp, 1)}",
                           current_iter=hb_iter, epoch=hb_epoch)
                print(f"--- {cfg}: {why} (rc {rc}) with no smaller viable mesh; "
                      "requeueing on the same device", flush=True)
                continue
            phase += 1
            if epochs_logged() <= before:
                stalled += 1
                if stalled >= 2:
                    print(f"--- {cfg}: no progress across two phases, aborting",
                          flush=True)
                    return rc or 1
            else:
                stalled = 0
        if hangs >= max_hangs:
            print(f"--- {cfg}: hang budget ({max_hangs}) exhausted, aborting",
                  flush=True)
            return rc or 1
        if not os.path.exists(test_csv):
            print(f"--- {cfg}: phase budget exhausted without test eval", flush=True)
            return rc or 1
        print(f"--- {cfg}: done ({epochs_logged()} epochs + test eval, final phase "
              f"rc {rc})", flush=True)
        return rc
    finally:
        if patched_path is not None:
            try:
                os.unlink(patched_path)
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(main())

"""The supervising dispatcher of the port (``train_maml_system_dispatch.py``
at the repository's root):

    python3 -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system_dispatch <cfg> \\
        [--pause_every N] [--max_requeues 100] [--max_hangs 8] [--device cpu] \\
        [--num_processes N [--fault_rank R] [--fleet_grace_s 30]] \\
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
  deaths in a row. The topology is suspect: a dp-N fleet resumes on the
  next smaller viable one (``parallel/mesh.degraded_dp_extent``, the
  config's ``data_parallel_devices`` patched), audit row
  ``hang-degrade:dp2->dp1``; with nothing smaller the phase reruns on the
  same topology (``hang-requeue:dp1``). After a clean degraded phase with
  progress, a re-promotion probe tries the larger fleet again
  (``probe-promote:dp2``);
* rc 77 (out of device memory; ``logs/oom_report.json``) is reported and
  not retried: the same config would run out again;
* any other rc counts a phase; two phases in a row without a new row of
  ``summary_statistics.csv`` abort.

A phase of a fleet (the config's ``data_parallel_devices`` N > 1, or
``--num_processes N``) starts N ranks of the entry point over a fresh
loopback coordinator, each with ``--coordinator_address``,
``--num_processes`` and ``--process_id`` (flags beat the config's keys).
Once any rank exits, the others get ``--fleet_grace_s`` to exit by
themselves (a survivor's own watchdog exit or collective error is
evidence), then SIGTERM, then SIGKILL after the grace again. The first
rank to exit abnormally is the one blamed. With ``--num_processes`` (fleet
mode) any abnormal exit is a host loss: audit row
``host-loss:rank<k>-degrade:procs2->procs1`` stamped with the observed
death time and the rank, and the run resumes on
``parallel/mesh.degraded_process_count`` ranks from the last checkpoint
(rank 0 is the single writer, and checkpoints hold no layout); every rank
exiting 75 is a preemption that requeues the same fleet; a clean degraded
phase probes the full fleet again (``probe-promote:procs2``). Without
``--num_processes`` the fleet's phase code is the blamed rank's and the
ladder above decides. ``--fault_rank R`` passes ``MAML_FAULTS`` to rank R
alone.

Audit rows go to the experiment's ``logs/interruptions.csv`` with the last
progress the child's heartbeat (``logs/status.json``, rank 0's) recorded.
One ``MAML_TRACE_ID`` is exported to every phase and rank (an inherited one
wins), and ``MAML_FAULTS`` reaches the first phase only. ``--device cpu``
is passed on to the entry point; without it the children run on the card.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from .parallel.distributed import find_free_port
from .parallel.mesh import degraded_dp_extent, degraded_process_count
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


def _audit_row(exp_name: str, kind: str, current_iter="", epoch="",
               process_index="", process_count="", when: float | None = None) -> None:
    """A dispatcher row of ``logs/interruptions.csv`` (the builder's
    header), aligned to the file's columns; a host loss's row names the
    rank and is stamped ``when`` it was observed."""
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
        row = [str(time.time() if when is None else when), str(kind),
               str(current_iter), str(epoch), str(process_index),
               str(process_count)][:max(n_cols, 4)]
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


def _signal_all(procs, sig) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:
                pass


def run_fleet(command: list[str], run_cfg_path: str, extra: list[str],
              num_processes: int, env: dict, fault_rank: int | None,
              grace_s: float) -> tuple[list[int], int | None, float | None]:
    """One phase of ``num_processes`` ranks over a fresh loopback
    coordinator, supervised to the fleet's exit. Returns ``(each rank's
    exit code, the first rank to exit, when it was seen)``: once a rank
    exits the fleet is no longer whole, and the first to go is the cause;
    the others get ``grace_s`` to exit by themselves, then SIGTERM, then
    SIGKILL after ``grace_s`` more."""
    address = f"127.0.0.1:{find_free_port()}"
    procs = []
    for rank in range(num_processes):
        rank_env = dict(env)
        if fault_rank is not None and rank != fault_rank:
            rank_env.pop("MAML_FAULTS", None)
        procs.append(subprocess.Popen(
            [*command, "--name_of_args_json_file", run_cfg_path, *extra,
             "--coordinator_address", address, "--num_processes",
             str(num_processes), "--process_id", str(rank)],
            env=rank_env,
        ))
    first_rank = first_wall = since = None
    stage = 0  # 0 waiting, 1 SIGTERM sent, 2 SIGKILL sent
    try:
        while any(p.poll() is None for p in procs):
            exited = [i for i, p in enumerate(procs) if p.poll() is not None]
            if exited:
                now = time.monotonic()
                if first_rank is None:
                    first_rank, first_wall, since = exited[0], time.time(), now
                elif stage < 2 and now - since > grace_s:
                    _signal_all(procs, signal.SIGKILL if stage else signal.SIGTERM)
                    stage, since = stage + 1, now
            time.sleep(0.1)
    finally:
        # The dispatcher itself interrupted: no rank outlives it.
        _signal_all(procs, signal.SIGKILL)
    return [p.wait() for p in procs], first_rank, first_wall


def classify_fleet(rcs: list[int], first_rank: int | None) -> tuple[int, int | None]:
    """``(phase rc, blamed rank)``: 0 when every rank exited 0; 75 when
    every rank exited 0 or 75 (a preemption of the fleet); else the code of
    the first rank to exit abnormally, which is blamed (later deaths are
    the loss's symptoms: a survivor's collective error or watchdog exit,
    or this supervisor's shutdown)."""
    if all(rc == 0 for rc in rcs):
        return 0, None
    if all(rc in (0, REQUEUE_EXIT_CODE) for rc in rcs):
        return REQUEUE_EXIT_CODE, None
    bad = [rank for rank, rc in enumerate(rcs) if rc not in (0, REQUEUE_EXIT_CODE)]
    blamed = first_rank if first_rank in bad else bad[0]
    return rcs[blamed], blamed


def _global_batch(cfg_dict: dict) -> int:
    return (int(cfg_dict.get("num_of_gpus", 1) or 1) * int(cfg_dict.get("batch_size", 32))
            * int(cfg_dict.get("samples_per_iter", 1) or 1))


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
    num_processes = _pop_flag(extra, "--num_processes", 0, int)
    fault_rank = _pop_flag(extra, "--fault_rank", None, int)
    fleet_grace_s = _pop_flag(extra, "--fleet_grace_s", 30.0, float)
    command = entry_command(cfg)
    cfg_path = resolve_config(cfg)
    with open(cfg_path) as f:
        cfg_dict = json.load(f)
    dp = max(int(_pop_flag(extra, "--data_parallel_devices", None, int)
                  or cfg_dict.get("data_parallel_devices", 0) or 0), 1)
    # Fleet mode: --num_processes names the fleet, and a rank lost is a
    # host lost. Otherwise a dp-N config is an N-rank fleet on the dp
    # ladder. A rank is a process either way.
    host_mode = num_processes > 1
    current = num_processes if host_mode else dp
    ladder = "procs" if host_mode else "dp"
    global_batch = _global_batch(cfg_dict)
    task_chunk = int(cfg_dict.get("task_chunk", 0) or 0)
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
    overrides: dict = {"data_parallel_devices": current}
    if pause_every is not None:
        overrides["total_epochs_before_pause"] = pause_every
    run_cfg_path = patched_path = None

    def write_patched() -> None:
        nonlocal run_cfg_path, patched_path
        if patched_path is not None:
            os.unlink(patched_path)
        with tempfile.NamedTemporaryFile(
            "w", suffix=f"_{os.path.splitext(os.path.basename(cfg))[0]}.json",
            delete=False,
        ) as patched:
            json.dump({**cfg_dict, **overrides}, patched)
        run_cfg_path = patched_path = patched.name

    def resize(n: int) -> None:
        nonlocal current
        current = overrides["data_parallel_devices"] = n
        write_patched()

    write_patched()
    # The sizes degraded from, newest last: a clean degraded phase pops one.
    promote_stack: list[int] = []

    try:
        max_phases = 2 * (total_epochs // (pause_every or total_epochs) + 2)
        stalled = phase = requeues = hangs = signal_deaths = 0
        child_env = dict(os.environ)
        child_env.setdefault(TRACE_ID_ENV, new_trace_id())
        rc = 0
        while phase < max_phases and requeues < max_requeues and hangs < max_hangs:
            before = epochs_logged()
            print(f"--- {cfg}: phase {phase} via {' '.join(command[2:])} "
                  f"(epochs logged: {before}/{total_epochs}"
                  + (f", fleet of {current}" if current > 1 else "") + ")", flush=True)
            blamed = lost_at = None
            if current > 1:
                rcs, first_rank, lost_at = run_fleet(
                    command, run_cfg_path, extra, current, child_env, fault_rank,
                    fleet_grace_s)
                rc, blamed = classify_fleet(rcs, first_rank)
                print(f"--- {cfg}: fleet rcs {rcs} -> phase rc {rc}", flush=True)
            else:
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
            host_loss = host_mode and current > 1 and blamed is not None
            if rc == HANG_EXIT_CODE or signal_deaths >= 2 or host_loss:
                hangs += 1
                stalled = signal_deaths = 0
                hb_iter, hb_epoch = _heartbeat_progress(exp_name)
                if host_loss:
                    why = f"host-loss:rank{blamed}"
                    smaller = degraded_process_count(
                        current, global_batch=global_batch, task_chunk=task_chunk)
                    row = dict(process_index=blamed, process_count=current,
                               when=lost_at)
                else:
                    why = "hang" if rc == HANG_EXIT_CODE else "repeated-signal-death"
                    smaller = degraded_dp_extent(
                        current, global_batch=global_batch, task_chunk=task_chunk)
                    row = {}
                if smaller is None:
                    _audit_row(exp_name, f"{why}-requeue:{ladder}{current}",
                               current_iter=hb_iter, epoch=hb_epoch, **row)
                    print(f"--- {cfg}: {why} (rc {rc}) with no smaller viable "
                          "topology; requeueing on the same one", flush=True)
                    continue
                _audit_row(exp_name, f"{why}-degrade:{ladder}{current}->{ladder}{smaller}",
                           current_iter=hb_iter, epoch=hb_epoch, **row)
                print(f"--- {cfg}: {why} (rc {rc}); degrading {ladder}{current} -> "
                      f"{ladder}{smaller}, resuming from the last valid checkpoint",
                      flush=True)
                promote_stack.append(current)
                resize(smaller)
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
                if promote_stack:
                    # A clean degraded phase: probe one step back up; a
                    # re-hang degrades again, on the hang budget.
                    restored = promote_stack.pop()
                    _audit_row(exp_name, f"probe-promote:{ladder}{restored}",
                               process_count=restored if host_mode else "")
                    print(f"--- {cfg}: clean degraded phase; probing re-promotion "
                          f"to {ladder}{restored}", flush=True)
                    resize(restored)
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

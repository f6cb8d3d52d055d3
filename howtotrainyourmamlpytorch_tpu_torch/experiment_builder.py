"""Experiment runtime: the train/validation loop, checkpoints, statistics,
resume, the ensemble test and the operations plane
(``howtotrainyourmamlpytorch_tpu/experiment_builder.py``).

* An epoch is ``total_iter_per_epoch`` meta-updates, then a validation
  epoch of ``num_evaluation_tasks / batch_size`` batches.
* Each phase's per-iteration metrics become ``{phase}_{key}_mean/std``:
  a row of ``logs/summary_statistics.csv`` and the cumulative
  ``logs/summary_statistics.json``, written before the epoch's checkpoint
  so that the checkpoint holds its own epoch's row. The train row also
  carries the telemetry's step-time, data-wait and stage-wait p50/p95 and
  the topology columns, under the JAX package's names.
* Checkpoints: ``saved_models/train_model_<epoch>`` with
  ``train_model_latest`` as its alias, written by a background writer
  (``checkpoint_async``), in the JAX package's format. With
  ``checkpoint_interval_s`` > 0, the full state is also written to
  ``train_model_latest`` mid-epoch once that many seconds have passed
  since the last checkpoint, so that a crash loses at most the interval.
* ``continue_from_epoch``: ``from_scratch``, ``latest`` (the newest valid
  checkpoint; a corrupt one is quarantined as ``.corrupt`` and the next
  tried) or an epoch index; the loader fast-forwards its seed window so a
  resumed run sees the episodes an unbroken one would.
* The run pauses (``sys.exit``) after ``total_epochs_before_pause`` epochs
  of this process, and ends with a test of the top-5 checkpoints by
  validation accuracy, their logits averaged.
* ``iters_per_dispatch`` K: K meta-updates a learner call
  (``run_train_iters``; 1 by default), in groups that never straddle an
  epoch boundary (an epoch's last group may be shorter). The summary
  keeps one sample per meta-update at any K. A learner without
  ``run_train_iters`` (gradient descent, matching nets, ProtoNets) takes
  one batch a call (``run_train_iter``) whatever K is.
* ``device_prefetch``: a stager thread prepares the next dispatch groups
  and copies them to the card ahead of the loop
  (``data/device_prefetch.py``); -1 (the default) sizes its depth from
  the loop's waits, N pins it, 0 prepares each batch inline. Within
  ``data_fault_budget`` faults a run, a failed batch is skipped with a
  warning; when the fault finished the loader's generator, training goes
  on from a fresh one.
* Metrics stay on the card until a log line (every ``TRAIN_LOG_EVERY``
  iterations) or an epoch boundary reads them. A non-finite meta-loss is
  ``halt`` (raise before anything is checkpointed), ``skip`` (the learner
  drops the update on the card) or ``rollback`` (reload the newest valid
  checkpoint, at most ``MAX_ROLLBACKS_PER_RUN`` times a process, and
  move the data past the poisoned batch).

The operations plane:

* SIGTERM/SIGINT set a flag; after the in-flight dispatch (and the epoch
  boundary, when one is due) the run writes an emergency
  ``train_model_latest`` (refused on a state with a pending non-finite
  loss), a row of ``logs/interruptions.csv``, and exits with
  ``REQUEUE_EXIT_CODE`` 75. A second signal stops at once.
* The hang watchdog (``utils/watchdog.py``) is armed around every dispatch
  and every epoch boundary after the first; it exits with 76.
* A ``torch.OutOfMemoryError`` writes ``logs/oom_report.json``
  (``telemetry/device.py``) and exits with 77.
* ``TrainTelemetry`` (``telemetry/runtime.py``): ``logs/telemetry.jsonl``,
  ``logs/status.json``, anomalies, the program ledger, profiler captures.
* ``--debug_nans`` runs the step eagerly under ``utils/sanitize.nan_checks``.
* The fault points of ``utils/faultinject.py`` sit where the JAX builder's
  do.

A data-parallel fleet (``process_count`` > 1, stamped by ``get_args``
from the process group; ``parallel/``) runs one builder per rank:

* rank 0 is the chief, the single writer of the checkpoints, the summary
  CSV/JSON and ``test_summary.csv`` (every rank holds the same replicated
  state, so one writer loses nothing); audit rows and telemetry stay per
  rank, with the rank on every event and in ``interruptions.csv``;
* the state is rank 0's on every rank after init and after every load
  (``models/common.CheckpointableLearner.replicate``), the experiment
  state too;
* barriers come before a rollback's reload and before the ensemble, so no
  rank reads a checkpoint the chief is still publishing;
* validation and test batches are sharded like train batches; the learner
  reduces the metrics over ranks, and the ensemble gathers every rank's
  per-task logits and targets.

Only the MAML learners split a meta-batch over ranks; the sequential
learners and ``--model_parallel_devices > 1`` raise (ROADMAP A10.2).
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from .data.device_prefetch import AUTO_DEPTH, DevicePrefetcher
from .models.common import StagedBatch, dispatch_multiplier, prepare_batch
from .parallel import multihost
from .parallel.mesh import TENSOR_PARALLEL_ITEM, refuse_tensor_parallel
from .telemetry.device import OOM_EXIT_CODE, is_resource_exhausted, write_oom_report
from .telemetry.runtime import TrainTelemetry
from .tune.space import fingerprint_from_args
from .utils import faultinject, sanitize
from .utils.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointCorruptError,
    publish_alias,
    publish_done_marker,
)
from .utils.platform import resolve_device
from .utils.storage import build_experiment_folder, save_statistics, save_to_json
from .utils.watchdog import HANG_EXIT_CODE, DispatchWatchdog

#: A log line (and the sentinel's read) every this many iterations.
TRAIN_LOG_EVERY = 50

#: Exit code of a preemption shutdown: an emergency checkpoint was written
#: and the run resumes with ``--continue_from_epoch latest``.
REQUEUE_EXIT_CODE = 75

#: Rollbacks of the divergence sentinel a process may make before it halts.
MAX_ROLLBACKS_PER_RUN = 5

class NonFiniteLossError(RuntimeError):
    """The divergence sentinel tripped under ``halt``, or spent the
    ``rollback`` budget; raised before the state can reach a checkpoint."""


class _RollbackSignal(Exception):
    """Unwinds the train loop to the rollback: the iteration at detection
    and the trips seen."""

    def __init__(self, trip_iter: int, trips: float = 1.0):
        super().__init__(trip_iter)
        self.trip_iter = int(trip_iter)
        self.trips = float(trips)


def _check_topology(args, model) -> tuple[int, int]:
    """``(process_index, process_count)`` of ``args``, refusing what the
    port does not run: a policy it does not know, tensor parallelism
    (A10.2), a fleet whose size is not the config's ``num_processes`` or
    ``data_parallel_devices``, and a learner that cannot split its
    meta-batch over the fleet's ranks."""
    policy = str(getattr(args, "on_nonfinite", "halt") or "halt").lower()
    if policy not in ("halt", "skip", "rollback"):
        raise ValueError(f"on_nonfinite must be halt|skip|rollback, got {policy!r}")
    refuse_tensor_parallel(int(getattr(args, "model_parallel_devices", 1) or 1))
    index = int(getattr(args, "process_index", 0) or 0)
    count = max(int(getattr(args, "process_count", 1) or 1), 1)
    for key in ("num_processes", "data_parallel_devices"):
        want = int(getattr(args, key, 0) or 0)
        if want > 1 and want != count:
            raise ValueError(
                f"{key} {want} needs a process group of {want} ranks "
                f"(--num_processes {want}, or the dispatcher); this run has "
                f"{count} process(es)"
            )
    if count > 1 and getattr(model, "dp", 1) != count:
        raise NotImplementedError(
            "multi-host training requires a learner that declares a dp batch "
            "sharding for its step programs (MAML's dp path); this "
            f"learner/mesh combination cannot span {count} processes "
            f"({TENSOR_PARALLEL_ITEM} holds the sequential learners on a fleet)"
        )
    return index, count


def _log_due(current_iter: int, chunk: int) -> bool:
    """Whether the dispatch of ``chunk`` iterations that ended at
    ``current_iter`` crossed a ``TRAIN_LOG_EVERY`` boundary, or is the
    first (the K = 1 path prints at iteration 1)."""
    return current_iter % TRAIN_LOG_EVERY < chunk or current_iter == chunk


def _host_values(total_losses: dict) -> dict:
    """``{key: float64 array}`` of the accumulated metrics, one sample per
    meta-update: the card's scalars and ``(K,)`` vectors copied to the host
    in one transfer and flattened, floats as they are."""
    tensors = [v for vs in total_losses.values() for v in vs
               if isinstance(v, torch.Tensor)]
    fetched = iter(
        torch.cat([t.detach().float().reshape(-1) for t in tensors]).cpu().tolist()
        if tensors else ()
    )
    out = {}
    for key, values in total_losses.items():
        samples = []
        for v in values:
            if isinstance(v, torch.Tensor):
                samples.extend(next(fetched) for _ in range(v.numel()))
            else:
                samples.append(float(v))
        out[key] = np.asarray(samples, dtype=np.float64)
    return out


class ExperimentBuilder:
    def __init__(self, args, data, model, device=None):
        """``args``: parsed flags (``Bunch``); ``data``: the loader class,
        called as ``data(args=args, current_iter=...)``; ``model``: a
        learner of the trainer contract; ``device``: the card unless the
        caller asks for another."""
        self.process_index, self.process_count = _check_topology(args, model)
        # Rank 0 writes; every rank keeps its own audit rows and events.
        self._is_chief = self.process_index == 0
        self._multihost = self.process_count > 1
        self.args, self.model = args, model
        self._data_cls = data
        self.device = resolve_device(device)
        self.on_nonfinite = str(getattr(args, "on_nonfinite", "halt") or "halt").lower()
        # A signal sets this; the loop exits at the next dispatch boundary.
        self._shutdown_signum: int | None = None
        self._prev_handlers: dict[int, object] = {}
        self._rollbacks_this_run = 0

        (
            self.saved_models_filepath,
            self.logs_filepath,
            self.samples_filepath,
        ) = build_experiment_folder(experiment_name=args.experiment_name)

        self.total_losses = {}
        self.state = {"best_val_acc": 0.0, "best_val_iter": 0, "current_iter": 0}
        self.create_summary_csv = False

        def knob(name, default):
            # None (absent from an older config) is the default; an
            # explicit 0 is kept.
            value = getattr(args, name, None)
            return default if value is None else value

        self.telemetry = TrainTelemetry(
            self.logs_filepath,
            enabled=bool(knob("telemetry", True)),
            profile_trace_path=str(knob("profile_trace_path", "") or ""),
            profile_num_iters=int(knob("profile_num_iters", 20) or 20),
            profile_trigger_path=str(knob("profile_trigger_path", "") or ""),
            peak_flops=float(knob("peak_flops", 0.0) or 0.0) or None,
            config_fingerprint=self._config_fingerprint(args),
            process_index=self.process_index, process_count=self.process_count,
        )
        self.telemetry.heartbeat_extra = self._heartbeat_extra
        self.watchdog_enabled = bool(knob("watchdog", True))
        self.watchdog_min_s = float(knob("watchdog_min_s", 600.0))
        self.watchdog_factor = float(knob("watchdog_factor", 20.0))
        self.debug_nans = bool(knob("debug_nans", False))
        self._watchdog: DispatchWatchdog | None = None
        self._epoch_boundaries_done = 0

        self.train_state = model.replicate(model.init_state(
            torch.Generator().manual_seed(int(args.seed)), self.device
        ))
        # The resume's checkpoint_load is this run's event.
        with self.telemetry.sink():
            if args.continue_from_epoch == "from_scratch":
                self.create_summary_csv = True
            elif args.continue_from_epoch == "latest":
                print("attempting to find existing checkpoint")
                if not self._resume_from_latest():
                    self.args.continue_from_epoch = "from_scratch"
                    self.create_summary_csv = True
            elif int(args.continue_from_epoch) >= 0:
                self._load(args.continue_from_epoch)
                self._align_summary_csv()

        self.data = data(args=args, current_iter=self.state["current_iter"])
        print(
            "train_seed {}, val_seed: {}, at start time".format(
                self.data.dataset.seed["train"], self.data.dataset.seed["val"]
            )
        )
        self.total_epochs_before_pause = args.total_epochs_before_pause
        self.state["best_epoch"] = int(
            self.state["best_val_iter"] / args.total_iter_per_epoch
        )
        self.epoch = int(self.state["current_iter"] / args.total_iter_per_epoch)
        self.augment_flag = "omniglot" in args.dataset_name.lower()
        self.start_time = time.time()
        self.epochs_done_in_this_run = 0
        self.checkpoint_async = bool(getattr(args, "checkpoint_async", True))
        self.checkpoint_interval_s = float(
            getattr(args, "checkpoint_interval_s", 0.0) or 0.0
        )
        self._ckpt_writer: AsyncCheckpointWriter | None = None
        self._last_ckpt_t = time.monotonic()
        # K meta-updates a dispatch only for a learner with
        # run_train_iters (MAML, ANIL); the others take one batch a call
        # at any K, as in the JAX builder.
        self._multi = hasattr(model, "run_train_iters")
        self.iters_per_dispatch = (
            max(int(getattr(args, "iters_per_dispatch", 1) or 1), 1)
            if self._multi else 1
        )
        prefetch = getattr(args, "device_prefetch", AUTO_DEPTH)
        self.device_prefetch = AUTO_DEPTH if prefetch is None else int(prefetch)
        budget = getattr(args, "data_fault_budget", 8)
        # The budget holds for the run: each stager gets what is left.
        self.data_fault_budget = 8 if budget is None else int(budget)
        self.data_faults = 0
        self._stager: DevicePrefetcher | None = None
        # Seconds this epoch: the loader blocked whoever pulls from it (the
        # stager, else the loop); the loop waited for a staged group.
        self._epoch_data_wait_s = 0.0
        self._epoch_stage_wait_s = 0.0
        self._epoch_train_t0 = time.perf_counter()
        # The compute options the train step runs with (the JAX builder
        # reports them with its memory levers).
        print("compute options: " + ", ".join(
            f"{k}={getattr(args, k, None)!r}" for k in
            ("compute_dtype", "task_chunk", "device_augment", "lane_pad_channels")
        ))

    # ------------------------------------------------------------------
    # Metric summaries
    # ------------------------------------------------------------------

    @staticmethod
    def build_summary_dict(total_losses, phase, summary_losses=None):
        """``{phase}_{key}_mean/std`` over each metric's finite samples, and
        ``{phase}_nonfinite_trips`` (the sentinel's count) for
        ``nonfinite``."""
        if summary_losses is None:
            summary_losses = {}
        for key, values in _host_values(total_losses).items():
            if key == "nonfinite":
                summary_losses[f"{phase}_nonfinite_trips"] = float(np.sum(values))
                continue
            finite = values[np.isfinite(values)]
            summary_losses[f"{phase}_{key}_mean"] = (
                np.mean(finite) if finite.size else float("nan")
            )
            summary_losses[f"{phase}_{key}_std"] = (
                np.std(finite) if finite.size else float("nan")
            )
        return summary_losses

    @staticmethod
    def build_loss_summary_string(summary_losses):
        """The loss and accuracy entries; of a ``(K,)`` vector, the last
        meta-update's."""
        return "".join(
            "{}: {:.4f}, ".format(key, float(torch.as_tensor(value).reshape(-1)[-1]))
            for key, value in summary_losses.items()
            if "loss" in key or "accuracy" in key
        )

    @staticmethod
    def merge_two_dicts(first_dict, second_dict):
        z = first_dict.copy()
        z.update(second_dict)
        return z

    # ------------------------------------------------------------------
    # Resume and the sentinel
    # ------------------------------------------------------------------

    def _checkpoint_path(self, model_idx) -> str:
        return os.path.join(self.saved_models_filepath, f"train_model_{model_idx}")

    def _load(self, model_idx) -> None:
        """``train_model_<model_idx>`` as the state, rank 0's on every rank
        of a fleet (the experiment state too)."""
        train_state, state = self.model.load_model(
            model_save_dir=self.saved_models_filepath, model_name="train_model",
            model_idx=model_idx, device=self.device,
        )
        self.train_state = self.model.replicate(train_state)
        self.state = multihost.broadcast_object(state)

    def _barrier(self, tag: str) -> None:
        """Every rank of a fleet meets here (nothing on one process)."""
        if self._multihost:
            multihost.barrier(tag)

    def _saved_epoch_indices(self) -> list[int]:
        """Epoch indices with a ``train_model_<e>`` file, newest first."""
        indices = []
        for name in os.listdir(self.saved_models_filepath):
            suffix = name[len("train_model_"):]
            if name.startswith("train_model_") and suffix.isdigit():
                indices.append(int(suffix))
        return sorted(indices, reverse=True)

    def _resume_from_latest(self) -> bool:
        """Loads the newest valid checkpoint: ``latest``, then the epoch
        files newest first. A corrupt one is renamed ``.corrupt`` and the
        next tried; a structural mismatch (``ValueError``) propagates, as
        every older file would mismatch too. False when none is valid."""
        candidates: list = []
        if os.path.exists(self._checkpoint_path("latest")):
            candidates.append("latest")
        candidates.extend(self._saved_epoch_indices())
        for model_idx in candidates:
            path = self._checkpoint_path(model_idx)
            try:
                self._load(model_idx)
                print(f"resumed from checkpoint {path}")
                self._align_summary_csv()
                return True
            except CheckpointCorruptError as exc:
                quarantined = path + ".corrupt"
                try:
                    if self._is_chief:
                        os.replace(path, quarantined)
                except FileNotFoundError:
                    pass
                print(f"WARNING: {exc}; quarantined to {quarantined}, falling "
                      "back to the previous checkpoint", file=sys.stderr)
        return False

    # ------------------------------------------------------------------
    # Preemption, hangs, OOM
    # ------------------------------------------------------------------

    def _install_signal_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal works on the main thread only
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[signum] = signal.signal(signum, self._request_shutdown)
            except (ValueError, OSError):
                pass

    def _restore_signal_handlers(self) -> None:
        for signum, handler in self._prev_handlers.items():
            try:
                signal.signal(signum, handler)
            except (ValueError, OSError):
                pass
        self._prev_handlers = {}

    def _request_shutdown(self, signum, frame) -> None:
        del frame
        if self._shutdown_signum is not None:
            raise KeyboardInterrupt  # a second signal stops at once
        self._shutdown_signum = signum
        # os.write, not print: a handler that lands inside a buffered print
        # on the same thread would die of a reentrant call.
        os.write(2, (f"\nreceived signal {signum}: finishing the in-flight "
                     "dispatch, then emergency checkpoint and requeue exit "
                     f"({REQUEUE_EXIT_CODE})\n").encode())

    def _write_interruption_row(self, kind=None) -> None:
        """A row of ``logs/interruptions.csv``: the pending signal's number,
        or ``kind`` (``"hang"``, ``"oom"``). The dispatcher appends its own
        rows to the same file."""
        interruptions = os.path.join(self.logs_filepath, "interruptions.csv")
        header = ["timestamp", "signal", "current_iter", "epoch",
                  "process_index", "process_count"]
        if not os.path.exists(interruptions):
            try:
                fd = os.open(interruptions, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, (",".join(header) + "\n").encode())
                os.close(fd)
            except FileExistsError:
                pass
        row = [time.time(), int(self._shutdown_signum) if kind is None else kind,
               int(self.state["current_iter"]), self.epoch, self.process_index,
               self.process_count]
        try:
            with open(interruptions) as f:
                existing = f.readline().rstrip("\n").split(",")
            if len(existing) < len(header):
                row = row[:len(existing)]
        except OSError:
            pass
        save_statistics(self.logs_filepath, row, filename="interruptions.csv")

    def _armed(self, upto_iter: int, observe: bool = True, scale: float = 1.0):
        """The watchdog's window around one dispatch (or, with ``observe``
        off, around an epoch boundary); nothing without a watchdog."""
        if self._watchdog is None:
            return contextlib.nullcontext()
        return self._watchdog.armed(upto_iter, observe=observe, scale=scale)

    def _boundary_deadline_scale(self) -> float:
        """An epoch boundary holds a validation epoch and a checkpoint
        snapshot: the validation batches (plus slack) times a dispatch."""
        num_val_batches = max(
            int(self.args.num_evaluation_tasks / self.args.batch_size), 1
        )
        return float(num_val_batches + 4)

    def _captures(self) -> int:
        """The learner's step-graph captures so far (0 off the card; a graph
        is never captured twice)."""
        graphs = getattr(self.model, "_step_graphs", None)
        return 0 if graphs is None else len(graphs.graphs)

    def _on_hang(self, diag: dict) -> None:
        """The watchdog's unwind before its exit: the writer drained (at
        most 30 s), the audit row, the ``requeue_exit`` event, the flush.
        The wedged dispatch is not touched."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain(raise_errors=False, timeout=30.0)
        try:
            self._write_interruption_row(kind="hang")
        except OSError:
            pass
        self.telemetry.event("requeue_exit", code=HANG_EXIT_CODE, hang=True,
                             iter=int(diag.get("iter", -1)))
        self.telemetry.shutdown()

    def _oom_levers(self) -> dict:
        """The knobs that relieve device-memory pressure, for the report."""
        def read(name, default=None):
            return getattr(self.args, name, default)

        return {
            "batch_size": read("batch_size"),
            "task_chunk": read("task_chunk", 0),
            "iters_per_dispatch": self.iters_per_dispatch,
            "device_prefetch": self.device_prefetch,
            "compute_dtype": read("compute_dtype"),
            "lane_pad_channels": read("lane_pad_channels"),
            "remat_inner_steps": read("remat_inner_steps", True),
            "number_of_training_steps_per_iter": read("number_of_training_steps_per_iter"),
            "num_target_samples": read("num_target_samples"),
            "data_parallel_devices": read("data_parallel_devices", 0),
        }

    def _handle_oom(self, exc: BaseException) -> None:
        """``logs/oom_report.json``, the audit row and the ``oom`` event;
        the caller exits with ``OOM_EXIT_CODE``."""
        report_path = os.path.join(self.logs_filepath, "oom_report.json")
        write_oom_report(report_path, ledger=self.telemetry.ledger, error=exc,
                         config_levers=self._oom_levers(),
                         current_iter=int(self.state["current_iter"]))
        try:
            self._write_interruption_row(kind="oom")
        except OSError:
            pass
        self.telemetry.event("oom", iter=int(self.state["current_iter"]),
                             code=OOM_EXIT_CODE, error=str(exc)[:500],
                             report=os.path.basename(report_path))
        print(f"out of device memory at iteration {self.state['current_iter']}: "
              f"forensics written to {report_path}; exiting with code "
              f"{OOM_EXIT_CODE}", file=sys.stderr)

    def _maybe_emergency_exit(self, write_checkpoint: bool = True) -> None:
        """At a dispatch boundary, when a signal came: the in-flight async
        write drained, an emergency ``train_model_latest`` (not over a state
        with a pending non-finite loss; ``halt`` raises then), the audit
        row, exit 75. ``write_checkpoint=False`` is the ensemble test's
        form: its state is a reloaded epoch, and the phase reruns whole."""
        if self._shutdown_signum is None:
            return
        self.telemetry.event("preemption", signal=int(self._shutdown_signum),
                             iter=int(self.state["current_iter"]))
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain(raise_errors=False)
        if not write_checkpoint:
            self._write_interruption_row()
            print("shutdown requested during the evaluation phase; exiting with "
                  f"requeue code {REQUEUE_EXIT_CODE} (the phase reruns on resume)",
                  flush=True)
            self.telemetry.event("requeue_exit", code=REQUEUE_EXIT_CODE)
            self.telemetry.shutdown()
            sys.exit(REQUEUE_EXIT_CODE)
        trips = (self._pending_nonfinite_trips() if self.on_nonfinite != "skip"
                 else 0.0)
        if trips and self.on_nonfinite == "halt":
            raise NonFiniteLossError(
                f"{int(trips)} non-finite meta-loss(es) pending at shutdown "
                f"(iteration {self.state['current_iter']}, on_nonfinite=halt); "
                "refusing to write an emergency checkpoint of poisoned state"
            )
        path = self._checkpoint_path("latest")
        if trips:
            print("WARNING: non-finite meta-loss pending at shutdown; not "
                  "overwriting train_model_latest (the requeued run resumes "
                  "from the last epoch checkpoint)", file=sys.stderr)
        elif self._is_chief:
            self.model.save_model(path, self.train_state, self.state)
        self._write_interruption_row()
        print(("emergency checkpoint written to " + path if not trips
               else "emergency checkpoint skipped (poisoned state)")
              + f"; exiting with requeue code {REQUEUE_EXIT_CODE}", flush=True)
        self.telemetry.event("requeue_exit", code=REQUEUE_EXIT_CODE,
                             emergency_checkpoint=not bool(trips))
        self.telemetry.shutdown()
        sys.exit(REQUEUE_EXIT_CODE)

    @staticmethod
    def _config_fingerprint(args) -> str | None:
        """The 12-hex id of the resolved knob set (``tune/space.py``), or
        None when ``args`` cannot be resolved: provenance, not correctness,
        so a half-built namespace does not stop a run."""
        try:
            return fingerprint_from_args(args)
        except Exception:  # noqa: BLE001 - provenance, not correctness
            return None

    def _heartbeat_extra(self) -> dict:
        """The builder's heartbeat fields (host values only)."""
        extra = {
            "epoch": int(self.epoch),
            "best_val_acc": float(self.state.get("best_val_acc", 0.0) or 0.0),
            "last_checkpoint_age_s": round(time.monotonic() - self._last_ckpt_t, 3),
            "shutdown_pending": self._shutdown_signum is not None,
        }
        if self._watchdog is not None:
            extra["watchdog"] = self._watchdog.state()
        return extra

    # ------------------------------------------------------------------
    # The divergence sentinel
    # ------------------------------------------------------------------

    def _align_summary_csv(self) -> None:
        """Drops the rows of ``summary_statistics.csv`` past the loaded
        state's epochs. An epoch's row is written before its checkpoint, so
        a process killed between the two (SIGKILL, the watchdog's exit, an
        async write still in flight) left a row that the replay of that
        epoch writes again; the JAX builder keeps both. The chief's file."""
        if not self._is_chief:
            return
        path = os.path.join(self.logs_filepath, "summary_statistics.csv")
        stats = self.state.get("per_epoch_statistics") or {}
        epochs = len(next(iter(stats.values()), []))
        try:
            with open(path) as f:
                lines = f.read().splitlines(keepends=True)
        except OSError:
            return
        try:
            float(lines[0].split(",")[0])
            header = 0
        except (IndexError, ValueError):
            header = 1
        extra = len(lines) - header - epochs
        if extra <= 0:
            return
        with open(path + ".tmp", "w") as f:
            f.writelines(lines[:header + epochs])
        os.replace(path + ".tmp", path)
        print(f"WARNING: dropped {extra} row(s) of {path} past the checkpoint's "
              f"{epochs} epoch(s); their epochs are trained again", file=sys.stderr)

    def _sentinel_check(self, losses, current_iter: int) -> None:
        """At the log cadence's read: ``halt`` raises on a tripped
        dispatch, ``rollback`` unwinds to ``_perform_rollback``; ``skip``
        was resolved on the card."""
        flag = losses.get("nonfinite")
        if self.on_nonfinite == "skip" or flag is None:
            return
        trips = float(torch.as_tensor(flag).sum())
        if trips == 0.0:
            return
        self.telemetry.event("nonfinite_trip", iter=int(current_iter), trips=trips,
                             policy=self.on_nonfinite, scope="dispatch")
        if self.on_nonfinite == "halt":
            raise NonFiniteLossError(
                f"non-finite meta-loss at iteration {current_iter} "
                "(on_nonfinite=halt); nothing was checkpointed. Rerun with "
                "--on_nonfinite skip/rollback to train through it, or "
                "--debug_nans to find the operation"
            )
        raise _RollbackSignal(current_iter, trips)

    def _pending_nonfinite_trips(self) -> float:
        """Sentinel trips among the epoch's accumulated metrics so far
        (reads them from the card)."""
        pending = self.total_losses.get("nonfinite")
        if not pending:
            return 0.0
        return float(np.sum(_host_values({"nonfinite": pending})["nonfinite"]))

    def _sentinel_epoch_boundary(self, summary_losses: dict) -> None:
        """The epoch's trip count: ``halt`` raises before validation and
        checkpointing; ``skip`` adds it to the persisted total."""
        trips = sum(
            float(value or 0.0) for key, value in summary_losses.items()
            if key.endswith("_nonfinite_trips")
        )
        if trips == 0.0:
            return
        self.telemetry.event("nonfinite_trip", iter=int(self.state["current_iter"]),
                             trips=trips, policy=self.on_nonfinite, scope="epoch")
        if self.on_nonfinite == "halt":
            raise NonFiniteLossError(
                f"{int(trips)} non-finite loss(es) in the epoch ending at "
                f"iteration {self.state['current_iter']} (on_nonfinite=halt); "
                "nothing was checkpointed"
            )
        if self.on_nonfinite == "rollback":
            raise _RollbackSignal(self.state["current_iter"], trips)
        self.state["nonfinite_trips_total"] = (
            float(self.state.get("nonfinite_trips_total", 0.0)) + trips
        )

    def _perform_rollback(self, trip: _RollbackSignal) -> None:
        """``rollback``: the newest valid checkpoint (or a fresh state from
        the seed when there is none) becomes the state, and the loader
        starts past the iteration that tripped, so the replay trains on
        fresh episodes. On a card the restored state goes into the
        captured graphs' static inputs at the next dispatch
        (``models/step_graph.py``); nothing is captured again."""
        if self._ckpt_writer is not None:
            # The in-flight epoch write may be the newest valid state.
            self._ckpt_writer.drain()
        # Every rank trips alike (the metrics are reduced), but only the
        # chief's drain fenced a write: no rank reloads before it is out.
        self._barrier("pre-rollback-reload")
        self._rollbacks_this_run += 1
        if self._rollbacks_this_run > MAX_ROLLBACKS_PER_RUN:
            raise NonFiniteLossError(
                f"divergence sentinel rolled back {MAX_ROLLBACKS_PER_RUN} times "
                "in this run without stabilizing; halting (on_nonfinite=rollback "
                "budget exhausted)"
            )
        carry_trips = float(self.state.get("nonfinite_trips_total", 0.0)) + trip.trips
        rollbacks = int(self.state.get("nonfinite_rollbacks", 0)) + 1
        print(f"WARNING: non-finite meta-loss at iteration {trip.trip_iter}; "
              "rolling back to the last valid checkpoint (rollback "
              f"{self._rollbacks_this_run}/{MAX_ROLLBACKS_PER_RUN})", file=sys.stderr)
        if not self._resume_from_latest():
            self.train_state = self.model.replicate(self.model.init_state(
                torch.Generator().manual_seed(int(self.args.seed)), self.device
            ))
            self.state = {"best_val_acc": 0.0, "best_val_iter": 0, "best_epoch": 0,
                          "current_iter": 0}
        self.state["nonfinite_trips_total"] = carry_trips
        self.state["nonfinite_rollbacks"] = rollbacks
        restored_iter = int(self.state["current_iter"])
        # The episodes of [restored_iter, trip_iter) are never served again.
        self.data.close()
        self.data = self._data_cls(
            args=self.args, current_iter=max(trip.trip_iter, restored_iter)
        )
        self.epoch = restored_iter // int(self.args.total_iter_per_epoch)
        self.total_losses = {}
        self.telemetry.event("rollback", trip_iter=trip.trip_iter,
                             restored_iter=restored_iter, trips=trip.trips,
                             rollbacks_this_run=self._rollbacks_this_run)
        self.telemetry.reset_window()

    # ------------------------------------------------------------------
    # Iterations
    # ------------------------------------------------------------------

    def _pop_input_waits(self) -> tuple[float, float]:
        """``(data_wait_s, stage_wait_s)`` since the last call: seconds the
        loader blocked whoever pulls from it, and seconds the loop waited
        for a staged group (0 without the stager)."""
        if self._stager is not None:
            return self._stager.pop_waits()
        return self.data.pop_data_wait(), 0.0

    def _after_dispatch(self, losses, total_losses, current_iter, n_iters):
        """Accounts one dispatch of ``n_iters`` meta-updates: the input
        waits and the telemetry's step sample, the metrics appended unread
        (the host does not wait for the step it queued), and the log line
        with the sentinel's read when due. Returns the new iteration
        count."""
        data_wait, stage_wait = self._pop_input_waits()
        self._epoch_data_wait_s += data_wait
        self._epoch_stage_wait_s += stage_wait
        self.telemetry.record_dispatch(
            current_iter + n_iters, n_iters=n_iters, data_wait_s=data_wait,
            stage_wait_s=stage_wait, staged=self._stager is not None,
        )
        for key, value in losses.items():
            total_losses.setdefault(key, []).append(value)
        current_iter += n_iters
        if _log_due(current_iter, n_iters):
            # The print and the sentinel read the same scalars: one read,
            # timed as the boundary's host-sync share.
            t_sync = time.perf_counter()
            self._sentinel_check(losses, current_iter)
            summary = self.build_loss_summary_string(losses)
            sync_s = time.perf_counter() - t_sync
            print(f"training iter {current_iter} epoch {self.epoch} -> " + summary,
                  flush=True)
            self.telemetry.boundary(current_iter, sync_s, reason="log")
        return current_iter

    def train_iteration(self, samples, epoch_idx, total_losses, current_iter):
        """One learner dispatch of the meta-updates in ``samples``, a list
        of loader samples or a staged group: ``run_train_iters`` of K where
        the learner has it (K = 1 included, so one path serves the JAX
        builder's ``train_iteration`` and ``train_iteration_multi``), else
        ``run_train_iter`` of the group's one batch. The metrics are
        appended whole, one sample per meta-update. The watchdog's window
        covers the dispatch and the log cadence's read; the injected hang
        and out-of-memory fire inside it, at the group's first
        iteration."""
        if isinstance(samples, StagedBatch):
            batches, shapes = samples, [a.shape for a in samples.arrays[:4]]
        else:
            # A loader sample is (xs, xt, ys, yt, seed[, aug]): the seed
            # stays on the host, the augmentation operand rides along.
            batches = [tuple(s[:4]) + tuple(s[5:]) for s in samples]
            shapes = [a.shape for a in batches[0][:4]]
        if current_iter == 0:
            print("shape of data", *shapes)
        n_iters = dispatch_multiplier(samples)
        with self._armed(current_iter + n_iters):
            faultinject.hang_due(current_iter)
            faultinject.oom_due(current_iter, self.device)
            if self._multi:
                self.train_state, losses = self.model.run_train_iters(
                    self.train_state, batches, epoch=epoch_idx
                )
            else:
                (batch,) = [batches] if isinstance(batches, StagedBatch) else batches
                self.train_state, losses = self.model.run_train_iter(
                    self.train_state, batch, epoch=epoch_idx
                )
            current_iter = self._after_dispatch(losses, total_losses, current_iter,
                                                n_iters)
        self.telemetry.ingest_train_program(samples)
        return total_losses, current_iter

    def evaluation_iteration(self, val_sample, total_losses, phase):
        x_support, x_target, y_support, y_target, _seed = val_sample
        self.train_state, losses, _ = self.model.run_validation_iter(
            self.train_state, (x_support, x_target, y_support, y_target)
        )
        for key, value in losses.items():
            total_losses.setdefault(key, []).append(value)
        return total_losses

    def test_evaluation_iteration(self, val_sample, model_idx,
                                  per_model_per_batch_preds):
        x_support, x_target, y_support, y_target, _seed = val_sample
        self.train_state, _, per_task_preds = self.model.run_validation_iter(
            self.train_state, (x_support, x_target, y_support, y_target)
        )
        # To the host batch by batch: the ensemble holds every model's
        # test-set logits. A fleet's ranks each hold their tasks' logits:
        # every rank gathers the whole batch's.
        per_model_per_batch_preds[model_idx].extend(
            list(multihost.gather_global(per_task_preds))
        )
        return per_model_per_batch_preds

    # ------------------------------------------------------------------
    # Checkpoints and statistics
    # ------------------------------------------------------------------

    def save_models(self, model, epoch, state):
        """One serialisation an epoch: the epoch file, then ``latest`` as
        its alias, then the ``.ready`` marker; on the background writer
        unless ``checkpoint_async`` is off, when the loop pays it all."""
        epoch_path = self._checkpoint_path(int(epoch))
        latest = self._checkpoint_path("latest")
        if not self._is_chief:
            # Rank 0 is the single writer of the replicated state.
            self._last_ckpt_t = time.monotonic()
            return
        t0 = time.perf_counter()
        if self._ckpt_writer is not None:
            snapshot = model.snapshot_model(self.train_state, state)
            self._ckpt_writer.submit(
                epoch_path, snapshot, alias_dst=latest, publish_marker=True
            )
            self.telemetry.event(
                "checkpoint_submit", path=os.path.basename(epoch_path),
                iter=int(self.state["current_iter"]),
                stall_s=time.perf_counter() - t0, pending=self._ckpt_writer.pending,
            )
        else:
            model.save_model(epoch_path, self.train_state, state)
            publish_alias(epoch_path, latest)
            publish_done_marker(epoch_path)
        self._last_ckpt_t = time.monotonic()
        print("saved models to", self.saved_models_filepath)

    def _interval_checkpoint(self) -> None:
        """The mid-epoch checkpoint of ``checkpoint_interval_s``: the full
        state, written to ``train_model_latest`` (no epoch file, no
        marker), from which ``latest`` resumes at this iteration. A state
        with a pending non-finite loss is not written unless the policy is
        ``skip``; the sentinel handles it."""
        if self.on_nonfinite != "skip" and self._pending_nonfinite_trips():
            print("WARNING: non-finite meta-loss pending at the checkpoint "
                  "interval; skipping the interval write", file=sys.stderr)
        elif self._is_chief:
            path = self._checkpoint_path("latest")
            t0 = time.perf_counter()
            if self._ckpt_writer is not None:
                self._ckpt_writer.submit(
                    path, self.model.snapshot_model(self.train_state, self.state)
                )
            else:
                self.model.save_model(path, self.train_state, self.state)
            self.telemetry.event("checkpoint_interval",
                                 iter=int(self.state["current_iter"]),
                                 stall_s=time.perf_counter() - t0)
        self._last_ckpt_t = time.monotonic()

    def pack_and_save_metrics(self, start_time, create_summary_csv, train_losses,
                              val_losses, state):
        epoch_summary_losses = self.merge_two_dicts(train_losses, val_losses)
        if "per_epoch_statistics" not in state:
            state["per_epoch_statistics"] = {}
        for key, value in epoch_summary_losses.items():
            state["per_epoch_statistics"].setdefault(key, []).append(float(value))

        epoch_summary_string = self.build_loss_summary_string(epoch_summary_losses)
        epoch_summary_losses["epoch"] = self.epoch
        epoch_summary_losses["epoch_run_time"] = time.time() - start_time
        if create_summary_csv and self._is_chief:
            self.summary_statistics_filepath = save_statistics(
                self.logs_filepath, list(epoch_summary_losses.keys()), create=True
            )
        self.create_summary_csv = False
        start_time = time.time()
        print("epoch {} -> {}".format(epoch_summary_losses["epoch"],
                                      epoch_summary_string))
        if not self._is_chief:
            # Every rank keeps the statistics (the ensemble's choice of
            # epochs must be the same everywhere); the chief writes them.
            return start_time, state
        # A row follows the file's header: a resumed experiment whose CSV
        # has other columns gets its values under the right names.
        row = list(epoch_summary_losses.values())
        summary_csv = os.path.join(self.logs_filepath, "summary_statistics.csv")
        if os.path.exists(summary_csv):
            with open(summary_csv) as f:
                header = f.readline().rstrip("\n").split(",")
            if header and header != list(epoch_summary_losses.keys()):
                row = [epoch_summary_losses.get(col, "") for col in header]
        self.summary_statistics_filepath = save_statistics(self.logs_filepath, row)
        return start_time, state

    def evaluated_test_set_using_the_best_models(self, top_n_models):
        """The top-N checkpoints by validation accuracy on the test
        episodes; their logits averaged, then the argmax scored."""
        per_epoch_statistics = self.state["per_epoch_statistics"]
        val_acc = np.copy(per_epoch_statistics["val_accuracy_mean"])
        top_n_models = min(top_n_models, len(val_acc))
        val_idx = np.arange(len(val_acc))
        sorted_idx = np.argsort(val_acc, axis=0).astype(np.int32)[::-1][:top_n_models]
        sorted_val_acc = val_acc[sorted_idx]
        val_idx = val_idx[sorted_idx]
        print("top models (by val acc):", val_idx, sorted_val_acc)

        top_n_idx = val_idx[:top_n_models]
        per_model_per_batch_preds = [[] for _ in range(top_n_models)]
        per_model_per_batch_targets = [[] for _ in range(top_n_models)]
        num_batches = int(self.args.num_evaluation_tasks / self.args.batch_size)
        for idx, model_idx in enumerate(top_n_idx):
            self._load(int(model_idx) + 1)  # checkpoint files count from 1
            for test_sample in self.data.get_test_batches(
                total_batches=num_batches, augment_images=False
            ):
                self._maybe_emergency_exit(write_checkpoint=False)
                # A fleet's loader yields this rank's shard: the targets of
                # the whole batch match the gathered logits.
                per_model_per_batch_targets[idx].extend(
                    multihost.allgather_host(np.array(test_sample[3])))
                per_model_per_batch_preds = self.test_evaluation_iteration(
                    val_sample=test_sample, model_idx=idx,
                    per_model_per_batch_preds=per_model_per_batch_preds,
                )
        per_batch_preds = np.mean(per_model_per_batch_preds, axis=0)
        per_batch_max = np.argmax(per_batch_preds, axis=2)
        per_batch_targets = np.array(per_model_per_batch_targets[0]).reshape(
            per_batch_max.shape
        )
        correct = np.equal(per_batch_targets, per_batch_max)
        test_losses = {
            "test_accuracy_mean": np.mean(correct),
            "test_accuracy_std": np.std(correct),
        }
        if self._is_chief:
            save_statistics(self.logs_filepath, list(test_losses.keys()),
                            create=True, filename="test_summary.csv")
            save_statistics(self.logs_filepath, list(test_losses.values()),
                            create=False, filename="test_summary.csv")
        print(test_losses)
        return test_losses

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def run_experiment(self):
        self._install_signal_handlers()
        if self.checkpoint_async and self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter()
        if self.watchdog_enabled and self._watchdog is None:
            self._watchdog = DispatchWatchdog(
                min_deadline_s=self.watchdog_min_s, factor=self.watchdog_factor,
                logs_dir=self.logs_filepath, on_hang=self._on_hang,
                identity={"process_index": self.process_index,
                          "process_count": self.process_count},
                capture_count=self._captures,
            )
        try:
            # activate(): the event sink, the ledger's hook and SIGUSR1 for
            # the run; its exit stops the profiler and flushes, on every
            # path (return, pause, requeue, crash).
            with self.telemetry.activate(), sanitize.nan_checks(self.debug_nans):
                try:
                    return self._run_experiment()
                except RuntimeError as exc:
                    # A failed device allocation: forensics, then the
                    # registered code (requeueing the same run would fail
                    # the same way).
                    if not is_resource_exhausted(exc):
                        raise
                    self._handle_oom(exc)
                    sys.exit(OOM_EXIT_CODE)
        finally:
            if self._watchdog is not None:
                self._watchdog.close()
                self._watchdog = None
            writer_error = None
            if self._ckpt_writer is not None:
                # Drained and closed on every exit path, the pause's
                # sys.exit and a crash included.
                self._ckpt_writer.drain(raise_errors=False)
                writer_error = self._ckpt_writer.pending_error()
                self._ckpt_writer.close()
                self._ckpt_writer = None
            self.data.close()
            self.telemetry.shutdown()
            self._restore_signal_handlers()
            in_flight = sys.exc_info()[1]
            benign_exit = in_flight is None or (
                isinstance(in_flight, SystemExit) and not in_flight.code
            )
            if writer_error is not None and benign_exit:
                raise writer_error

    def _run_experiment(self):
        total_iters = int(self.args.total_epochs * self.args.total_iter_per_epoch)
        # A loader generator that raised is finished; after the stager
        # quarantined its fault, the rest is drawn from a fresh one.
        while (self.state["current_iter"] < total_iters
               and not self.args.evaluate_on_test_set_only):
            start, faults = self.state["current_iter"], self.data_faults
            try:
                self._train_loop(total_iters)
            except _RollbackSignal as trip:
                self._perform_rollback(trip)
                continue
            if (self.state["current_iter"] == start
                    and self.data_faults == faults):
                raise RuntimeError(
                    f"the loader gave no train batch at iteration {start} "
                    f"of {total_iters}"
                )
        # The last epoch's write must be on disk before the ensemble reads
        # the checkpoints (and a failed write fails the run here); on a
        # fleet no rank reads before the chief's write is out.
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()
        self._barrier("pre-ensemble")
        return self.evaluated_test_set_using_the_best_models(top_n_models=5)

    def _make_stager(self, batches) -> DevicePrefetcher | None:
        """The prefetcher over a train-batch generator, in the loop's
        dispatch groups (``device_prefetch`` 0: none)."""
        if self.device_prefetch == 0:
            return None
        codec = self.model.cfg.wire_codec
        return DevicePrefetcher(
            batches, lambda batch: prepare_batch(batch, codec=codec), self.device,
            depth=self.device_prefetch,
            group=self.iters_per_dispatch,
            start_iter=int(self.state["current_iter"]),
            epoch_len=int(self.args.total_iter_per_epoch),
            fault_budget=self.data_fault_budget - self.data_faults,
        )

    def _train_loop(self, total_iters):
        """The train loop over a fresh batch generator, staged or inline.
        The stager is closed on every exit from here: the pause's
        ``sys.exit``, the sentinel's raise, a crash."""
        batches = self.data.get_train_batches(
            total_batches=total_iters - self.state["current_iter"],
            augment_images=self.augment_flag,
        )
        self._epoch_train_t0 = time.perf_counter()
        stager = self._make_stager(batches)
        if stager is None:
            self._train_loop_host(batches)
            return
        self._stager = stager
        try:
            for staged in stager:
                self._dispatch(staged)
        finally:
            self._stager = None
            self.data_faults += stager.faults_quarantined
            stager.close()

    def _train_loop_host(self, batches):
        """``device_prefetch`` 0: each sample prepared inline, buffered
        into groups flushed at K or an epoch's end (poisoned as the fault
        plan says)."""
        buffered = []
        for train_sample in batches:
            buffered.append(train_sample)
            next_iter = self.state["current_iter"] + len(buffered)
            if (len(buffered) == self.iters_per_dispatch
                    or next_iter % self.args.total_iter_per_epoch == 0):
                self._dispatch(faultinject.poison_batches(
                    buffered, self.state["current_iter"]))
                buffered = []
        if buffered:
            self._dispatch(faultinject.poison_batches(
                buffered, self.state["current_iter"]))

    def _dispatch(self, group) -> None:
        """One learner call on ``group`` (a list of samples or a staged
        group), then the epoch boundary or the interval checkpoint when
        due, then the shutdown check: after the epoch boundary, so that a
        signal landing on a boundary dispatch still gets its validation,
        row and checkpoint first. Every boundary after the process's first
        (which builds the eval path's plans) runs in the watchdog's window
        with ``observe`` off."""
        self.total_losses, self.state["current_iter"] = self.train_iteration(
            samples=group,
            epoch_idx=self.state["current_iter"] / self.args.total_iter_per_epoch,
            total_losses=self.total_losses, current_iter=self.state["current_iter"],
        )
        if self.state["current_iter"] % self.args.total_iter_per_epoch == 0:
            if self._epoch_boundaries_done >= 1:
                with self._armed(self.state["current_iter"], observe=False,
                                 scale=self._boundary_deadline_scale()):
                    self._run_epoch_boundary()
            else:
                self._run_epoch_boundary()
            self._epoch_data_wait_s = self._epoch_stage_wait_s = 0.0
            self._epoch_train_t0 = time.perf_counter()
        elif (self.checkpoint_interval_s > 0
              and time.monotonic() - self._last_ckpt_t
              >= self.checkpoint_interval_s):
            self._interval_checkpoint()
        faultinject.sigterm_due(self.state["current_iter"])
        self._maybe_emergency_exit()

    def _run_epoch_boundary(self) -> None:
        train_wall_s = time.perf_counter() - self._epoch_train_t0
        if self._stager is not None:
            waits = (f"{self._epoch_stage_wait_s:.3f} s waiting for staged "
                     f"groups (the stager waited {self._epoch_data_wait_s:.3f} s "
                     "on the loader)")
        else:
            waits = f"{self._epoch_data_wait_s:.3f} s blocked on the loader"
        print(f"epoch {self.epoch} train loop {train_wall_s:.3f} s, of which "
              f"{waits}", flush=True)
        t_sync = time.perf_counter()
        train_losses = self.build_summary_dict(self.total_losses, phase="train")
        epoch_sync_s = time.perf_counter() - t_sync
        train_losses.update(self.telemetry.epoch_stats("train", epoch=self.epoch))
        self.telemetry.boundary(self.state["current_iter"], epoch_sync_s,
                                reason="epoch_summary")
        self._sentinel_epoch_boundary(train_losses)
        total_losses = {}
        num_val_batches = int(self.args.num_evaluation_tasks / self.args.batch_size)
        for val_sample in self.data.get_val_batches(
            total_batches=num_val_batches, augment_images=False
        ):
            total_losses = self.evaluation_iteration(
                val_sample=val_sample, total_losses=total_losses, phase="val"
            )
        val_losses = self.build_summary_dict(total_losses, phase="val")
        self._sentinel_epoch_boundary(val_losses)
        if val_losses["val_accuracy_mean"] > self.state["best_val_acc"]:
            print("Best validation accuracy", val_losses["val_accuracy_mean"])
            self.state["best_val_acc"] = val_losses["val_accuracy_mean"]
            self.state["best_val_iter"] = self.state["current_iter"]
            self.state["best_epoch"] = int(
                self.state["best_val_iter"] / self.args.total_iter_per_epoch
            )

        self.epoch += 1
        self.state = self.merge_two_dicts(
            self.merge_two_dicts(self.state, train_losses), val_losses
        )
        # Statistics before the checkpoint: the epoch-N file holds epoch N's
        # row, so a resume keeps the ensemble's epoch -> file mapping.
        self.start_time, self.state = self.pack_and_save_metrics(
            start_time=self.start_time,
            create_summary_csv=self.create_summary_csv,
            train_losses=train_losses,
            val_losses=val_losses,
            state=self.state,
        )
        self.save_models(model=self.model, epoch=self.epoch, state=self.state)
        self.total_losses = {}
        self.epochs_done_in_this_run += 1
        self._epoch_boundaries_done += 1
        if self._is_chief:
            save_to_json(
                filename=os.path.join(self.logs_filepath, "summary_statistics.json"),
                dict_to_store=self.state["per_epoch_statistics"],
            )
        self.telemetry.flush()
        if self.epochs_done_in_this_run >= self.total_epochs_before_pause:
            print(
                "train_seed {}, val_seed: {}, at pause time".format(
                    self.data.dataset.seed["train"], self.data.dataset.seed["val"]
                )
            )
            sys.exit()

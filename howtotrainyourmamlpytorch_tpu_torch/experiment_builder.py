"""Experiment runtime: the train/validation loop, checkpoints, statistics,
resume and the ensemble test (``howtotrainyourmamlpytorch_tpu/
experiment_builder.py``, its loop; the operations planes wait).

* An epoch is ``total_iter_per_epoch`` meta-updates, then a validation
  epoch of ``num_evaluation_tasks / batch_size`` batches.
* Each phase's per-iteration metrics become ``{phase}_{key}_mean/std``:
  a row of ``logs/summary_statistics.csv`` and the cumulative
  ``logs/summary_statistics.json``, written before the epoch's checkpoint
  so that the checkpoint holds its own epoch's row.
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
  ``halt`` (raise before anything is checkpointed) or ``skip`` (the
  learner drops the update on the card).

What is not ported raises or is reported once at start; see
``_refuse_unported`` and ``NOT_PORTED``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .data.device_prefetch import AUTO_DEPTH, DevicePrefetcher
from .models.common import StagedBatch, dispatch_multiplier, prepare_batch
from .utils.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointCorruptError,
    publish_alias,
    publish_done_marker,
)
from .utils.platform import resolve_device
from .utils.storage import build_experiment_folder, save_statistics, save_to_json

#: A log line (and the sentinel's read) every this many iterations.
TRAIN_LOG_EVERY = 50

#: Knobs of JAX-only mechanisms that change no number: accepted, and
#: reported at start as not ported, with the ROADMAP item that holds them.
NOT_PORTED = {
    "telemetry": "A12",
    "watchdog": "A12",
    "profile_trace_path": "A12",
    "profile_trigger_path": "A12",
    "peak_flops": "A12",
    "debug_nans": "A12",
}


class NonFiniteLossError(RuntimeError):
    """The divergence sentinel tripped under the ``halt`` policy; raised
    before the state can reach a checkpoint."""


def _refuse_unported(args) -> None:
    """Knobs that change what is computed raise away from their default."""
    policy = str(getattr(args, "on_nonfinite", "halt") or "halt").lower()
    if policy == "rollback":
        raise NotImplementedError("on_nonfinite=rollback is ROADMAP item A12")
    if policy not in ("halt", "skip"):
        raise ValueError(f"on_nonfinite must be halt|skip|rollback, got {policy!r}")
    multi = (
        int(getattr(args, "process_count", 1) or 1) > 1
        or int(getattr(args, "num_processes", 0) or 0) > 1
        or getattr(args, "coordinator_address", None)
        or int(getattr(args, "data_parallel_devices", 0) or 0) > 1
        or int(getattr(args, "model_parallel_devices", 1) or 1) > 1
    )
    if multi:
        raise NotImplementedError(
            "multi-device and multi-host training is ROADMAP item A10"
        )


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
        _refuse_unported(args)
        self.args, self.model = args, model
        self.device = resolve_device(device)
        self.on_nonfinite = str(getattr(args, "on_nonfinite", "halt") or "halt").lower()

        (
            self.saved_models_filepath,
            self.logs_filepath,
            self.samples_filepath,
        ) = build_experiment_folder(experiment_name=args.experiment_name)

        self.total_losses = {}
        self.state = {"best_val_acc": 0.0, "best_val_iter": 0, "current_iter": 0}
        self.create_summary_csv = False

        self.train_state = model.init_state(
            torch.Generator().manual_seed(int(args.seed)), self.device
        )
        if args.continue_from_epoch == "from_scratch":
            self.create_summary_csv = True
        elif args.continue_from_epoch == "latest":
            print("attempting to find existing checkpoint")
            if not self._resume_from_latest():
                self.args.continue_from_epoch = "from_scratch"
                self.create_summary_csv = True
        elif int(args.continue_from_epoch) >= 0:
            self.train_state, self.state = self.model.load_model(
                model_save_dir=self.saved_models_filepath,
                model_name="train_model",
                model_idx=args.continue_from_epoch,
                device=self.device,
            )

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
        print("not ported, no effect on this run: " + ", ".join(
            f"{k}={getattr(args, k, None)!r} ({item})" for k, item in NOT_PORTED.items()
        ) + "; signal handlers, OOM forensics and fault injection (A12)")

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
                self.train_state, self.state = self.model.load_model(
                    model_save_dir=self.saved_models_filepath,
                    model_name="train_model",
                    model_idx=model_idx,
                    device=self.device,
                )
                print(f"resumed from checkpoint {path}")
                return True
            except CheckpointCorruptError as exc:
                quarantined = path + ".corrupt"
                try:
                    os.replace(path, quarantined)
                except FileNotFoundError:
                    pass
                print(f"WARNING: {exc}; quarantined to {quarantined}, falling "
                      "back to the previous checkpoint", file=sys.stderr)
        return False

    def _sentinel_check(self, losses, current_iter: int) -> None:
        """``halt``: raises on a tripped iteration, at the log cadence's
        read. ``skip`` was resolved on the card."""
        flag = losses.get("nonfinite")
        if (self.on_nonfinite == "skip" or flag is None
                or float(torch.as_tensor(flag).sum()) == 0.0):
            return
        raise NonFiniteLossError(
            f"non-finite meta-loss at iteration {current_iter} "
            "(on_nonfinite=halt); nothing was checkpointed"
        )

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
        if self.on_nonfinite == "halt":
            raise NonFiniteLossError(
                f"{int(trips)} non-finite loss(es) in the epoch ending at "
                f"iteration {self.state['current_iter']} (on_nonfinite=halt); "
                "nothing was checkpointed"
            )
        self.state["nonfinite_trips_total"] = (
            float(self.state.get("nonfinite_trips_total", 0.0)) + trips
        )

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
        waits, the metrics appended unread (the host does not wait for the
        step it queued), and the log line with the sentinel's read when
        due. Returns the new iteration count."""
        data_wait, stage_wait = self._pop_input_waits()
        self._epoch_data_wait_s += data_wait
        self._epoch_stage_wait_s += stage_wait
        for key, value in losses.items():
            total_losses.setdefault(key, []).append(value)
        current_iter += n_iters
        if _log_due(current_iter, n_iters):
            self._sentinel_check(losses, current_iter)
            print(f"training iter {current_iter} epoch {self.epoch} -> "
                  + self.build_loss_summary_string(losses), flush=True)
        return current_iter

    def train_iteration(self, samples, epoch_idx, total_losses, current_iter):
        """One learner dispatch of the meta-updates in ``samples``, a list
        of loader samples or a staged group: ``run_train_iters`` of K where
        the learner has it (K = 1 included, so one path serves the JAX
        builder's ``train_iteration`` and ``train_iteration_multi``), else
        ``run_train_iter`` of the group's one batch. The metrics are
        appended whole, one sample per meta-update."""
        if isinstance(samples, StagedBatch):
            batches, shapes = samples, [a.shape for a in samples.arrays[:4]]
        else:
            # A loader sample is (xs, xt, ys, yt, seed[, aug]): the seed
            # stays on the host, the augmentation operand rides along.
            batches = [tuple(s[:4]) + tuple(s[5:]) for s in samples]
            shapes = [a.shape for a in batches[0][:4]]
        if current_iter == 0:
            print("shape of data", *shapes)
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
                                            dispatch_multiplier(samples))
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
        # test-set logits.
        per_model_per_batch_preds[model_idx].extend(
            list(per_task_preds.detach().cpu().numpy())
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
        if self._ckpt_writer is not None:
            snapshot = model.snapshot_model(self.train_state, state)
            self._ckpt_writer.submit(
                epoch_path, snapshot, alias_dst=latest, publish_marker=True
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
        else:
            path = self._checkpoint_path("latest")
            if self._ckpt_writer is not None:
                self._ckpt_writer.submit(
                    path, self.model.snapshot_model(self.train_state, self.state)
                )
            else:
                self.model.save_model(path, self.train_state, self.state)
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
        if create_summary_csv:
            self.summary_statistics_filepath = save_statistics(
                self.logs_filepath, list(epoch_summary_losses.keys()), create=True
            )
            self.create_summary_csv = False
        start_time = time.time()
        print("epoch {} -> {}".format(epoch_summary_losses["epoch"],
                                      epoch_summary_string))
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
            self.train_state, self.state = self.model.load_model(
                model_save_dir=self.saved_models_filepath,
                model_name="train_model",
                model_idx=int(model_idx) + 1,  # checkpoint files count from 1
                device=self.device,
            )
            for test_sample in self.data.get_test_batches(
                total_batches=num_batches, augment_images=False
            ):
                per_model_per_batch_targets[idx].extend(np.array(test_sample[3]))
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
        if self.checkpoint_async and self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter()
        try:
            return self._run_experiment()
        finally:
            writer_error = None
            if self._ckpt_writer is not None:
                # Drained and closed on every exit path, the pause's
                # sys.exit and a crash included.
                self._ckpt_writer.drain(raise_errors=False)
                writer_error = self._ckpt_writer.pending_error()
                self._ckpt_writer.close()
                self._ckpt_writer = None
            self.data.close()
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
            self._train_loop(total_iters)
            if (self.state["current_iter"] == start
                    and self.data_faults == faults):
                raise RuntimeError(
                    f"the loader gave no train batch at iteration {start} "
                    f"of {total_iters}"
                )
        # The last epoch's write must be on disk before the ensemble reads
        # the checkpoints (and a failed write fails the run here).
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain()
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
        into groups flushed at K or an epoch's end."""
        buffered = []
        for train_sample in batches:
            buffered.append(train_sample)
            next_iter = self.state["current_iter"] + len(buffered)
            if (len(buffered) == self.iters_per_dispatch
                    or next_iter % self.args.total_iter_per_epoch == 0):
                self._dispatch(buffered)
                buffered = []
        if buffered:
            self._dispatch(buffered)

    def _dispatch(self, group) -> None:
        """One learner call on ``group`` (a list of samples or a staged
        group), then the epoch boundary or the interval checkpoint when
        due."""
        self.total_losses, self.state["current_iter"] = self.train_iteration(
            samples=group,
            epoch_idx=self.state["current_iter"] / self.args.total_iter_per_epoch,
            total_losses=self.total_losses, current_iter=self.state["current_iter"],
        )
        if self.state["current_iter"] % self.args.total_iter_per_epoch == 0:
            self._run_epoch_boundary()
            self._epoch_data_wait_s = self._epoch_stage_wait_s = 0.0
            self._epoch_train_t0 = time.perf_counter()
        elif (self.checkpoint_interval_s > 0
              and time.monotonic() - self._last_ckpt_t
              >= self.checkpoint_interval_s):
            self._interval_checkpoint()

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
        train_losses = self.build_summary_dict(self.total_losses, phase="train")
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
        save_to_json(
            filename=os.path.join(self.logs_filepath, "summary_statistics.json"),
            dict_to_store=self.state["per_epoch_statistics"],
        )
        if self.epochs_done_in_this_run >= self.total_epochs_before_pause:
            print(
                "train_seed {}, val_seed: {}, at pause time".format(
                    self.data.dataset.seed["train"], self.data.dataset.seed["val"]
                )
            )
            sys.exit()

"""Meta-learning batch loader: episode synthesis on a thread pool with
prefetch (``howtotrainyourmamlpytorch_tpu/data/loader.py``, the thread
backend).

* Episodes are synthesised by a thread pool (PIL decode, NumPy and the
  native gather release the GIL) and collated into ``(B, N, K|T, C, H,
  W)`` NumPy batches, a bounded queue ahead of the train step.
* Batch ``i`` of a generator draws episodes from seeds ``seed_base + i *
  batch + j``; ``continue_from_iter`` fast-forwards the train offset on
  resume, so a resumed run sees the episodes an unbroken run would
  (``data.py:536-542,583-588`` of the original PyTorch implementation).

Not ported, and refused where set: the ``process`` backend (ROADMAP A5:
it forks workers, which is unsafe once CUDA is initialised), the
hard-episode replay manifest (A12) and the per-host shard of a multi-host
run (A10).
"""

from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
import time

import numpy as np

from .dataset import FewShotLearningDataset


class _ProducerError:
    """Queue marker carrying a synthesis-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _collate_episodes(episodes):
    """Stacks ``(xs, xt, ys, yt, seed[, aug])`` episode tuples into batch
    arrays; the on-device augmentation operand, where there is one, to
    ``(B, N)`` or ``(B,)``."""
    return tuple(np.stack(c) for c in zip(*episodes))


def _refuse_unported(args) -> None:
    backend = str(getattr(args, "dataprovider_backend", "thread") or "thread")
    if backend.lower() != "thread":
        raise NotImplementedError(
            f"dataprovider_backend={backend!r}: only the thread backend is "
            "ported; the process backend (forked workers after CUDA is "
            "initialised) is ROADMAP item A5"
        )
    if str(getattr(args, "replay_manifest", "") or "").strip():
        raise NotImplementedError(
            "the hard-episode replay manifest is ROADMAP item A12"
        )
    if int(getattr(args, "data_shard_count", 1) or 1) > 1:
        raise NotImplementedError(
            "a per-host data shard (data_shard_count > 1) is ROADMAP item A10"
        )


class MetaLearningSystemDataLoader:
    """Train/val/test episode-batch generators over the episode dataset."""

    def __init__(self, args, current_iter: int = 0):
        _refuse_unported(args)
        self.args = args
        self.num_of_gpus = args.num_of_gpus
        self.batch_size = args.batch_size
        self.samples_per_iter = args.samples_per_iter
        self.num_workers = max(int(args.num_dataprovider_workers), 1)
        self.total_train_iters_produced = 0
        self.dataset = FewShotLearningDataset(args=args)
        self.full_data_length = dict(self.dataset.data_length)
        self.continue_from_iter(current_iter=current_iter)
        # Seconds the consumer spent blocked on the prefetch queue since the
        # last pop_data_wait(); accrued in the consumer thread only.
        self._data_wait_s = 0.0
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_workers
        )

    @property
    def global_batch(self) -> int:
        """Episodes per yielded batch (``data.py:575-581``)."""
        return self.num_of_gpus * self.batch_size * self.samples_per_iter

    def continue_from_iter(self, current_iter: int) -> None:
        """Fast-forwards the train seed offset after a resume."""
        self.total_train_iters_produced += current_iter * self.global_batch

    def pop_data_wait(self) -> float:
        """Returns and resets the seconds the consumer spent blocked on
        batch delivery since the previous call."""
        waited, self._data_wait_s = self._data_wait_s, 0.0
        return waited

    def close(self) -> None:
        """Stops the synthesis pool; queued batches are dropped."""
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _iter_batches(self, set_name: str, seed_base: int, augment: bool,
                      length: int, prefetch: int = 2):
        """Yields collated batches of ``global_batch`` episodes, synthesised
        by the pool ``num_workers + prefetch`` batches ahead
        (``drop_last``).

        ``set_name``, ``seed_base`` and ``augment`` are taken when the
        generator is made and passed to ``get_set`` explicitly: the pool
        shares one dataset, and a validation epoch run in the middle of a
        live train generator switches its current set and augmentation."""
        n_batches = length // self.global_batch
        out: queue.Queue = queue.Queue(maxsize=prefetch)
        sentinel = object()

        def synthesize_batch(b: int):
            base = b * self.global_batch
            return _collate_episodes([
                self.dataset.get_set(set_name, seed=seed_base + idx,
                                     augment_images=augment)
                for idx in range(base, base + self.global_batch)
            ])

        def produce():
            try:
                depth = self.num_workers + prefetch
                pending: collections.deque = collections.deque()
                for b in range(n_batches):
                    pending.append(self._pool.submit(synthesize_batch, b))
                    if len(pending) >= depth:
                        out.put(pending.popleft().result())
                while pending:
                    out.put(pending.popleft().result())
            except concurrent.futures.CancelledError:
                pass  # close() cancelled the pending batches: stop quietly
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                teardown = isinstance(exc, RuntimeError) and (
                    concurrent.futures.thread._shutdown
                    or getattr(self._pool, "_shutdown", False)
                )
                if not teardown:
                    out.put(_ProducerError(exc))
            finally:
                # Blocks on a full queue rather than drop the sentinel; an
                # abandoned consumer leaves this daemon thread parked.
                out.put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        while True:
            t_blocked = time.perf_counter()
            batch = out.get()
            self._data_wait_s += time.perf_counter() - t_blocked
            if batch is sentinel:
                break
            if isinstance(batch, _ProducerError):
                thread.join()
                raise batch.exc
            yield batch
        thread.join()

    def get_train_batches(self, total_batches: int = -1, augment_images: bool = False):
        """Training batches, advancing the seed window (``data.py:590-604``)."""
        if total_batches == -1:
            self.dataset.data_length = dict(self.full_data_length)
        else:
            self.dataset.data_length["train"] = total_batches * self.batch_size
        self.dataset.switch_set(
            set_name="train", current_iter=self.total_train_iters_produced
        )
        self.dataset.set_augmentation(augment_images=augment_images)
        self.total_train_iters_produced += self.global_batch
        yield from self._iter_batches(
            "train", int(self.dataset.seed["train"]), augment_images,
            self.dataset.data_length["train"],
        )

    def get_val_batches(self, total_batches: int = -1, augment_images: bool = False):
        """Validation batches from the fixed val seed (``data.py:607-620``)."""
        if total_batches == -1:
            self.dataset.data_length = dict(self.full_data_length)
        else:
            self.dataset.data_length["val"] = total_batches * self.batch_size
        self.dataset.switch_set(set_name="val")
        self.dataset.set_augmentation(augment_images=augment_images)
        yield from self._iter_batches(
            "val", int(self.dataset.seed["val"]), augment_images,
            self.dataset.data_length["val"],
        )

    def get_test_batches(self, total_batches: int = -1, augment_images: bool = False):
        """Test batches from the fixed test seed (``data.py:623-636``)."""
        if total_batches == -1:
            self.dataset.data_length = dict(self.full_data_length)
        else:
            self.dataset.data_length["test"] = total_batches * self.batch_size
        self.dataset.switch_set(set_name="test")
        self.dataset.set_augmentation(augment_images=augment_images)
        yield from self._iter_batches(
            "test", int(self.dataset.seed["test"]), augment_images,
            self.dataset.data_length["test"],
        )

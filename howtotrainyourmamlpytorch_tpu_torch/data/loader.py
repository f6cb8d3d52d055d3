"""Meta-learning batch loader: episode synthesis on a pool of threads or
spawned processes, with prefetch (``howtotrainyourmamlpytorch_tpu/data/loader.py``).

* Episodes are synthesised by the pool and collated into ``(B, N, K|T, C,
  H, W)`` NumPy batches, a bounded queue ahead of the train step. The
  ``thread`` backend (the default: PIL decode, NumPy and the native gather
  release the GIL) shares the loader's dataset. The ``process`` backend
  runs each batch in a worker process. The JAX package forks its workers;
  a fork after CUDA is initialised is unsafe, so these are spawned. A
  worker gets the parent's per-class file index (it never lists the tree
  again: ``os.walk``'s order is unsorted, and a worker that listed
  differently would draw other episodes), and with ``load_into_memory``
  the preloaded class stores as views of ``multiprocessing.shared_memory``
  blocks that the parent fills once. Only collated arrays cross back. A
  crashed worker raises in the consumer; the pool is shut down, and the
  blocks unlinked, at ``close`` or before the interpreter's teardown.
* Batch ``i`` of a generator draws episodes from seeds ``seed_base + i *
  batch + j``; ``continue_from_iter`` fast-forwards the train offset on
  resume, so a resumed run sees the episodes an unbroken run would
  (``data.py:536-542,583-588`` of the original PyTorch implementation).
* A replay manifest (``episode_miner``'s) mixes mined hard episodes into
  the train stream: every ``replay_every``-th global episode slot draws the
  next mined seed. Validation and test streams never replay.
* The per-host shard of a multi-process run (``data_shard_index`` of
  ``data_shard_count``, stamped by ``get_args`` from the process group):
  the loader synthesises only the contiguous ``[shard_lo, shard_lo +
  shard_size)`` slice of every batch's episode indices. Seeds stay keyed
  to the global episode index, so the shards of one batch, concatenated in
  rank order, are the single-process batch bit for bit, and a resumed
  sharded loader keeps the global seed window.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import concurrent.futures.process
import json
import multiprocessing
import os
import queue
import threading
import time
import types
from multiprocessing import shared_memory

import numpy as np

from .dataset import FewShotLearningDataset

#: The replay-manifest schema this loader reads (``episode_miner`` writes
#: it); a newer one is refused, never misread.
REPLAY_MANIFEST_SCHEMA = 1

#: Byte alignment of each class store inside its shared-memory block.
_STORE_ALIGN = 64


def load_replay_manifest(path: str) -> tuple[int, ...]:
    """The mined episode seeds of a replay manifest, hardest first. A
    missing or malformed file raises: a run that silently dropped its
    curriculum is worse than one that does not start. Provenance keys the
    miner adds (``learner``, ``source``) are ignored."""
    with open(path) as f:
        manifest = json.load(f)
    if int(manifest.get("schema", -1)) > REPLAY_MANIFEST_SCHEMA:
        raise ValueError(
            f"{path}: replay manifest schema {manifest.get('schema')} is "
            f"newer than this build reads (up to {REPLAY_MANIFEST_SCHEMA})"
        )
    seeds = tuple(int(row["seed"]) for row in manifest.get("episodes", []))
    if not seeds:
        raise ValueError(f"{path}: replay manifest holds no episodes")
    return seeds


def replay_seed(seed_base: int, idx: int, replay_seeds: tuple[int, ...],
                replay_every: int, offset: int = 0) -> int:
    """The episode seed of within-generator index ``idx``: every
    ``replay_every``-th global slot (``offset + idx``, ``offset`` being the
    generator's distance from the run's first episode) draws the next mined
    seed, cycled; every other slot ``seed_base + idx``. Keyed to the global
    slot, a resumed run replays what an unbroken one would. With no
    manifest this is the plain seed rule."""
    slot = offset + idx
    if replay_seeds and replay_every > 0 and (slot + 1) % replay_every == 0:
        return int(replay_seeds[(slot // replay_every) % len(replay_seeds)])
    return seed_base + idx


class _ProducerError:
    """Queue marker carrying a synthesis exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _collate_episodes(episodes):
    """Stacks ``(xs, xt, ys, yt, seed[, aug])`` episode tuples into batch
    arrays; the on-device augmentation operand, where there is one, to
    ``(B, N)`` or ``(B,)``."""
    return tuple(np.stack(c) for c in zip(*episodes))


def _synthesize_batch(dataset, set_name, seed_base, augment, b, global_batch,
                      shard, replay):
    """This shard of batch ``b`` of a generator, collated (both backends);
    ``shard`` is ``(shard_lo, shard_size)``."""
    replay_seeds, replay_every, replay_offset = replay
    shard_lo, shard_size = shard
    base = b * global_batch + shard_lo
    return _collate_episodes([
        dataset.get_set(
            set_name,
            seed=replay_seed(seed_base, idx, replay_seeds, replay_every,
                             replay_offset),
            augment_images=augment,
        )
        for idx in range(base, base + shard_size)
    ])


# ---------------------------------------------------------------------------
# The process backend
# ---------------------------------------------------------------------------


class _SharedStores:
    """Every split's preloaded class stores, copied once into one
    shared-memory block per split. ``layout`` is what a worker needs to map
    them: ``{set: (block name, {class: (offset, shape, dtype)})}``."""

    def __init__(self, datasets: dict):
        self.blocks: list[shared_memory.SharedMemory] = []
        self.layout: dict = {}
        try:
            for set_name, classes in datasets.items():
                entries, size = {}, 0
                for key, store in classes.items():
                    entries[key] = (size, store.shape, store.dtype.str)
                    size += -(-store.nbytes // _STORE_ALIGN) * _STORE_ALIGN
                block = shared_memory.SharedMemory(create=True, size=max(size, 1))
                self.blocks.append(block)
                for key, store in classes.items():
                    offset, shape, dtype = entries[key]
                    view = np.ndarray(shape, dtype, buffer=block.buf, offset=offset)
                    view[...] = store
                    del view  # no export of the buffer may outlive close()
                self.layout[set_name] = (block.name, entries)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for block in self.blocks:
            block.close()
            try:
                block.unlink()
            except FileNotFoundError:
                pass
        self.blocks = []


#: Seconds a spawned worker waits at start for the others.
_WORKER_START_TIMEOUT_S = 300.0

#: The worker process's dataset, the blocks its stores are views of, and
#: the barrier every worker meets at start.
_WORKER_DATASET: FewShotLearningDataset | None = None
_WORKER_BLOCKS: list = []
_WORKER_BARRIER = None


def _worker_state(dataset: FewShotLearningDataset, in_memory: bool) -> dict:
    """What a spawned worker rebuilds the dataset from: the parent's
    attributes (its split and per-class file index included), the flags as
    a plain namespace (so a worker imports none of the parser's modules),
    without the per-thread and per-address caches, and without the stores
    when they travel through shared memory."""
    state = {key: value for key, value in vars(dataset).items()
             if key not in ("_episode_tls", "_class_key_cache", "_class_addr_cache")}
    state["args"] = types.SimpleNamespace(**vars(dataset.args))
    if in_memory:
        del state["datasets"]
    return state


def _init_worker(state: dict, layout: dict | None, barrier) -> None:
    """A spawned worker's initializer: the parent's dataset, its stores
    mapped read-only from the shared blocks (the native assembly takes this
    process's own base addresses)."""
    global _WORKER_DATASET, _WORKER_BARRIER
    _WORKER_BARRIER = barrier
    dataset = FewShotLearningDataset.__new__(FewShotLearningDataset)
    dataset.__dict__.update(state)
    if layout is not None:
        dataset.datasets = {}
        for set_name, (name, entries) in layout.items():
            block = shared_memory.SharedMemory(name=name)
            _WORKER_BLOCKS.append(block)
            stores = {}
            for key, (offset, shape, dtype) in entries.items():
                view = np.ndarray(shape, dtype, buffer=block.buf, offset=offset)
                view.setflags(write=False)
                stores[key] = view
            dataset.datasets[set_name] = stores
    _WORKER_DATASET = dataset


def _worker_ready() -> int:
    """The start-up task: it returns (this worker's pid) only when every
    worker holds one, so each worker answers exactly one."""
    _WORKER_BARRIER.wait(timeout=_WORKER_START_TIMEOUT_S)
    return os.getpid()


def _synthesize_batch_in_worker(set_name, seed_base, augment, b, global_batch,
                                shard, replay):
    return _synthesize_batch(_WORKER_DATASET, set_name, seed_base, augment, b,
                             global_batch, shard, replay)


class _SpawnedPool:
    """The process backend's executor of spawned workers and the shared
    blocks they read. ``close`` (idempotent; also run at exit, before the
    interpreter's teardown) shuts the workers down, then unlinks the
    blocks."""

    def __init__(self, dataset: FewShotLearningDataset, num_workers: int):
        in_memory = bool(dataset.data_loaded_in_memory)
        self.stores = _SharedStores(dataset.datasets) if in_memory else None
        self.closed = False
        started = time.perf_counter()
        context = multiprocessing.get_context("spawn")
        self.executor = concurrent.futures.ProcessPoolExecutor(
            max_workers=num_workers, mp_context=context,
            initializer=_init_worker,
            initargs=(_worker_state(dataset, in_memory),
                      self.stores.layout if in_memory else None,
                      context.Barrier(num_workers)),
        )
        atexit.register(self.close)
        try:
            # As many start-up tasks as workers, submitted before any can
            # start: the pool spawns every worker now, not at the first
            # batches, and the barrier holds each task until all run.
            readies = [self.executor.submit(_worker_ready)
                       for _ in range(num_workers)]
            self.worker_pids = sorted(f.result() for f in readies)
        except BaseException:
            self.close()
            raise
        #: Seconds from the pool's creation to every worker answering.
        self.startup_s = time.perf_counter() - started

    def submit(self, *args):
        return self.executor.submit(_synthesize_batch_in_worker, *args)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        atexit.unregister(self.close)
        self.executor.shutdown(wait=True, cancel_futures=True)
        if self.stores is not None:
            self.stores.close()


class MetaLearningSystemDataLoader:
    """Train/val/test episode-batch generators over the episode dataset."""

    def __init__(self, args, current_iter: int = 0):
        self.args = args
        self.num_of_gpus = args.num_of_gpus
        self.batch_size = args.batch_size
        self.samples_per_iter = args.samples_per_iter
        self.num_workers = max(int(args.num_dataprovider_workers), 1)
        # This loader's shard of every batch (0 of 1: the whole batch).
        self.shard_index = int(getattr(args, "data_shard_index", 0) or 0)
        self.shard_count = max(int(getattr(args, "data_shard_count", 1) or 1), 1)
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError(
                f"data_shard_index {self.shard_index} out of range for "
                f"{self.shard_count} shard(s)"
            )
        self.total_train_iters_produced = 0
        # The hard-episode mix-in: off unless a manifest is set.
        manifest_path = str(getattr(args, "replay_manifest", "") or "").strip()
        self.replay_seeds: tuple[int, ...] = (
            load_replay_manifest(manifest_path) if manifest_path else ()
        )
        self.replay_every = (
            max(int(getattr(args, "replay_every", 8) or 0), 0)
            if self.replay_seeds else 0
        )
        backend = str(getattr(args, "dataprovider_backend", "thread") or "thread")
        self.backend = backend.lower()
        if self.backend not in ("thread", "process"):
            raise ValueError(
                f"dataprovider_backend must be thread|process, got {backend!r}"
            )
        self.dataset = FewShotLearningDataset(args=args)
        self.full_data_length = dict(self.dataset.data_length)
        self.continue_from_iter(current_iter=current_iter)
        # Seconds the consumer spent blocked on the prefetch queue since the
        # last pop_data_wait(); accrued in the consumer thread only.
        self._data_wait_s = 0.0
        if self.backend == "process":
            self._spawned: _SpawnedPool | None = _SpawnedPool(
                self.dataset, self.num_workers)
            self._pool = self._spawned.executor
        else:
            self._spawned = None
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.num_workers
            )

    @property
    def global_batch(self) -> int:
        """Episodes per batch over all shards (``data.py:575-581``): seed
        windows and epoch arithmetic do not depend on the shard count; a
        sharded loader yields ``shard_size`` of them."""
        return self.num_of_gpus * self.batch_size * self.samples_per_iter

    @property
    def shard_size(self) -> int:
        """Episodes this loader synthesises per batch."""
        if self.global_batch % self.shard_count != 0:
            raise ValueError(
                f"global meta-batch {self.global_batch} not divisible by "
                f"{self.shard_count} data-plane shard(s)"
            )
        return self.global_batch // self.shard_count

    @property
    def shard_lo(self) -> int:
        """The first episode index (within a batch) of this shard: the
        ``parallel/mesh.host_batch_bounds`` slice."""
        return self.shard_index * self.shard_size

    @property
    def worker_startup_s(self) -> float | None:
        """The process backend's seconds to start its workers (None on
        threads)."""
        return None if self._spawned is None else self._spawned.startup_s

    def continue_from_iter(self, current_iter: int) -> None:
        """Fast-forwards the train seed offset after a resume."""
        self.total_train_iters_produced += current_iter * self.global_batch

    def pop_data_wait(self) -> float:
        """Returns and resets the seconds the consumer spent blocked on
        batch delivery since the previous call."""
        waited, self._data_wait_s = self._data_wait_s, 0.0
        return waited

    def close(self) -> None:
        """Stops the synthesis pool; queued batches are dropped. The process
        backend waits for its workers to exit and unlinks its blocks."""
        if self._spawned is not None:
            self._spawned.close()
        else:
            self._pool.shutdown(wait=False, cancel_futures=True)

    def _iter_batches(self, set_name: str, seed_base: int, augment: bool,
                      length: int, prefetch: int = 2,
                      replay: tuple = ((), 0, 0)):
        """Yields collated batches of ``global_batch`` episodes, synthesised
        by the pool ``num_workers + prefetch`` batches ahead
        (``drop_last``).

        ``set_name``, ``seed_base``, ``augment`` and ``replay`` are taken
        when the generator is made and passed to ``get_set`` explicitly:
        the thread pool shares one dataset, and a validation epoch run in
        the middle of a live train generator switches its current set and
        augmentation."""
        n_batches = length // self.global_batch
        out: queue.Queue = queue.Queue(maxsize=prefetch)
        sentinel = object()
        task = (set_name, seed_base, augment)
        shard = (self.shard_lo, self.shard_size)

        if self._spawned is not None:
            spawned = self._spawned

            def submit(b):
                return spawned.submit(*task, b, self.global_batch, shard, replay)
        else:
            def submit(b):
                return self._pool.submit(_synthesize_batch, self.dataset, *task,
                                         b, self.global_batch, shard, replay)

        def produce():
            try:
                depth = self.num_workers + prefetch
                pending: collections.deque = collections.deque()
                for b in range(n_batches):
                    pending.append(submit(b))
                    if len(pending) >= depth:
                        out.put(pending.popleft().result())
                while pending:
                    out.put(pending.popleft().result())
            except concurrent.futures.CancelledError:
                pass  # close() cancelled the pending batches: stop quietly
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                # A pool shut down under the producer stops it quietly; a
                # crashed worker (which also marks the pool shut down) and
                # every other failure reach the consumer.
                teardown = (
                    isinstance(exc, RuntimeError)
                    and not isinstance(exc, concurrent.futures.BrokenExecutor)
                    and (concurrent.futures.thread._shutdown
                         or getattr(concurrent.futures.process,
                                    "_global_shutdown", False)
                         or getattr(self._pool, "_shutdown", False)
                         or getattr(self._pool, "_shutdown_thread", False))
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
        """Training batches, advancing the seed window (``data.py:590-604``),
        with the replay manifest's episodes mixed in."""
        if total_batches == -1:
            self.dataset.data_length = dict(self.full_data_length)
        else:
            self.dataset.data_length["train"] = total_batches * self.batch_size
        self.dataset.switch_set(
            set_name="train", current_iter=self.total_train_iters_produced
        )
        self.dataset.set_augmentation(augment_images=augment_images)
        self.total_train_iters_produced += self.global_batch
        seed_base = int(self.dataset.seed["train"])
        yield from self._iter_batches(
            "train", seed_base, augment_images,
            self.dataset.data_length["train"],
            # The generator's global episode offset: the seed window's
            # distance from the run's first (the same in a resumed run and
            # an unbroken one).
            replay=(self.replay_seeds, self.replay_every,
                    seed_base - int(self.dataset.init_seed["train"])),
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

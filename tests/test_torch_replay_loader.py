"""The port loader's replay manifest and its spawned ``process`` backend
against the JAX loader, on the CPU (``data/loader.py``).

``replay_seed`` over a grid; the manifest-mixed train batches bit-equal to
the JAX loader's (every Nth global slot a mined seed, cycled; the other
slots, and the validation stream, untouched; a resumed loader replays what
an unbroken one does); the bad-manifest errors; the spawned backend's
batches bit-equal to the thread backend's and to the JAX fork backend's,
with and without ``load_into_memory``; its workers import no torch, map
the parent's shared blocks and never list the tree; ``close`` unlinks the
blocks with no leaked-segment warning; a crashed worker raises in the
consumer. (Mirrors JAX ``tests/test_data.py:156-230`` and ``:419-438``.)
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from concurrent.futures import BrokenExecutor
from multiprocessing import shared_memory

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.data import MetaLearningSystemDataLoader as JLoader
from howtotrainyourmamlpytorch_tpu.data import loader as jloader
from howtotrainyourmamlpytorch_tpu_torch.data import (
    FewShotLearningDataset,
    MetaLearningSystemDataLoader,
)
from howtotrainyourmamlpytorch_tpu_torch.data import loader

from test_data import make_args, make_dataset_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINED = (777, 888, 999)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    make_dataset_dir(tmp_path / "omniglot_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    return tmp_path


def _manifest(path, seeds=MINED, **extra):
    path.write_text(json.dumps({
        "schema": 1, "source": "test", **extra,
        "episodes": [{"seed": s, "margin": 0.01 * i} for i, s in enumerate(seeds)],
    }))
    return str(path)


def _batches(loader_, n, augment=False):
    return list(loader_.get_train_batches(total_batches=n, augment_images=augment))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("every", [0, 1, 2, 3, 4, 8])
def test_replay_seed_equals_jax_over_a_grid(every):
    for seeds in ((), (5,), (101, 202), MINED):
        for offset in (0, 3, 8, 13):
            for base in (1000, 123457):
                got = [loader.replay_seed(base, i, seeds, every, offset) for i in range(40)]
                assert got == [jloader.replay_seed(base, i, seeds, every, offset)
                               for i in range(40)]
    if every:
        stream = [loader.replay_seed(1000, i, (101, 202), every) for i in range(3 * every)]
        assert stream[every - 1] == 101 and stream[2 * every - 1] == 202


def test_manifest_batches_bit_equal_to_jax_with_resume_alignment(tree):
    manifest = _manifest(tree / "replay_manifest.json", learner="maml")
    args = make_args(tree, replay_manifest=manifest, replay_every=4)
    port, jax_ = MetaLearningSystemDataLoader(args), JLoader(args)
    plain = MetaLearningSystemDataLoader(make_args(tree))
    try:
        assert port.replay_seeds == jax_.replay_seeds == MINED
        batches = _batches(port, 3)
        _assert_batches_equal(batches, _batches(jax_, 3))
        seeds = np.concatenate([b[4] for b in batches])
        plain_seeds = np.concatenate([b[4] for b in _batches(plain, 3)])
        assert list(seeds[[3, 7, 11]]) == [777, 888, 999]
        untouched = [i for i in range(len(seeds)) if (i + 1) % 4]
        np.testing.assert_array_equal(seeds[untouched], plain_seeds[untouched])
        # The replayed slot is the mined seed's episode, bit for bit.
        xs, *_ = FewShotLearningDataset(make_args(tree)).get_set("train", seed=777)
        np.testing.assert_array_equal(batches[0][0][3], xs)
        # Validation never replays.
        _assert_batches_equal(list(port.get_val_batches(total_batches=1)),
                              list(plain.get_val_batches(total_batches=1)))
        # Resumed at iteration 2: global slot 11 draws cycle entry 2 (999)
        # in both packages, as the unbroken run did.
        resumed = MetaLearningSystemDataLoader(args, current_iter=2)
        jresumed = JLoader(args, current_iter=2)
        try:
            tail = _batches(resumed, 1)
            _assert_batches_equal(tail, _batches(jresumed, 1))
            _assert_batches_equal(tail, batches[2:])
            assert tail[0][4][3] == 999
        finally:
            resumed.close()
    finally:
        for each in (port, plain):
            each.close()


@pytest.mark.parametrize("case", ["newer", "empty", "missing", "malformed"])
def test_bad_manifests_are_refused_as_in_jax(tree, case):
    path = tree / f"{case}.json"
    if case == "newer":
        path.write_text('{"schema": 99, "episodes": [{"seed": 1}]}')
        error, match = ValueError, "newer"
    elif case == "empty":
        path.write_text('{"schema": 1, "episodes": []}')
        error, match = ValueError, "no episodes"
    elif case == "missing":
        error, match = FileNotFoundError, None
    else:
        path.write_text('{"schema": 1, "episodes": [')
        error, match = ValueError, None
    args = make_args(tree, replay_manifest=str(path))
    with pytest.raises(error, match=match):
        JLoader(args)
    with pytest.raises(error, match=match):
        MetaLearningSystemDataLoader(args)


@pytest.mark.parametrize("in_memory", [False, True])
def test_spawned_backend_bit_equal_to_threads_and_to_the_jax_fork(tree, in_memory):
    manifest = _manifest(tree / "m.json")
    common = dict(load_into_memory=in_memory, replay_manifest=manifest, replay_every=3)
    threads = MetaLearningSystemDataLoader(make_args(tree, **common))
    spawned = MetaLearningSystemDataLoader(
        make_args(tree, dataprovider_backend="process", **common))
    fork = JLoader(make_args(tree, dataprovider_backend="process", **common))
    try:
        assert spawned.backend == "process" and spawned.worker_startup_s > 0
        assert len(spawned._spawned.worker_pids) == 2
        for augment in (False, True):
            want = _batches(threads, 3, augment)
            _assert_batches_equal(_batches(spawned, 3, augment), want)
            _assert_batches_equal(_batches(fork, 3, augment), want)
        for kind in ("val", "test"):
            get = f"get_{kind}_batches"
            _assert_batches_equal(list(getattr(spawned, get)(total_batches=2)),
                                  list(getattr(threads, get)(total_batches=2)))
    finally:
        spawned.close()
        threads.close()
        fork._pool.shutdown(wait=True)


def test_spawned_workers_map_the_shared_blocks_and_import_no_torch(tree):
    spawned = MetaLearningSystemDataLoader(
        make_args(tree, load_into_memory=True, dataprovider_backend="process"))
    names = [block.name for block in spawned._spawned.stores.blocks]
    try:
        assert len(names) == 3  # one block per split
        _batches(spawned, 1)
        for pid in spawned._spawned.worker_pids:
            with open(f"/proc/{pid}/maps") as f:
                maps = f.read()
            assert all(name in maps for name in names), pid
            assert "libtorch" not in maps, f"worker {pid} imported torch"
        # A worker rebuilds the parent's dataset from its state (never from
        # __init__, which would list the tree): the index and the split are
        # the parent's; the stores travel through the blocks, not the state.
        state = loader._worker_state(spawned.dataset, in_memory=True)
        assert "datasets" not in state and "args" in state
        paths = loader._worker_state(
            FewShotLearningDataset(make_args(tree)), in_memory=False)["datasets"]
        assert {k: set(v) for k, v in paths.items()} == \
            {k: set(v) for k, v in spawned.dataset.datasets.items()}
    finally:
        spawned.close()
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)
    spawned.close()  # idempotent


@pytest.mark.parametrize("closes", [True, False])
def test_shared_blocks_are_unlinked_without_a_leak_warning(tree, closes):
    """In a process of its own: the blocks are gone after ``close`` or, when
    the loader is left open, after the interpreter exits, and the resource
    tracker warns of no leaked segment."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {os.path.join(REPO, 'tests')!r})
        from test_data import make_args
        from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
        loader = MetaLearningSystemDataLoader(make_args(__import__('pathlib').Path(
            {str(tree)!r}), load_into_memory=True, dataprovider_backend="process"))
        next(loader.get_train_batches(total_batches=2))
        print(json.dumps([b.name for b in loader._spawned.stores.blocks]), flush=True)
        if {closes!r}:
            loader.close()
    """)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "DATASET_DIR": str(tree)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "leaked" not in proc.stderr and "resource_tracker" not in proc.stderr, proc.stderr
    for name in json.loads(proc.stdout.strip().splitlines()[-1]):
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


def test_a_crashed_worker_raises_in_the_consumer(tree):
    spawned = MetaLearningSystemDataLoader(
        make_args(tree, dataprovider_backend="process", num_dataprovider_workers=1))
    try:
        batches = spawned.get_train_batches(total_batches=20)
        next(batches)
        os.kill(spawned._spawned.worker_pids[0], signal.SIGKILL)
        with pytest.raises(BrokenExecutor):
            for _ in batches:
                pass
    finally:
        spawned.close()


def test_backend_names_are_checked(tree):
    with pytest.raises(ValueError, match="thread|process"):
        MetaLearningSystemDataLoader(make_args(tree, dataprovider_backend="fork"))
    # The per-host shard (A10, ported since): a shard out of range raises.
    with pytest.raises(ValueError, match="out of range"):
        MetaLearningSystemDataLoader(make_args(tree, data_shard_index=2,
                                               data_shard_count=2))

"""The port's device prefetcher (``data/device_prefetch.py``) on the CPU,
where it stages without page-locked memory or a copy stream: the cases of
the JAX package's tests/test_device_prefetch.py that mean something
without JAX.

* staged training is bit for bit the inline path, at K = 1 and at K = the
  group;
* groups never straddle an epoch boundary;
* a producer error reaches the consumer; faults are skipped within the
  budget and fatal past it;
* ``close`` stops the thread wherever the producer is blocked;
* auto depth grows under starvation, a pinned depth never does;
* the builder: its stager's groups and budget, and a training run that
  reaches its end across a quarantined loader fault.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.data.device_prefetch import (
    AUTO_DEPTH,
    DEFAULT_DEPTH,
    MAX_AUTO_DEPTH,
    DataPipelineError,
    DevicePrefetcher,
)
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import (
    BackboneConfig,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models.common import (
    StagedBatch,
    WireCodec,
    prepare_batch,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves
from test_data import make_dataset_dir
from test_torch_experiment import _run_port
from test_torch_train import SMALL, one_intra_op_thread  # noqa: F401

CODEC = WireCodec(1.0, None, None)


def small_learner():
    """tests/test_torch_train.py's SMALL widths, first order, the uint8
    wire (binary images), no MSL."""
    return MAMLFewShotLearner(MAMLConfig(
        backbone=BackboneConfig(**SMALL),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        use_multi_step_loss_optimization=False,
        second_order=False,
        wire_codec=CODEC,
    ))


def make_samples(rng, n, tasks=2):
    """n loader-layout samples ``(xs, xt, ys, yt, seed)`` of binary 12x12
    images, each distinct."""
    samples = []
    for i in range(n):
        xs = rng.randint(0, 2, (tasks, 5, 1, 1, 12, 12)).astype(np.float32)
        xt = rng.randint(0, 2, (tasks, 5, 1, 1, 12, 12)).astype(np.float32)
        ys = np.tile(np.arange(5)[None, :, None], (tasks, 1, 1)).astype(np.int32)
        samples.append((xs, xt, ys, ys.copy(), np.full(tasks, 100 + i)))
    return samples


def prepare(batch):
    return prepare_batch(batch, codec=CODEC)


def stage_all(samples, **kwargs):
    stager = DevicePrefetcher(iter(samples), prepare, "cpu", **kwargs)
    try:
        return list(stager), stager
    finally:
        stager.close()


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# Staged training is the inline path
# ---------------------------------------------------------------------------


def test_staged_k1_training_bitwise_identical():
    samples = make_samples(np.random.RandomState(0), 5)
    learner = small_learner()
    s_host = s_staged = learner.init_state(torch.Generator().manual_seed(7), "cpu")
    for sample in samples:
        s_host, _ = learner.run_train_iter(s_host, sample[:4], epoch=0)
    staged, _ = stage_all(samples, depth=2, group=1)
    assert [b.n_iters for b in staged] == [1] * 5
    assert [b.first_iter for b in staged] == list(range(5))
    for batch in staged:
        assert isinstance(batch, StagedBatch)
        assert batch.arrays[2].shape == (1, 2, 5)  # stacked, K = 1
        s_staged, _ = learner.run_train_iters(s_staged, batch, epoch=0)
    assert _same(s_host, s_staged)


def test_staged_group_dispatch_bitwise_identical():
    """group=K stages whole dispatches (the pre-stacked form); the last,
    partial group matches the builder's epoch-tail flush."""
    samples = make_samples(np.random.RandomState(1), 7)
    learner = small_learner()
    s_host = s_staged = learner.init_state(torch.Generator().manual_seed(9), "cpu")
    for chunk in (samples[:3], samples[3:6], samples[6:]):
        s_host, m_host = learner.run_train_iters(
            s_host, [c[:4] for c in chunk], epoch=0
        )
    staged, _ = stage_all(samples, depth=2, group=3)
    assert [b.n_iters for b in staged] == [3, 3, 1]
    assert [b.first_iter for b in staged] == [0, 3, 6]
    assert staged[-1].arrays[2].shape == (1, 2, 5)  # stacked, K = 1
    for batch in staged:
        s_staged, m_staged = learner.run_train_iters(s_staged, batch, epoch=0)
    assert _same(s_host, s_staged)
    assert torch.equal(m_host["loss"], m_staged["loss"])


def test_groups_never_straddle_epoch_boundary():
    samples = make_samples(np.random.RandomState(2), 8)
    staged, _ = stage_all(samples, depth=2, group=3, start_iter=0, epoch_len=4)
    assert [b.n_iters for b in staged] == [3, 1, 3, 1]
    assert [b.first_iter for b in staged] == [0, 3, 4, 7]
    # A mid-epoch resume (start_iter=3, boundaries at 4 and 8):
    # iterations 3 | 4,5,6 | 7 | 8,9,10.
    staged, _ = stage_all(samples, depth=2, group=3, start_iter=3, epoch_len=4)
    assert [b.n_iters for b in staged] == [1, 3, 1, 3]
    assert [b.first_iter for b in staged] == [3, 4, 7, 8]


def test_staged_arrays_are_the_prepared_batches():
    samples = make_samples(np.random.RandomState(3), 4)
    staged, _ = stage_all(samples, depth=1, group=2)
    for g, batch in enumerate(staged):
        for k in range(2):
            want = prepare(samples[2 * g + k][:4])
            for got, field in zip(batch.arrays, want):
                assert got.dtype == torch.from_numpy(field).dtype
                np.testing.assert_array_equal(got[k].numpy(), field)


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------


def test_producer_error_propagates_to_consumer():
    """A producer death surfaces at the consumer's next pop as a
    DataPipelineError, the original exception chained with the traceback
    of its raise site in the stager thread."""

    def exploding():
        yield from make_samples(np.random.RandomState(5), 1)
        raise ValueError("corrupt image mid-epoch")

    stager = DevicePrefetcher(exploding(), prepare, "cpu", depth=2, group=1)
    try:
        next(stager)
        with pytest.raises(DataPipelineError, match="corrupt image") as exc:
            for _ in stager:
                pass
        cause = exc.value.__cause__
        assert isinstance(cause, ValueError)
        frames = []
        tb = cause.__traceback__
        while tb is not None:
            frames.append(tb.tb_frame.f_code.co_name)
            tb = tb.tb_next
        assert "exploding" in frames
    finally:
        stager.close()


class FlakySource:
    """An iterator over ``samples`` whose pulls numbered in ``fail_at``
    raise an I/O error once, without consuming a sample."""

    def __init__(self, samples, fail_at):
        self._samples = iter(samples)
        self._fail_at = set(fail_at)
        self.pulls = 0

    def __iter__(self):
        return self

    def __next__(self):
        self.pulls += 1
        if self.pulls in self._fail_at:
            raise OSError(5, "loader I/O blip")
        return next(self._samples)


def test_producer_fault_quarantine_skips_then_fails_past_budget(capsys):
    """Within ``fault_budget`` a transient fault is skipped with a warning
    and every batch still arrives; a stage that keeps failing spends the
    budget, then fails fast with the original error chained."""
    source = FlakySource(make_samples(np.random.RandomState(7), 6), fail_at=[3])
    stager = DevicePrefetcher(source, prepare, "cpu", depth=2, group=1,
                              fault_budget=2)
    try:
        got = list(stager)
        assert len(got) == 6
        # The failed window's iteration number goes to the next pull.
        assert [b.first_iter for b in got] == list(range(6))
        assert stager.faults_quarantined == 1
    finally:
        stager.close()
    assert "data fault at iteration 2 quarantined (1/2)" in capsys.readouterr().err

    def bad_prepare(batch):
        raise OSError(5, "corrupt episode")

    stager = DevicePrefetcher(iter(make_samples(np.random.RandomState(8), 6)),
                              bad_prepare, "cpu", depth=2, group=1, fault_budget=2)
    try:
        with pytest.raises(DataPipelineError, match="corrupt episode") as exc:
            for _ in stager:
                pass
        assert isinstance(exc.value.__cause__, OSError)
        assert stager.faults_quarantined == 2
    finally:
        stager.close()


def test_budget_zero_fails_on_the_first_fault():
    source = FlakySource(make_samples(np.random.RandomState(9), 3), fail_at=[1])
    stager = DevicePrefetcher(source, prepare, "cpu", depth=2, group=1)
    try:
        with pytest.raises(DataPipelineError, match="I/O blip"):
            next(stager)
        assert stager.faults_quarantined == 0
    finally:
        stager.close()


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------


def test_close_stops_thread_and_releases_buffers():
    stager = DevicePrefetcher(iter(make_samples(np.random.RandomState(6), 6)),
                              prepare, "cpu", depth=3, group=1)
    first = next(stager)
    deadline = time.time() + 5.0
    while time.time() < deadline:
        with stager._lock:
            if len(stager._buffer) >= 3:
                break
        time.sleep(0.01)
    with stager._lock:
        buffered = len(stager._buffer)
    assert buffered, "the stager never filled its buffer"
    stager.close()
    assert stager.closed
    assert not stager._thread.is_alive()
    assert stager.released_buffers >= buffered
    assert stager._buffer == []
    # The consumed group stays usable; close drops only unconsumed ones.
    assert first.arrays[0].shape == (1, 2, 5, 1, 12, 12)
    stager.close()  # idempotent


def test_close_is_safe_while_producer_blocked_on_full_buffer():
    stager = DevicePrefetcher(iter(make_samples(np.random.RandomState(7), 50)),
                              prepare, "cpu", depth=1, group=1)
    next(stager)
    time.sleep(0.05)  # the producer parks on the full buffer
    stager.close()
    assert not stager._thread.is_alive()
    assert not any(t.name == "device-prefetch-stager" and t.is_alive()
                   for t in threading.enumerate())


def test_close_returns_promptly_when_producer_blocked_upstream():
    """A producer parked inside ``next(source)`` cannot be woken; ``close``
    must not wait for it."""
    release = threading.Event()

    def stuck_source():
        release.wait(30)
        yield None

    stager = DevicePrefetcher(stuck_source(), lambda b: b, "cpu", depth=2, group=1)
    try:
        time.sleep(0.05)  # let the producer park in next(source)
        t0 = time.monotonic()
        stager.close()
        assert time.monotonic() - t0 < 10.0
        assert stager.closed
    finally:
        release.set()
        stager._thread.join(timeout=10.0)
    assert not stager._thread.is_alive()


def test_pop_waits_split_and_auto_depth_growth():
    """A slow source accrues data wait in the stager and stage wait in the
    consumer; repeated starvation deepens auto mode."""
    samples = make_samples(np.random.RandomState(8), 30)

    def slow_source():
        for s in samples:
            time.sleep(0.002)
            yield s

    stager = DevicePrefetcher(slow_source(), prepare, "cpu", depth=AUTO_DEPTH,
                              group=1)
    try:
        assert stager.depth == DEFAULT_DEPTH
        for _ in stager:
            pass
        data_wait_s, stage_wait_s = stager.pop_waits()
        assert data_wait_s > 0.0
        assert stage_wait_s > 0.0
        assert DEFAULT_DEPTH < stager.depth <= MAX_AUTO_DEPTH
        assert stager.pop_waits() == (0.0, 0.0)
    finally:
        stager.close()


def test_pinned_depth_never_grows():
    samples = make_samples(np.random.RandomState(9), 20)

    def slow_source():
        for s in samples:
            time.sleep(0.002)
            yield s

    stager = DevicePrefetcher(slow_source(), prepare, "cpu", depth=2, group=1)
    try:
        for _ in stager:
            pass
        assert stager.depth == 2
    finally:
        stager.close()


def test_stress_every_sample_arrives_once_in_order():
    """The stager and the consumer switching every microsecond, depth 1,
    groups of 3 over 4-iteration epochs: every sample arrives exactly once,
    in order, grouped by the epoch rule."""
    n = 300
    samples = [(np.full((1, 5, 1, 1, 2, 2), i, np.float32),) * 2
               + (np.zeros((1, 5, 1), np.int32),) * 2 + (i,) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stager = DevicePrefetcher(iter(samples), prepare_batch, "cpu", depth=1,
                              group=3, epoch_len=4)
    try:
        staged = list(stager)
    finally:
        sys.setswitchinterval(old)
        stager.close()
    assert not stager._thread.is_alive()
    seen = [int(b.arrays[0][k, 0, 0, 0, 0, 0]) for b in staged for k in range(b.n_iters)]
    assert seen == list(range(n))
    assert [b.n_iters for b in staged] == [3, 1] * (n // 4)
    assert [b.first_iter for b in staged] == sum(([4 * e, 4 * e + 3]
                                                  for e in range(n // 4)), [])


# ---------------------------------------------------------------------------
# The builder's choice
# ---------------------------------------------------------------------------


class _Stub:
    pass


@pytest.mark.parametrize("prefetch, k, depth, group", [
    (-1, 1, DEFAULT_DEPTH, 1), (3, 1, 3, 1), (-1, 4, DEFAULT_DEPTH, 4), (0, 4, None, None),
])
def test_builder_stages_in_its_dispatch_groups(prefetch, k, depth, group):
    """``--device_prefetch`` 0 prepares inline; -1 stages at auto depth, N
    at a pinned depth; groups are ``--iters_per_dispatch``, with the
    builder's epoch length and what is left of its fault budget."""
    builder = _Stub()
    builder.device_prefetch = prefetch
    builder.iters_per_dispatch = k
    builder.data_faults = 2
    builder.data_fault_budget = 5
    builder.device = torch.device("cpu")
    builder.state = {"current_iter": 6}
    builder.args = _Stub()
    builder.args.total_iter_per_epoch = 10
    builder.model = small_learner()
    stager = ExperimentBuilder._make_stager(builder, iter(()))
    if depth is None:
        assert stager is None
        return
    try:
        assert (stager.depth, stager._group) == (depth, group)
        assert stager._auto == (prefetch == AUTO_DEPTH)
        assert (stager._next_iter, stager._epoch_len) == (6, 10)
        assert stager._fault_budget == 5 - 2
    finally:
        stager.close()


@pytest.mark.parametrize("k", [1, 2])
def test_a_quarantined_loader_fault_does_not_end_training(k, tmp_path, monkeypatch,
                                                          capsys):
    """A loader generator that raises is finished, so after the stager
    quarantines its fault the stream ends early. The builder goes on with a
    fresh generator for the iterations left, as the JAX builder does: the
    run reaches its last iteration with every epoch's statistics row and
    checkpoint, and one fault spent of the run's budget."""
    make_dataset_dir(tmp_path / "omniglot_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    train_batches = MetaLearningSystemDataLoader.get_train_batches
    requested = []

    def flaky(self, *args, **kwargs):
        requested.append(kwargs["total_batches"])
        batches = train_batches(self, *args, **kwargs)
        if len(requested) == 1:
            yield next(batches)
            yield next(batches)
            raise OSError(5, "loader I/O blip")
        yield from batches

    monkeypatch.setattr(MetaLearningSystemDataLoader, "get_train_batches", flaky)
    builder, test_losses = _run_port(
        tmp_path, "fault", continue_from_epoch="from_scratch", total_epochs=2,
        total_iter_per_epoch=3, iters_per_dispatch=k,
    )
    assert "data fault at iteration 2 quarantined (1/" in capsys.readouterr().err
    assert requested == [6, 4]
    assert builder.data_faults == 1
    _, last = builder.model.load_model(
        str(tmp_path / "fault" / "saved_models"), "train_model", 2, "cpu"
    )
    assert last["current_iter"] == 6
    with open(tmp_path / "fault" / "logs" / "summary_statistics.csv") as f:
        assert len(f.read().splitlines()) == 1 + 2
    saved = set(os.listdir(tmp_path / "fault" / "saved_models"))
    assert {"train_model_1", "train_model_2", "train_model_latest"} <= saved
    assert 0.0 <= test_losses["test_accuracy_mean"] <= 1.0

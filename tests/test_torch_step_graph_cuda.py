"""The train step as a CUDA graph (``models/step_graph.py``) and the device
prefetcher's copy stream, on a card.

Every test here needs a CUDA device and nvcc, is marked ``cuda`` and skips
without one. The file imports nothing of JAX:

    python -m pytest tests/test_torch_step_graph_cuda.py -q --noconftest

A replay runs the kernels the eager step runs, in the same order, on the
same inputs, with deterministic cuDNN: the graph is held to the eager
``_train_step`` bit for bit.
"""

import gc
import os
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.data.device_prefetch import DevicePrefetcher
from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    BackboneConfig,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models.common import (
    prepare_batch,
    set_injected_lr,
)
from howtotrainyourmamlpytorch_tpu_torch.models.step_graph import WARMUP_STEPS
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as tfn
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "accuracy", "nonfinite")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the Hopper kernels")
    return torch.device("cuda")


def learner_of(cls=MAMLFewShotLearner, **kw):
    """4 stages of 8 filters on 28x28, per-step BN over 2 steps, the fused
    train ops, remat on, MSL over 2 epochs of a 4-epoch cosine schedule."""
    return cls(MAMLConfig(
        backbone=BackboneConfig(
            num_stages=4, num_filters=8, per_step_bn_statistics=True,
            num_steps=2, num_classes=5, fused_norm_train=True, fused_norm_pool=True,
        ),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        multi_step_loss_num_epochs=2, total_epochs=4, **kw,
    ))


def batches(rng, k, tasks=2):
    out = []
    for _ in range(k):
        xs = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
        xt = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
        ys = np.tile(np.arange(5)[None, :, None], (tasks, 1, 1))
        out.append((xs, xt, ys, ys.copy()))
    return out


def eager(learner, state, data, epoch):
    """The eager ``_train_step`` over ``data`` at ``epoch``'s variant, its
    learning rate and importance vector."""
    state = state._replace(opt_state=set_injected_lr(
        state.opt_state, learner._epoch_lr(epoch)
    ))
    importance = learner._importance(state, learner._train_importance(epoch))
    steps = []
    for batch in data:
        state, m = learner._train_step(
            state, learner._device_batch(state, batch), importance,
            second_order=learner._use_second_order(epoch),
            final_only=learner._final_only(epoch),
        )
        steps.append(m)
    return state, {k: torch.stack([m[k] for m in steps]) for k in METRICS}


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_replays_equal_eager_steps_across_branches_and_epochs(cuda):
    """K = 3 replays against 3 eager steps, bit for bit (state, Adam
    moments, per-iteration metrics): at epoch 0 (MSL), epoch 1 (the same
    graph, another learning rate and importance vector) and epoch 2 (past
    the MSL horizon, a second graph). A state held from before each
    dispatch is unchanged after it."""
    _check_replays_against_eager(learner_of())


def test_anil_replays_equal_eager_steps_across_branches_and_epochs(cuda):
    """The same for ANIL, whose captured step adapts the head alone and
    sends the outer gradient to the frozen body through every inner
    step's forward."""
    _check_replays_against_eager(learner_of(ANILLearner))


def _check_replays_against_eager(learner):
    rng = np.random.RandomState(0)
    state = learner.init_state(torch.Generator().manual_seed(1))
    assert learner._epoch_lr(0) != learner._epoch_lr(1)
    for epoch in (0, 1, 2):
        data = batches(rng, 3)
        held = [a.clone() for a in tree_leaves(state)]
        want, want_m = eager(learner, state, data, epoch)
        got, got_m = learner.run_train_iters(state, data, epoch)
        torch.cuda.synchronize()
        assert same(got, want), epoch
        for k in METRICS:
            assert torch.equal(got_m[k], want_m[k]), (epoch, k)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), held))
        state = got
    graphs = learner._step_graphs.graphs
    assert sorted(g.key for g in graphs.values()) == [(True, False), (True, True)]
    assert sum(g.replays for g in graphs.values()) == 9


@pytest.mark.parametrize("cls", [MAMLFewShotLearner, ANILLearner])
def test_graph_kernel_nodes_are_the_captured_launches(cuda, cls):
    """Each captured graph keeps its ``cudaGraph_t``: its fused-norm kernel
    nodes, read from the driver, are the launches its capture counted."""
    import chip_smoke

    learner = learner_of(cls)
    rng = np.random.RandomState(4)
    state = learner.init_state(torch.Generator().manual_seed(5))
    for epoch in (0, 2):
        state, _ = learner.run_train_iters(state, batches(rng, 2), epoch)
    for graph in learner._step_graphs.graphs.values():
        names = chip_smoke.graph_kernel_names(graph.graph)
        nodes = {k: sum(symbol in n for n in names)
                 for k, symbol in chip_smoke.KERNEL_SYMBOLS.items()}
        assert nodes == graph.launches, graph.key
        assert len(names) > sum(nodes.values())  # and the convolutions' kernels


def test_eager_step_is_reproducible_across_process_history(cuda):
    """The train step's backward runs on the calling thread, so the order
    of its gradient sums does not follow how many autograd nodes another
    thread numbered before: an eager step gives the same bits before and
    after other second-order work in the process."""
    learner = learner_of()
    state = learner.init_state(torch.Generator().manual_seed(6))
    data = batches(np.random.RandomState(7), 2)
    first, first_m = eager(learner, state, data, 0)
    x = torch.randn(64, device=cuda, requires_grad=True)
    for n in range(7):
        (g,) = torch.autograd.grad((x.sin() ** (n + 2)).sum(), x, create_graph=True)
        g.sum().backward()
    again, again_m = eager(learner, state, data, 0)
    torch.cuda.synchronize()
    assert same(first, again)
    assert all(torch.equal(first_m[k], again_m[k]) for k in METRICS)


def test_metrics_and_states_are_not_aliased(cuda):
    """A dispatch's metrics and state stay as they were after the next
    replays overwrite the graph's outputs."""
    learner = learner_of()
    rng = np.random.RandomState(1)
    state0 = learner.init_state(torch.Generator().manual_seed(2))
    first, m1 = learner.run_train_iters(state0, batches(rng, 2), 0)
    kept = [a.clone() for a in tree_leaves(first)]
    kept_m = {k: m1[k].clone() for k in METRICS}
    learner.run_train_iters(first, batches(rng, 3), 0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(first), kept))
    assert all(torch.equal(m1[k], kept_m[k]) for k in METRICS)
    assert m1["loss"][0] != m1["loss"][1]


def test_run_train_iter_is_one_replay(cuda):
    """``run_train_iter`` replays the graph ``run_train_iters`` captured;
    the wrappers counted the warm-up and the capture only."""
    learner = learner_of(remat_inner_steps=False)
    rng = np.random.RandomState(2)
    state = learner.init_state(torch.Generator().manual_seed(3))
    data = batches(rng, 3)
    tfn.reset_launch_counts()
    state, _ = learner.run_train_iters(state, data[:2], 0)
    (graph,) = learner._step_graphs.graphs.values()
    # 2 steps x (support + target) x 4 stages; stages 0-1 pool (28, 14).
    assert graph.launches == {"bn_stats": 8, "bn_stats_act": 8,
                              "bn_act_bwd": 0, "bn_act_pool_apply": 8}
    want, _ = eager(learner, state, data[2:], 0)
    counted = dict(tfn.launch_counts)
    got, m = learner.run_train_iter(state, data[2], 0)
    assert tfn.launch_counts == counted  # a replay runs no wrapper
    assert graph.replays == 3 and m["loss"].shape == ()
    assert same(got, want)
    assert counted["bn_stats"] == (WARMUP_STEPS + 1) * 8 + 8  # and the eager step


def test_staged_groups_on_the_copy_stream_train_as_inline(cuda):
    """The prefetcher's page-locked, copy-stream groups give the inline
    path's training bit for bit, at K = 1 and at K = 3."""
    learner = learner_of()
    rng = np.random.RandomState(3)
    data = batches(rng, 6)
    samples = [(*b, np.zeros(2)) for b in data]
    state0 = learner.init_state(torch.Generator().manual_seed(4))
    for group in (1, 3):
        inline, staged = state0, state0
        for i in range(0, 6, group):
            chunk = data[i:i + group]
            inline, _ = (learner.run_train_iter(inline, chunk[0], 0) if group == 1
                         else learner.run_train_iters(inline, chunk, 0))
        stager = DevicePrefetcher(iter(samples), prepare_batch, cuda, group=group)
        try:
            for batch in stager:
                assert batch.arrays[0].device.type == "cuda"
                staged, _ = learner.run_train_iters(staged, batch, 0)
        finally:
            stager.close()
        torch.cuda.synchronize()
        assert same(staged, inline), group


def test_a_failed_capture_raises(cuda):
    """A step that synchronizes cannot be captured: the dispatch raises
    and no eager step runs in the graph's place. In a process of its own:
    a failed capture leaves the CUDA generator in capture mode."""
    code = textwrap.dedent("""
        import numpy as np, torch
        import test_torch_step_graph_cuda as t
        learner = t.learner_of(remat_inner_steps=False)
        state = learner.init_state(torch.Generator().manual_seed(5))
        step = learner._train_step
        ran = []

        def syncing(*args, **kwargs):
            new_state, m = step(*args, **kwargs)
            ran.append(float(m["loss"]))  # a host read: not allowed in a capture
            return new_state, m

        learner._train_step = syncing
        try:
            learner.run_train_iters(state, t.batches(np.random.RandomState(6), 2), 0)
        except RuntimeError as exc:
            print("RAISED", len(ran), type(exc).__name__, exc)
        else:
            print("RAN", len(ran))
    """)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")]
    )}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)
    # The warm-up step ran eagerly (one host read); the capture raised.
    assert f"RAISED {WARMUP_STEPS} " in proc.stdout, proc.stdout + proc.stderr


def test_replay_after_a_rollback_equals_an_eager_step_from_the_restored_state(
        cuda, tmp_path):
    """A rollback hands a state restored from a checkpoint to the graphs
    captured before it (``experiment_builder._perform_rollback``): the
    replay copies it into the static inputs, so two replays from it, after
    replays from a NaN-poisoned state, equal eager steps from it bit for
    bit, with no new capture."""
    learner = learner_of()
    rng = np.random.RandomState(3)
    state = learner.init_state(torch.Generator().manual_seed(1))
    learner.run_train_iters(state, batches(rng, 2), 0)
    learner.save_model(str(tmp_path / "train_model_1"), state, {"current_iter": 0})
    poisoned = batches(rng, 2)
    poisoned[0] = (poisoned[0][0], np.full_like(poisoned[0][1], np.nan),
                   *poisoned[0][2:])
    bad, bad_m = learner.run_train_iters(state, poisoned, 0)
    assert bool(bad_m["nonfinite"][0])
    captures = len(learner._step_graphs.graphs)
    restored, _ = learner.load_model(str(tmp_path), "train_model", 1, device=cuda)
    assert same(restored, state)
    data = batches(rng, 2)
    want, want_m = eager(learner, restored, data, 0)
    got, got_m = learner.run_train_iters(restored, data, 0)
    torch.cuda.synchronize()
    assert same(got, want)
    for k in METRICS:
        assert torch.equal(got_m[k], want_m[k]), k
    assert len(learner._step_graphs.graphs) == captures


def test_capture_guard_counts_one_capture_per_branch(cuda):
    """Over dispatches at epochs 0, 1 (the MSL branch again) and 2, 3 (the
    final-only branch), K = 1 and K = 2: one capture per (second_order,
    final_only) branch and batch shape, none twice."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.sanitize import capture_guard

    learner = learner_of()
    rng = np.random.RandomState(4)
    state = learner.init_state(torch.Generator().manual_seed(1))
    with capture_guard() as guard:
        for epoch in (0, 1, 2, 3):
            for k in (1, 2):
                state, _ = learner.run_train_iters(state, batches(rng, k), epoch)
    torch.cuda.synchronize()
    guard.assert_captures_once()
    guard.assert_captures(1, second_order=True, final_only=False)
    guard.assert_captures(1, second_order=True, final_only=True)
    assert len(guard.events) == len(learner._step_graphs.graphs) == 2


def test_capture_runs_with_the_collector_paused(cuda):
    """A learner whose step graphs an earlier run left in a reference cycle
    is finalized outside the next capture, never inside it (destroying a
    graph there ends the capture, ``tools/port_capture_probe.py``): the
    warm-up runs with the collector on, the captured step with it off, it
    is on again after the dispatch, and the replays that follow the
    collection of the old graphs equal eager steps."""
    rng = np.random.RandomState(7)
    old = learner_of()
    old.run_train_iters(old.init_state(torch.Generator().manual_seed(2)),
                        batches(rng, 1), 0)
    cycle = {"learner": old}
    cycle["self"] = cycle
    gone = weakref.ref(old)
    del old, cycle

    learner = learner_of()
    step = learner._train_step
    collector = []

    def watched(*args, **kwargs):
        collector.append(gc.isenabled())
        return step(*args, **kwargs)

    learner._train_step = watched
    state = learner.init_state(torch.Generator().manual_seed(1))
    state, _ = learner.run_train_iters(state, batches(rng, 1), 0)
    torch.cuda.synchronize()
    assert collector == [True] * WARMUP_STEPS + [False]
    assert gc.isenabled()
    gc.collect()
    assert gone() is None
    learner._train_step = step
    data = batches(rng, 2)
    want, want_m = eager(learner, state, data, 0)
    got, got_m = learner.run_train_iters(state, data, 0)
    torch.cuda.synchronize()
    assert same(got, want)
    for k in METRICS:
        assert torch.equal(got_m[k], want_m[k]), k

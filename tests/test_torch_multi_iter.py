"""The port's ``run_train_iters`` (several meta-updates a dispatch) against
the JAX learner's and against its own ``run_train_iter``, and the
``--iters_per_dispatch`` CLI against the JAX CLI (CPU, float32).

On the CPU the port runs the eager step K times; on a card it replays the
step captured as a CUDA graph (tests/test_torch_step_graph_cuda.py holds
the replays to the eager step bit for bit). Config and helpers:
tests/test_torch_train.py, tests/test_torch_experiment.py.
"""

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.experiment_builder import (
    ExperimentBuilder as JBuilder,
)
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.data import (
    MetaLearningSystemDataLoader as JLoader,
)
from howtotrainyourmamlpytorch_tpu.utils.parser_utils import (
    args_to_maml_config as j_args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch import experiment_builder
from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models.common import (
    StagedBatch,
    dispatch_multiplier,
    prepare_batch,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves
from test_data import make_dataset_dir
from test_torch_experiment import _args, _run_port, _seed_checkpoint, _stats
from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_ATOL,
    LOSS_RTOL,
    assert_tree_close,
    episode_batch,
    jax_config,
    learner_pair,
    one_intra_op_thread,
)
from test_torch_train_iter import _split_conv_biases

K = 3
METRICS = ("loss", "accuracy", "nonfinite")


def _stacked(batches):
    """The pre-stacked form: ``prepare_batch`` of each, stacked on K."""
    prepared = [prepare_batch(b) for b in batches]
    return tuple(np.stack([p[i] for p in prepared]) for i in range(4))


@pytest.mark.parametrize("epoch", [0, 20], ids=["msl", "final-only"])
def test_run_train_iters_matches_jax(epoch, rng):
    """K = 3 second-order meta-updates of the fused learner in one call, on
    the MSL branch (epoch 0) and past the MSL horizon (epoch 20), against
    the JAX ``run_train_iters`` on the same stacked batches: per-iteration
    losses at the loss bar, theta and LSLR at the gradient bar (conv
    biases as in tests/test_torch_train_iter.py). The port's ``(K,)``
    metrics and state equal its own K sequential ``run_train_iter``
    calls bit for bit."""
    jlearner, jstate, learner, state0 = learner_pair(jax_config(True))
    batches = [episode_batch(rng) for _ in range(K)]
    stacked = _stacked(batches)
    jstate, jm = jlearner.run_train_iters(jstate, stacked, epoch)
    state, m = learner.run_train_iters(state0, stacked, epoch)
    assert learner._final_only(epoch) == (epoch == 20)
    assert {k: tuple(m[k].shape) for k in METRICS} == dict.fromkeys(METRICS, (K,))
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(m["accuracy"].numpy(), np.asarray(jm["accuracy"]))
    assert m["nonfinite"].tolist() == np.asarray(jm["nonfinite"]).tolist() == [0.0] * K
    assert {k: v for k, v in m.items() if isinstance(v, float)} == {
        k: v for k, v in jm.items() if isinstance(v, float)
    }
    assert int(state.iteration) == int(jstate.iteration) == K
    biases, rest = _split_conv_biases(tree_to_numpy(state.theta))
    jbiases, jrest = _split_conv_biases(jax.tree.map(np.asarray, jstate.theta))
    assert_tree_close(rest, jrest, GRAD_RTOL, GRAD_ATOL)
    assert_tree_close(biases, jbiases, 0, 2 * K * learner.cfg.meta_learning_rate)
    assert_tree_close(tree_to_numpy(state.lslr), jstate.lslr, GRAD_RTOL, GRAD_ATOL)

    seq, steps = state0, []
    for batch in batches:
        seq, one = learner.run_train_iter(seq, batch, epoch)
        steps.append(one)
    for key in METRICS:
        assert torch.equal(m[key], torch.stack([s[key] for s in steps])), key
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(seq)))


def test_input_forms_give_the_same_dispatch(rng):
    """A list of K episode batches, the pre-stacked numpy form, the same as
    tensors and a ``StagedBatch`` are one dispatch of K, bit for bit; the
    state passed in is left as it was."""
    _, _, learner, state0 = learner_pair(jax_config(False))
    held = [a.clone() for a in tree_leaves(state0)]
    batches = [episode_batch(rng) for _ in range(K)]
    stacked = _stacked(batches)
    tensors = tuple(torch.from_numpy(a) for a in stacked)
    forms = [batches, stacked, tensors, StagedBatch(tensors, K, 0)]
    assert [dispatch_multiplier(f) for f in forms] == [K] * 4
    runs = [learner.run_train_iters(state0, form, 0) for form in forms]
    for state, m in runs[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(state), tree_leaves(runs[0][0])))
        for key in METRICS:
            assert torch.equal(m[key], runs[0][1][key]), key
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state0), held))


def test_a_staged_group_of_one_is_a_train_iteration(rng):
    """A ``StagedBatch`` of one (stacked, K = 1) through ``run_train_iters``
    gives ``run_train_iter``'s update on the host batch, its metrics the
    same values with a leading axis of one."""
    _, _, learner, state0 = learner_pair(jax_config(False))
    batch = episode_batch(rng)
    staged = StagedBatch(_stacked([batch]), 1, 0)
    staged = staged._replace(arrays=tuple(torch.from_numpy(a) for a in staged.arrays))
    a, ma = learner.run_train_iter(state0, batch, 0)
    b, mb = learner.run_train_iters(state0, staged, 0)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert ma["loss"].shape == () and mb["loss"].shape == (1,)
    assert all(torch.equal(ma[k].reshape(1), mb[k]) for k in METRICS)


def test_remat_draws_no_random_numbers(rng):
    """The remat step checkpoints without restoring the RNG state
    (``preserve_rng_state=False``, which a CUDA-graph capture needs): the
    step draws no random numbers, so restoring it changes no bit."""
    from howtotrainyourmamlpytorch_tpu_torch.models import maml

    jcfg = jax_config(True)
    _, _, learner, state0 = learner_pair(jcfg)
    assert learner.cfg.remat_inner_steps
    batches = [episode_batch(rng) for _ in range(2)]
    without, m_without = learner.run_train_iters(state0, batches, 0)

    def preserving(fn, *args, **kwargs):
        return checkpoint(fn, *args, **{**kwargs, "preserve_rng_state": True})

    checkpoint = maml.checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(maml, "checkpoint", preserving)
        torch.manual_seed(0)
        with_rng, m_with = learner.run_train_iters(state0, batches, 0)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(without), tree_leaves(with_rng)))
    assert all(torch.equal(m_without[k], m_with[k]) for k in METRICS)


# ---------------------------------------------------------------------------
# The --iters_per_dispatch CLI
# ---------------------------------------------------------------------------

EPOCHS, ITERS, GROUP = 2, 10, 4
CLI_LOSS_RTOL, CLI_LOSS_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def k_runs(tmp_path_factory):
    """From one JAX ``train_model_0``: the port at K = 1 and at K = 4
    (staged, the default, and inline with ``device_prefetch`` 0), and the
    JAX CLI at K = 4; 2 epochs of 10 iterations, so each epoch ends on a
    short group of 2."""
    tmp_path = tmp_path_factory.mktemp("k_cli")
    make_dataset_dir(tmp_path / "omniglot_mini")
    env = pytest.MonkeyPatch()
    env.setenv("DATASET_DIR", str(tmp_path))
    shape = dict(total_epochs=EPOCHS, total_iter_per_epoch=ITERS)
    names = {"k1": dict(iters_per_dispatch=1),
             "k4": dict(iters_per_dispatch=GROUP),
             "k4_inline": dict(iters_per_dispatch=GROUP, device_prefetch=0)}
    samples = {}
    host_values = experiment_builder._host_values

    def counting(total_losses):
        out = host_values(total_losses)
        samples.setdefault(current, []).append(len(out.get("loss", ())))
        return out

    try:
        seed = _seed_checkpoint(tmp_path, "jax")
        for name in names:
            (tmp_path / name / "saved_models").mkdir(parents=True)
            (tmp_path / name / "saved_models" / "train_model_0").write_bytes(
                seed.read_bytes()
            )
        jargs = _args(tmp_path, "jax", iters_per_dispatch=GROUP, **shape)
        JBuilder(
            args=jargs, data=JLoader,
            model=JLearner(j_args_to_maml_config(jargs)), device=None,
        ).run_experiment()
        env.setattr(experiment_builder, "_host_values", counting)
        for current, overrides in names.items():
            _run_port(tmp_path, current, **shape, **overrides)
        yield dict(stats={n: _stats(tmp_path, n) for n in (*names, "jax")},
                   samples=samples)
    finally:
        env.undo()


def test_k_dispatch_keeps_one_sample_per_meta_update(k_runs):
    """K = 4, staged or inline, writes the K = 1 run's statistics: each
    epoch's train summary reads one sample per meta-update, the epoch's
    short last group included, so the loss and accuracy statistics are
    equal bit for bit. The learning rate and the MSL weights are floats of
    the dispatch, constant over an epoch: their means agree to rounding."""
    stats = k_runs["stats"]
    for name in ("k4", "k4_inline"):
        assert stats[name].keys() == stats["k1"].keys()
        for key, values in stats["k1"].items():
            if any(part in key for part in ("_step_time_p", "_data_wait_p",
                                            "_stage_wait_p")):
                continue  # wall-clock columns (TrainTelemetry.epoch_stats)
            if "learning_rate" in key or "importance" in key:
                np.testing.assert_allclose(stats[name][key], values, rtol=1e-12,
                                           atol=1e-15, err_msg=f"{name} {key}")
            else:
                np.testing.assert_array_equal(stats[name][key], values,
                                              err_msg=f"{name} {key}")
    for name in ("k1", "k4", "k4_inline"):
        # Per epoch: the train summary (one sample per iteration), the
        # validation summary (4 evaluation batches of 2 tasks).
        train_reads = k_runs["samples"][name][0::2]
        assert train_reads == [ITERS] * EPOCHS, (name, k_runs["samples"][name])


@pytest.mark.parametrize("phase", ["train", "val"])
def test_k_dispatch_losses_match_the_jax_cli(k_runs, phase):
    """The port at K = 4 against the JAX CLI at K = 4, per epoch."""
    stats = k_runs["stats"]
    port = np.asarray(stats["k4"][f"{phase}_loss_mean"])
    want = np.asarray(stats["jax"][f"{phase}_loss_mean"])
    assert len(port) == EPOCHS
    np.testing.assert_allclose(port, want, rtol=CLI_LOSS_RTOL, atol=CLI_LOSS_ATOL)

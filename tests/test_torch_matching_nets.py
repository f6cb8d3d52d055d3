"""The port's matching-networks baseline against the JAX learner's, from the
same weights and episode batches (CPU, float32), with ``parity_bug`` off
(the target-label NLL, batch-mean metrics) and on (the reference's head bug
for bug, last-task metrics). Config and helpers:
tests/test_torch_gradient_descent.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import MatchingNetsLearner as JMatchingNetsLearner
from howtotrainyourmamlpytorch_tpu.models import matching_nets as jmatching
from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import MatchingNetsLearner
from howtotrainyourmamlpytorch_tpu_torch.models import matching_nets

from test_torch_gradient_descent import (
    GRAD_ATOL,
    ITERS,
    GRAD_RTOL,
    LOGIT_ATOL,
    LOGIT_RTOL,
    LOSS_ATOL,
    LOSS_RTOL,
    check_train_trajectory,
    device_batch,
    jax_batch,
    theta_without_conv_biases,
    zoo_config,
    zoo_pair,
)
from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    assert_tree_close,
    episode_batch,
    one_intra_op_thread,
    port_config,
)

PARITY = pytest.mark.parametrize("parity_bug", [False, True], ids=["fixed", "parity_bug"])
FUSED = pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])


def mn_pair(jcfg, parity_bug):
    jlearner = JMatchingNetsLearner(jcfg, parity_bug=parity_bug)
    learner = MatchingNetsLearner(port_config(jcfg), parity_bug=parity_bug)
    return (jlearner, learner, *zoo_pair(jlearner, learner))


@PARITY
@FUSED
def test_run_train_iter_matches_jax(fused, parity_bug, rng):
    """Three iterations of one Adam update a task: losses at the loss bar,
    then theta at the gradient bar (conv biases within the steps'
    learning rate)."""
    jlearner, learner, jstate, state = mn_pair(zoo_config(fused), parity_bug)
    jstate, state = check_train_trajectory(jlearner, jstate, learner, state, rng)
    theta, jtheta = tree_to_numpy(state.theta), jax.tree.map(np.asarray, jstate.theta)
    assert_tree_close(theta_without_conv_biases(theta),
                      theta_without_conv_biases(jtheta), GRAD_RTOL, GRAD_ATOL)
    # Each framework's Adam moves a bias up to about the learning rate a
    # step, each its own way.
    assert_tree_close(theta, jtheta, 0, 2 * 3 * 2 * learner.cfg.meta_learning_rate)


@PARITY
@FUSED
def test_first_task_loss_and_gradients_match_jax(fused, parity_bug, rng):
    """Task 0's loss and its gradient over theta: what the first Adam
    update reads."""
    jlearner, learner, jstate, state = mn_pair(zoo_config(fused), parity_bug)
    batch = episode_batch(rng)
    xs, xt, ys, yt = jax_batch(batch)
    (jloss, _), jgrads = jax.value_and_grad(jlearner._task_loss, has_aux=True)(
        jstate.theta, jstate.bn_state, xs[0], ys[0], xt[0], yt[0]
    )
    pxs, pxt, pys, pyt = device_batch(learner, state, batch)
    loss, _, grads = learner._grads(
        lambda p: (learner._task_losses(p, state.bn_state, pxs[:1], pys[:1],
                                        pxt[:1], pyt[:1])[0][0], None),
        state.theta,
    )
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)


@PARITY
@FUSED
def test_run_validation_iter_matches_jax(fused, parity_bug, rng):
    """Three batches. Eval is pure: the state comes back as given; the
    predictions of every task at the logit bar, the loss at the loss
    bar."""
    jlearner, learner, jstate, state = mn_pair(zoo_config(fused), parity_bug)
    for _ in range(ITERS):
        batch = episode_batch(rng)
        _, jm, jpreds = jlearner.run_validation_iter(jstate, batch)
        same, m, preds = learner.run_validation_iter(state, batch)
        assert same is state and set(m) == set(jm) == {"loss", "accuracy"}
        assert preds.shape == (2, 5, 5) and not preds.requires_grad
        np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))


def test_metrics_are_the_batch_mean_or_the_last_task(rng):
    """Without ``parity_bug`` the reported loss is the tasks' mean; with it,
    the last task's."""
    batch = episode_batch(rng)
    per_task = []
    for parity_bug in (False, True):
        _, learner, _, state = mn_pair(zoo_config(False), parity_bug)
        xs, xt, ys, yt = device_batch(learner, state, batch)
        losses = learner._task_losses(state.theta, None, xs, ys, xt, yt)[0]
        _, m, _ = learner.run_validation_iter(state, batch)
        per_task.append((losses, float(m["loss"])))
    (fixed, fixed_loss), (bug, bug_loss) = per_task
    assert fixed_loss == pytest.approx(float(fixed.mean()), rel=1e-6)
    assert bug_loss == pytest.approx(float(bug[-1]), rel=1e-6)


def test_cosine_attention_matches_jax_with_a_support_mask(rng):
    """The support-side norm and the ``-inf`` mask: masked rows get exactly
    zero attention."""
    support = rng.randn(7, 6).astype(np.float32)
    target = rng.randn(4, 6).astype(np.float32)
    labels = np.asarray([0, 1, 2, 3, 4, 0, 1])
    mask = np.asarray([1, 1, 1, 1, 1, 0, 0], np.float32)
    for m in (None, mask):
        want = jmatching.cosine_attention_predictions(
            jnp.asarray(support), jnp.asarray(target), jnp.asarray(labels), 5,
            None if m is None else jnp.asarray(m),
        )
        got = matching_nets.cosine_attention_predictions(
            torch.from_numpy(support), torch.from_numpy(target),
            torch.from_numpy(labels), 5, None if m is None else torch.from_numpy(m),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    padded = matching_nets.cosine_attention_predictions(
        torch.from_numpy(support), torch.from_numpy(target), torch.from_numpy(labels),
        5, torch.from_numpy(mask),
    )
    unpadded = matching_nets.cosine_attention_predictions(
        torch.from_numpy(support[:5]), torch.from_numpy(target),
        torch.from_numpy(labels[:5]), 5,
    )
    np.testing.assert_allclose(padded.numpy(), unpadded.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_serve_matches_jax(masked, rng):
    """``serve_adapt`` embeds one task's support set, ``serve_classify``
    attends over it: the probabilities at the logit bar."""
    jlearner, learner, jstate, state = mn_pair(zoo_config(True), False)
    xs, xt, ys, _ = episode_batch(rng, targets=3)
    xs, ys, xq = xs[0].reshape(5, 1, 12, 12), ys[0].reshape(5), xt[0].reshape(15, 1, 12, 12)
    jistate, istate = jlearner.inference_state(jstate), learner.inference_state(state)
    t = torch.from_numpy
    if masked:
        mask = np.asarray([1, 1, 1, 0, 1], np.float32)
        jadapted = jlearner.serve_adapt_masked(jistate, jnp.asarray(xs), jnp.asarray(ys),
                                               jnp.asarray(mask))
        adapted = learner.serve_adapt_masked(istate, t(xs), t(ys), t(mask))
    else:
        jadapted = jlearner.serve_adapt(jistate, jnp.asarray(xs), jnp.asarray(ys))
        adapted = learner.serve_adapt(istate, t(xs), t(ys))
    np.testing.assert_allclose(adapted["support_emb"].numpy(),
                               np.asarray(jadapted["support_emb"]),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    jpreds = jlearner.serve_classify(jistate, jadapted, jnp.asarray(xq))
    preds = learner.serve_classify(istate, adapted, t(xq))
    assert preds.shape == (15, 5) and preds.dtype == torch.float32
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_parity_bug_refuses_a_support_mask():
    learner = MatchingNetsLearner(port_config(zoo_config(False)), parity_bug=True)
    istate = learner.init_inference_state(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="parity_bug"):
        learner.serve_adapt_masked(istate, torch.zeros(5, 1, 12, 12),
                                   torch.arange(5), torch.ones(5))

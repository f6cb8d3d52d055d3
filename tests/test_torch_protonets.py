"""The port's prototypical networks against the JAX learner's, from the same
weights and episode batches (CPU, float32). The port runs the tasks at once
folded into channels where JAX vmaps them; one Adam update on the task
mean; the running statistics averaged over the tasks. Config and helpers:
tests/test_torch_gradient_descent.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import ProtoNetsLearner as JProtoNetsLearner
from howtotrainyourmamlpytorch_tpu.models import protonets as jprotonets
from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    GradientDescentLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models import common, protonets

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

FUSED = pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])


def pn_pair(jcfg):
    jlearner = JProtoNetsLearner(jcfg)
    learner = ProtoNetsLearner(port_config(jcfg))
    return (jlearner, learner, *zoo_pair(jlearner, learner))


@FUSED
def test_run_train_iter_matches_jax(fused, rng):
    """Three meta-updates: losses at the loss bar, then theta at the
    gradient bar.

    Some leaves have a true gradient of about zero, so that Adam moves them
    by up to the learning rate a step on rounding noise, each framework
    its own way; they are held to twice that. The conv biases sit before
    batch norm. The linear bias adds one vector to every embedding, and
    the last stage's beta shifts every image's features alike wherever the
    LeakyReLU passes them: neither moves a squared distance."""
    jlearner, learner, jstate, state = pn_pair(zoo_config(fused))
    jstate, state = check_train_trajectory(jlearner, jstate, learner, state, rng)
    theta, jtheta = tree_to_numpy(state.theta), jax.tree.map(np.asarray, jstate.theta)
    last = f"conv{learner.cfg.backbone.num_stages - 1}"

    def steady(tree):
        tree = theta_without_conv_biases(tree)
        return {**tree, last: {**tree[last], "norm": {"gamma": tree[last]["norm"]["gamma"]}},
                "linear": {"weight": tree["linear"]["weight"]}}

    assert_tree_close(steady(theta), steady(jtheta), GRAD_RTOL, GRAD_ATOL)
    assert_tree_close(theta, jtheta, 0, 2 * 3 * learner.cfg.meta_learning_rate)


def test_running_statistics_are_the_task_mean(rng):
    """After one meta-update, the running statistics the tasks evolved
    apart, averaged over them, as the JAX learner's. (Later updates move
    the conv biases by Adam noise, which the running means then carry.)"""
    jlearner, learner, jstate, state = pn_pair(zoo_config(False))
    batch = episode_batch(rng)
    jstate, _ = jlearner.run_train_iter(jstate, batch, 0)
    state, _ = learner.run_train_iter(state, batch, 0)
    for k, (mean, var) in state.bn_state.items():
        np.testing.assert_allclose(mean.numpy(), np.asarray(jstate.bn_state[k][0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), np.asarray(jstate.bn_state[k][1]),
                                   rtol=1e-4, atol=1e-5)


@FUSED
def test_first_step_loss_and_gradients_match_jax(fused, rng):
    """The task-mean loss of the first step and its gradient over theta:
    the gradient of the expanded leaves sums over the tasks as the vmapped
    JAX loss's does."""
    jlearner, learner, jstate, state = pn_pair(zoo_config(fused))
    batch = episode_batch(rng)
    xs, xt, ys, yt = jax_batch(batch)

    def batch_loss(theta):
        losses, _ = jax.vmap(jlearner._task_loss, in_axes=(None, None, 0, 0, 0, 0))(
            theta, jstate.bn_state, xs, ys, xt, yt
        )
        return jnp.mean(losses)

    jloss, jgrads = jax.value_and_grad(batch_loss)(jstate.theta)
    pxs, pxt, pys, pyt = device_batch(learner, state, batch)
    loss, _, grads = learner._grads(
        lambda p: learner._batch_loss(p, state.bn_state, pxs, pys, pxt, pyt), state.theta
    )
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)


@FUSED
def test_run_validation_iter_matches_jax(fused, rng):
    """Three batches. Eval is pure: the state comes back as given; the
    logits of every task at the logit bar."""
    jlearner, learner, jstate, state = pn_pair(zoo_config(fused))
    for _ in range(ITERS):
        batch = episode_batch(rng, targets=3)
        _, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
        same, m, logits = learner.run_validation_iter(state, batch)
        assert same is state and set(m) == set(jm) == {"loss", "accuracy"}
        assert logits.shape == (2, 15, 5) and not logits.requires_grad
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))


def test_prototype_head_matches_jax(rng):
    """``class_prototypes`` (an absent class's zero prototype, a masked
    row's exact zero), ``squared_distance_logits`` and ``prototype_logits``,
    one task and a batch of tasks."""
    support = rng.randn(7, 6).astype(np.float32)
    query = rng.randn(4, 6).astype(np.float32)
    labels = np.asarray([0, 1, 1, 3, 4, 0, 1])  # class 2 absent
    mask = np.asarray([1, 1, 1, 1, 1, 0, 0], np.float32)
    t, j = torch.from_numpy, jnp.asarray
    for m in (None, mask):
        want = jprotonets.prototype_logits(j(support), j(labels), j(query), 5,
                                           None if m is None else j(m))
        got = protonets.prototype_logits(t(support), t(labels), t(query), 5,
                                         None if m is None else t(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    protos = protonets.class_prototypes(t(support), t(labels), 5, t(mask))
    assert float(protos[2].abs().max()) == 0.0
    np.testing.assert_array_equal(
        protos.numpy(), protonets.class_prototypes(t(support[:5]), t(labels[:5]), 5).numpy()
    )
    batched = protonets.prototype_logits(
        t(np.stack([support, support[::-1].copy()])), t(np.stack([labels, labels])),
        t(np.stack([query, query])), 5,
    )
    np.testing.assert_allclose(
        batched[1].numpy(),
        protonets.prototype_logits(t(support[::-1].copy()), t(labels), t(query), 5).numpy(),
        rtol=1e-6,
    )


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_serve_matches_jax(masked, rng):
    """``serve_adapt`` gives one task's prototypes, ``serve_classify`` the
    distance logits: both at the logit bar."""
    jlearner, learner, jstate, state = pn_pair(zoo_config(True))
    xs, xt, ys, _ = episode_batch(rng, targets=3)
    xs, ys, xq = xs[0].reshape(5, 1, 12, 12), ys[0].reshape(5), xt[0].reshape(15, 1, 12, 12)
    jistate, istate = jlearner.inference_state(jstate), learner.inference_state(state)
    t = torch.from_numpy
    if masked:
        mask = np.asarray([1, 0, 1, 1, 1], np.float32)
        jadapted = jlearner.serve_adapt_masked(jistate, jnp.asarray(xs), jnp.asarray(ys),
                                               jnp.asarray(mask))
        adapted = learner.serve_adapt_masked(istate, t(xs), t(ys), t(mask))
    else:
        jadapted = jlearner.serve_adapt(jistate, jnp.asarray(xs), jnp.asarray(ys))
        adapted = learner.serve_adapt(istate, t(xs), t(ys))
    np.testing.assert_allclose(adapted["prototypes"].numpy(),
                               np.asarray(jadapted["prototypes"]),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    jlogits = jlearner.serve_classify(jistate, jadapted, jnp.asarray(xq))
    logits = learner.serve_classify(istate, adapted, t(xq))
    assert logits.shape == (15, 5) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize(
    "cls", [GradientDescentLearner, MatchingNetsLearner, ProtoNetsLearner, ANILLearner],
    ids=["gd", "matching_nets", "protonets", "anil"],
)
@pytest.mark.parametrize(
    "kw",
    [{"compute_dtype": "bfloat16"}, {"task_chunk": 2},
     {"device_augment": common.DeviceAugment("rot90")}],
    ids=["bf16", "task_chunk", "device_augment"],
)
def test_learners_refuse_what_the_port_does_not_take(cls, kw, rng):
    """The options the port once refused here (bfloat16 compute, task
    chunks, on-device augmentation) are taken: every zoo learner builds
    with each and takes a finite train step, the augmented one on a batch
    that carries its quarter-turn operand. (The zoo learners run task by
    task or all at once whatever ``task_chunk`` says, as in JAX.)"""
    cfg = dataclasses.replace(port_config(zoo_config(False)), **kw)
    learner = cls(cfg)
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    batch = episode_batch(rng)
    if "device_augment" in kw:
        batch = (*batch, rng.randint(0, 4, size=(2, 5)).astype(np.int32))
    new_state, losses = learner.run_train_iter(state, batch, epoch=0)
    assert bool(torch.isfinite(losses["loss"]))
    assert int(new_state.iteration) == 1

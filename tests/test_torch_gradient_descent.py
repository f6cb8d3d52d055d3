"""The port's gradient-descent baseline against the JAX learner's, from the
same weights and episode batches (CPU, float32).

The config has 3 stages of 8 filters on 12x12 images, meta-batch 2,
5-way 1-shot with one target a class, 2 support steps a task, per-step BN
off (as the published gradient-descent config). "fused" is
``use_pallas_fused_norm``, ``fused_norm_train`` and ``fused_norm_pool``, as
the port's CLI runs them on the card: the 12x12 and 6x6 stages take the
pooled op, the 3x3 stage the one-level op. JAX runs its Pallas kernels in
interpret mode, the port the plain bodies of its Functions on the CPU.
Weights go across with ``convert.py``.

The helpers here serve the other learner files too
(tests/test_torch_matching_nets.py, test_torch_protonets.py,
test_torch_anil.py, test_torch_zoo_cli.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import (
    BackboneConfig as JBackboneConfig,
    GradientDescentLearner as JGradientDescentLearner,
    MAMLConfig as JMAMLConfig,
)
from howtotrainyourmamlpytorch_tpu.models.common import prepare_batch as jprepare_batch
from howtotrainyourmamlpytorch_tpu.ops import cross_entropy as jcross_entropy
from howtotrainyourmamlpytorch_tpu.utils import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    shared_state_from_numpy,
    tree_to_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    GDInferenceState,
    GradientDescentLearner,
)

from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    _adam_state,
    assert_tree_close,
    episode_batch,
    one_intra_op_thread,
    port_config,
)

SMALL = dict(num_stages=3, num_filters=8, num_classes=5, image_height=12,
             image_width=12)
FUSED = dict(use_pallas_fused_norm=True, fused_norm_train=True, fused_norm_pool=True)
# The bars of the loss, the first step's gradients and the logits (the
# serve bar of tests/test_torch_serve.py).
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
ITERS = 3


def zoo_config(fused: bool, **kw) -> JMAMLConfig:
    bb = dict(SMALL, **(FUSED if fused else {}))
    bb.update(kw.pop("backbone", {}))
    return JMAMLConfig(
        backbone=JBackboneConfig(**bb),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        **kw,
    )


def shared_state_numpy(jstate) -> tuple:
    """A JAX ``GDState``/``MatchingNetsState``/``ProtoNetsState`` in
    ``convert.shared_state_from_numpy``'s form."""
    adam = _adam_state(jstate.opt_state)
    return (
        jax.tree.map(np.asarray, jstate.theta),
        {k: tuple(np.asarray(a) for a in v) for k, v in jstate.bn_state.items()},
        (jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
         np.asarray(adam.count)),
        np.asarray(jstate.iteration),
    )


def zoo_pair(jlearner, learner, seed=5):
    """The JAX learner's initial state and the port's copy of it."""
    jstate = jlearner.init_state(jax.random.PRNGKey(seed))
    lr = float(jstate.opt_state.hyperparams["learning_rate"])
    state = shared_state_from_numpy(
        shared_state_numpy(jstate), learner.state_type, lr, "cpu"
    )
    return jstate, state


def gd_pair(jcfg):
    jlearner = JGradientDescentLearner(jcfg)
    learner = GradientDescentLearner(port_config(jcfg))
    return (jlearner, learner, *zoo_pair(jlearner, learner))


def theta_without_conv_biases(tree):
    """A theta tree (numpy) without the conv biases, which sit before
    batch norm: their true gradient is zero, so Adam moves them by up to
    the learning rate a step on rounding noise in either framework."""
    return {k: ({**v, "conv": {"weight": v["conv"]["weight"]}} if "conv" in v else v)
            for k, v in tree.items()}


def check_train_trajectory(jlearner, jstate, learner, state, rng, epoch=0):
    """``ITERS`` ``run_train_iter`` of both from the same state; returns
    both states at the end."""
    jlosses, losses = [], []
    for _ in range(ITERS):
        batch = episode_batch(rng)
        jstate, jm = jlearner.run_train_iter(jstate, batch, epoch)
        state, m = learner.run_train_iter(state, batch, epoch)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        assert set(m) == set(jm)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
        assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 0.0
        assert m["learning_rate"] == jm["learning_rate"]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert int(state.iteration) == int(jstate.iteration)
    return jstate, state


def device_batch(learner, state, batch):
    return learner._decode(learner._device_batch(state, batch))


def jax_batch(batch):
    return tuple(jnp.asarray(a) for a in jprepare_batch(batch))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_run_train_iter_matches_jax(fused, rng):
    """Three iterations of 2 tasks x (2 support + 1 target) Adam updates:
    losses at the loss bar, then theta at the gradient bar (the conv
    biases within the Adam steps' learning rate)."""
    jlearner, learner, jstate, state = gd_pair(zoo_config(fused))
    jstate, state = check_train_trajectory(jlearner, jstate, learner, state, rng)
    theta, jtheta = tree_to_numpy(state.theta), jax.tree.map(np.asarray, jstate.theta)
    assert_tree_close(theta_without_conv_biases(theta),
                      theta_without_conv_biases(jtheta), GRAD_RTOL, GRAD_ATOL)
    updates = ITERS * 2 * 3
    # Each framework's Adam moves a bias up to about the learning rate a
    # step, each its own way.
    assert_tree_close(theta, jtheta, 0, 2 * updates * learner.cfg.meta_learning_rate)
    assert int(state.opt_state.count) == int(_adam_state(jstate.opt_state).count) == updates


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_first_support_step_matches_jax(fused, rng):
    """Task 0's first support loss and its gradient over theta, the
    quantity the first of GD's Adam updates reads."""
    jlearner, learner, jstate, state = gd_pair(zoo_config(fused))
    batch = episode_batch(rng)
    xs, _, ys, _ = jax_batch(batch)

    def support_loss(theta):
        logits, _ = jlearner.backbone.apply(theta, jstate.bn_state, xs[0], 0)
        return jcross_entropy(logits, ys[0])

    jloss, jgrads = jax.value_and_grad(support_loss)(jstate.theta)
    pxs, _, pys, _ = device_batch(learner, state, batch)
    loss, _, _, grads = learner._task_step(state.theta, state.bn_state, pxs[:1], pys[:1])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_run_validation_iter_fine_tunes_and_reports_the_last_task(fused, rng):
    """Three eval iterations, each on the state the last returned. Eval
    fine-tunes by design: it returns a new state (theta moved, iteration
    counted) and leaves the one given as it was; its loss and accuracy are
    the last task's, its logits every task's."""
    jlearner, learner, jstate, state = gd_pair(zoo_config(fused))
    for i in range(ITERS):
        batch = episode_batch(rng, targets=3)
        held = tree_to_numpy(state.theta)
        jnew, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
        new, m, logits = learner.run_validation_iter(state, batch)
        assert set(m) == set(jm) == {"loss", "accuracy", "nonfinite"}
        assert logits.shape == (2, 15, 5) and not logits.requires_grad
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
        # The reported metrics are the last task's target pass.
        yt = torch.from_numpy(batch[3].reshape(2, -1)).long()
        last = torch.nn.functional.cross_entropy(logits[-1], yt[-1])
        assert float(m["loss"]) == pytest.approx(float(last), rel=1e-6)
        assert float(m["accuracy"]) == float((logits[-1].argmax(-1) == yt[-1]).float().mean())
        assert int(new.iteration) == int(jnew.iteration) == i + 1
        assert_tree_close(tree_to_numpy(state.theta), held, 0, 0)
        assert not np.array_equal(tree_to_numpy(new.theta)["linear"]["weight"],
                                  held["linear"]["weight"])
        jstate, state = jnew, new
    assert_tree_close(theta_without_conv_biases(tree_to_numpy(state.theta)),
                      theta_without_conv_biases(jax.tree.map(np.asarray, jstate.theta)),
                      GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_serve_matches_jax(masked, rng):
    """``serve_adapt`` (fresh Adam moments at the served learning rate)
    then ``serve_classify`` on one task; masked: two padded support rows
    carry ``support_mask == 0``."""
    jlearner, learner, jstate, state = gd_pair(zoo_config(False))
    xs, xt, ys, _ = episode_batch(rng, targets=3)
    xs, ys, xq = xs[0].reshape(5, 1, 12, 12), ys[0].reshape(5), xt[0].reshape(15, 1, 12, 12)
    mask = None
    if masked:
        xs = np.concatenate([xs, rng.rand(2, 1, 12, 12).astype(np.float32)])
        ys = np.concatenate([ys, [0, 1]])
        mask = np.asarray([1, 1, 1, 1, 1, 0, 0], np.float32)
    jistate = jlearner.inference_state(jstate)
    istate = learner.inference_state(state)
    assert isinstance(istate, GDInferenceState)
    assert float(istate.fine_tune_lr) == float(jistate.fine_tune_lr)
    t = torch.from_numpy
    if masked:
        jadapted = jlearner.serve_adapt_masked(jistate, jnp.asarray(xs), jnp.asarray(ys),
                                               jnp.asarray(mask))
        adapted = learner.serve_adapt_masked(istate, t(xs), t(ys), t(mask))
    else:
        jadapted = jlearner.serve_adapt(jistate, jnp.asarray(xs), jnp.asarray(ys))
        adapted = learner.serve_adapt(istate, t(xs), t(ys))
    jlogits = jlearner.serve_classify(jistate, jadapted, jnp.asarray(xq))
    logits = learner.serve_classify(istate, adapted, t(xq))
    assert logits.shape == (15, 5) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_load_inference_state_recomputes_the_fine_tune_lr(tmp_path):
    """A JAX checkpoint at iteration 7 of 2 an epoch: the serving state
    holds epoch 3's learning rate, as the JAX learner's does, and the
    checkpoint's parameters bit for bit."""
    jcfg = zoo_config(False, total_epochs=5, total_iter_per_epoch=2)
    jlearner, learner, jstate, state = gd_pair(jcfg)
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, jstate, {"current_iter": 7})
    jistate, _ = jlearner.load_inference_state(path)
    istate, exp = learner.load_inference_state(path, device="cpu")
    assert exp == {"current_iter": 7}
    assert isinstance(istate, GDInferenceState)
    assert float(istate.fine_tune_lr) == float(jistate.fine_tune_lr)
    assert float(istate.fine_tune_lr) == pytest.approx(learner._epoch_lr(3))
    assert_tree_close(tree_to_numpy(istate.theta),
                      jax.tree.map(np.asarray, jistate.theta), 0, 0)


def test_skip_policy_keeps_the_state_on_a_nonfinite_batch(rng):
    """``skip_nonfinite_updates``: a batch with a NaN pixel trips the
    sentinel and the state stays whole, the iteration counted; eval
    reports the trip without the skip."""
    jcfg = zoo_config(False, skip_nonfinite_updates=True)
    jlearner, learner, jstate, state = gd_pair(jcfg)
    batch = episode_batch(rng)
    batch[0][1, 2, 0, 0, 3, 3] = np.nan
    jnew, jm = jlearner.run_train_iter(jstate, batch, 0)
    new, m = learner.run_train_iter(state, batch, 0)
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 1.0
    assert int(new.iteration) == int(jnew.iteration) == 1
    assert_tree_close(tree_to_numpy(new.theta), tree_to_numpy(state.theta), 0, 0)
    _, vm, _ = learner.run_validation_iter(state, batch)
    assert float(vm["nonfinite"]) == 1.0


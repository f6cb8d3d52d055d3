"""The port's ``run_train_iter`` and ``run_validation_iter`` against the JAX
learner's over several iterations, from the same weights and episode
batches (CPU, float32). Config and helpers: tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
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

ITERS = 5


def _split_conv_biases(tree):
    """``(conv biases, the rest)`` of a theta tree (numpy leaves)."""
    biases = {k: v["conv"]["bias"] for k, v in tree.items() if k.startswith("conv")}
    rest = {
        k: ({**v, "conv": {"weight": v["conv"]["weight"]}} if k in biases else v)
        for k, v in tree.items()
    }
    return biases, rest


# Plain MAML, as 18 of the 38 experiment configs train it: per-step BN
# off, fixed inner learning rates, no multi-step loss; and the same with
# the norm's gamma and beta adapted in the inner loop.
PLAIN_MAML = dict(
    backbone={"per_step_bn_statistics": False},
    learnable_per_layer_per_step_inner_loop_learning_rate=False,
    use_multi_step_loss_optimization=False,
)
PLAIN_MAML_BN_INNER = dict(
    PLAIN_MAML,
    backbone={"per_step_bn_statistics": False,
              "enable_inner_loop_optimizable_bn_params": True},
)


@pytest.mark.parametrize(
    "epoch, settings",
    [(0, {}), (20, {}),
     (0, PLAIN_MAML), (20, PLAIN_MAML),
     (0, PLAIN_MAML_BN_INNER), (20, PLAIN_MAML_BN_INNER)],
    ids=["msl-second-order", "final-only-first-order",
         "plain-maml-second-order", "plain-maml-first-order",
         "plain-maml-bn-inner-second-order", "plain-maml-bn-inner-first-order"],
)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_run_train_iter_matches_jax(fused, epoch, settings, rng):
    """Losses of 5 meta-updates at the JAX test's loss bar, then theta and
    LSLR. Epoch 0 runs at second order (MSL under MAML++); epoch 20 runs
    past the MSL horizon at first order (order annealing to second order
    after epoch 25). The plain-MAML settings train the last step's target
    loss only, at fixed rates, with or without the norm's gamma and beta
    in the inner loop.

    Conv biases sit before batch norm and have a zero true gradient, so
    Adam moves them by up to the learning rate per step on rounding noise
    in either framework: they are held to 2 * iterations * meta_lr; the
    rest to the gradient bar."""
    _check_trajectory(fused, epoch, second_order=epoch == 0, rng=rng, **settings)


def test_final_only_second_order_matches_jax(rng):
    """Past the MSL horizon at second order: the flagship's setting from
    its epoch 10 on (plain norm; the fused ops' final-only pass is in the
    first-order case above)."""
    _check_trajectory(False, 20, second_order=True, rng=rng)


@pytest.mark.parametrize(
    "backbone",
    [{"norm_layer": "layer_norm"}, {"block_order": "norm_conv"},
     {"max_pooling": False}],
    ids=["layer-norm", "norm-conv", "stride2"],
)
def test_backbone_options_train_iter_matches_jax(backbone, rng):
    """The VGG's other options through 5 second-order MSL meta-updates,
    the fused flags on: the layer norm (its weight frozen by outer Adam as
    in JAX), the norm of the stage input (no fused site) and stride-2 convs
    with a global average pool (the fused norm unpooled)."""
    _check_trajectory(True, 0, second_order=True, rng=rng, backbone=backbone)


def test_layer_norm_weight_stays_frozen(rng):
    """Outer Adam keeps the layer norm's weight at 1 (no moments, no
    update), as the JAX learner's mask does; its bias trains."""
    jlearner, jstate, learner, state = learner_pair(
        jax_config(False, backbone={"norm_layer": "layer_norm"})
    )
    norm = state.opt_state.mu["theta"]["conv0"]["norm"]
    assert norm["weight"] is None and norm["bias"] is not None
    assert learner.trainable_mask({"theta": state.theta, "lslr": state.lslr})[
        "theta"]["conv1"]["norm"] == {"weight": False, "bias": True}
    new, _ = learner.run_train_iter(state, episode_batch(rng), epoch=0)
    for i in range(3):
        before, after = state.theta[f"conv{i}"]["norm"], new.theta[f"conv{i}"]["norm"]
        assert torch.equal(after["weight"], before["weight"])
        assert torch.equal(after["weight"], torch.ones_like(after["weight"]))
        assert not torch.equal(after["bias"], before["bias"])
    labels = jlearner._label_fn({"theta": jstate.theta, "lslr": jstate.lslr})
    assert labels["theta"]["conv1"]["norm"] == {"weight": "frozen", "bias": "trainable"}


def _check_trajectory(fused, epoch, second_order, rng, **settings):
    jcfg = jax_config(
        fused, first_order_to_second_order_epoch=-1 if second_order else 25,
        **settings,
    )
    jlearner, jstate, learner, state = learner_pair(jcfg)
    assert learner._use_second_order(epoch) == second_order
    jlosses, losses = [], []
    for _ in range(ITERS):
        batch = episode_batch(rng)
        jstate, jm = jlearner.run_train_iter(jstate, batch, epoch)
        state, m = learner.run_train_iter(state, batch, epoch)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
        assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 0.0
        assert {k: v for k, v in m.items() if isinstance(v, float)} == {
            k: v for k, v in jm.items() if isinstance(v, float)
        }
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert int(state.iteration) == int(jstate.iteration) == ITERS
    theta = tree_to_numpy(state.theta)
    jtheta = jax.tree.map(np.asarray, jstate.theta)
    biases, rest = _split_conv_biases(theta)
    jbiases, jrest = _split_conv_biases(jtheta)
    assert_tree_close(rest, jrest, GRAD_RTOL, GRAD_ATOL)
    assert_tree_close(biases, jbiases, 0, 2 * ITERS * learner.cfg.meta_learning_rate)
    assert_tree_close(tree_to_numpy(state.lslr), jstate.lslr, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"backbone": {"use_pallas_fused_norm": True}},
        {"eval_steps": 3},
    ],
    ids=["off", "fused-eval", "extra-eval-step"],
)
def test_run_validation_iter_matches_jax(kw, rng):
    """Eval logits, loss and accuracy; with ``use_pallas_fused_norm`` the
    one-level op and, on the even stages, the pooled op run (the eval
    gating of JAX); one more eval step than train steps reads the logits
    of the training step count. The state comes back unchanged."""
    jlearner, jstate, learner, state = learner_pair(jax_config(True, **kw))
    batch = episode_batch(rng, targets=3)
    _, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
    same, m, logits = learner.run_validation_iter(state, batch)
    assert same is state
    assert logits.shape == (2, 15, 5) and not logits.requires_grad
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL, atol=LOSS_ATOL
    )
    assert float(m["accuracy"]) == pytest.approx(float(jnp.asarray(jm["accuracy"])))

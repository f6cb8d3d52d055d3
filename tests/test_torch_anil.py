"""The port's ANIL learner against the JAX learner's, from the same weights
and episode batches (CPU, float32). ANIL is MAML with the inner loop on the
classifier head alone; the config is tests/test_torch_train.py's MAML++
one (per-step BN, LSLR, MSL, second order) at 8 filters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import ANILLearner as JANILLearner
from howtotrainyourmamlpytorch_tpu.utils import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    train_state_from_numpy,
    tree_to_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import ANILLearner
from howtotrainyourmamlpytorch_tpu_torch.utils import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map_with_path

from test_torch_gradient_descent import (
    LOGIT_ATOL,
    LOGIT_RTOL,
    LOSS_ATOL,
    LOSS_RTOL,
    theta_without_conv_biases,
)
from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    GRAD_ATOL,
    GRAD_RTOL,
    assert_tree_close,
    episode_batch,
    jax_config,
    jax_train_state_numpy,
    one_intra_op_thread,
    port_config,
)

ITERS = 3
FUSED = pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])


def anil_config(fused, **kw):
    return jax_config(fused, backbone={"num_filters": 8}, **kw)


def anil_pair(jcfg, seed=5):
    jlearner = JANILLearner(jcfg)
    jstate = jlearner.init_state(jax.random.PRNGKey(seed))
    learner = ANILLearner(port_config(jcfg))
    state = train_state_from_numpy(
        jax_train_state_numpy(jstate), jcfg.meta_learning_rate, "cpu"
    )
    return jlearner, jstate, learner, state


@pytest.mark.parametrize("epoch", [0, 20], ids=["msl-second-order", "final-only-first-order"])
@FUSED
def test_run_train_iter_matches_jax(fused, epoch, rng):
    """Three meta-updates: epoch 0 at second order through the head-only
    inner steps (MSL), epoch 20 past the MSL horizon at first order
    (second order from epoch 25). Losses at the loss bar, then theta
    without the conv biases (which sit before batch norm) and the LSLR
    rates at the gradient bar."""
    jcfg = anil_config(fused, first_order_to_second_order_epoch=-1 if epoch == 0 else 25)
    jlearner, jstate, learner, state = anil_pair(jcfg)
    jlosses, losses = [], []
    for _ in range(ITERS):
        batch = episode_batch(rng)
        jstate, jm = jlearner.run_train_iter(jstate, batch, epoch)
        state, m = learner.run_train_iter(state, batch, epoch)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    theta = tree_to_numpy(state.theta)
    jtheta = jax.tree.map(np.asarray, jstate.theta)
    assert_tree_close(theta_without_conv_biases(theta),
                      theta_without_conv_biases(jtheta), GRAD_RTOL, GRAD_ATOL)
    assert_tree_close(theta, jtheta, 0, 2 * ITERS * learner.cfg.meta_learning_rate)
    assert_tree_close(tree_to_numpy(state.lslr), jstate.lslr, GRAD_RTOL, GRAD_ATOL)


@FUSED
def test_meta_loss_and_grads_match_jax(fused, rng):
    """The first second-order meta-step's loss and gradients over theta and
    the head's LSLR rates; the outer gradient reaches the frozen body
    through every inner step's forward. (First order: the epoch-20
    trajectory above.)"""
    second_order = True
    jlearner, jstate, learner, state = anil_pair(anil_config(fused))
    batch = episode_batch(rng)
    jbatch = tuple(jnp.asarray(a) for a in jlearner._prepare_batch(batch))
    importance = np.asarray([0.3, 0.7], np.float32)
    outer = {"theta": jstate.theta, "lslr": jstate.lslr}
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(jlearner._meta_loss, has_aux=True), static_argnums=(4, 5),
    )(outer, jstate.bn_state, jbatch, jnp.asarray(importance), 2, second_order)
    loss, _, _, grads = learner._meta_grads(
        state, learner._device_batch(state, batch), torch.from_numpy(importance),
        second_order=second_order, final_only=False,
    )
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)
    assert float(grads["theta"]["conv0"]["conv"]["weight"].abs().max()) > 0


@FUSED
def test_run_validation_iter_matches_jax(fused, rng):
    """Three batches. Eval adapts the head at first order: logits at the
    logit bar, the state returned as given."""
    jlearner, jstate, learner, state = anil_pair(anil_config(fused))
    for _ in range(ITERS):
        batch = episode_batch(rng, targets=3)
        _, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
        same, m, logits = learner.run_validation_iter(state, batch)
        assert same is state
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("clip", [None, 10.0], ids=["no-clip", "clip"])
def test_lslr_and_checkpoint_hold_only_the_head_rows(clip, tmp_path):
    """The LSLR table has rows for ``linear/*`` alone; the checkpoint's
    paths and tree CRC are the JAX ANIL state's (MAML's masked layout), and
    an archive of either package loads in the other bit for bit."""
    jlearner, jstate, learner, state = anil_pair(anil_config(False, clip_grad_value=clip))
    rows = []
    tree_map_with_path(
        lambda path, a: a is None or rows.append(("/".join(path), tuple(a.shape))),
        state.lslr,
    )
    assert sorted(rows) == [("linear/bias", (3,)), ("linear/weight", (3,))]
    paths = [p for p, _ in learner._path_leaves(state)]
    lslr_paths = [p for p in paths if p.startswith("a:lslr;")]
    assert lslr_paths == ["a:lslr;d:linear;d:bias", "a:lslr;d:linear;d:weight"]
    assert ckpt.tree_crc32(paths) == jckpt._tree_fingerprint(jstate)
    jckpt.save_checkpoint(str(tmp_path / "train_model_0"), jstate, {"current_iter": 0})
    loaded, _ = learner.load_model(str(tmp_path), "train_model", 0, device="cpu")
    for (p, a), (_, b) in zip(learner._path_leaves(loaded), learner._path_leaves(state)):
        assert torch.equal(a, b), p
    learner.save_model(str(tmp_path / "train_model_1"), state, {"current_iter": 0})
    jloaded, _ = jlearner.load_model(str(tmp_path), "train_model", 1)
    for a, b in zip(jax.tree.leaves(jloaded), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serve_adapts_the_head_alone(rng):
    """``serve_adapt`` returns fast weights for the head only (the frozen
    body is ``None``), and with ``serve_classify`` matches the JAX learner
    task by task."""
    jlearner, jstate, learner, state = anil_pair(anil_config(True))
    xs, xt, ys, _ = episode_batch(rng, targets=3)
    xs, ys, xq = xs.reshape(2, 5, 1, 12, 12), ys.reshape(2, 5), xt.reshape(2, 15, 1, 12, 12)
    jistate = jlearner.inference_state(jstate)
    istate = learner.inference_state(state)
    fast = learner.serve_adapt(istate, torch.from_numpy(xs), torch.from_numpy(ys))
    assert fast["conv0"]["conv"] == {"weight": None, "bias": None}
    assert tuple(fast["linear"]["weight"].shape[:1]) == (2,)
    logits = learner.serve_classify(istate, fast, torch.from_numpy(xq))
    for t in range(2):
        jfast = jlearner.serve_adapt(jistate, jnp.asarray(xs[t]), jnp.asarray(ys[t]))
        jlogits = jlearner.serve_classify(jistate, jfast, jnp.asarray(xq[t]))
        np.testing.assert_allclose(logits[t].numpy(), np.asarray(jlogits),
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)

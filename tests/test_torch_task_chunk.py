"""``task_chunk`` in the port against the JAX package's (CPU, float32).

The port runs each chunk of tasks' forward and outer backward before the
next chunk's, the chunk's loss scaled by chunk/B and the gradients summed
(``models/maml.py``); JAX scans the chunks through one vmapped program
(``maml.py:802-872``). The per-task math is the same; the sums are
reassociated.

Bars: the loss at rtol 1e-5 (tests/test_task_chunk.py:107); the
meta-gradient against JAX's chunked one at the repo's port-against-JAX
grad bar (rtol 1e-3, atol 1e-5, tests/test_torch_train.py), the bar the
port meets against JAX unchunked too; against the port's own full batch at
JAX's reassociation bar, rtol 2e-5, atol 1e-7 (tests/test_task_chunk.py:98).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLConfig, MAMLFewShotLearner

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
    port_config,
)

TASKS = 4
# JAX's reassociation bar, chunked against the full batch.
CHUNK_RTOL, CHUNK_ATOL = 2e-5, 1e-7


def _jax_meta_grads(jlearner, jstate, batch, importance, second_order, final_only):
    jbatch = tuple(jnp.asarray(a) for a in jlearner._prepare_batch(batch))
    outer = {"theta": jstate.theta, "lslr": jstate.lslr}
    (loss, aux), grads = jax.value_and_grad(
        lambda o: jlearner._meta_loss(
            o, jstate.bn_state, jbatch, jnp.asarray(importance), 2,
            second_order, None, final_only,
        ),
        has_aux=True,
    )(outer)
    return loss, aux, grads


def _port_meta_grads(learner, state, batch, importance, second_order, final_only):
    return learner._meta_grads(
        state, learner._device_batch(state, batch), torch.from_numpy(importance),
        second_order=second_order, final_only=final_only,
    )


@pytest.mark.parametrize("final_only", [False, True], ids=["msl", "final_only"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_chunked_meta_grads_match_jax(fused, final_only, rng):
    """Second order, 4 tasks in chunks of 2: loss, accuracy, meta-gradient
    and the task-averaged BN state against JAX's chunked scan; and against
    the port's own full batch at JAX's reassociation bar."""
    jcfg = jax_config(fused, task_chunk=2)
    jlearner, jstate, learner, state = learner_pair(jcfg)
    batch = episode_batch(rng, tasks=TASKS)
    importance = np.asarray([0.3, 0.7], np.float32)
    jloss, jaux, jgrads = _jax_meta_grads(
        jlearner, jstate, batch, importance, True, final_only
    )
    loss, accuracy, bn_state, grads = _port_meta_grads(
        learner, state, batch, importance, True, final_only
    )
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert float(accuracy) == pytest.approx(float(jnp.mean(jaux["accuracy"])))
    assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)
    jbn = jax.tree.map(lambda s: np.asarray(jnp.mean(s, axis=0)), jaux["bn_state"])
    for k in jbn:
        for a, b in zip(bn_state[k], jbn[k]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)

    full = MAMLFewShotLearner(dataclasses.replace(learner.cfg, task_chunk=0))
    f_loss, f_acc, f_bn, f_grads = _port_meta_grads(
        full, state, batch, importance, True, final_only
    )
    np.testing.assert_allclose(float(loss), float(f_loss), rtol=1e-5, atol=1e-6)
    assert float(accuracy) == float(f_acc)
    assert_tree_close(tree_to_numpy(grads), tree_to_numpy(f_grads),
                      CHUNK_RTOL, CHUNK_ATOL)


def test_chunked_training_tracks_the_full_batch(rng):
    """Three chunked meta-updates against three of the full batch from one
    state: losses at rtol 1e-5, as tests/test_task_chunk.py holds JAX's;
    and an eval episode's logits and loss, chunked against JAX's chunked
    eval."""
    jcfg = jax_config(True, task_chunk=2)
    jlearner, jstate, chunked, state = learner_pair(jcfg)
    full = MAMLFewShotLearner(dataclasses.replace(chunked.cfg, task_chunk=0))
    sc = sf = state
    for _ in range(3):
        batch = episode_batch(rng, tasks=TASKS)
        sc, lc = chunked.run_train_iter(sc, batch, epoch=0)
        sf, lf = full.run_train_iter(sf, batch, epoch=0)
        np.testing.assert_allclose(float(lc["loss"]), float(lf["loss"]),
                                   rtol=1e-5, atol=1e-6)
    batch = episode_batch(rng, tasks=TASKS)
    _, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
    _, m, logits = chunked.run_validation_iter(state, batch)
    assert logits.shape == (TASKS, 5, 5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunk_at_least_the_task_count_is_the_full_batch(chunk, rng):
    """A chunk of at least B tasks runs the full batch: the same bits."""
    jcfg = jax_config(True)
    _, _, full, state = learner_pair(jcfg)
    big = MAMLFewShotLearner(dataclasses.replace(full.cfg, task_chunk=chunk))
    batch = episode_batch(rng, tasks=TASKS)
    sf, lf = full.run_train_iter(state, batch, epoch=0)
    sb, lb = big.run_train_iter(state, batch, epoch=0)
    assert torch.equal(lf["loss"], lb["loss"])
    for a, b in zip(jax.tree.leaves(tree_to_numpy(sf.theta)),
                    jax.tree.leaves(tree_to_numpy(sb.theta))):
        np.testing.assert_array_equal(a, b)


def test_chunk_must_divide_the_task_count(rng):
    """A chunk that does not divide B raises at the step, train and eval,
    as JAX's does at trace time; a negative chunk is refused by the
    config."""
    learner = MAMLFewShotLearner(port_config(jax_config(False, task_chunk=3)))
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    batch = episode_batch(rng, tasks=TASKS)
    with pytest.raises(ValueError, match="divide"):
        learner.run_train_iter(state, batch, epoch=0)
    with pytest.raises(ValueError, match="divide"):
        learner.run_validation_iter(state, batch)
    with pytest.raises(ValueError, match="task_chunk"):
        MAMLConfig(task_chunk=-1)

"""The port's MAML++ meta-training step against the JAX learner's, from the
same weights and episode batches (CPU, float32).

The config has 3 stages of 4 filters on 12x12 images: the pre-pool stages
are 12x12 and 6x6 (even: with ``fused_norm_pool`` the pooled op runs
there) and 3x3 (odd: the any-order op and a separate pool). Per-step BN
over 2 inner steps, LSLR, meta-batch 2, 5-way. "fused" is
``fused_norm_train=True, fused_norm_pool=True``: JAX runs its Pallas
kernels in interpret mode, the port the plain bodies of its Functions on
the CPU. Weights go across with ``convert.py``.

The trajectories of ``run_train_iter`` and ``run_validation_iter`` are in
tests/test_torch_train_iter.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import (
    BackboneConfig as JBackboneConfig,
    MAMLConfig as JMAMLConfig,
    MAMLFewShotLearner as JLearner,
)
from howtotrainyourmamlpytorch_tpu.models import common as jcommon
from howtotrainyourmamlpytorch_tpu.models import maml as jmaml
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
    tree_to_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    BackboneConfig,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models import common, maml
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's CPU tests run tensors of a few kilobytes through thousands
    of small ops. With several test workers on the same cores, each op's
    intra-op thread pool then waits on the others' (one launch-count test
    took 654 s against 17 s, six at a time); one thread a worker keeps each
    op on its own core. Modules that import this fixture get it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(num_stages=3, num_filters=4, per_step_bn_statistics=True,
             num_steps=2, num_classes=5, image_height=12, image_width=12)
# The bar of tests/test_pallas_fused_norm_ho.py:346-350.
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5


def jax_config(fused: bool, **kw) -> JMAMLConfig:
    bb = dict(SMALL, fused_norm_train=fused, fused_norm_pool=fused)
    bb.update(kw.pop("backbone", {}))
    return JMAMLConfig(
        backbone=JBackboneConfig(**bb),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=kw.pop("eval_steps", 2),
        **kw,
    )


def port_config(jcfg: JMAMLConfig) -> MAMLConfig:
    shared = {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(MAMLConfig) if f.name != "backbone"
    }
    return MAMLConfig(
        backbone=BackboneConfig(**dataclasses.asdict(jcfg.backbone)), **shared
    )


def _adam_state(opt_state) -> optax.ScaleByAdamState:
    (adam,) = [
        s for s in jax.tree.leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)
        ) if isinstance(s, optax.ScaleByAdamState)
    ]
    return adam


def _moments(tree):
    """optax moments -> numpy, ``MaskedNode`` (a frozen leaf) -> ``None``."""
    masked = lambda a: isinstance(a, optax.MaskedNode)  # noqa: E731
    return jax.tree.map(
        lambda a: None if masked(a) else np.asarray(a), tree, is_leaf=masked
    )


def bn_tuples(bn):
    """A BN-state tree with its ``BatchNormState``s as plain tuples, at any
    depth (the VGG's one level, ResNet-12's two)."""
    if isinstance(bn, dict):
        return {k: bn_tuples(v) for k, v in bn.items()}
    return tuple(bn)


def jax_train_state_numpy(jstate) -> tuple:
    """A JAX ``TrainState`` in ``convert.train_state_from_numpy``'s form."""
    theta, lslr, bn = jax.tree.map(
        np.asarray, (jstate.theta, jstate.lslr, jstate.bn_state)
    )
    adam = _adam_state(jstate.opt_state)
    return (
        theta, lslr, bn_tuples(bn),
        (_moments(adam.mu), _moments(adam.nu), np.asarray(adam.count)),
        np.asarray(jstate.iteration),
    )


def learner_pair(jcfg, seed=5):
    """JAX learner and state, the port's learner and the same state."""
    jlearner = JLearner(jcfg)
    jstate = jlearner.init_state(jax.random.PRNGKey(seed))
    learner = MAMLFewShotLearner(port_config(jcfg))
    state = train_state_from_numpy(
        jax_train_state_numpy(jstate), jcfg.meta_learning_rate, "cpu"
    )
    return jlearner, jstate, learner, state


def episode_batch(rng, tasks=2, targets=1, hw=12):
    """``(B, N, K, C, H, W)`` images in [0, 1) and their labels."""
    xs = rng.rand(tasks, 5, 1, 1, hw, hw).astype(np.float32)
    xt = rng.rand(tasks, 5, targets, 1, hw, hw).astype(np.float32)
    ys = np.tile(np.arange(5)[None, :, None], (tasks, 1, 1))
    yt = np.tile(np.arange(5)[None, :, None], (tasks, 1, targets))
    return xs, xt, ys, yt


def assert_tree_close(ours, theirs, rtol, atol, path=()):
    """Matched by key; ``None`` must sit at the same positions."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            assert_tree_close(ours[k], theirs[k], rtol, atol, path + (k,))
    elif theirs is None:
        assert ours is None, path
    else:
        np.testing.assert_allclose(
            np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol,
            err_msg=str(path),
        )


@pytest.mark.parametrize("second_order", [True, False], ids=["second", "first"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_meta_loss_and_grads_match_jax(fused, second_order, rng):
    jlearner, jstate, learner, state = learner_pair(jax_config(fused))
    batch = episode_batch(rng)
    jbatch = tuple(jnp.asarray(a) for a in jlearner._prepare_batch(batch))
    importance = np.asarray([0.3, 0.7], np.float32)
    outer = {"theta": jstate.theta, "lslr": jstate.lslr}
    (jloss, jaux), jgrads = jax.jit(
        jax.value_and_grad(jlearner._meta_loss, has_aux=True),
        static_argnums=(4, 5),
    )(outer, jstate.bn_state, jbatch, jnp.asarray(importance), 2, second_order)
    loss, accuracy, bn_state, grads = learner._meta_grads(
        state, learner._device_batch(state, batch), torch.from_numpy(importance),
        second_order=second_order, final_only=False,
    )
    np.testing.assert_allclose(
        float(loss), float(jloss), rtol=LOSS_RTOL, atol=LOSS_ATOL
    )
    assert float(accuracy) == pytest.approx(float(jnp.mean(jaux["accuracy"])))
    assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)
    jbn = jax.tree.map(lambda s: np.asarray(jnp.mean(s, axis=0)), jaux["bn_state"])
    for k in jbn:
        for a, b in zip(bn_state[k], jbn[k]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)


def test_remat_inner_steps_gives_the_same_loss_and_grads(rng):
    """Each inner step under torch.utils.checkpoint recomputes its
    activations in the outer backward: same loss, same grads."""
    jcfg = jax_config(True)
    batch = episode_batch(rng)
    results = []
    for remat in (True, False):
        learner = MAMLFewShotLearner(
            port_config(dataclasses.replace(jcfg, remat_inner_steps=remat))
        )
        state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
        results.append(learner._meta_grads(
            state, learner._device_batch(state, batch),
            torch.tensor([0.5, 0.5]), second_order=True, final_only=False,
        ))
    (loss_a, _, _, grads_a), (loss_b, _, _, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    assert_tree_close(tree_to_numpy(grads_a), tree_to_numpy(grads_b), 0, 1e-7)


def test_schedules_match_jax_bitwise():
    """Derivative-order annealing, the MSL importance vectors (train and
    eval) and the cosine LR, epoch by epoch."""
    for steps, msl_epochs in ((2, 10), (5, 10), (5, 3)):
        for epoch in range(0, 14):
            np.testing.assert_array_equal(
                maml.per_step_loss_importance(epoch, steps, msl_epochs),
                jmaml.per_step_loss_importance(epoch, steps, msl_epochs),
            )
    np.testing.assert_array_equal(
        maml.final_step_importance(3, 1), jmaml.final_step_importance(3, 1)
    )
    for kw in ({}, {"eval_steps": 3}, {"use_multi_step_loss_optimization": False}):
        jcfg = jax_config(False, first_order_to_second_order_epoch=2,
                          multi_step_loss_num_epochs=4, total_epochs=9, **kw)
        jlearner, learner = JLearner(jcfg), MAMLFewShotLearner(port_config(jcfg))
        np.testing.assert_array_equal(
            learner._eval_importance(), jlearner._eval_importance()
        )
        for epoch in range(12):
            assert learner._use_second_order(epoch) == jlearner._use_second_order(epoch)
            np.testing.assert_array_equal(
                learner._train_importance(epoch), jlearner._train_importance(epoch)
            )
            assert learner._epoch_lr(epoch) == jlearner._epoch_lr(epoch)
    for args in ((0, 1e-3, 1e-5, 100), (37, 1e-3, 1e-5, 100), (150, 0.01, 0.0, 100)):
        assert common.cosine_epoch_lr(*args) == jcommon.cosine_epoch_lr(*args)


def test_adam_with_clip_matches_optax():
    """Three steps of the injected-LR Adam, +-10 clip first, against
    optax's ``make_injected_adam`` on the same gradients (the second and
    third exceed the clip, so an unclipped Adam would differ)."""
    rng = np.random.RandomState(1)
    params = {"w": rng.randn(6).astype(np.float32), "b": rng.randn(2).astype(np.float32)}
    grads = [
        {k: (scale * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
        for scale in (1.0, 40.0, 15.0)
    ]
    jtx = jcommon.make_injected_adam(1e-3, 10.0)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    tx = common.make_injected_adam(1e-3, 10.0)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = tx.init(tparams)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1)
        jstate = jcommon.set_injected_lr(jstate, lr)
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = common.set_injected_lr(tstate, lr)
        tparams, tstate = tx.step(
            tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tstate
        )
    for k in params:
        np.testing.assert_allclose(
            tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7
        )
    assert int(tstate.count) == 3


def test_imagenet_dataset_name_clips_the_meta_gradient(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text('{"dataset_name": "mini_imagenet_full_size"}')
    assert load_maml_config(str(path)).clip_grad_value == 10.0
    path.write_text('{"dataset_name": "omniglot_dataset"}')
    assert load_maml_config(str(path)).clip_grad_value is None
    learner = MAMLFewShotLearner(
        port_config(jax_config(False, clip_grad_value=10.0))
    )
    assert learner.tx.clip_grad_value == 10.0


def test_frozen_leaves_stay_unchanged(rng):
    """Frozen gamma, beta and LSLR get no Adam moments and no update, as
    optax.set_to_zero leaves them; the rest moves."""
    jcfg = jax_config(
        True, learnable_bn_gamma=False, learnable_bn_beta=False,
        learnable_per_layer_per_step_inner_loop_learning_rate=False,
    )
    learner = MAMLFewShotLearner(port_config(jcfg))
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    assert state.opt_state.mu["theta"]["conv0"]["norm"] == {"gamma": None, "beta": None}
    assert all(v is None for v in jax.tree.leaves(
        state.opt_state.mu["lslr"], is_leaf=lambda x: x is None
    ))
    new, _ = learner.run_train_iter(state, episode_batch(rng), epoch=0)
    for i in range(3):
        for k in ("gamma", "beta"):
            key = f"conv{i}"
            assert torch.equal(new.theta[key]["norm"][k], state.theta[key]["norm"][k])
        assert torch.equal(new.lslr[f"conv{i}"]["conv"]["weight"],
                           state.lslr[f"conv{i}"]["conv"]["weight"])
    assert not torch.equal(new.theta["linear"]["weight"], state.theta["linear"]["weight"])
    # The JAX learner leaves the same positions without moments.
    jstate = JLearner(jcfg).init_state(jax.random.PRNGKey(0))
    mu = _moments(_adam_state(jstate.opt_state).mu)
    assert mu["theta"]["conv0"]["norm"] == {"gamma": None, "beta": None}


@pytest.mark.parametrize("skip", [True, False])
def test_skip_nonfinite_updates_keeps_the_state(skip, rng):
    jcfg = jax_config(True, skip_nonfinite_updates=skip)
    learner = MAMLFewShotLearner(port_config(jcfg))
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    xs, xt, ys, yt = episode_batch(rng)
    xs[0, 0, 0, 0, 0, 0] = np.nan
    new, losses = learner.run_train_iter(state, (xs, xt, ys, yt), epoch=0)
    assert float(losses["nonfinite"]) == 1.0
    assert int(new.iteration) == 1
    weight = new.theta["linear"]["weight"]
    if skip:
        for a, b in zip(jax.tree.leaves(tree_to_numpy(new[:4])),
                        jax.tree.leaves(tree_to_numpy(state[:4]))):
            np.testing.assert_array_equal(a, b)
    else:
        assert not torch.isfinite(weight).all()
    # A finite batch trips nothing.
    _, losses = learner.run_train_iter(state, episode_batch(rng), epoch=0)
    assert float(losses["nonfinite"]) == 0.0


def test_train_state_round_trip(rng):
    """JAX TrainState -> numpy -> port -> numpy is the identity, frozen
    positions included; a port state after a step goes back the same way."""
    jcfg = jax_config(True, learnable_bn_beta=False)
    jlearner, jstate, learner, state = learner_pair(jcfg)
    tree = jax_train_state_numpy(jstate)
    back = train_state_to_numpy(state)
    assert_tree_close(back[0], tree[0], 0, 0)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert back[3][0]["theta"]["conv0"]["norm"]["beta"] is None
    new, _ = learner.run_train_iter(state, episode_batch(rng), epoch=0)
    again = train_state_from_numpy(train_state_to_numpy(new), 1e-3, "cpu")
    jax.tree.map(np.testing.assert_array_equal, train_state_to_numpy(again),
                 train_state_to_numpy(new))
    assert int(again.iteration) == 1 and int(again.opt_state.count) == 1


def test_unported_options_raise():
    """task_chunk and device_augment build (each is held to JAX in its own
    file); the values JAX refuses raise as there."""
    assert MAMLFewShotLearner(MAMLConfig(task_chunk=2)).cfg.task_chunk == 2
    augment = common.DeviceAugment("rot90")
    assert MAMLFewShotLearner(MAMLConfig(device_augment=augment)).cfg.device_augment == augment
    with pytest.raises(ValueError, match="collective_fusion"):
        MAMLConfig(collective_fusion="ring")
    with pytest.raises(ValueError, match="task_chunk"):
        MAMLConfig(task_chunk=-1)

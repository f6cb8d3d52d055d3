"""The port's ResNet-12 backbone and its MAML++ learner against the JAX
package's (CPU, float32).

The backbone runs 28x28 binary images through narrow stages (4, 4, 8, 8),
so the stages pass through 28 -> 14 -> 7 -> 3 -> 1, the odd pool included;
JAX's fused variants run the Pallas kernels in interpret mode at slope
0.1, the port the plain bodies of its Functions. The learner runs 16x16
images, 2 tasks and 2 inner steps with per-step BN, LSLR and MSL; its
weights go across with ``convert.py``. The launch counts of the Omniglot
ResNet-12 JSON's train and eval iterations are counted here, at narrow
width, and held to the counts ``chip_smoke.py`` holds its card run to.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import MAMLConfig as JMAMLConfig
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.models.backbone import BackboneConfig as JBackboneConfig
from howtotrainyourmamlpytorch_tpu.models.resnet import ResNet12Backbone as JResNet
from howtotrainyourmamlpytorch_tpu.ops import cross_entropy as j_cross_entropy
from howtotrainyourmamlpytorch_tpu.ops import max_pool2d as j_max_pool2d
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    bn_state_from_numpy,
    inference_state_from_numpy,
    inference_state_to_numpy,
    train_state_from_numpy,
    tree_from_numpy,
    tree_to_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    BackboneConfig,
    MAMLFewShotLearner,
    ResNet12Backbone,
    build_backbone,
)
from howtotrainyourmamlpytorch_tpu_torch.models import resnet
from howtotrainyourmamlpytorch_tpu_torch.models.backbone import leaky_relu
from howtotrainyourmamlpytorch_tpu_torch.ops.losses import cross_entropy, nll
from howtotrainyourmamlpytorch_tpu_torch.ops.norm import BatchNormState
from howtotrainyourmamlpytorch_tpu_torch.ops.pool import max_pool2d
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

import chip_smoke
from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_ATOL,
    LOSS_RTOL,
    _adam_state,
    _moments,
    assert_tree_close,
    bn_tuples,
    episode_batch,
    jax_train_state_numpy,
    one_intra_op_thread,
    port_config,
)
from test_torch_zoo_launches import FUSED, counted  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
# Gradients of leaves the loss is invariant to: rounding noise, up to
# 1.4e-5 seen in either framework at these shapes.
INVARIANT_ATOL = 1e-4
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-5
NET = dict(architecture="resnet12", resnet_widths=(4, 4, 8, 8),
           per_step_bn_statistics=True, num_steps=2, num_classes=5,
           image_height=28, image_width=28)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_JSON = os.path.join(
    REPO, "experiment_config_local",
    "omniglot_maml++-omniglot-resnet12_1_8_0.1_64_5_1.json",
)


def _numpy(tree):
    """JAX tree -> numpy arrays, NamedTuples as plain tuples."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return np.asarray(tree)


def _task_axis(tree):
    return tree_map(lambda a: a.unsqueeze(0), tree)


def _net(rng, **kw):
    """The JAX backbone with non-trivial per-step gamma/beta rows, its
    state, the port's backbone and both trees on the port's side."""
    jnet = JResNet(JBackboneConfig(**{**NET, **kw}))
    params, bn = jnet.init(jax.random.PRNGKey(3))
    for stage in (v for k, v in params.items() if k.startswith("res")):
        for unit in stage.values():
            norm = unit["norm"]
            norm["gamma"] = jnp.asarray(rng.rand(*norm["gamma"].shape) + 0.5, jnp.float32)
            norm["beta"] = jnp.asarray(rng.randn(*norm["beta"].shape) * 0.1, jnp.float32)
    net = build_backbone(BackboneConfig(**{**NET, **kw}))
    tparams = tree_from_numpy(_numpy(params), "cpu")
    tbn = bn_state_from_numpy(_numpy(bn), "cpu")
    return jnet, params, bn, net, tparams, tbn


def _assert_close(ours, theirs, rtol=RTOL, atol=ATOL):
    """Leaf by leaf, matched by key, ``BatchNormState``s field by field."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_close(ours[k], theirs[k], rtol, atol)
    elif isinstance(theirs, tuple):
        for a, b in zip(ours, theirs):
            _assert_close(a, b, rtol, atol)
    else:
        np.testing.assert_allclose(
            ours.detach().numpy(), np.asarray(theirs), rtol=rtol, atol=atol
        )


def _split_invariant(tree):
    """``(leaves the loss is invariant to, the rest)`` of a ResNet theta
    tree: every conv bias (a batch norm follows it) and stage 0's shortcut
    weight (one input channel: the batch norm removes its scale). Their
    true gradient is 0; what both frameworks compute is rounding noise,
    amplified by the batch norms of the 2x2 and 1x1 stages."""
    invariant, rest = {}, {}
    for k, v in tree.items():
        if not k.startswith("res"):
            rest[k] = v
            continue
        invariant[k] = {u: {"bias": unit["conv"]["bias"]} for u, unit in v.items()}
        rest[k] = {u: {**unit, "conv": {"weight": unit["conv"]["weight"]}}
                   for u, unit in v.items()}
        if k == "res0":
            invariant[k]["shortcut"]["weight"] = v["shortcut"]["conv"]["weight"]
            rest[k]["shortcut"] = {"norm": v["shortcut"]["norm"]}
    return invariant, rest


def _assert_leafwise_close(ours, theirs, rtol, atol, path=()):
    """Per leaf, ``max|ours - theirs| <= atol + rtol * max|theirs|``: the
    rounding of a sum over a leaf's inputs scales with the leaf, so an
    element near 0 in a leaf of O(1) elements carries the leaf's noise
    (chip_smoke.py holds meta-gradients in the same form)."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            _assert_leafwise_close(ours[k], theirs[k], rtol, atol, path + (k,))
    elif theirs is None:
        assert ours is None, path
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        assert a.shape == b.shape, path
        gap, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert gap <= atol + rtol * scale, (path, gap, scale)


def _assert_grads_close(grads, jgrads):
    """Gradient trees at the gradient bar, leaf-wise; the leaves the loss
    is invariant to (``_split_invariant``) to ``INVARIANT_ATOL`` of each
    other."""
    invariant, rest = _split_invariant(grads)
    jinvariant, jrest = _split_invariant(jgrads)
    _assert_leafwise_close(rest, jrest, GRAD_RTOL, GRAD_ATOL)
    assert_tree_close(invariant, jinvariant, 0, INVARIANT_ATOL)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------


def test_build_backbone_and_init_layout_match_jax():
    """``build_backbone`` gives the ResNet for ``resnet12``; the trees have
    JAX's paths and leaf shapes, the BN state two levels deep."""
    net = build_backbone(BackboneConfig(**NET))
    assert isinstance(net, ResNet12Backbone)
    params, bn = net.init(torch.Generator().manual_seed(0))
    jparams, jbn = JResNet(JBackboneConfig(**NET)).init(jax.random.PRNGKey(0))
    assert tree_map(lambda a: tuple(a.shape), params) == jax.tree.map(
        lambda a: a.shape, jparams
    )
    assert tree_map(lambda a: tuple(a.shape), bn_tuples(bn)) == jax.tree.map(
        lambda a: a.shape, bn_tuples(jbn)
    )
    assert params["res0"]["shortcut"]["conv"]["weight"].shape == (4, 1, 1, 1)
    assert BackboneConfig(**NET).feature_dim == 8
    assert BackboneConfig(architecture="resnet12", num_filters=64).feature_dim == 512
    mask = net.inner_loop_mask(params)
    assert mask["res2"]["conv1"] == {"conv": {"weight": True, "bias": True},
                                     "norm": {"gamma": False, "beta": False}}


@pytest.mark.parametrize("fused", ["off", "vjp", "jvp"])
def test_apply_and_inner_grad_match_jax(fused, rng):
    """Logits, the gradient of a support loss over every leaf and the
    evolved running statistics, at the first step and at a step past the
    per-step rows (clamped to the last)."""
    jnet, jparams, jbn, net, params, bn = _net(rng)
    x = (rng.rand(5, 1, 28, 28) > 0.5).astype(np.float32)
    y = np.arange(5) % 5

    def jloss(p, step):
        logits, new_bn = jnet.apply(p, jbn, jnp.asarray(x), step, fused=fused)
        return j_cross_entropy(logits, jnp.asarray(y)), (logits, new_bn)

    jvalue_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for step in (0, 2):
        (_, (jlogits, jnew)), jgrads = jvalue_and_grad(jparams, step)
        leaves = [a.clone().requires_grad_() for a in tree_leaves(params)]
        logits, new_bn = net.apply(
            _task_axis(tree_unflatten(params, leaves)), _task_axis(bn),
            torch.from_numpy(x)[None], step, fused=fused,
        )
        grads = torch.autograd.grad(cross_entropy(logits[0], torch.from_numpy(y)), leaves)
        np.testing.assert_allclose(
            logits[0].detach().numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL
        )
        _assert_grads_close(tree_to_numpy(tree_unflatten(params, grads)), _numpy(jgrads))
        _assert_close(tree_map(lambda a: a[0], new_bn), jnew)


@pytest.mark.parametrize("fused", ["off", "vjp", "jvp"])
def test_folded_tasks_equal_per_task_loop(fused, rng):
    """Two tasks with their own weights and images, folded into channels,
    give each task's own logits, running stats and inner gradient."""
    _, _, _, net, base, base_bn = _net(rng)
    tasks, n = 2, 5
    params = tree_map(
        lambda a: a.expand(tasks, *a.shape)
        + 0.05 * torch.from_numpy(rng.randn(tasks, *a.shape).astype(np.float32)),
        base,
    )
    bn = tree_map(lambda a: a.expand(tasks, *a.shape).clone(), base_bn)
    x = torch.from_numpy((rng.rand(tasks, n, 1, 28, 28) > 0.5).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, (tasks, n)))

    def run(p, b, xx, yy):
        leaves = [a.detach().clone().requires_grad_() for a in tree_leaves(p)]
        logits, new_bn = net.apply(tree_unflatten(p, leaves), b, xx, 1, fused=fused)
        grads = torch.autograd.grad(nll(logits, yy).mean(-1).sum(), leaves)
        return logits.detach(), new_bn, grads

    logits, new_bn, grads = run(params, bn, x, y)
    for t in range(tasks):
        one = lambda tree: tree_map(lambda a: a[t : t + 1], tree)  # noqa: E731
        lt, bt, gt = run(one(params), one(bn), x[t : t + 1], y[t : t + 1])
        torch.testing.assert_close(logits[t : t + 1], lt, rtol=RTOL, atol=ATOL)
        for a, b in zip(tree_leaves(one(new_bn)), tree_leaves(bt)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        for a, b in zip(grads, gt):
            torch.testing.assert_close(a[t : t + 1], b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [8, 7])
def test_residual_add_edges_match_jax(hw, rng):
    """The stage tail ``max_pool(leaky_relu(h + sc, 0.1))`` on {-1, 0, 1}
    operands: the sum is exactly 0 at many positions, where JAX's
    LeakyReLU takes the positive branch (gradient 1, not 0.1), and 2x2
    windows tie often, where the gradient goes to the first maximum in
    row-major order. Odd sizes drop the trailing row and column."""
    h = rng.randint(-1, 2, (2, 3, hw, hw)).astype(np.float32)
    sc = rng.randint(-1, 2, (2, 3, hw, hw)).astype(np.float32)
    sc[:, :, :4, :4] = -h[:, :, :4, :4]  # whole windows summing to 0
    t = rng.randn(2, 3, hw // 2, hw // 2).astype(np.float32)

    def jtail(a, b):
        return j_max_pool2d(jax.nn.leaky_relu(a + b, negative_slope=0.1), 2, 2)

    jout, vjp = jax.vjp(jtail, jnp.asarray(h), jnp.asarray(sc))
    jgrads = vjp(jnp.asarray(t))
    ht, st = (torch.from_numpy(a).requires_grad_() for a in (h, sc))
    out = max_pool2d(leaky_relu(ht + st, resnet.LEAKY_SLOPE), 2, 2)
    grads = torch.autograd.grad(out, (ht, st), torch.from_numpy(t))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    for a, b in zip(grads, jgrads):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The first window of each map is all zeros: its gradient is t itself.
    np.testing.assert_array_equal(grads[0][:, :, 0, 0].numpy(), t[:, :, 0, 0])


def test_zero_residual_sum_takes_positive_branch(rng):
    """Stage 0's conv2 and shortcut norms with gamma 0 and betas b and -b
    on channels 0 and 1: there ``h + sc`` is exactly 0 at every position,
    and the stage's LeakyReLU must take its positive branch, as JAX's does
    (slope 0.1 would scale the betas' gradients by 0.1). Channels 2 and 3
    stay as they were, so later stages see a well-conditioned input."""
    jnet, jparams, jbn, net, params, bn = _net(rng)
    b = rng.randn(2, 2).astype(np.float32)
    for name, sign in (("conv2", 1.0), ("shortcut", -1.0)):
        norm = params["res0"][name]["norm"]
        norm["gamma"][:, :2] = 0.0
        norm["beta"][:, :2] = torch.from_numpy(sign * b)
        jparams["res0"][name]["norm"] = {k: jnp.asarray(v.numpy()) for k, v in norm.items()}
    x = (rng.rand(5, 1, 28, 28) > 0.5).astype(np.float32)
    y = np.arange(5)
    jgrads = jax.jit(jax.grad(lambda p: j_cross_entropy(
        jnet.apply(p, jbn, jnp.asarray(x), 0, fused="off")[0], jnp.asarray(y)
    )))(jparams)
    leaves = [a.clone().requires_grad_() for a in tree_leaves(params)]
    logits, _ = net.apply(_task_axis(tree_unflatten(params, leaves)), None,
                          torch.from_numpy(x)[None], 0, fused="off")
    grads = tree_unflatten(params, torch.autograd.grad(
        cross_entropy(logits[0], torch.from_numpy(y)), leaves
    ))
    _assert_grads_close(tree_to_numpy(grads), _numpy(jgrads))
    # The betas enter the zero sum alike, and their gradient is not 0.
    dconv2 = grads["res0"]["conv2"]["norm"]["beta"][0, :2]
    torch.testing.assert_close(dconv2, grads["res0"]["shortcut"]["norm"]["beta"][0, :2])
    assert float(dconv2.abs().min()) > 1e-4


# ---------------------------------------------------------------------------
# Learner
# ---------------------------------------------------------------------------

LEARNER_NET = dict(NET, image_height=16, image_width=16)


def _jax_config(**kw):
    backbone = dict(LEARNER_NET, **kw.pop("backbone", {}))
    return JMAMLConfig(
        backbone=JBackboneConfig(**backbone),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        # Epoch 0 first order, epoch 1 second order, both under MSL.
        first_order_to_second_order_epoch=0,
        **kw,
    )


@pytest.fixture(scope="module")
def built():
    """The JAX learner and state (one per module: its programs compile
    once), the port's learner and the same state."""
    jcfg = _jax_config()
    jlearner = JLearner(jcfg)
    jstate = jlearner.init_state(jax.random.PRNGKey(5))
    # Non-uniform LSLR rates, so a wrong step index shows.
    jstate = jstate._replace(lslr=jax.tree.map(
        lambda a: a * jnp.asarray([1.0, 0.5, 2.0], a.dtype), jstate.lslr
    ))
    learner = MAMLFewShotLearner(port_config(jcfg))
    state = train_state_from_numpy(
        jax_train_state_numpy(jstate), jcfg.meta_learning_rate, "cpu"
    )
    return jlearner, jstate, learner, state


@pytest.fixture
def learners(built):
    """``built`` with a copy of the JAX state: its train step donates the
    state it is given."""
    jlearner, jstate, learner, state = built
    return jlearner, jax.tree.map(jnp.copy, jstate), learner, state


@pytest.mark.parametrize("epoch", [1, 0], ids=["msl-second-order", "msl-first-order"])
def test_run_train_iter_matches_jax(learners, epoch, rng):
    """Two meta-updates. The losses at the train-loss bar. After the first,
    the meta-gradient, through Adam's first moment (a tenth of it), at the
    gradient bar leaf-wise (``_assert_grads_close``), and the averaged BN
    state at the serve bar. Adam's normalised step turns a gradient within
    rounding of 0 into a step of the learning rate either way (the
    invariant leaves take one each step), so after the second update theta
    and the LSLR rates are held to 2 * iterations * meta_lr."""
    jlearner, jstate, learner, state = learners
    assert learner._use_second_order(epoch) == (epoch == 1)
    jlosses, losses = [], []
    for i in range(2):
        batch = episode_batch(rng, hw=16)
        jstate, jm = jlearner.run_train_iter(jstate, batch, epoch)
        state, m = learner.run_train_iter(state, batch, epoch)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
        if i:
            continue
        jmu = _moments(_adam_state(jstate.opt_state).mu)
        mu = tree_to_numpy(state.opt_state.mu)
        _assert_grads_close(mu["theta"], jmu["theta"])
        _assert_leafwise_close(mu["lslr"], jmu["lslr"], GRAD_RTOL, GRAD_ATOL)
        assert_tree_close(
            tree_to_numpy(bn_tuples(state.bn_state)),
            bn_tuples(jax.tree.map(np.asarray, jstate.bn_state)), RTOL, ATOL,
        )
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    step_bound = 4 * learner.cfg.meta_learning_rate
    assert_tree_close(tree_to_numpy(state.theta), jax.tree.map(np.asarray, jstate.theta),
                      0, step_bound)
    assert_tree_close(tree_to_numpy(state.lslr), jstate.lslr, 0, step_bound)


def _assert_tensor_close(ours, theirs, rtol, atol):
    """``max|ours - theirs| <= atol + rtol * max|theirs|`` over the whole
    tensor: after the inner steps through twelve batch norms, logits of
    one batch carry rounding noise of the batch's scale (up to 4.8e-5 on
    logits up to 2.5 seen), which an element near 0 fails against an
    elementwise bar."""
    gap = float(np.abs(np.asarray(ours) - np.asarray(theirs)).max())
    assert gap <= atol + rtol * float(np.abs(np.asarray(theirs)).max()), gap


def test_run_validation_iter_matches_jax(learners, rng):
    jlearner, jstate, learner, state = learners
    batch = episode_batch(rng, targets=3, hw=16)
    _, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
    same, m, logits = learner.run_validation_iter(state, batch)
    assert same is state
    _assert_tensor_close(logits.numpy(), jlogits, SERVE_RTOL, SERVE_ATOL)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_serve_adapt_and_classify_match_jax(learners, rng):
    """The port's serving half against the JAX learner's eval logits on the
    same episodes (the JAX package holds its ``serve_adapt`` and
    ``serve_classify`` bit for bit to its eval graph)."""
    jlearner, jstate, learner, state = learners
    xs, xt, ys, yt = episode_batch(rng, targets=3, hw=16)
    _, _, jlogits = jlearner.run_validation_iter(jstate, (xs, xt, ys, yt))
    istate = learner.inference_state(state)
    fast = learner.serve_adapt(istate, torch.from_numpy(xs[:, :, 0]),
                               torch.from_numpy(ys[:, :, 0]))
    logits = learner.serve_classify(
        istate, fast, torch.from_numpy(xt.reshape(2, 15, 1, 16, 16))
    )
    assert fast["res1"]["shortcut"]["norm"] == {"gamma": None, "beta": None}
    assert tuple(fast["res3"]["conv2"]["conv"]["weight"].shape) == (2, 8, 8, 3, 3)
    _assert_tensor_close(logits.numpy(), jlogits, SERVE_RTOL, SERVE_ATOL)


def test_nested_bn_state_round_trip(learners):
    """The two-level BN state through ``convert.py`` and back."""
    _, jstate, _, _ = learners
    tree = jax_train_state_numpy(jstate)[:3]
    istate = inference_state_from_numpy(tree, "cpu")
    assert isinstance(istate.bn_state["res3"]["shortcut"], BatchNormState)
    jax.tree.map(np.testing.assert_array_equal, inference_state_to_numpy(istate), tree)


# ---------------------------------------------------------------------------
# Launch counts and kernel shapes of the card run
# ---------------------------------------------------------------------------


def _json_learner(**overrides):
    """The ResNet JSON's learner at 2 filters (stages 2, 4, 8, 16) with
    the three fused flags; launches do not depend on width."""
    return MAMLFewShotLearner(load_maml_config(
        RESNET_JSON, cnn_num_filters=2, multi_step_loss_num_epochs=2,
        **FUSED, **overrides,
    ))


def _iteration(counted, learner, train, epoch=0, tasks=8):  # noqa: F811
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    batch = chip_smoke.train_batch(np.random.RandomState(0), tasks)
    for name in counted:
        counted[name] = 0
    if train:
        learner.run_train_iter(state, batch, epoch)
    else:
        learner.run_validation_iter(state, batch)
    return dict(counted)


def test_launches_per_iteration_are_what_chip_smoke_holds(counted):  # noqa: F811
    """The JSON's train iteration (remat on, as the CLI trains) under MSL
    and past its horizon, and its eval iteration: 8 fused sites a forward
    (conv0 and conv1 of 4 stages), no pooled op, so no ``bn_stats`` and no
    K5; ``bn_act_bwd`` for each eval inner gradient."""
    learner = _json_learner()
    assert learner.cfg.remat_inner_steps and learner.cfg.backbone.architecture == "resnet12"
    assert _iteration(counted, learner, True, 0) == chip_smoke.CLI_RESNET12_TRAIN
    assert _iteration(counted, learner, True, 2) == chip_smoke.CLI_RESNET12_TRAIN_FINAL
    assert _iteration(counted, learner, False) == chip_smoke.CLI_RESNET12_EVAL


def test_serve_launches_are_what_chip_smoke_holds(counted):  # noqa: F811
    """A serve dispatch of 4 tasks: 8 sites x (5 adapt + 1 classify)
    one-level forwards and 8 x 5 backwards."""
    learner = _json_learner()
    istate = learner.init_inference_state(torch.Generator().manual_seed(0), "cpu")
    for name in counted:
        counted[name] = 0
    xs = torch.zeros(4, 5, 1, 28, 28)
    fast = learner.serve_adapt(istate, xs, torch.arange(5).repeat(4, 1))
    learner.serve_classify(istate, fast, torch.zeros(4, 15, 1, 28, 28))
    assert counted == chip_smoke.RESNET_SERVE_LAUNCHES


def _fused_site_shapes(cfg, tasks, n):
    """The input shapes of the fused sites of one forward pass, from the
    config alone: conv0 and conv1 of each stage at the stage's folded
    width and its input size."""
    backbone = ResNet12Backbone(cfg.backbone)
    hw, shapes = cfg.backbone.image_height, []
    for width in backbone.widths:
        shapes += [(n, tasks * width, hw, hw)] * 2
        hw //= 2
    return shapes


def test_full_width_shapes_are_checked_in_chip_smoke():
    """Every (shape, slope) the ResNet path gives the kernels at the
    JSON's full width (train and eval: 8 tasks, 5 support and 5 target
    images; serve: 4 tasks, 5 support, 15 queries) is among those
    chip_smoke.py holds to the plain version; so are the stride-2 VGG's."""
    cfg = load_maml_config(RESNET_JSON)
    checked = set(chip_smoke.KERNEL_CASES)
    want = {(s, resnet.LEAKY_SLOPE) for s in _fused_site_shapes(cfg, 8, 5)}
    want |= {(s, resnet.LEAKY_SLOPE) for n in (5, 15)
             for s in _fused_site_shapes(cfg, 4, n)}
    assert (((5, 4096, 3, 3), 0.1) in want and ((5, 512, 28, 28), 0.1) in want)
    assert want <= checked, sorted(want - checked)
    flagship = load_maml_config(chip_smoke.FLAGSHIP, max_pooling=False)
    hw = [h for h, _ in flagship.backbone.stage_spatial_shapes()]
    assert hw == [14, 7, 4, 2]
    assert {((5, 512, h, h), 0.01) for h in hw} <= checked

"""The port's VGG backbone against the JAX package's, and its folded task
axis against a loop over tasks (CPU, float32).

The JAX backbone with ``fused="vjp"`` or ``"jvp"`` (and, with
``fused_norm_pool``, the pooled op on even stages) runs the Pallas kernels
in interpret mode; the port's runs the plain version of its Hopper kernels
on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models.backbone import (
    BackboneConfig as JBackboneConfig,
    VGGBackbone as JVGGBackbone,
)
from howtotrainyourmamlpytorch_tpu.ops import cross_entropy as j_cross_entropy
from howtotrainyourmamlpytorch_tpu_torch.convert import tree_from_numpy
from howtotrainyourmamlpytorch_tpu_torch.models.backbone import (
    BackboneConfig,
    VGGBackbone,
    build_backbone,
)
from howtotrainyourmamlpytorch_tpu_torch.ops.losses import cross_entropy, nll
from howtotrainyourmamlpytorch_tpu_torch.ops.norm import BatchNormState
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from test_torch_train import one_intra_op_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5

SMALL = dict(num_stages=2, num_filters=8, per_step_bn_statistics=True,
             num_steps=2, num_classes=5, image_height=8, image_width=8)
# 28 -> 14 -> 7 -> 3: the flagship's stage shapes, odd ones included.
ODD = dict(num_stages=4, num_filters=4, per_step_bn_statistics=True,
           num_steps=2, num_classes=5, image_height=28, image_width=28)
# The same with the pool fused into the norm on the even stages (28, 14).
ODD_POOL = dict(ODD, fused_norm_pool=True)
# The VGG's other options on SMALL: layer norm over each task's (C, H, W);
# the norm of the stage input before the conv (no fused site); stride-2
# convs (8 -> 4 -> 2) and a global average pool, the fused norm unpooled.
LAYER_NORM = dict(SMALL, norm_layer="layer_norm")
NORM_CONV = dict(SMALL, block_order="norm_conv")
STRIDE2 = dict(SMALL, max_pooling=False, fused_norm_pool=True)
CASES = [
    *((kw, kid, fused) for kid, kw in (("small", SMALL), ("odd-stages", ODD),
                                       ("odd-stages-pool", ODD_POOL))
      for fused in ("off", "vjp", "jvp")),
    (LAYER_NORM, "layer-norm", "off"), (NORM_CONV, "norm-conv", "off"),
    (NORM_CONV, "norm-conv", "jvp"),
    *((STRIDE2, "stride2", fused) for fused in ("off", "vjp", "jvp")),
]


def _numpy(tree):
    """JAX tree -> numpy arrays, NamedTuples as plain tuples."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return np.asarray(tree)


def _port_bn(tree):
    return {k: BatchNormState(*v) for k, v in tree.items()}


def _assert_tree_close(ours, theirs):
    """Leaf by leaf, matched by key (JAX flattens dicts in sorted order)."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_tree_close(ours[k], theirs[k])
        return
    np.testing.assert_allclose(
        ours.detach().numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL
    )


def _with_task_axis(tree):
    return tree_map(lambda a: a.unsqueeze(0), tree)


def _setup(kw, rng, n=5):
    jcfg = JBackboneConfig(**kw)
    jnet = JVGGBackbone(jcfg)
    params, bn = jnet.init(jax.random.PRNGKey(3))
    # Non-trivial per-step affine rows (or layer-norm weight and bias), so
    # the step select shows.
    for i in range(jcfg.num_stages):
        norm = params[f"conv{i}"]["norm"]
        for k, v in norm.items():
            scale, offset = (1.0, 0.5) if k in ("gamma", "weight") else (0.1, 0.0)
            noise = rng.rand(*v.shape) if offset else rng.randn(*v.shape)
            norm[k] = jnp.asarray(noise * scale + offset, jnp.float32)
    x = (rng.rand(n, 1, jcfg.image_height, jcfg.image_width) > 0.5).astype(np.float32)
    y = np.arange(n) % jcfg.num_classes
    net = VGGBackbone(BackboneConfig(**dataclasses.asdict(jcfg)))
    return jnet, params, bn, net, x, y


@pytest.mark.parametrize(
    "kw,fused", [(kw, fused) for kw, _, fused in CASES],
    ids=[f"{kid}-{fused}" for _, kid, fused in CASES],
)
def test_apply_and_inner_grad_match_jax(kw, fused, rng):
    jnet, jparams, jbn, net, x, y = _setup(kw, rng)
    params = tree_from_numpy(_numpy(jparams), "cpu")
    bn = _port_bn(tree_from_numpy(_numpy(jbn), "cpu"))

    def jloss(p, step):
        logits, new_bn = jnet.apply(p, jbn, jnp.asarray(x), step, fused=fused)
        return j_cross_entropy(logits, jnp.asarray(y)), (logits, new_bn)

    jvalue_and_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    for step in range(kw["num_steps"] + 1):  # the last step clamps
        (_, (jlogits, jnew)), jgrads = jvalue_and_grad(jparams, step)
        leaves = [a.clone().requires_grad_() for a in tree_leaves(params)]
        p = _with_task_axis(tree_unflatten(params, leaves))
        logits, new_bn = net.apply(
            p, _with_task_axis(bn), torch.from_numpy(x)[None], step, fused=fused
        )
        grads = torch.autograd.grad(
            cross_entropy(logits[0], torch.from_numpy(y)), leaves
        )
        np.testing.assert_allclose(
            logits[0].detach().numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL
        )
        _assert_tree_close(tree_unflatten(params, grads), jgrads)
        for k in jnew:
            for a, b in zip(new_bn[k], jnew[k]):
                np.testing.assert_allclose(
                    a[0].numpy(), np.asarray(b), rtol=RTOL, atol=ATOL
                )


@pytest.mark.parametrize("fused", ["off", "vjp", "jvp"])
def test_folded_tasks_equal_per_task_loop(fused, rng):
    """Three tasks with their own weights and images, folded into channels,
    give each task's own logits, running stats and inner gradient: the
    batch statistics never span tasks."""
    _check_folded_tasks(dict(SMALL, fused_norm_pool=True), fused, rng)


@pytest.mark.parametrize(
    "kw,fused", [(LAYER_NORM, "off"), (NORM_CONV, "off"), (STRIDE2, "jvp")],
    ids=["layer-norm", "norm-conv", "stride2"],
)
def test_folded_tasks_equal_per_task_loop_options(kw, fused, rng):
    """The same for the other options: the layer norm's statistics over
    each task's (C, H, W), the stage input's batch norm, the stride-2
    stages and their average pool stay within a task."""
    _check_folded_tasks(kw, fused, rng)


def _check_folded_tasks(kw, fused, rng):
    _, jparams, jbn, net, _, _ = _setup(kw, rng)
    tasks, n = 3, 5
    base = tree_from_numpy(_numpy(jparams), "cpu")
    params = tree_map(
        lambda a: a.expand(tasks, *a.shape)
        + 0.05 * torch.from_numpy(rng.randn(tasks, *a.shape).astype(np.float32)),
        base,
    )
    bn = tree_map(
        lambda a: a.expand(tasks, *a.shape).clone(),
        _port_bn(tree_from_numpy(_numpy(jbn), "cpu")),
    )
    x = torch.from_numpy((rng.rand(tasks, n, 1, 8, 8) > 0.5).astype(np.float32))
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


def test_unported_options_raise():
    """Lane padding builds on both backbones (48 -> 64 channels) and is
    refused with a layer norm or ``norm_conv``, as in JAX; unknown values
    and ResNet-12's unsupported ones raise as in JAX."""
    vgg = VGGBackbone(BackboneConfig(num_filters=48, lane_pad_channels=True))
    params, _ = vgg.init(torch.Generator().manual_seed(0))
    assert params["conv0"]["conv"]["weight"].shape[0] == 64
    resnet = build_backbone(BackboneConfig(architecture="resnet12", num_filters=48,
                                           lane_pad_channels=True))
    assert resnet.widths == (64, 128, 256, 384)
    with pytest.raises(ValueError, match="lane_pad_channels"):
        VGGBackbone(BackboneConfig(lane_pad_channels=True, norm_layer="layer_norm"))
    with pytest.raises(ValueError, match="batch_norm"):
        build_backbone(BackboneConfig(architecture="resnet12", norm_layer="layer_norm"))
    with pytest.raises(ValueError, match="stage widths"):
        build_backbone(BackboneConfig(architecture="resnet12", resnet_widths=(4, 6, 8)))
    with pytest.raises(ValueError, match="block_order"):
        VGGBackbone(BackboneConfig(block_order="sideways"))
    with pytest.raises(ValueError, match="architecture"):
        build_backbone(BackboneConfig(architecture="vit"))
    for kw in (LAYER_NORM, NORM_CONV, STRIDE2):
        VGGBackbone(BackboneConfig(**kw))
    net = VGGBackbone(BackboneConfig(**SMALL, fused_norm_pool=True))
    params, _ = net.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="sideways"):
        net.apply(
            _with_task_axis(params), None, torch.zeros(1, 2, 1, 8, 8), 0,
            fused="sideways",
        )


def test_init_layout_matches_jax():
    for kw in (SMALL, LAYER_NORM, NORM_CONV, STRIDE2):
        jparams, jbn = JVGGBackbone(JBackboneConfig(**kw)).init(jax.random.PRNGKey(0))
        params, bn = VGGBackbone(BackboneConfig(**kw)).init(
            torch.Generator().manual_seed(0)
        )
        shapes = tree_map(lambda a: tuple(a.shape), params)
        assert shapes == jax.tree.map(lambda a: a.shape, jparams)
        assert set(bn) == set(jbn)
        for k in jbn:
            assert [tuple(a.shape) for a in bn[k]] == [b.shape for b in jbn[k]]
        assert BackboneConfig(**kw).feature_dim == JBackboneConfig(**kw).feature_dim

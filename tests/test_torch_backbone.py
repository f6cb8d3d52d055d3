"""The port's VGG backbone against the JAX package's, and its folded task
axis against a loop over tasks (CPU, float32).

The JAX backbone with ``fused="vjp"`` runs the Pallas kernels in interpret
mode; the port's runs the plain version of its Hopper kernels on the CPU.
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
)
from howtotrainyourmamlpytorch_tpu_torch.ops.losses import cross_entropy, nll
from howtotrainyourmamlpytorch_tpu_torch.ops.norm import BatchNormState
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

RTOL, ATOL = 1e-4, 1e-5

SMALL = dict(num_stages=2, num_filters=8, per_step_bn_statistics=True,
             num_steps=2, num_classes=5, image_height=8, image_width=8)
# 28 -> 14 -> 7 -> 3: the flagship's stage shapes, odd ones included.
ODD = dict(num_stages=4, num_filters=4, per_step_bn_statistics=True,
           num_steps=2, num_classes=5, image_height=28, image_width=28)


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
    # Non-trivial per-step affine rows, so the step select shows.
    for i in range(jcfg.num_stages):
        norm = params[f"conv{i}"]["norm"]
        norm["gamma"] = jnp.asarray(rng.rand(*norm["gamma"].shape) + 0.5, jnp.float32)
        norm["beta"] = jnp.asarray(rng.randn(*norm["beta"].shape) * 0.1, jnp.float32)
    x = (rng.rand(n, 1, jcfg.image_height, jcfg.image_width) > 0.5).astype(np.float32)
    y = np.arange(n) % jcfg.num_classes
    net = VGGBackbone(BackboneConfig(**dataclasses.asdict(jcfg)))
    return jnet, params, bn, net, x, y


@pytest.mark.parametrize("fused", ["off", "vjp"])
@pytest.mark.parametrize("kw", [SMALL, ODD], ids=["small", "odd-stages"])
def test_apply_and_inner_grad_match_jax(kw, fused, rng):
    jnet, jparams, jbn, net, x, y = _setup(kw, rng)
    params = tree_from_numpy(_numpy(jparams), "cpu")
    bn = _port_bn(tree_from_numpy(_numpy(jbn), "cpu"))
    for step in range(kw["num_steps"] + 1):  # the last step clamps

        def jloss(p):
            logits, new_bn = jnet.apply(p, jbn, jnp.asarray(x), step, fused=fused)
            return j_cross_entropy(logits, jnp.asarray(y)), (logits, new_bn)

        (_, (jlogits, jnew)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            jparams
        )
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


@pytest.mark.parametrize("fused", ["off", "vjp"])
def test_folded_tasks_equal_per_task_loop(fused, rng):
    """Three tasks with their own weights and images, folded into channels,
    give each task's own logits, running stats and inner gradient: the
    batch statistics never span tasks."""
    _, jparams, jbn, net, _, _ = _setup(SMALL, rng)
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
    with pytest.raises(NotImplementedError, match="layer_norm"):
        VGGBackbone(BackboneConfig(norm_layer="layer_norm"))
    with pytest.raises(NotImplementedError, match="pooled"):
        VGGBackbone(BackboneConfig(fused_norm_pool=True))
    net = VGGBackbone(BackboneConfig(**SMALL))
    params, _ = net.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="second-order"):
        net.apply(
            _with_task_axis(params), None, torch.zeros(1, 2, 1, 8, 8), 0,
            fused="jvp",
        )


def test_init_layout_matches_jax():
    jparams, jbn = JVGGBackbone(JBackboneConfig(**SMALL)).init(jax.random.PRNGKey(0))
    params, bn = VGGBackbone(BackboneConfig(**SMALL)).init(
        torch.Generator().manual_seed(0)
    )
    shapes = tree_map(lambda a: tuple(a.shape), params)
    assert shapes == jax.tree.map(lambda a: a.shape, jparams)
    for k in jbn:
        assert [tuple(a.shape) for a in bn[k]] == [b.shape for b in jbn[k]]

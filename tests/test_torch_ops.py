"""The port's ops, inner loop, trees and wire codec against the JAX
package's, on the same numpy inputs (CPU, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu import inner_loop as j_inner
from howtotrainyourmamlpytorch_tpu.models import common as j_common
from howtotrainyourmamlpytorch_tpu.ops import (
    accuracy as j_accuracy,
    conv2d as j_conv2d,
    cross_entropy as j_cross_entropy,
    linear as j_linear,
    masked_cross_entropy as j_masked_cross_entropy,
    max_pool2d as j_max_pool2d,
)
from howtotrainyourmamlpytorch_tpu.ops.initializers import (
    xavier_uniform as j_xavier,
)
from howtotrainyourmamlpytorch_tpu.ops.norm import (
    batch_norm as j_batch_norm,
    init_batch_norm_state as j_init_bn,
)
from howtotrainyourmamlpytorch_tpu.utils import trees as j_trees
from howtotrainyourmamlpytorch_tpu_torch import inner_loop as t_inner
from howtotrainyourmamlpytorch_tpu_torch.models import common as t_common
from howtotrainyourmamlpytorch_tpu_torch.models.backbone import leaky_relu
from howtotrainyourmamlpytorch_tpu_torch.ops import initializers, losses
from howtotrainyourmamlpytorch_tpu_torch.ops.conv import conv2d
from howtotrainyourmamlpytorch_tpu_torch.ops.linear import linear
from howtotrainyourmamlpytorch_tpu_torch.ops.norm import (
    BatchNormState,
    batch_norm,
    init_batch_norm_state,
)
from howtotrainyourmamlpytorch_tpu_torch.ops.pool import max_pool2d
from howtotrainyourmamlpytorch_tpu_torch.utils import trees as t_trees
from howtotrainyourmamlpytorch_tpu_torch.utils.platform import resolve_device

T = torch.from_numpy


def close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "stride,padding,groups,cin", [(1, 1, 1, 3), (2, 0, 1, 1), (1, 1, 3, 6)]
)
def test_conv2d_matches_jax(stride, padding, groups, cin, rng):
    x = rng.randn(2, cin, 9, 9).astype(np.float32)
    w = rng.randn(6, cin // groups, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ours = conv2d(T(x), T(w), T(b), stride=stride, padding=padding, groups=groups)
    theirs = j_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=stride, padding=padding, groups=groups)
    close(ours, theirs, atol=1e-4)


def test_linear_matches_jax_per_task(rng):
    x = rng.randn(3, 4, 7).astype(np.float32)
    w = rng.randn(3, 5, 7).astype(np.float32)
    b = rng.randn(3, 5).astype(np.float32)
    ours = linear(T(x), T(w), T(b))
    for t in range(3):
        close(ours[t], j_linear(jnp.asarray(x[t]), jnp.asarray(w[t]),
                                jnp.asarray(b[t])))


@pytest.mark.parametrize("hw", [8, 7])
def test_max_pool_gradient_routing_on_binary_ties(hw, rng):
    """Binary images make 2x2 windows of equal values common; the gradient
    must go to the same element as lax.reduce_window's (the first max in
    row-major order). Odd sizes drop the trailing row/column."""
    x = (rng.rand(2, 3, hw, hw) > 0.5).astype(np.float32)
    x[:, :, :4, :4] = 1.0  # whole windows tied
    t = rng.randn(2, 3, hw // 2, hw // 2).astype(np.float32)
    xt = T(x).requires_grad_()
    out = max_pool2d(xt)
    (dx,) = torch.autograd.grad(out, xt, T(t))
    jout, vjp = jax.vjp(lambda a: j_max_pool2d(a, 2, 2), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(t))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))


def test_leaky_relu_gradient_at_zero_matches_jax():
    x = np.asarray([-2.0, -0.0, 0.0, 3.0], np.float32)
    xt = T(x).requires_grad_()
    (g,) = torch.autograd.grad(leaky_relu(xt).sum(), xt)
    jg = jax.grad(lambda a: jax.nn.leaky_relu(a, 0.01).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[2] == 1.0  # positive branch at exactly 0


def test_losses_match_jax(rng):
    logits = rng.randn(12, 5).astype(np.float32) * 3
    labels = rng.randint(0, 5, 12).astype(np.int32)
    mask = (rng.rand(12) > 0.3).astype(np.float32)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    close(losses.cross_entropy(T(logits), T(labels)), j_cross_entropy(jl, jy))
    close(
        losses.masked_cross_entropy(T(logits), T(labels), T(mask)),
        j_masked_cross_entropy(jl, jy, jnp.asarray(mask)),
    )
    close(losses.accuracy(T(logits), T(labels)), j_accuracy(jl, jy))


@pytest.mark.parametrize("per_step", [True, False])
def test_batch_norm_matches_jax_with_step_clamp(per_step, rng):
    steps = 3
    x = (rng.randn(4, 6, 5, 5) * 2 + 1).astype(np.float32)
    shape = (steps, 6) if per_step else (6,)
    gamma = (rng.rand(*shape) + 0.5).astype(np.float32)
    beta = rng.randn(*shape).astype(np.float32)
    jstate = j_init_bn(6, steps if per_step else None)
    tstate = init_batch_norm_state(6, steps if per_step else None)
    for step in range(steps + 2):  # steps >= S clamp to the last row
        jout, jstate = j_batch_norm(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), jstate, step)
        tout, tstate = batch_norm(T(x), T(gamma), T(beta), tstate, step)
        close(tout, jout)
        for a, b in zip(tstate, jstate):
            close(a, b)
    out, none = batch_norm(T(x), T(gamma), T(beta), None, 0)
    assert none is None and out.shape == x.shape


def test_xavier_uniform_bounds_and_generator():
    shape = (64, 32, 3, 3)
    limit = np.sqrt(6.0 / (32 * 9 + 64 * 9))
    w = initializers.xavier_uniform(torch.Generator().manual_seed(0), shape)
    again = initializers.xavier_uniform(torch.Generator().manual_seed(0), shape)
    assert w.shape == shape and torch.equal(w, again)
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.99 * limit
    # Same distribution as the JAX init: U(-limit, limit) with the same fans.
    jw = np.asarray(j_xavier(jax.random.PRNGKey(0), shape))
    assert np.abs(jw).max() <= limit and np.abs(jw).max() > 0.99 * limit


def test_lslr_matches_jax(rng):
    tree = {"a": {"w": rng.randn(3, 4).astype(np.float32)}, "b": None}
    grads = {"a": {"w": rng.randn(3, 4).astype(np.float32)}, "b": None}
    jtree = {"a": {"w": jnp.asarray(tree["a"]["w"])}, "b": None}
    jgrads = {"a": {"w": jnp.asarray(grads["a"]["w"])}, "b": None}
    jlslr = j_inner.init_lslr(jtree, 5, 0.1)
    tlslr = t_inner.init_lslr({"a": {"w": T(tree["a"]["w"])}, "b": None}, 5, 0.1)
    assert tlslr["b"] is None and tuple(tlslr["a"]["w"].shape) == (6,)
    close(tlslr["a"]["w"], jlslr["a"]["w"])
    tlslr["a"]["w"][2] = 0.37
    jlslr = {"a": {"w": jlslr["a"]["w"].at[2].set(0.37)}, "b": None}
    ours = t_inner.lslr_update(
        {"a": {"w": T(tree["a"]["w"])}, "b": None},
        {"a": {"w": T(grads["a"]["w"])}, "b": None}, tlslr, 2,
    )
    theirs = j_inner.lslr_update(jtree, jgrads, jlslr, 2)
    assert ours["b"] is None
    close(ours["a"]["w"], theirs["a"]["w"], rtol=0, atol=0)


def test_sgd_update_matches_jax(rng):
    w, g = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    ours = t_inner.sgd_update({"a": {"w": T(w)}, "b": None},
                              {"a": {"w": T(g)}, "b": None}, 0.3)
    theirs = j_inner.sgd_update({"a": {"w": jnp.asarray(w)}, "b": None},
                                {"a": {"w": jnp.asarray(g)}, "b": None}, 0.3)
    assert ours["b"] is None
    close(ours["a"]["w"], theirs["a"]["w"], rtol=0, atol=0)


@pytest.mark.parametrize("codec", [None, (1.0, None, None)], ids=["f32", "uint8"])
def test_prepare_batch_matches_jax(codec, rng):
    """Shots flattened into the class axis, labels int32, images float32 or
    on the uint8 wire, and an on-device augmentation operand carried as a
    fifth array: the same arrays as the JAX package's."""
    xs = (rng.rand(2, 5, 3, 1, 4, 4) > 0.5).astype(np.float32)
    xt = (rng.rand(2, 5, 2, 1, 4, 4) > 0.5).astype(np.float32)
    ys = np.tile(np.arange(5)[None, :, None], (2, 1, 3))
    yt = np.tile(np.arange(5)[None, :, None], (2, 1, 2))
    tc = None if codec is None else t_common.WireCodec(*codec)
    jc = None if codec is None else j_common.WireCodec(*codec)
    ours = t_common.prepare_batch((xs, xt, ys, yt), tc)
    theirs = j_common.prepare_batch((xs, xt, ys, yt), jc)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ks = rng.randint(0, 4, size=(2, 5)).astype(np.int32)
    ours = t_common.prepare_batch((xs, xt, ys, yt, ks), tc)
    theirs = j_common.prepare_batch((xs, xt, ys, yt, ks), jc)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_partition_merge_match_jax():
    tree = {"conv0": {"conv": {"weight": 1.0, "bias": 2.0},
                      "norm": {"gamma": 3.0, "beta": 4.0}},
            "linear": {"weight": 5.0, "bias": 6.0}}
    mask = {"conv0": {"conv": {"weight": True, "bias": True},
                      "norm": {"gamma": False, "beta": False}},
            "linear": {"weight": True, "bias": True}}
    ours = t_trees.partition(tree, mask)
    theirs = j_trees.partition(tree, mask)
    assert ours == tuple(theirs)
    assert ours[0]["conv0"]["norm"] == {"gamma": None, "beta": None}
    assert t_trees.merge(*ours) == tree == j_trees.merge(*theirs)
    assert t_trees.tree_leaves(ours[0]) == [1.0, 2.0, 5.0, 6.0]
    state = BatchNormState(1.0, 2.0)
    mapped = t_trees.tree_map(lambda a: a * 2, {"s": state})
    assert mapped["s"] == BatchNormState(2.0, 4.0)


@pytest.mark.parametrize(
    "codec", [(1.0, None, None), (255.0, (0.5, 0.4, 0.3), (0.2, 0.25, 0.3))]
)
def test_wire_codec_matches_jax(codec, rng):
    scale = codec[0]
    x = (rng.randint(0, 256, (2, 3, 5, 5)) / scale).astype(np.float32)
    x[0, 0, 0, 0] = 300.0  # clipped, not wrapped
    jc, tc = j_common.WireCodec(*codec), t_common.WireCodec(*codec)
    wire = t_common.encode_images(x, tc)
    np.testing.assert_array_equal(wire, j_common.encode_images(x, jc))
    close(
        t_common.decode_images(T(wire), tc, torch.float32),
        j_common.decode_images(jnp.asarray(wire), jc, jnp.float32),
        rtol=1e-6, atol=1e-6,
    )


def test_resolve_device_needs_cuda_or_explicit_cpu(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()

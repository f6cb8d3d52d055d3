"""The port's any-order fused norm and pooled fused norm against the JAX
package's ``fused_bn_leaky_relu_ho`` / ``fused_bn_leaky_relu_pool`` run in
interpret mode on the CPU, and the autograd structure of their Functions.

On the CPU the Functions run the plain bodies of their kernels, so these
tests exercise the same backward (differentiable torch ops, the statistics
routed back through the Function) that runs on the card. Tolerances are
those of tests/test_pallas_fused_norm_ho.py. The kernels themselves run
only on a card: tests/test_torch_fused_norm_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import pallas_fused_norm as pfn
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as tfn

EPS, SLOPE = 1e-5, 0.01
FWD_TOL = {"y": (1e-5, 1e-5), "mean": (1e-5, 1e-6), "var": (1e-4, 1e-5)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

OPS = {
    "ho": (
        lambda *a: pfn.fused_bn_leaky_relu_ho(*a, EPS, SLOPE, True),
        tfn.fused_bn_leaky_relu_ho,
    ),
    "pool": (
        lambda *a: pfn.fused_bn_leaky_relu_pool(*a, EPS, SLOPE, True),
        tfn.fused_bn_leaky_relu_pool,
    ),
}


def _inputs(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    gamma = (rng.rand(shape[1]) + 0.5).astype(np.float32)
    beta = rng.randn(shape[1]).astype(np.float32)
    return x, gamma, beta


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays, grad=True):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize(
    "op,shape",
    [("ho", (10, 64, 14, 14)), ("ho", (3, 5, 3, 3)), ("pool", (4, 5, 8, 6)),
     ("pool", (10, 64, 14, 14))],
)
def test_forward_matches_jax(op, shape, rng):
    jop, top = OPS[op]
    arrays = _inputs(rng, shape)
    want = jop(*_jax(arrays))
    with torch.no_grad():
        got = top(*_torch(arrays, grad=False))
    for name, a, b in zip(("y", "mean", "var"), got, want):
        rtol, atol = FWD_TOL[name]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("op", ["ho", "pool"])
def test_first_order_grads_match_jax(op, rng):
    """A loss over ``y`` and over the statistics: the JAX op gives mean and
    var tangents, so their cotangents must reach ``x``."""
    jop, top = OPS[op]
    arrays = _inputs(rng, (4, 5, 6, 6))
    out_shape = (4, 5, 3, 3) if op == "pool" else (4, 5, 6, 6)
    t = rng.randn(*out_shape).astype(np.float32)
    u, v = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)

    def jloss(*a):
        y, mean, var = jop(*a)
        return jnp.sum(y * t) + jnp.sum(mean * u) + jnp.sum(var * v)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrays))
    leaves = _torch(arrays)
    y, mean, var = top(*leaves)
    loss = (y * torch.from_numpy(t)).sum() + (mean * torch.from_numpy(u)).sum() \
        + (var * torch.from_numpy(v)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


def _jax_rev_over_rev(f, x, gamma, beta):
    """``tests/test_pallas_fused_norm_ho.py:107-119``: an outer grad over
    a function that takes an inner grad."""

    def outer(x):
        def inner_loss(g):
            return jnp.sum(f(x, g, beta)[0] ** 2)

        g1 = gamma - 0.1 * jax.grad(inner_loss)(gamma)
        return jnp.sum(f(x, g1, beta)[0])

    return jax.grad(outer)(x)


def _torch_rev_over_rev(f, x, gamma, beta):
    x = x.clone().requires_grad_()
    gamma = gamma.clone().requires_grad_()
    inner = (f(x, gamma, beta)[0] ** 2).sum()
    (g,) = torch.autograd.grad(inner, gamma, create_graph=True)
    (dx,) = torch.autograd.grad(f(x, gamma - 0.1 * g, beta)[0].sum(), x)
    return dx


@pytest.mark.parametrize("op,shape", [("ho", (4, 5, 6, 6)), ("pool", (3, 4, 6, 6))])
def test_rev_over_rev_matches_jax(op, shape, rng):
    jop, top = OPS[op]
    arrays = _inputs(rng, shape)
    want = _jax_rev_over_rev(jop, *_jax(arrays))
    got = _torch_rev_over_rev(top, *_torch(arrays, grad=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize(
    "fn,shape",
    [(tfn.FusedBNLeakyReLUHO, (3, 2, 3, 5)), (tfn.FusedBNLeakyReLUPool, (3, 2, 4, 6))],
    ids=["ho", "pool"],
)
def test_gradcheck_and_gradgradcheck_float64(fn, shape):
    """Every output (y, mean, var) against finite differences, first and
    second order, through the Function's own backward."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
    gamma = (torch.rand(shape[1], generator=gen, dtype=torch.float64) + 0.5)
    beta = torch.randn(shape[1], generator=gen, dtype=torch.float64)
    args = (x, gamma.requires_grad_(), beta.requires_grad_())
    op = lambda *a: fn.apply(*a, EPS, SLOPE)  # noqa: E731
    assert torch.autograd.gradcheck(op, args)
    assert torch.autograd.gradgradcheck(op, args)


def test_pool_ties_route_the_gradient_to_the_first_view(rng):
    """Every 2x2 window holds four equal values, so every window ties. JAX
    sends the pooled gradient to the first view (:712-718); so must the
    port, judged on the recomputed activation."""
    small = rng.randn(3, 4, 3, 2).astype(np.float32)
    x = np.repeat(np.repeat(small, 2, axis=2), 2, axis=3)
    gamma = (rng.rand(4) + 0.5).astype(np.float32)
    beta = rng.randn(4).astype(np.float32)
    t = rng.randn(3, 4, 3, 2).astype(np.float32)
    jop, top = OPS["pool"]
    want = jax.grad(
        lambda *a: jnp.sum(jop(*a)[0] * t), argnums=(0, 1, 2)
    )(*_jax((x, gamma, beta)))
    leaves = _torch((x, gamma, beta))
    got = torch.autograd.grad((top(*leaves)[0] * torch.from_numpy(t)).sum(), leaves)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)
    routed = tfn._first_max_route(torch.from_numpy(x), torch.from_numpy(t))
    assert torch.equal(routed[:, :, 0::2, 0::2], torch.from_numpy(t))
    assert int((routed != 0).sum()) == t.size


def test_pool_rejects_odd_spatial(rng):
    x, gamma, beta = _torch(_inputs(rng, (2, 4, 7, 6)))
    with pytest.raises(ValueError, match="even"):
        tfn.fused_bn_leaky_relu_pool(x, gamma, beta)


def test_cpu_calls_launch_no_kernel(rng):
    tfn.reset_launch_counts()
    for op, shape in (("ho", (3, 5, 4, 4)), ("pool", (3, 5, 4, 4))):
        leaves = _torch(_inputs(rng, shape))
        _torch_rev_over_rev(OPS[op][1], *leaves)
    assert tfn.launch_counts == dict.fromkeys(tfn.KERNELS, 0)


@pytest.mark.parametrize("op", ["ho", "pool"])
def test_non_cpu_tensor_never_takes_the_plain_bodies(op):
    """A tensor off the CPU goes to the kernels, which refuse what is not a
    CUDA tensor: there is no fallback to the plain bodies."""
    x = torch.empty((2, 3, 4, 4), device="meta")
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        OPS[op][1](x, v, v)

"""The port's fused batch-norm + LeakyReLU against the JAX package's Pallas
op ``fused_bn_leaky_relu`` run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain version; the tests hold that
version (and the explicit backward formulas the Hopper kernels implement)
to the Pallas op on y, mean, var, dx, dgamma and dbeta, on the single-block
path and on the row-blocked path. Tolerances are those of
tests/test_pallas_fused_norm.py. The kernels themselves run only on a card:
tests/test_torch_fused_norm_cuda.py holds them to the plain version there.
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
GRAD_TOL = (1e-4, 1e-4)


def _inputs(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    gamma = (rng.rand(shape[1]) + 0.5).astype(np.float32)
    beta = rng.randn(shape[1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, gamma, beta, g


def _jax_op(x, gamma, beta, g):
    """y, mean, var and (dx, dgamma, dbeta) of the Pallas op (interpret)."""
    (y, mean, var), vjp = jax.vjp(
        lambda a, b, c: pfn.fused_bn_leaky_relu(a, b, c, EPS, SLOPE, True),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
    )
    grads = vjp((jnp.asarray(g), jnp.zeros_like(mean), jnp.zeros_like(var)))
    return [np.asarray(a) for a in (y, mean, var)], [np.asarray(a) for a in grads]


def _port_op(x, gamma, beta, g):
    """The same through the port's wrapper on CPU tensors (autograd)."""
    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, gamma, beta))
    y, mean, var = tfn.fused_bn_leaky_relu(xt, gt, bt, EPS, SLOPE)
    grads = torch.autograd.grad(y, (xt, gt, bt), torch.from_numpy(g))
    return (
        [a.detach().numpy() for a in (y, mean, var)],
        [a.numpy() for a in grads],
    )


def _port_formulas(x, gamma, beta, g):
    """dx, dgamma, dbeta from the plain backward the kernels implement."""
    xt, gt, bt, g_t = (torch.from_numpy(a) for a in (x, gamma, beta, g))
    mean, var = tfn.plain_stats(xt)
    dgamma, dbeta = tfn.plain_bwd_reduce(xt, g_t, mean, var, gt, bt, EPS, SLOPE)
    dx = tfn.plain_bwd_apply(
        xt, g_t, mean, var, gt, bt, dgamma, dbeta, EPS, SLOPE
    )
    return [a.numpy() for a in (dx, dgamma, dbeta)]


def _assert_matches_jax(x, gamma, beta, g):
    (jy, jmean, jvar), jgrads = _jax_op(x, gamma, beta, g)
    (ty, tmean, tvar), tgrads = _port_op(x, gamma, beta, g)
    for name, a, b in (("y", ty, jy), ("mean", tmean, jmean), ("var", tvar, jvar)):
        rtol, atol = FWD_TOL[name]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    for grads in (tgrads, _port_formulas(x, gamma, beta, g)):
        for name, a, b in zip(("dx", "dgamma", "dbeta"), grads, jgrads):
            np.testing.assert_allclose(
                a, b, rtol=GRAD_TOL[0], atol=GRAD_TOL[1], err_msg=name
            )


@pytest.fixture
def small_blocks(monkeypatch):
    """Force the Pallas op's row-blocked two-phase path at CPU shapes."""
    monkeypatch.setattr(pfn, "_MAX_RESIDENT_BYTES", 24 * 128 * 4)


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (10, 64, 14, 14)])
def test_plain_matches_pallas_single_block(shape, rng):
    _assert_matches_jax(*_inputs(rng, shape))


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (4, 8, 7, 9)])
def test_plain_matches_pallas_blocked(shape, rng, small_blocks):
    _assert_matches_jax(*_inputs(rng, shape))


def _assert_plain_bwd_matches_jax(x, gamma, beta, g):
    """``plain_bwd``, the version ``bn_act_bwd`` is held to on the card,
    from the port's statistics, against the Pallas op's gradients."""
    _, jgrads = _jax_op(x, gamma, beta, g)
    xt, gt, bt, g_t = (torch.from_numpy(a) for a in (x, gamma, beta, g))
    mean, var = tfn.plain_stats(xt)
    grads = tfn.plain_bwd(xt, g_t, mean, var, gt, bt, EPS, SLOPE)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), grads, jgrads):
        np.testing.assert_allclose(
            a.numpy(), b, rtol=GRAD_TOL[0], atol=GRAD_TOL[1], err_msg=name
        )


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (10, 64, 14, 14), (5, 3, 3, 3)])
def test_plain_bwd_matches_pallas_single_block(shape, rng):
    _assert_plain_bwd_matches_jax(*_inputs(rng, shape))


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (4, 8, 7, 9)])
def test_plain_bwd_matches_pallas_blocked(shape, rng, small_blocks):
    _assert_plain_bwd_matches_jax(*_inputs(rng, shape))


def test_leaky_relu_gradient_at_zero_takes_positive_branch(rng):
    """pre == 0 exactly: each row of each channel is {-1, 0, 1} twice, gamma 1 and beta
    0, so the mean is exactly 0 and so are x-hat and pre at the zeros. JAX
    and the Pallas kernels take the positive branch there (``pre >= 0``);
    the port must too, in its forward and its gradient."""
    x = np.tile(np.asarray([-1.0, 0.0, 1.0], np.float32), 16).reshape(2, 4, 1, 6)
    gamma = np.ones(4, np.float32)
    beta = np.zeros(4, np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    _assert_matches_jax(x, gamma, beta, g)
    # The zeros' dpre is g itself: slope * g there would move dgamma/dbeta.
    xt = torch.from_numpy(x)
    mean, var = tfn.plain_stats(xt)
    assert float(mean.abs().max()) == 0.0
    _, dbeta = tfn.plain_bwd_reduce(
        xt, torch.from_numpy(g), mean, var, torch.from_numpy(gamma),
        torch.from_numpy(beta), EPS, SLOPE,
    )
    pos = (x >= 0).astype(np.float32)
    want = (g * (pos + SLOPE * (1 - pos))).sum(axis=(0, 2, 3))
    np.testing.assert_allclose(dbeta.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cpu_calls_launch_no_kernel(rng):
    tfn.reset_launch_counts()
    x, gamma, beta, g = _inputs(rng, (3, 5, 4, 4))
    _port_op(x, gamma, beta, g)
    _port_formulas(x, gamma, beta, g)
    assert tfn.launch_counts == dict.fromkeys(tfn.KERNELS, 0)


def test_backward_kernel_refuses_cpu_tensors(rng):
    """``bn_act_bwd`` takes CUDA tensors only: on the CPU the Function's
    backward is the plain version differentiated by autograd."""
    x, gamma, beta, g = (torch.from_numpy(a) for a in _inputs(rng, (2, 3, 4, 4)))
    mean, var = tfn.plain_stats(x)
    with pytest.raises(ValueError, match="CUDA"):
        tfn.bn_act_bwd(x, g, mean, var, gamma, beta)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernels, which refuse what is not a
    CUDA tensor: there is no fallback to the plain version."""
    x = torch.empty((2, 3, 4, 4), device="meta")
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfn.fused_bn_leaky_relu(x, v, v)

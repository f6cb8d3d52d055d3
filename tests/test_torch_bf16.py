"""bfloat16 compute in the port against the JAX package's, on the CPU.

``compute_dtype="bfloat16"``: the float32 masters are cast once at the
step's boundary (``models/common.cast_floats``, the identity in float32),
activations and the inner loop run in bfloat16, the norm statistics, the
LSLR table, the outer gradients and Adam in float32. The norm ops on
bfloat16 input compute in float32 and round their full-size outputs once,
as the Pallas bodies do.

Bars:

* the norm ops' bfloat16 outputs (y, dx), against the Pallas op in
  interpret mode: per element one bfloat16 unit in the last place of the
  JAX value, plus ``1e-4 * max|JAX|`` where the two float32 results cancel
  to near 0 (they compute by other formulas: JAX transposes its tangents,
  the port writes the cotangents out). The pooled op's dx in JAX is two
  roundings (its statistics path and its per-view path are each cast to
  bfloat16, then added), so it is held there to one more unit at the
  largest value (``2**-8 * max``), and to the one-ulp bar against the JAX
  op on the same values in float32, rounded once (measured: equal).
  Second order, where both frameworks round intermediates to bfloat16 in
  other places: two units plus two at the largest value (``2**-7 * max``;
  measured 0.04% and 0.4% of the largest value). The float32 statistics
  and dgamma/dbeta at the float32 tests' bars
  (tests/test_torch_fused_norm.py);
* the MAML learner's losses and logits at JAX's own bf16 bar, rtol 0.1 and
  atol 0.05 (tests/test_bf16.py:88-143). The gap measured on this
  configuration: first loss 1.5e-3 relative, eval logits 0.044 of up to
  1.2, losses after six updates up to 0.098 of 2.0 (bfloat16 rounds at
  other places in the two frameworks' convolutions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import pallas_fused_norm as pfn
from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    GradientDescentLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models.common import cast_floats
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as tfn
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from test_torch_gradient_descent import zoo_config
from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    episode_batch,
    jax_config,
    learner_pair,
    one_intra_op_thread,
    port_config,
)

EPS, SLOPE = 1e-5, 0.01
STAT_TOL = {"mean": (1e-5, 1e-6), "var": (1e-4, 1e-5)}
GRAD_TOL = (1e-4, 1e-4)
# JAX's own bf16 bar against float32 (tests/test_bf16.py).
BF16_RTOL, BF16_ATOL = 0.1, 0.05


def assert_bf16_close(got, want, ulps=1, rel_floor=1e-4):
    """bfloat16 ``got`` per element within ``ulps`` bfloat16 units in the
    last place of ``want``, plus ``rel_floor * max|want|``."""
    got = torch.as_tensor(np.asarray(got, np.float32))
    want_t = torch.as_tensor(np.asarray(want, np.float32))
    gap = (got - want_t).abs()
    _, exponent = torch.frexp(want_t)
    ulp = torch.ldexp(torch.ones_like(gap), exponent - 8)
    bar = ulps * ulp + rel_floor * float(want_t.abs().max())
    assert bool((gap <= bar).all()), float((gap - bar).max())


def _inputs(rng, shape, ties=False):
    """bfloat16 x (on a half-unit grid when ``ties``, so that equal values
    meet in the pool windows and at the LeakyReLU), float32 gamma, beta."""
    x = rng.randn(*shape)
    if ties:
        x = np.round(x * 2) / 2
    x = torch.tensor(x, dtype=torch.bfloat16)
    gamma = torch.tensor(rng.rand(shape[1]) + 0.5, dtype=torch.float32)
    beta = torch.tensor(0.3 * rng.randn(shape[1]), dtype=torch.float32)
    return x, gamma, beta


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    )


OPS = {
    "vjp": (tfn.fused_bn_leaky_relu, pfn.fused_bn_leaky_relu),
    "ho": (tfn.fused_bn_leaky_relu_ho, pfn.fused_bn_leaky_relu_ho),
    "pool": (tfn.fused_bn_leaky_relu_pool, pfn.fused_bn_leaky_relu_pool),
}


@pytest.mark.parametrize("kind", list(OPS))
def test_bf16_norm_ops_match_jax(kind, rng):
    """Forward and first-order gradients of each op on bfloat16 input (with
    ties) against the Pallas op in interpret mode: y and dx bfloat16, the
    statistics and dgamma/dbeta float32."""
    ours_op, jax_op = OPS[kind]
    x, gamma, beta = _inputs(rng, (5, 8, 6, 6), ties=True)
    y_shape = (5, 8, 3, 3) if kind == "pool" else tuple(x.shape)
    g = torch.tensor(rng.randn(*y_shape), dtype=torch.bfloat16)
    # The one-level op's statistics carry no cotangent; the others' do.
    gm = torch.zeros(8) if kind == "vjp" else torch.tensor(rng.randn(8), dtype=torch.float32)
    gv = torch.zeros(8) if kind == "vjp" else torch.tensor(rng.randn(8), dtype=torch.float32)

    (jy, jmean, jvar), vjp = jax.vjp(
        lambda a, b, c: jax_op(a, b, c, EPS, SLOPE, True),
        _jnp(x), _jnp(gamma), _jnp(beta),
    )
    jgrads = vjp((_jnp(g), _jnp(gm), _jnp(gv)))

    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y, mean, var = ours_op(*leaves, EPS, SLOPE)
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    outs = [y] + ([] if kind == "vjp" else [mean, var])
    cots = [g] + ([] if kind == "vjp" else [gm, gv])
    dx, dgamma, dbeta = torch.autograd.grad(outs, leaves, cots)
    assert dx.dtype == torch.bfloat16 and dgamma.dtype == torch.float32

    assert_bf16_close(y.detach().float(), jy)
    for name, ours, theirs in (("mean", mean, jmean), ("var", var, jvar)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   *STAT_TOL[name], err_msg=name)
    for ours, theirs in zip((dgamma, dbeta), jgrads[1:]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), *GRAD_TOL)
    if kind != "pool":
        assert_bf16_close(dx.float(), jgrads[0])
        return
    assert_bf16_close(dx.float(), jgrads[0], rel_floor=2.0 ** -8)
    # The port rounds once: the JAX op in float32 on the same values,
    # rounded once, takes the same windows' first maxima.
    _, vjp32 = jax.vjp(
        lambda a, b, c: jax_op(a, b, c, EPS, SLOPE, True),
        _jnp(x).astype(jnp.float32), _jnp(gamma), _jnp(beta),
    )
    want = vjp32((_jnp(g).astype(jnp.float32), _jnp(gm), _jnp(gv)))[0]
    assert_bf16_close(dx.float(), want.astype(jnp.bfloat16))


@pytest.mark.parametrize("kind", ["ho", "pool"])
def test_bf16_norm_ops_second_order_match_jax(kind, rng):
    """Reverse over reverse on bfloat16 input: the gradient with respect
    to x of a loss after one step on gamma along the gradient of another,
    against JAX's."""
    ours_op, jax_op = OPS[kind]
    x, gamma, beta = _inputs(rng, (5, 8, 6, 6), ties=kind == "pool")

    def jax_second(xx):
        def inner(gg):
            return jnp.sum(jax_op(xx, gg, _jnp(beta), EPS, SLOPE, True)[0]
                           .astype(jnp.float32) ** 2)
        step = _jnp(gamma) - 0.1 * jax.grad(inner)(_jnp(gamma))
        return jnp.sum(jax_op(xx, step, _jnp(beta), EPS, SLOPE, True)[0]
                       .astype(jnp.float32))

    want = jax.grad(jax_second)(_jnp(x))
    xx, gg = (t.clone().requires_grad_() for t in (x, gamma))
    (g,) = torch.autograd.grad(
        (ours_op(xx, gg, beta, EPS, SLOPE)[0].float() ** 2).sum(), gg,
        create_graph=True,
    )
    (got,) = torch.autograd.grad(
        ours_op(xx, gg - 0.1 * g, beta, EPS, SLOPE)[0].float().sum(), xx
    )
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got.float(), want, ulps=2, rel_floor=2.0 ** -7)


def test_bf16_plain_versions_compute_in_float32_and_round_once(rng):
    """The plain versions on bfloat16 input give what the float32 plain
    versions give on the same values, rounded once; on float32 input they
    are the float32 code itself."""
    x, gamma, beta = _inputs(rng, (3, 4, 6, 6))
    g = torch.tensor(rng.randn(3, 4, 6, 6), dtype=torch.bfloat16)
    mean, var = tfn.plain_stats(x)
    f_mean, f_var = tfn.plain_stats(x.float())
    assert torch.equal(mean, f_mean) and torch.equal(var, f_var)
    for ours, f32 in (
        (tfn.plain_apply(x, mean, var, gamma, beta),
         tfn.plain_apply(x.float(), mean, var, gamma, beta)),
        (tfn.plain_pool_apply(x, mean, var, gamma, beta),
         tfn.plain_pool_apply(x.float(), mean, var, gamma, beta)),
        (tfn.plain_bwd(x, g, mean, var, gamma, beta)[0],
         tfn.plain_bwd(x.float(), g.float(), mean, var, gamma, beta)[0]),
    ):
        assert ours.dtype == torch.bfloat16
        assert torch.equal(ours, f32.to(torch.bfloat16))


def test_cast_floats_is_the_identity_at_float32():
    """At float32 the boundary cast returns its input, not a copy; at
    bfloat16 it casts the floating leaves and leaves the others."""
    tree = {"w": torch.ones(2, 2), "i": torch.arange(3), "none": None}
    assert cast_floats(tree, torch.float32) is tree
    cast = cast_floats(tree, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int64 and cast["none"] is None


def _close_bf16_bar(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(theirs, np.float64),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "off"])
def test_bf16_maml_matches_jax(fused, rng):
    """MAML++ in bfloat16 from one state, port against JAX: an eval
    episode's loss and logits, three ``run_train_iter`` and a K=3
    ``run_train_iters``, at JAX's bf16 bar. The masters, the LSLR table and
    the BN state stay float32."""
    jlearner, jstate, learner, state = learner_pair(
        jax_config(fused, compute_dtype="bfloat16")
    )
    batch = episode_batch(rng)
    _, jm, jlogits = jlearner.run_validation_iter(jstate, batch)
    _, m, logits = learner.run_validation_iter(state, batch)
    assert logits.dtype == torch.float32
    _close_bf16_bar(float(m["loss"]), float(jm["loss"]))
    _close_bf16_bar(logits.numpy(), np.asarray(jlogits, np.float32))
    for _ in range(3):
        b = episode_batch(rng)
        jstate, jlosses = jlearner.run_train_iter(jstate, b, epoch=0)
        state, losses = learner.run_train_iter(state, b, epoch=0)
        assert bool(torch.isfinite(losses["loss"]))
        _close_bf16_bar(float(losses["loss"]), float(jlosses["loss"]))
    group = [episode_batch(rng) for _ in range(3)]
    jstate, jlosses = jlearner.run_train_iters(jstate, group, epoch=0)
    state, losses = learner.run_train_iters(state, group, epoch=0)
    _close_bf16_bar(losses["loss"].numpy(), np.asarray(jlosses["loss"]))
    for leaf in tree_leaves((state.theta, state.lslr, state.bn_state,
                             state.opt_state.mu, state.opt_state.nu)):
        assert leaf.dtype == torch.float32


@pytest.mark.parametrize(
    "cls", [GradientDescentLearner, MatchingNetsLearner, ProtoNetsLearner, ANILLearner],
    ids=["gd", "matching_nets", "protonets", "anil"],
)
def test_bf16_zoo_learners_train_finite(cls, rng):
    """Each zoo learner in bfloat16: three finite train steps (as
    tests/test_bf16.py:146 for the JAX learners), the masters float32."""
    learner = cls(dataclasses.replace(port_config(zoo_config(True)),
                                      compute_dtype="bfloat16"))
    state = learner.init_state(torch.Generator().manual_seed(14), "cpu")
    for _ in range(3):
        state, losses = learner.run_train_iter(state, episode_batch(rng), epoch=0)
        assert bool(torch.isfinite(losses["loss"]))
        assert float(losses["nonfinite"]) == 0.0
    for leaf in tree_leaves(state.theta):
        assert leaf.dtype == torch.float32
    _, eval_losses, _ = learner.run_validation_iter(state, episode_batch(rng))
    assert bool(torch.isfinite(eval_losses["loss"]))

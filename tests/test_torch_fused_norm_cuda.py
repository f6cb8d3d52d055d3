"""The port's Hopper kernels against their plain PyTorch version, on a card.

Every test here needs a CUDA device and nvcc, is marked ``cuda`` and skips
without one. The file imports nothing of JAX, so it also runs on a machine
without JAX, where tests/conftest.py cannot load:

    python -m pytest tests/test_torch_fused_norm_cuda.py -q --noconftest

Tolerance, norm-wise per output: max|kernel - plain| <= 1e-5 + 1e-4 *
max|plain| (reductions summed in another order; rsqrtf and fused
multiply-add rounding elementwise).
"""

import dataclasses

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.models import (
    BackboneConfig,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as tfn
from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    rng = np.random.RandomState(seed)
    arrays = (
        rng.randn(*shape), rng.rand(shape[1]) + 0.5, 0.1 * rng.randn(shape[1]),
        rng.randn(*shape),
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= ATOL + RTOL * float(want.abs().max()), err


@pytest.mark.parametrize(
    "shape", [(5, 256, 28, 28), (15, 256, 3, 3), (3, 5, 7, 9)]
)
def test_kernels_match_plain(shape, cuda):
    x, gamma, beta, g = _inputs(shape, cuda)
    mean, var = tfn.plain_stats(x)
    pairs = [
        (tfn.bn_stats(x), (mean, var)),
        (tfn.bn_stats_act(x, gamma, beta),
         (tfn.plain_apply(x, mean, var, gamma, beta), mean, var)),
        (tfn.bn_act_bwd(x, g, mean, var, gamma, beta),
         tfn.plain_bwd(x, g, mean, var, gamma, beta)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize(
    "shape,streamed",
    [
        ((5, 512, 7, 7), False),   # H*W 49: scalar copies, 3 channels a block
        ((15, 256, 3, 3), False),  # H*W 9
        ((1, 8, 28, 28), False),   # N = 1
        ((4, 1, 14, 14), False),   # C = 1
        ((3, 5, 7, 9), False),
        ((25, 96, 84, 84), False),  # a cluster of 8 blocks
        ((5, 256, 28, 28), True),  # forced onto the streamed path
        ((3, 5, 7, 9), True),
    ],
)
def test_forward_kernels_match_plain(shape, streamed, cuda):
    """bn_stats_act and bn_stats against plain_stats + plain_apply; two
    calls bitwise equal, and both entries' statistics bitwise equal."""
    x, gamma, beta, _ = _inputs(shape, cuda)
    x = 2 * x + 3  # a mean far from 0 against the spread
    plan = tfn.fwd_plan(x, streamed=streamed)
    assert plan.staged != streamed
    if shape == (5, 512, 7, 7):
        assert plan.channels_per_block > 1, plan
    y, mean, var = tfn.bn_stats_act(x, gamma, beta, plan=plan)
    again = tfn.bn_stats_act(x, gamma, beta, plan=plan)
    stats = tfn.bn_stats(x, plan=plan)
    torch.cuda.synchronize()
    for a, b in zip((y, mean, var, mean, var), (*again, *stats)):
        assert torch.equal(a, b)
    p_mean, p_var = tfn.plain_stats(x)
    _close(mean, p_mean)
    _close(var, p_var)
    _close(y, tfn.plain_apply(x, p_mean, p_var, gamma, beta))


@pytest.mark.parametrize(
    "shape,streamed",
    [
        ((5, 512, 7, 7), False),   # a warp a channel, 3 channels a block
        ((15, 256, 3, 3), False),  # H*W 9: scalar copies
        ((3, 5, 7, 9), False),     # odd H*W
        ((1, 8, 28, 28), False),   # N = 1
        ((4, 1, 14, 14), False),   # C = 1
        ((25, 96, 84, 84), False),  # a cluster of blocks
        ((5, 256, 28, 28), True),  # forced onto the streamed path
        ((3, 5, 7, 9), True),
    ],
)
def test_backward_kernel_matches_plain(shape, streamed, cuda):
    """bn_act_bwd against plain_bwd on the same statistics; two calls
    bitwise equal."""
    x, gamma, beta, g = _inputs(shape, cuda)
    x = 2 * x + 3
    mean, var = tfn.plain_stats(x)
    plan = tfn.bwd_plan(x, streamed=streamed)
    assert plan.staged != streamed
    if shape == (5, 512, 7, 7):
        assert plan.channels_per_block > 1, plan
    if shape == (25, 96, 84, 84):
        assert plan.cluster > 1, plan
    got = tfn.bn_act_bwd(x, g, mean, var, gamma, beta, plan=plan)
    again = tfn.bn_act_bwd(x, g, mean, var, gamma, beta, plan=plan)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for a, b in zip(got, tfn.plain_bwd(x, g, mean, var, gamma, beta)):
        _close(a, b)


def test_function_matches_plain_and_is_deterministic(cuda):
    x, gamma, beta, g = _inputs((5, 64, 14, 14), cuda)
    outs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        y, mean, var = tfn.fused_bn_leaky_relu(*leaves)
        assert not mean.requires_grad and not var.requires_grad
        outs.append((y, mean, var, *torch.autograd.grad(y, leaves, g)))
    for a, b in zip(*outs):  # no float atomics: the same bits every run
        assert torch.equal(a, b)
    y, mean, var, dx, dgamma, dbeta = outs[0]
    p_mean, p_var = tfn.plain_stats(x)
    _close(mean, p_mean)
    _close(var, p_var)
    _close(y, tfn.plain_apply(x, p_mean, p_var, gamma, beta))
    # Backward from the Function's own statistics, so both versions take the
    # same LeakyReLU branch where pre lies within rounding of 0.
    p_dx, p_dgamma, p_dbeta = tfn.plain_bwd(x, g, mean, var, gamma, beta)
    _close(dgamma, p_dgamma)
    _close(dbeta, p_dbeta)
    _close(dx, p_dx)


@pytest.mark.parametrize("shape", [(5, 512, 28, 28), (5, 512, 14, 14), (3, 5, 6, 10)])
def test_pool_kernel_matches_plain(shape, cuda):
    x, gamma, beta, _ = _inputs(shape, cuda)
    mean, var = tfn.plain_stats(x)
    got = tfn.bn_act_pool_apply(x, mean, var, gamma, beta)
    torch.cuda.synchronize()
    _close(got, tfn.plain_pool_apply(x, mean, var, gamma, beta))


def _plain_op(x, gamma, beta, pool, stats):
    """The plain composition, differentiated by autograd, with the values
    of ``stats`` (the kernels') in place of its own statistics but their
    gradient: both versions then take the same LeakyReLU branch and the
    same window maximum where two values lie within rounding."""
    mean, var = tfn.plain_stats(x)
    mean = mean + (stats[0] - mean).detach()
    var = var + (stats[1] - var).detach()
    y = tfn.plain_apply(x, mean, var, gamma, beta)
    return (torch.nn.functional.max_pool2d(y, 2, 2) if pool else y), mean, var


@pytest.mark.parametrize(
    "pool,shape", [(False, (5, 512, 7, 7)), (True, (5, 512, 28, 28))],
    ids=["ho", "pool"],
)
def test_any_order_functions_match_plain(pool, shape, cuda):
    """Forward, first-order grads of a loss over y, mean and var, and the
    reverse-over-reverse composition, against the plain composition."""
    op = tfn.fused_bn_leaky_relu_pool if pool else tfn.fused_bn_leaky_relu_ho
    x, gamma, beta, _ = _inputs(shape, cuda)
    stats = tfn.bn_stats(x)
    t = torch.randn_like(op(x, gamma, beta)[0])

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (x, gamma, beta)]
        y, mean, var = fn(*leaves)
        first = torch.autograd.grad(
            (y * t).sum() + mean.sum() + var.sum(), leaves
        )
        xx, gg = (a.clone().requires_grad_() for a in (x, gamma))
        (g,) = torch.autograd.grad((fn(xx, gg, beta)[0] ** 2).sum(), gg,
                                   create_graph=True)
        (second,) = torch.autograd.grad(fn(xx, gg - 0.1 * g, beta)[0].sum(), xx)
        return (y, mean, var, *first, second)

    got = grads(op)
    for a, b in zip(got, grads(lambda *a: _plain_op(*a, pool, stats))):
        _close(a.detach(), b.detach())
    assert torch.equal(got[-1], grads(op)[-1])  # deterministic


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        tfn.bn_stats(torch.zeros((2, 3, 4, 4), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tfn.bn_stats(torch.zeros((2, 4, 4, 3), device=cuda).permute(0, 3, 1, 2))
    v = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="even"):
        tfn.bn_act_pool_apply(torch.zeros((2, 3, 5, 4), device=cuda), v, v, v, v)


def test_served_episodes_run_the_kernels(cuda):
    cfg = MAMLConfig(
        backbone=BackboneConfig(
            num_stages=4, num_filters=8, per_step_bn_statistics=True,
            num_steps=2, num_classes=5, use_pallas_fused_norm=True,
        ),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
    )
    plain_cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_fused_norm=False)
    )
    learner = MAMLFewShotLearner(cfg)
    state = learner.init_inference_state(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    raw = [
        ((rng.rand(5, 1, 28, 28) > 0.8).astype(np.float32), np.arange(5),
         (rng.rand(7, 1, 28, 28) > 0.8).astype(np.float32))
        for _ in range(3)
    ]
    engine = ServingEngine(learner, state, ServeConfig(meta_batch_size=4))
    plain = ServingEngine(
        MAMLFewShotLearner(plain_cfg), state, ServeConfig(meta_batch_size=4)
    )
    tfn.reset_launch_counts()
    got = engine.dispatch([engine.prepare_episode(*e) for e in raw])
    # One dispatch: 4 stages x (2 adapt steps + classify) forwards, 2 x 4
    # backwards.
    assert tfn.launch_counts == {
        "bn_stats": 0, "bn_stats_act": 12, "bn_act_bwd": 8, "bn_act_pool_apply": 0,
    }, tfn.launch_counts
    want = plain.dispatch([plain.prepare_episode(*e) for e in raw])
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_fused_train_step_runs_the_kernels(cuda):
    """A second-order meta-step with the any-order op and the pooled op
    launches bn_stats, bn_stats_act and K5 and gives the plain-norm
    learner's loss."""
    cfg = MAMLConfig(
        backbone=BackboneConfig(
            num_stages=4, num_filters=8, per_step_bn_statistics=True,
            num_steps=2, num_classes=5, fused_norm_train=True,
            fused_norm_pool=True,
        ),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
        remat_inner_steps=False,
    )
    plain_cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, fused_norm_train=False, fused_norm_pool=False
    ))
    learner = MAMLFewShotLearner(cfg)
    state = learner.init_state(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    xs = (rng.rand(2, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    ys = np.tile(np.arange(5)[None, :, None], (2, 1, 1))
    batch = (xs, xs.copy(), ys, ys.copy())
    tfn.reset_launch_counts()
    _, losses = learner.run_train_iter(state, batch, epoch=0)
    counts = dict(tfn.launch_counts)
    # 2 steps x (support + target) x 4 stages; stages 0-1 pool (28, 14).
    assert counts["bn_stats"] == 8 and counts["bn_stats_act"] == 8, counts
    assert counts["bn_act_pool_apply"] == 8 and counts["bn_act_bwd"] == 0, counts
    _, plain = MAMLFewShotLearner(plain_cfg).run_train_iter(state, batch, epoch=0)
    np.testing.assert_allclose(float(losses["loss"]), float(plain["loss"]),
                               rtol=1e-4)

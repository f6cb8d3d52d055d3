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
    dgamma, dbeta = tfn.plain_bwd_reduce(x, g, mean, var, gamma, beta)
    pairs = [
        (tfn.bn_stats(x), (mean, var)),
        ((tfn.bn_act_apply(x, mean, var, gamma, beta),),
         (tfn.plain_apply(x, mean, var, gamma, beta),)),
        (tfn.bn_act_bwd_reduce(x, g, mean, var, gamma, beta), (dgamma, dbeta)),
        ((tfn.bn_act_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta),),
         (tfn.plain_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta),)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
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
    p_dgamma, p_dbeta = tfn.plain_bwd_reduce(x, g, mean, var, gamma, beta)
    _close(dgamma, p_dgamma)
    _close(dbeta, p_dbeta)
    _close(dx, tfn.plain_bwd_apply(x, g, mean, var, gamma, beta, p_dgamma, p_dbeta))


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        tfn.bn_stats(torch.zeros((2, 3, 4, 4), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tfn.bn_stats(torch.zeros((2, 4, 4, 3), device=cuda).permute(0, 3, 1, 2))


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
    assert all(tfn.launch_counts[k] > 0 for k in tfn.KERNELS), tfn.launch_counts
    want = plain.dispatch([plain.prepare_episode(*e) for e in raw])
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

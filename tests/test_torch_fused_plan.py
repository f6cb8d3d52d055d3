"""The launch plan of the port's fused-norm forward (``bn_stats`` and
``bn_stats_act``), checked on the CPU for every shape the repo runs.

``_fwd_plan`` is pure Python: from the shape, the SM count and the shared
memory a block may take it picks the cluster size, the channels per block
and the staged or streamed path that the CUDA kernel then follows. These
tests walk the blocks as the kernel does (``bn_fwd_kernel`` in
``csrc/fused_norm.cu``) and check that every channel, and every element of
it, is covered exactly once. The limits are an H100 SXM's: 132 SMs and 227
KB of shared memory a block.
"""

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as tfn

SM_COUNT = 132
MAX_SMEM = 227 * 1024

SERVE = [(n, 256, hw, hw) for n in (5, 15) for hw in (28, 14, 7, 3)]
TRAIN = [(5, 512, hw, hw) for hw in (28, 14, 7, 3)]
NORTH_STAR = [(n, 96, hw, hw) for n in (25, 75) for hw in (84, 42, 21, 10)]


def _coverage(shape, plan):
    """Times each (channel, row) is visited by the plan's blocks, walking
    them as the kernel does."""
    n, c, h, w = shape
    rows = n * h * w
    seen = np.zeros((c, rows), np.int64)
    k, cpb = plan.cluster, plan.channels_per_block
    per = tfn._slice_floats(rows, k)
    for block in range(plan.blocks):
        rank = block % k
        begin = min(rows, rank * per)
        end = min(rows, begin + per)
        for group in range(cpb):
            ch = block // k if k > 1 else block * cpb + group
            if ch < c:
                seen[ch, begin:end] += 1
    return seen


@pytest.mark.parametrize("shape", SERVE + TRAIN + NORTH_STAR, ids=str)
def test_plan_covers_every_channel_once(shape):
    plan = tfn._fwd_plan(shape, SM_COUNT, MAX_SMEM)
    assert plan.cluster in tfn.CLUSTER_SIZES
    assert plan.cluster == 1 or plan.channels_per_block == 1
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    if plan.cluster > 1:
        assert plan.threads == tfn.FWD_THREADS
    assert plan.smem_bytes <= MAX_SMEM
    assert (_coverage(shape, plan) == 1).all()
    n, c, h, w = shape
    rows = n * h * w
    # Staged wherever the channel fits the largest cluster's shared memory.
    assert plan.staged == (4 * tfn._slice_floats(rows, 16) <= MAX_SMEM)
    if plan.staged:
        assert plan.smem_bytes == (
            4 * plan.channels_per_block * tfn._slice_floats(rows, plan.cluster)
        )
    if rows <= tfn.WARP_ROWS:  # a warp a channel
        assert plan.threads == 32 * plan.channels_per_block


def test_plan_packs_small_channels_several_to_a_block():
    plan = tfn._fwd_plan((5, 512, 3, 3), SM_COUNT, MAX_SMEM)
    assert plan.channels_per_block == 3 and plan.threads == 96
    assert plan.blocks == -(-512 // 3)


def test_plan_of_the_north_star_target_stage():
    """(75, 96, 84, 84), 2.1 MB a channel: a 16-block cluster stages it; a
    card that cannot hold one streams it."""
    shape = (75, 96, 84, 84)
    plan = tfn._fwd_plan(shape, SM_COUNT, MAX_SMEM)
    assert plan == tfn.FwdPlan(16, 1, True, 132304, 256, 96 * 16)
    portable = tfn._fwd_plan(shape, SM_COUNT, MAX_SMEM, max_cluster=8)
    assert not portable.staged and portable.smem_bytes == 0
    assert (_coverage(shape, portable) == 1).all()


@pytest.mark.parametrize(
    "shape", [(5, 256, 28, 28), (5, 512, 3, 3), (1, 1, 7, 7), (25, 96, 84, 84)],
    ids=str,
)
def test_forced_streamed_plan(shape):
    plan = tfn._fwd_plan(shape, SM_COUNT, MAX_SMEM, streamed=True)
    assert not plan.staged and plan.smem_bytes == 0
    assert plan.cluster in tfn.CLUSTER_SIZES[:4] and plan.channels_per_block == 1
    assert (_coverage(shape, plan) == 1).all()


@pytest.mark.parametrize("cluster", tfn.CLUSTER_SIZES)
def test_staged_plan_of_each_cluster_size_covers_every_channel_once(cluster):
    """The staged plans ``tools/port_fwd_plan_sweep.py`` times, one per
    cluster size, come from the planner's own ``_staged_plan``."""
    shape = (25, 96, 42, 42)
    plan = tfn._staged_plan(shape, cluster)
    assert plan.cluster == cluster and plan.staged and plan.blocks == 96 * cluster
    assert plan.smem_bytes == 4 * tfn._slice_floats(25 * 42 * 42, cluster)
    assert (_coverage(shape, plan) == 1).all()


def test_plan_prefers_portable_clusters_under_the_block_budget():
    plan = tfn._fwd_plan((25, 96, 84, 84), SM_COUNT, MAX_SMEM)
    assert plan.cluster == 8 and plan.smem_bytes <= tfn.BLOCK_SLICE_BYTES


def test_launch_counts_cover_the_kernels_and_stay_zero_on_cpu(rng):
    assert tuple(tfn.launch_counts) == tfn.KERNELS == (
        "bn_stats", "bn_stats_act", "bn_act_bwd_reduce", "bn_act_bwd_apply",
        "bn_act_pool_apply",
    )
    tfn.reset_launch_counts()
    x = torch.tensor(rng.randn(2, 3, 4, 4), dtype=torch.float32, requires_grad=True)
    gamma, beta = torch.ones(3, requires_grad=True), torch.zeros(3, requires_grad=True)
    for op in (tfn.fused_bn_leaky_relu, tfn.fused_bn_leaky_relu_ho,
               tfn.fused_bn_leaky_relu_pool):
        y = op(x, gamma, beta)[0]
        torch.autograd.grad(y.sum(), (x, gamma, beta))
    assert tfn.launch_counts == dict.fromkeys(tfn.KERNELS, 0)


def test_forward_kernels_refuse_cpu_tensors():
    """The wrappers take CUDA tensors only: a CPU tensor reaches the plain
    version through the ops, never a kernel wrapper's fallback."""
    x = torch.zeros((2, 3, 4, 4))
    v = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        tfn.bn_stats(x)
    with pytest.raises(ValueError, match="CUDA"):
        tfn.bn_stats_act(x, v, v)

"""The launch plan of the port's cluster kernels, the fused-norm forward
(``bn_stats`` and ``bn_stats_act``) and backward (``bn_act_bwd``), checked
on the CPU for every shape the repo runs.

``_plan`` is pure Python: from the shape, the staged bytes a row (4 for the
forward's x, 8 for the backward's x and cotangent), the SM count and the
shared memory a block may take it picks the cluster size, the channels per
block and the staged or streamed path that the CUDA kernels then follow.
These tests walk the blocks as the kernels do (``slice_of`` in
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
# One task of 64 filters: the gradient-descent and matching-nets learners.
ZOO = [(5, 64, hw, hw) for hw in (28, 14, 7, 3)]
# ResNet-12 at the Omniglot JSON's widths: train and eval fold 8 tasks
# (up to 4096 channels of 45 rows), serve 4 (5 support, 15 queries); and
# the VGG without max pooling at its stride-2 stages.
RESNET_STAGES = tuple(zip((64, 128, 256, 512), (28, 14, 7, 3)))
RESNET = ([(5, 8 * w, hw, hw) for w, hw in RESNET_STAGES]
          + [(n, 4 * w, hw, hw) for n in (5, 15) for w, hw in RESNET_STAGES])
STRIDE2 = [(5, 512, hw, hw) for hw in (4, 2)]
SHAPES = SERVE + TRAIN + NORTH_STAR + ZOO + RESNET + STRIDE2


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


def _check_plan_shape(shape, row_bytes):
    plan = tfn._plan(shape, SM_COUNT, MAX_SMEM, row_bytes)
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
    assert plan.staged == (row_bytes * tfn._slice_floats(rows, 16) <= MAX_SMEM)
    if plan.staged:
        assert plan.smem_bytes == (
            row_bytes * plan.channels_per_block
            * tfn._slice_floats(rows, plan.cluster)
        )
    if rows <= tfn.WARP_ROWS:  # a warp a channel
        assert plan.threads == 32 * plan.channels_per_block


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_every_channel_once(shape):
    _check_plan_shape(shape, tfn.FWD_ROW_BYTES)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_plan_covers_every_channel_once(shape):
    """The backward stages x and the cotangent: 8 bytes a row."""
    _check_plan_shape(shape, tfn.BWD_ROW_BYTES)


def test_plan_packs_small_channels_several_to_a_block():
    plan = tfn._plan((5, 512, 3, 3), SM_COUNT, MAX_SMEM)
    assert plan.channels_per_block == 3 and plan.threads == 96
    assert plan.blocks == -(-512 // 3)


def test_plan_of_the_north_star_target_stage():
    """(75, 96, 84, 84), 2.1 MB a channel: a 16-block cluster stages it; a
    card that cannot hold one streams it."""
    shape = (75, 96, 84, 84)
    plan = tfn._plan(shape, SM_COUNT, MAX_SMEM)
    assert plan == tfn.Plan(16, 1, True, 132304, 256, 96 * 16)
    portable = tfn._plan(shape, SM_COUNT, MAX_SMEM, max_cluster=8)
    assert not portable.staged and portable.smem_bytes == 0
    assert (_coverage(shape, portable) == 1).all()


def test_backward_plan_streams_the_north_star_target_stage():
    """x and the cotangent of (75, 96, 84, 84), 4.2 MB a channel, would need
    265 KB a block of a 16-block cluster: more than a block may take."""
    shape = (75, 96, 84, 84)
    assert tfn.BWD_ROW_BYTES * tfn._slice_floats(75 * 84 * 84, 16) > MAX_SMEM
    plan = tfn._plan(shape, SM_COUNT, MAX_SMEM, tfn.BWD_ROW_BYTES)
    assert not plan.staged and plan.smem_bytes == 0
    assert (_coverage(shape, plan) == 1).all()


@pytest.mark.parametrize("row_bytes", [4, 8], ids=["forward", "backward"])
@pytest.mark.parametrize(
    "shape", [(5, 256, 28, 28), (5, 512, 3, 3), (1, 1, 7, 7), (25, 96, 84, 84)],
    ids=str,
)
def test_forced_streamed_plan(shape, row_bytes):
    plan = tfn._plan(shape, SM_COUNT, MAX_SMEM, row_bytes, streamed=True)
    assert not plan.staged and plan.smem_bytes == 0
    assert plan.cluster in tfn.CLUSTER_SIZES[:4] and plan.channels_per_block == 1
    assert (_coverage(shape, plan) == 1).all()


@pytest.mark.parametrize("row_bytes", [4, 8], ids=["forward", "backward"])
@pytest.mark.parametrize("cluster", tfn.CLUSTER_SIZES)
def test_staged_plan_of_each_cluster_size_covers_every_channel_once(cluster, row_bytes):
    """The staged plans ``tools/port_fwd_plan_sweep.py`` times, one per
    cluster size, come from the planner's own ``_staged_plan``."""
    shape = (25, 96, 42, 42)
    plan = tfn._staged_plan(shape, cluster, row_bytes)
    assert plan.cluster == cluster and plan.staged and plan.blocks == 96 * cluster
    assert plan.smem_bytes == row_bytes * tfn._slice_floats(25 * 42 * 42, cluster)
    assert (_coverage(shape, plan) == 1).all()


def test_plan_prefers_portable_clusters_under_the_block_budget():
    plan = tfn._plan((25, 96, 84, 84), SM_COUNT, MAX_SMEM)
    assert plan.cluster == 8 and plan.smem_bytes <= tfn.BLOCK_SLICE_BYTES


def test_backward_plan_takes_16_blocks_under_the_block_budget():
    """x and the cotangent of (25, 96, 84, 84) fit the block budget on 16
    blocks (88 KB), not on 8 (176 KB); without 16-block clusters the plan
    stages on 8 over the budget."""
    shape = (25, 96, 84, 84)
    plan = tfn._plan(shape, SM_COUNT, MAX_SMEM, tfn.BWD_ROW_BYTES)
    assert plan == tfn._staged_plan(shape, 16, tfn.BWD_ROW_BYTES)
    assert plan.smem_bytes <= tfn.BLOCK_SLICE_BYTES
    portable = tfn._plan(shape, SM_COUNT, MAX_SMEM, tfn.BWD_ROW_BYTES, max_cluster=8)
    assert portable == tfn._staged_plan(shape, 8, tfn.BWD_ROW_BYTES)
    assert tfn.BLOCK_SLICE_BYTES < portable.smem_bytes <= MAX_SMEM


def test_a_plan_that_does_not_cover_the_tensor_is_refused():
    """The wrappers check a plan against the kernel before the launch: the
    forward's staged plan gives the backward half the shared memory its x
    and cotangent need."""
    x = torch.empty((5, 256, 28, 28), device="meta")
    fwd = tfn._plan(x.shape, SM_COUNT, MAX_SMEM, tfn.FWD_ROW_BYTES)
    with pytest.raises(ValueError, match="does not cover"):
        tfn._check_plan("bn_act_bwd", x, fwd, tfn.BWD_ROW_BYTES)
    with pytest.raises(ValueError, match="does not cover"):
        tfn._check_plan("bn_stats", x, fwd._replace(blocks=fwd.blocks - 1),
                        tfn.FWD_ROW_BYTES)


def test_launch_counts_cover_the_kernels_and_stay_zero_on_cpu(rng):
    assert tuple(tfn.launch_counts) == tfn.KERNELS == (
        "bn_stats", "bn_stats_act", "bn_act_bwd", "bn_act_pool_apply",
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

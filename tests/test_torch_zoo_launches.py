"""Fused-norm kernel launches per train and eval iteration of the four new
learners, counted on the CPU at the flagship's stage layout, against the
counts chip_smoke.py holds their card runs to exactly.

On a CUDA tensor each fused-norm Function launches its kernels once a
call: the one-level op ``bn_stats_act`` forward and ``bn_act_bwd``
backward, the any-order op ``bn_stats_act``, the pooled op ``bn_stats``
and K5 ``bn_act_pool_apply``. On the CPU the Functions run their plain
bodies, so this test counts the calls: it routes the one-level op through
its Function with counting plain kernels and counts the any-order and
pooled Functions' forwards. The counts depend on the stage layout (28x28
Omniglot, 4 stages, the 28 and 14 pixel stages pooled), the meta-batch of
8, the step counts and remat, not on the width, so the learners run at 8
filters.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    GradientDescentLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
    backbone,
)
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as fn
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

import chip_smoke
from test_torch_train import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED = dict.fromkeys(("use_pallas_fused_norm", "fused_norm_train", "fused_norm_pool"), True)


@pytest.fixture
def counted(monkeypatch):
    """Launch counts of the Functions' kernels while active, on the CPU."""
    counts = dict.fromkeys(fn.KERNELS, 0)

    def stats_act(x, gamma, beta, eps=fn.EPS, slope=fn.SLOPE):
        counts["bn_stats_act"] += 1
        mean, var = fn.plain_stats(x)
        return fn.plain_apply(x, mean, var, gamma, beta, eps, slope), mean, var

    def act_bwd(x, g, mean, var, gamma, beta, eps=fn.EPS, slope=fn.SLOPE):
        counts["bn_act_bwd"] += 1
        return fn.plain_bwd(x, g, mean, var, gamma, beta, eps, slope)

    def counting(function, names):
        forward = function.forward

        def wrapped(ctx, *args):
            for name in names:
                counts[name] += 1
            return forward(ctx, *args)

        return staticmethod(wrapped)

    monkeypatch.setattr(fn, "bn_stats_act", stats_act)
    monkeypatch.setattr(fn, "bn_act_bwd", act_bwd)
    monkeypatch.setattr(backbone, "fused_bn_leaky_relu",
                        lambda *a: fn.FusedBNLeakyReLU.apply(*a))
    monkeypatch.setattr(fn.FusedBNLeakyReLUHO, "forward",
                        counting(fn.FusedBNLeakyReLUHO, ("bn_stats_act",)))
    monkeypatch.setattr(fn.FusedBNLeakyReLUPool, "forward",
                        counting(fn.FusedBNLeakyReLUPool, ("bn_stats", "bn_act_pool_apply")))
    return counts


def _learner(cls, config, **overrides):
    cfg = load_maml_config(os.path.join(REPO, "experiment_config", config),
                           cnn_num_filters=8, **FUSED, **overrides)
    return cls(cfg)


def _batch(rng, tasks=8):
    return chip_smoke.train_batch(rng, tasks)


def _iteration_counts(counted, learner, train: bool, epoch=0):
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(np.random.RandomState(0))
    for name in counted:
        counted[name] = 0
    if train:
        learner.run_train_iter(state, batch, epoch)
    else:
        learner.run_validation_iter(state, batch)
    return dict(counted)


ZOO = {
    "gd": (GradientDescentLearner, chip_smoke.GD_CONFIG, chip_smoke.CLI_GD_TRAIN,
           chip_smoke.CLI_GD_EVAL),
    "matching_nets": (MatchingNetsLearner, chip_smoke.MATCHING_NETS_CONFIG,
                      chip_smoke.CLI_MATCHING_NETS_TRAIN, chip_smoke.CLI_MATCHING_NETS_EVAL),
    "protonets": (ProtoNetsLearner, chip_smoke.FLAGSHIP, chip_smoke.CLI_PROTONETS_TRAIN,
                  chip_smoke.CLI_PROTONETS_EVAL),
}


@pytest.mark.parametrize("phase", ["train", "eval"])
@pytest.mark.parametrize("kind", list(ZOO))
def test_shared_weights_learners_launch_what_chip_smoke_holds(counted, kind, phase):
    """Gradient descent: 8 tasks x (5 support + 1 target) forward and
    backward passes, train and eval alike; matching nets: 8 tasks x 2
    forwards and their backward in training, the 8 tasks folded in eval;
    ProtoNets: 2 forwards of the folded tasks. Each pass runs the pooled op
    at two stages and the one-level op at two, whose backward is
    ``bn_act_bwd``."""
    cls, config, want_train, want_eval = ZOO[kind]
    learner = _learner(cls, os.path.basename(config))
    got = _iteration_counts(counted, learner, phase == "train")
    assert got == (want_train if phase == "train" else want_eval)
    if phase == "train":
        assert got["bn_act_bwd"] > 0


@pytest.mark.parametrize("final_only", [False, True], ids=["msl", "final_only"])
def test_anil_launches_what_chip_smoke_holds(counted, final_only):
    """ANIL's train step (remat on, as the CLI trains) and its eval
    iteration: the any-order and pooled ops' forwards, recomputed where the
    outer backward reaches the checkpointed steps; no ``bn_act_bwd``, the
    head-only inner gradient never reaching a norm in eval."""
    learner = _learner(ANILLearner, os.path.basename(chip_smoke.FLAGSHIP),
                       multi_step_loss_num_epochs=2)
    assert learner.cfg.remat_inner_steps
    epoch = 2 if final_only else 0
    assert learner._final_only(epoch) == final_only
    got = _iteration_counts(counted, learner, True, epoch)
    assert got == (chip_smoke.CLI_ANIL_TRAIN_FINAL if final_only else chip_smoke.CLI_ANIL_TRAIN)
    assert _iteration_counts(counted, learner, False) == chip_smoke.CLI_ANIL_EVAL


def test_maml_flagship_counts_agree_with_this_count(counted):
    """The shim against counts the card confirmed: the MAML++ flagship CLI's
    train and eval iterations (chip_smoke.py's CLI_FLAGSHIP_*)."""
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner

    learner = _learner(MAMLFewShotLearner, os.path.basename(chip_smoke.FLAGSHIP),
                       multi_step_loss_num_epochs=2)
    assert _iteration_counts(counted, learner, True, 0) == chip_smoke.CLI_FLAGSHIP_TRAIN
    assert _iteration_counts(counted, learner, True, 2) == chip_smoke.CLI_FLAGSHIP_TRAIN_FINAL
    assert _iteration_counts(counted, learner, False) == chip_smoke.CLI_FLAGSHIP_EVAL


def test_zoo_kernel_shapes_are_checked_in_chip_smoke():
    """The shapes the T = 1 learners give the kernels at flagship width (5
    images x 64 channels) are among those chip_smoke.py holds to the plain
    version before its [coverage] check."""
    for hw in (28, 14, 7, 3):
        assert (5, 64, hw, hw) in chip_smoke.KERNEL_SHAPES
    for hw in (28, 14):
        assert (5, 64, hw, hw) in chip_smoke.POOL_SHAPES


@pytest.mark.parametrize("tag, overrides", chip_smoke.BACKBONE_OPTIONS,
                         ids=[t for t, _ in chip_smoke.BACKBONE_OPTIONS])
def test_backbone_options_launch_what_chip_smoke_holds(counted, tag, overrides):
    """chip_smoke.py's backbone_options phase: the first second-order step
    without remat (5 inner steps x support and target forwards a stage, the
    any-order op) and one eval iteration (5 + 1 forwards a stage and 5
    backwards, the one-level op). Only the stride-2 VGG has fused sites,
    none of them pooled; layer norm and ``norm_conv`` launch nothing."""
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner

    learner = _learner(MAMLFewShotLearner, os.path.basename(chip_smoke.FLAGSHIP),
                       **overrides)
    learner = MAMLFewShotLearner(dataclasses.replace(learner.cfg, remat_inner_steps=False))
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    for name in counted:
        counted[name] = 0
    chip_smoke.first_step(learner, state, _batch(np.random.RandomState(0)))
    learner.run_validation_iter(state, _batch(np.random.RandomState(1)))
    assert counted == chip_smoke.BACKBONE_OPTION_LAUNCHES[tag]

"""Lane padding (``lane_pad_channels``, ``ops/layout.py``) in the port,
against its unpadded twin and the JAX package (CPU, float32).

Conv channel dims are padded with structurally zero filters and the head
slices the real features back, so every padded leaf's gradient is exactly
zero and checkpoints never hold padding. Pinned: the layout helpers
against JAX's; padded against unpadded learners; second-order
meta-gradients at JAX's reassociation bar (rtol 2e-5, atol 1e-6,
tests/test_layout_padding.py) and zero on the padding; padding lanes
frozen exactly through training; checkpoints between padded and unpadded
learners of either package.

Not bitwise here, unlike JAX's: oneDNN's grouped convolution sums a
task's real channels in another order when the group holds padded ones,
so where tasks are folded into one convolution (MAML, ProtoNets, matching
nets' eval) the logits move by a few float32 ulps (measured up to 6.3e-7
of the largest logit over three batches; one task at a time, gradient
descent, stays bitwise). Held to ``PAD_RTOL`` norm-wise: logits, losses,
and the parameters after three updates, but for the leaves whose true
gradient is about zero (the conv biases before batch norm, ProtoNets'
linear bias), which Adam moves by up to the learning rate a step on
rounding noise and which are held to twice that (as
tests/test_torch_protonets.py holds them against JAX).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.ops import layout as jlayout
from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import (
    GradientDescentLearner,
    MAMLFewShotLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.ops import layout
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from test_torch_train import jax_config, one_intra_op_thread, port_config  # noqa: F401

LEARNERS = [MAMLFewShotLearner, GradientDescentLearner, MatchingNetsLearner,
            ProtoNetsLearner]
IDS = ["maml", "gd", "matching_nets", "protonets"]
EXP = {"current_iter": 9, "best_val_acc": 0.25}
# Padded against unpadded, norm-wise: max|padded - unpadded| <= PAD_RTOL *
# max|unpadded| (measured 6.3e-7 for logits, 2.8e-6 for parameters).
PAD_RTOL = 1e-5


def assert_pad_close(padded, unpadded):
    padded, unpadded = np.asarray(padded), np.asarray(unpadded)
    gap = float(np.abs(real_slice(padded, unpadded) - unpadded).max())
    assert gap <= PAD_RTOL * float(np.abs(unpadded).max()), gap


def _steady(path, cls) -> bool:
    """Whether a theta leaf has a true gradient away from zero."""
    if path[-1] == "bias" and path[-2] == "conv":
        return False
    return not (cls is ProtoNetsLearner and path == ("linear", "bias"))


def make_cfg(cls=MAMLFewShotLearner, lane_pad=False, **backbone):
    """Six filters, padded to eight (48 -> 64 at the north star's width)."""
    bb = dict(num_stages=2, num_filters=6, lane_pad_channels=lane_pad)
    bb.update(backbone)
    jcfg = jax_config(False, backbone=bb, use_multi_step_loss_optimization=False)
    return port_config(jcfg)


def make_batch(rng, tasks=4, size=12):
    xs = rng.randn(tasks, 5, 1, 1, size, size).astype(np.float32)
    ys = np.tile(np.arange(5)[None, :, None], (tasks, 1, 1)).astype(np.int32)
    return xs, xs.copy(), ys, ys.copy()


def pair(cls, seed, **backbone):
    a, p = (cls(make_cfg(cls, pad, **backbone)) for pad in (False, True))
    gen = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
    return a, p, a.init_state(gen(), "cpu"), p.init_state(gen(), "cpu")


def real_slice(padded, real):
    return np.asarray(padded)[tuple(slice(0, s) for s in np.shape(real))]


def padding_mask(padded, real):
    mask = np.ones(np.shape(padded), bool)
    mask[tuple(slice(0, s) for s in np.shape(real))] = False
    return mask


def test_lane_padded_width_matches_jax():
    for c in range(1, 400):
        assert layout.lane_padded_width(c) == jlayout.lane_padded_width(c)
    assert layout.lane_padded_width(48) == 64
    with pytest.raises(ValueError):
        layout.lane_padded_width(0)


def test_strip_pad_round_trip_matches_jax(rng):
    """zero_pad_to, strip_tree and pad_tree give JAX's arrays; stripping a
    padded tree and padding it back is the identity; a template's padding
    values are kept."""
    arr = rng.randn(3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        layout.zero_pad_to(torch.from_numpy(arr), (4, 8)).numpy(),
        np.asarray(jlayout.zero_pad_to(jax.numpy.asarray(arr), (4, 8))),
    )
    arr_t = torch.from_numpy(arr)
    assert layout.zero_pad_to(arr_t, (3, 5)) is arr_t
    with pytest.raises(ValueError):
        layout.zero_pad_to(torch.from_numpy(arr), (2, 8))
    padded = {"w": torch.from_numpy(rng.randn(8, 8).astype(np.float32)),
              "s": (torch.ones(8), None)}
    template = {"w": torch.zeros(6, 6), "s": (torch.zeros(6), None)}
    stripped = layout.strip_tree(padded, template)
    jstripped = jlayout.strip_tree(
        {"w": padded["w"].numpy(), "s": (padded["s"][0].numpy(), None)},
        {"w": np.zeros((6, 6)), "s": (np.zeros(6), None)},
    )
    np.testing.assert_array_equal(stripped["w"].numpy(), jstripped["w"])
    back = layout.pad_tree(stripped, padded)
    assert torch.equal(back["w"], padded["w"]) and back["s"][1] is None
    assert layout.trees_same_shapes(back, padded)
    assert not layout.trees_same_shapes(stripped, padded)


@pytest.mark.parametrize("cls", LEARNERS, ids=IDS)
def test_padded_learner_matches_unpadded(cls, rng):
    """Eval logits and loss, three train steps' losses (second order for
    MAML) and the parameters at ``PAD_RTOL`` (bitwise for gradient descent,
    one task at a time); every padding lane still its initial value."""
    a, p, sa, sp = pair(cls, 2)
    batch = make_batch(rng)
    _, la, logits_a = a.run_validation_iter(sa, batch)
    _, lp, logits_p = p.run_validation_iter(sp, batch)
    assert_pad_close(logits_p, logits_a)
    assert_pad_close(lp["loss"], la["loss"])
    init = tree_to_numpy(sp.theta)
    for _ in range(3):
        batch = make_batch(rng)
        sa, la = a.run_train_iter(sa, batch, epoch=0)
        sp, lp = p.run_train_iter(sp, batch, epoch=0)
        assert_pad_close(lp["loss"], la["loss"])
    flat = jax.tree_util.tree_flatten_with_path(tree_to_numpy(sa.theta))[0]
    for (path, leaf_a), leaf_p, leaf_i in zip(flat,
                                              jax.tree.leaves(tree_to_numpy(sp.theta)),
                                              jax.tree.leaves(init)):
        path = tuple(k.key for k in path)
        if cls is GradientDescentLearner:
            np.testing.assert_array_equal(real_slice(leaf_p, leaf_a), leaf_a)
        elif _steady(path, cls):
            assert_pad_close(leaf_p, leaf_a)
        else:
            np.testing.assert_allclose(real_slice(leaf_p, leaf_a), leaf_a, rtol=0,
                                       atol=2 * 3 * p.cfg.meta_learning_rate)
        mask = padding_mask(leaf_p, leaf_a)
        np.testing.assert_array_equal(leaf_p[mask], leaf_i[mask])


def test_padded_second_order_meta_grads(rng):
    """The meta-gradient: the real slice at JAX's reassociation bar, zero
    on every padding lane."""
    a, p, sa, sp = pair(MAMLFewShotLearner, 3)
    batch = make_batch(rng)
    grads = [
        learner._meta_grads(state, learner._device_batch(state, batch),
                            torch.tensor([0.0, 1.0]), second_order=True,
                            final_only=True)[3]
        for learner, state in ((a, sa), (p, sp))
    ]
    ga, gp = (jax.tree.leaves(tree_to_numpy(g["theta"])) for g in grads)
    assert sum(float(np.abs(g).sum()) for g in ga) > 0
    for leaf_p, leaf_a in zip(gp, ga):
        np.testing.assert_allclose(real_slice(leaf_p, leaf_a), leaf_a,
                                   rtol=2e-5, atol=1e-6)
        assert np.all(leaf_p[padding_mask(leaf_p, leaf_a)] == 0.0)


def test_padded_resnet12_eval_matches_unpadded(rng):
    """ResNet-12 at widths (4, 5, 6, 7), padded to 8: eval logits and loss
    at ``PAD_RTOL``."""
    backbone = dict(architecture="resnet12", resnet_widths=(4, 5, 6, 7),
                    per_step_bn_statistics=False, image_height=16, image_width=16)
    a, p, sa, sp = pair(MAMLFewShotLearner, 4, **backbone)
    assert p.backbone.widths == (8, 8, 8, 8)
    batch = make_batch(rng, size=16)
    _, la, logits_a = a.run_validation_iter(sa, batch)
    _, lp, logits_p = p.run_validation_iter(sp, batch)
    assert_pad_close(logits_p, logits_a)
    assert_pad_close(lp["loss"], la["loss"])


def test_lane_friendly_width_is_a_no_op():
    """At eight filters padding changes no shape: the same state, and no
    template for the checkpoint path."""
    a, p, sa, sp = pair(MAMLFewShotLearner, 5, num_filters=8)
    for x, y in zip(tree_leaves(sa.theta), tree_leaves(sp.theta)):
        assert torch.equal(x, y)
    assert p._unpadded_template("init_state") is None


def _read(path):
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def test_padded_archive_equals_unpadded_archive(tmp_path):
    """From one seed, a padded and an unpadded writer write archives whose
    members are byte for byte the same (the manifest CRCs are over the
    stripped state)."""
    a, p, sa, sp = pair(MAMLFewShotLearner, 9)
    pa, pp = str(tmp_path / "train_model_1"), str(tmp_path / "train_model_2")
    a.save_model(pa, sa, dict(EXP))
    p.save_model(pp, sp, dict(EXP))
    za, zp = _read(pa), _read(pp)
    assert set(za) == set(zp)
    for name in za:
        assert za[name].dtype == zp[name].dtype and za[name].tobytes() == zp[name].tobytes()
    snap = p.snapshot_model(sp, dict(EXP))
    assert all(np.array_equal(v, za[k]) for k, v in snap.arrays.items())


def test_checkpoint_round_trip_padded_unpadded_padded(tmp_path, rng):
    """padded writer -> unpadded reader -> padded reader: every reader sees
    the real values, the padded one the initial padding; the round-tripped
    padded state gives the writer's logits bitwise; the inference prefix
    re-pads the same way."""
    writer = MAMLFewShotLearner(make_cfg(lane_pad=True))
    state = writer.init_state(torch.Generator().manual_seed(8), "cpu")
    state, _ = writer.run_train_iter(state, make_batch(rng), epoch=0)
    writer.save_model(str(tmp_path / "train_model_3"), state, dict(EXP))
    unpadded = MAMLFewShotLearner(make_cfg(lane_pad=False))
    s_unpadded, exp = unpadded.load_model(str(tmp_path), "train_model", 3, "cpu")
    assert exp == EXP
    for u, w in zip(jax.tree.leaves(tree_to_numpy(s_unpadded.theta)),
                    jax.tree.leaves(tree_to_numpy(state.theta))):
        np.testing.assert_array_equal(u, real_slice(w, u))
    unpadded.save_model(str(tmp_path / "train_model_4"), s_unpadded, dict(EXP))
    padded = MAMLFewShotLearner(make_cfg(lane_pad=True))
    s_padded, _ = padded.load_model(str(tmp_path), "train_model", 4, "cpu")
    for a, b in zip(tree_leaves(s_padded), tree_leaves(state)):
        assert a.shape == b.shape
    init = padded.init_state(torch.Generator().manual_seed(0), "cpu")
    for p_leaf, u_leaf, i_leaf in zip(
        jax.tree.leaves(tree_to_numpy(s_padded.theta)),
        jax.tree.leaves(tree_to_numpy(s_unpadded.theta)),
        jax.tree.leaves(tree_to_numpy(init.theta)),
    ):
        np.testing.assert_array_equal(real_slice(p_leaf, u_leaf), u_leaf)
        mask = padding_mask(p_leaf, u_leaf)
        np.testing.assert_array_equal(p_leaf[mask], i_leaf[mask])
    batch = make_batch(rng)
    _, _, logits_w = writer.run_validation_iter(state, batch)
    _, _, logits_p = padded.run_validation_iter(s_padded, batch)
    assert torch.equal(logits_w, logits_p)
    istate, exp = padded.load_inference_state(str(tmp_path / "train_model_4"), "cpu")
    assert exp == EXP
    for a, b in zip(tree_leaves(istate.theta), tree_leaves(s_padded.theta)):
        assert torch.equal(a, b)


def test_jax_padded_checkpoint_loads_into_the_port(tmp_path, rng):
    """A JAX lane-padded learner's checkpoint after a train step loads into
    the port's padded learner as the JAX state itself (JAX's padding lanes
    stay at their initial values, which the port's template holds) and
    into its unpadded learner as the JAX state's real slice."""
    jcfg = jax_config(False, backbone=dict(num_stages=2, num_filters=6,
                                           lane_pad_channels=True))
    jlearner = JLearner(jcfg)
    jstate = jlearner.init_state(jax.random.PRNGKey(8))
    jstate, _ = jlearner.run_train_iter(jstate, make_batch(rng), epoch=0)
    jlearner.save_model(str(tmp_path / "train_model_2"), jstate, dict(EXP))
    jtheta = jax.tree.leaves(jax.tree.map(np.asarray, jstate.theta))
    for pad in (True, False):
        cfg = port_config(jcfg)
        cfg = dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, lane_pad_channels=pad)
        )
        learner = MAMLFewShotLearner(cfg)
        state, exp = learner.load_model(str(tmp_path), "train_model", 2, "cpu")
        assert exp == EXP and int(state.iteration) == 1
        for ours, theirs in zip(jax.tree.leaves(tree_to_numpy(state.theta)), jtheta):
            np.testing.assert_array_equal(ours, theirs if pad else real_slice(theirs, ours))

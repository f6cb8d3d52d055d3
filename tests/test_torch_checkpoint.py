"""The port's checkpoint archive against the JAX package's: interchangeable
both ways, bit for bit, with the same key paths and fingerprint; and the
integrity contract of ``tests/test_checkpoint_integrity.py`` on the port's
module (CPU).

A JAX ``TrainState`` and the port's hold the same values
(``tests/test_torch_train.learner_pair``), over the configurations whose
optimizer states lay out differently: gradient clip on and off, frozen
LSLR rates, frozen batch-norm gamma and beta; and a ResNet-12 state, whose
parameters and BN statistics nest two levels deep. The same holds for the
states of the gradient-descent, matching-nets and ProtoNets learners,
whose Adam runs over all of theta with no mask, with the clip and
without.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import (
    DictKey,
    GetAttrKey,
    SequenceKey,
    tree_flatten_with_path,
)

from howtotrainyourmamlpytorch_tpu.models import (
    GradientDescentLearner as JGradientDescentLearner,
    MatchingNetsLearner as JMatchingNetsLearner,
    ProtoNetsLearner as JProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu.utils import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    shared_state_from_numpy,
    train_state_from_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    GradientDescentLearner,
    InferenceState,
    MatchingNetsLearner,
    ProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models.common import CheckpointableLearner
from howtotrainyourmamlpytorch_tpu_torch.utils import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from test_torch_gradient_descent import shared_state_numpy, zoo_config
from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    jax_config,
    jax_train_state_numpy,
    learner_pair,
    one_intra_op_thread,
    port_config,
)

CONFIGS = {
    "default": {},
    "clip": {"clip_grad_value": 10.0},
    "frozen_lslr": {"learnable_per_layer_per_step_inner_loop_learning_rate": False},
    "frozen_gamma_beta": {"learnable_bn_gamma": False, "learnable_bn_beta": False},
    # ResNet-12: two-level paths (a:theta;d:res0;d:conv0;...) and BN state.
    "resnet12": {"backbone": {"architecture": "resnet12", "resnet_widths": (4, 4, 8, 8),
                              "image_height": 16, "image_width": 16}},
}
EXP = {"current_iter": 7, "best_val_acc": 0.5, "per_epoch_statistics": {"a": [1.0]}}


def _encode(path) -> str:
    names = {DictKey: "d:{0.key}", SequenceKey: "s:{0.idx}", GetAttrKey: "a:{0.name}"}
    return ";".join(names[type(e)].format(e) for e in path)


@pytest.fixture(params=list(CONFIGS), scope="module")
def pair(request):
    jcfg = jax_config(False, **CONFIGS[request.param])
    jlearner, jstate, learner, state = learner_pair(jcfg)
    # Move the state off its init so that every leaf is distinct.
    rng = np.random.RandomState(0)
    jstate = jax.tree.map(
        lambda a: a + np.asarray(rng.rand(*np.shape(a))).astype(a.dtype)
        if np.issubdtype(a.dtype, np.floating) else a + 3,
        jstate,
    )
    lr = float(jstate.opt_state.hyperparams["learning_rate"])
    state = train_state_from_numpy(jax_train_state_numpy(jstate), lr, "cpu")
    return jlearner, jstate, learner, state


def _assert_same_leaves(learner, got, want):
    got, want = learner._path_leaves(got), learner._path_leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_paths_and_fingerprint_match_jax(pair):
    _, jstate, learner, state = pair
    jax_paths = [_encode(p) for p, _ in tree_flatten_with_path(jstate)[0]]
    port = learner._path_leaves(state)
    assert [p for p, _ in port] == jax_paths
    if learner.cfg.backbone.architecture == "resnet12":
        assert "a:theta;d:res0;d:conv0;d:conv;d:weight" in jax_paths
        assert "a:bn_state;d:res3;d:shortcut;a:running_var" in jax_paths
    assert ckpt.tree_crc32(p for p, _ in port) == jckpt._tree_fingerprint(jstate)
    for (_, got), want in zip(port, jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_jax_checkpoint_loads_in_the_port(pair, tmp_path):
    jlearner, jstate, learner, state = pair
    path = str(tmp_path / "train_model_0")
    jckpt.save_checkpoint(path, jstate, EXP)
    loaded, exp = learner.load_model(str(tmp_path), "train_model", 0, device="cpu")
    assert exp == EXP
    _assert_same_leaves(learner, loaded, state)


def test_port_checkpoint_loads_in_jax(pair, tmp_path):
    jlearner, jstate, learner, state = pair
    learner.save_model(str(tmp_path / "train_model_1"), state, EXP)
    loaded, exp = jlearner.load_model(str(tmp_path), "train_model", 1)
    assert exp == EXP
    for got, want in zip(jax.tree.leaves(loaded), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # The manifests agree too.
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, EXP)
    manifests = []
    for name in ("train_model_1", "jax"):
        with np.load(str(tmp_path / name)) as archive:
            manifests.append(json.loads(bytes(archive["__manifest__"]).decode()))
    assert manifests[0] == manifests[1]


def test_inference_prefix_of_a_jax_checkpoint(pair, tmp_path):
    _, jstate, learner, state = pair
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, jstate, EXP)
    istate, exp = learner.load_inference_state(path, device="cpu")
    assert exp == EXP
    _assert_same_leaves(learner, istate, type(istate)(*state[:3]))


# ---------------------------------------------------------------------------
# The shared-weights learners' states: Adam over all of theta, no mask
# ---------------------------------------------------------------------------

ZOO = {
    "gd": (JGradientDescentLearner, GradientDescentLearner),
    "matching_nets": (JMatchingNetsLearner, MatchingNetsLearner),
    "protonets": (JProtoNetsLearner, ProtoNetsLearner),
}


@pytest.fixture(params=[(k, c) for k in ZOO for c in (None, 10.0)],
                ids=[f"{k}-{'clip' if c else 'no-clip'}" for k in ZOO for c in (None, 10.0)],
                scope="module")
def zoo_pair_moved(request):
    """A JAX ``GDState``/``MatchingNetsState``/``ProtoNetsState`` moved off
    its init (every leaf distinct) and the port's copy; with the +-10 clip
    the optax chain is one level deeper."""
    kind, clip = request.param
    jcls, cls = ZOO[kind]
    jcfg = zoo_config(False, clip_grad_value=clip)
    jlearner, learner = jcls(jcfg), cls(port_config(jcfg))
    jstate = jlearner.init_state(jax.random.PRNGKey(3))
    rng = np.random.RandomState(1)
    jstate = jax.tree.map(
        lambda a: a + np.asarray(rng.rand(*np.shape(a))).astype(a.dtype)
        if np.issubdtype(a.dtype, np.floating) else a + 3,
        jstate,
    )
    lr = float(jstate.opt_state.hyperparams["learning_rate"])
    state = shared_state_from_numpy(shared_state_numpy(jstate), learner.state_type,
                                    lr, "cpu")
    return jlearner, jstate, learner, state


def test_zoo_paths_and_fingerprint_match_jax(zoo_pair_moved):
    test_paths_and_fingerprint_match_jax(zoo_pair_moved)


def test_zoo_jax_checkpoint_loads_in_the_port(zoo_pair_moved, tmp_path):
    test_jax_checkpoint_loads_in_the_port(zoo_pair_moved, tmp_path)


def test_zoo_port_checkpoint_loads_in_jax(zoo_pair_moved, tmp_path):
    test_port_checkpoint_loads_in_jax(zoo_pair_moved, tmp_path)


def test_zoo_inference_prefix_of_a_jax_checkpoint(zoo_pair_moved, tmp_path):
    """The parameters and BN statistics (``InferenceState``) lead the
    archive; the learners' own ``load_inference_state`` (gradient descent
    adds its fine-tune rate) reads the same prefix."""
    _, jstate, learner, state = zoo_pair_moved
    path = str(tmp_path / "ckpt")
    jckpt.save_checkpoint(path, jstate, EXP)
    istate, exp = CheckpointableLearner.load_inference_state(learner, path, device="cpu")
    assert exp == EXP and type(istate) is InferenceState
    _assert_same_leaves(learner, istate, InferenceState(*state[:2]))
    served, _ = learner.load_inference_state(path, device="cpu")
    for a, b in zip(served[:2], istate):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# The integrity contract, on the port's module
# ---------------------------------------------------------------------------


def _leaves(seed=0, n=3, size=7):
    rng = np.random.RandomState(seed)
    return [(f"a:l;d:{i}", rng.randn(size).astype(np.float32)) for i in range(n)] + [
        ("a:count", np.asarray(seed, np.int32))
    ]


def _save(path, seed=0, exp=None):
    return ckpt.save_checkpoint(str(path), _leaves(seed), exp or {"current_iter": seed})


def test_roundtrip_and_manifest(tmp_path):
    path = _save(tmp_path / "ckpt", seed=3)
    restored, exp = ckpt.load_checkpoint(path, _leaves(0))
    assert exp == {"current_iter": 3}
    for got, (_, want) in zip(restored, _leaves(3)):
        np.testing.assert_array_equal(got, want)
    info = ckpt.verify_checkpoint(path)
    assert info["leaves"] == 4 and info["has_manifest"]


def test_truncated_archive_is_typed_corrupt(tmp_path):
    path = _save(tmp_path / "ckpt")
    size = os.path.getsize(path)
    for cut in (0, 10, size // 2, size - 3):
        with open(path, "r+b") as f:
            f.truncate(cut)
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_checkpoint(path, _leaves(0))
        _save(tmp_path / "ckpt")


def test_bitflip_in_leaf_data_is_typed_corrupt(tmp_path):
    path = str(tmp_path / "ckpt")
    leaf = np.full((64,), 1.2345678, np.float32)
    ckpt.save_checkpoint(path, [("a:x", leaf)], {"current_iter": 0})
    with open(path, "rb") as f:
        offset = f.read().find(leaf.tobytes())
    assert offset > 0
    with open(path, "r+b") as f:
        f.seek(offset + 17)
        byte = f.read(1)
        f.seek(offset + 17)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(path, [("a:x", leaf)])


def test_missing_file_is_typed_corrupt(tmp_path):
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(str(tmp_path / "nope"), _leaves(0))


def test_newer_schema_refused_not_quarantined(tmp_path):
    path = _save(tmp_path / "ckpt")
    with np.load(path) as archive:
        arrays = {k: archive[k] for k in archive.files}
    manifest = json.loads(bytes(arrays["__manifest__"]).decode())
    manifest["schema"] = ckpt.SCHEMA_VERSION + 1
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ckpt.CheckpointError) as err:
        ckpt.load_checkpoint(path, _leaves(0))
    assert not isinstance(err.value, ckpt.CheckpointCorruptError)


@pytest.mark.parametrize("template, match", [
    (_leaves(0, n=2), "leaves"),
    (_leaves(0, n=5), "leaves"),
    ([(p.replace("a:l", "a:m"), a) for p, a in _leaves(0)], "fingerprint"),
    (_leaves(0, size=8), "shape"),
])
def test_structural_mismatch_is_valueerror(tmp_path, template, match):
    path = _save(tmp_path / "ckpt")
    with pytest.raises(ValueError, match=match):
        ckpt.load_checkpoint(path, template)


def test_transient_read_error_retries_then_gives_up_without_corrupt(tmp_path, monkeypatch):
    path = _save(tmp_path / "ckpt")
    real_load, calls = np.load, []

    def flaky(file, *args, **kwargs):
        calls.append(file)
        if len(calls) < 2:
            raise OSError(5, "EIO")
        return real_load(file, *args, **kwargs)

    monkeypatch.setattr(np, "load", flaky)
    ckpt.load_checkpoint(path, _leaves(0), backoff_s=0.0)
    assert len(calls) == 2

    def always_eio(file, *args, **kwargs):
        raise OSError(5, "EIO")

    monkeypatch.setattr(np, "load", always_eio)
    with pytest.raises(ckpt.CheckpointError) as err:
        ckpt.load_checkpoint(path, _leaves(0), backoff_s=0.0)
    assert not isinstance(err.value, ckpt.CheckpointCorruptError)


def test_alias_is_a_hardlink_and_marker_records_the_digest(tmp_path):
    path = _save(tmp_path / "train_model_1")
    latest = ckpt.publish_alias(path, str(tmp_path / "train_model_latest"))
    assert os.path.samefile(path, latest)
    marker = ckpt.publish_done_marker(path)
    with open(marker) as f:
        payload = json.load(f)
    assert payload["digest"] == ckpt.checkpoint_digest(path)
    assert payload["digest"] == jckpt.checkpoint_digest(path)


def test_async_writer_gives_the_sync_bytes_in_order(tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "sync"), _leaves(2), {"current_iter": 2})
    writer = ckpt.AsyncCheckpointWriter()
    try:
        for epoch in (1, 2):
            writer.submit(
                str(tmp_path / f"ckpt_{epoch}"),
                ckpt.snapshot_for_save(_leaves(epoch), {"current_iter": epoch}),
                alias_dst=str(tmp_path / "latest"), publish_marker=True,
            )
        assert writer.drain()
        assert writer.pending == 0
    finally:
        writer.close()
    with open(tmp_path / "sync", "rb") as a, open(tmp_path / "ckpt_2", "rb") as b:
        assert a.read() == b.read()
    _, exp = ckpt.load_checkpoint(str(tmp_path / "latest"), _leaves(0))
    assert exp["current_iter"] == 2
    assert os.path.exists(tmp_path / "ckpt_1.ready")


def test_async_writer_error_surfaces_at_the_next_boundary(tmp_path):
    writer = ckpt.AsyncCheckpointWriter()
    try:
        writer.submit(str(tmp_path / "missing_dir" / "ckpt"),
                      ckpt.snapshot_for_save(_leaves(1), {}), backoff_s=0.0)
        with pytest.raises(OSError):
            writer.drain()
        writer.submit(str(tmp_path / "ok"), ckpt.snapshot_for_save(_leaves(1), {}))
        assert writer.drain()
    finally:
        writer.close()
    with pytest.raises(ckpt.CheckpointError):
        writer.submit(str(tmp_path / "late"), ckpt.snapshot_for_save(_leaves(1), {}))

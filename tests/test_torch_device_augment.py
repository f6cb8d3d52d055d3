"""On-device train augmentation (``--device_augment``) in the port against
the JAX package's, on the CPU: the rotation and the crop/flip transforms
bit for bit, the defer-augment loader's batches bit for bit, and training
on raw pixels with the in-step rotation bitwise equal to training on
host-rotated episodes (JAX's contract, tests/test_wire_codec.py:222-285).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.data import MetaLearningSystemDataLoader as JLoader
from howtotrainyourmamlpytorch_tpu.models import common as jcommon
from howtotrainyourmamlpytorch_tpu.utils import parser_utils as j_parser
from howtotrainyourmamlpytorch_tpu_torch.data import (
    FewShotLearningDataset,
    MetaLearningSystemDataLoader,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    GradientDescentLearner,
    MAMLFewShotLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.models import common
from howtotrainyourmamlpytorch_tpu_torch.utils import parser_utils
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from test_data import make_args, make_dataset_dir
from test_torch_train import one_intra_op_thread  # noqa: F401
from test_wire_codec import _learner_args


@pytest.fixture
def omniglot_env(tmp_path, monkeypatch):
    make_dataset_dir(tmp_path / "omniglot_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("shape", [(10, 1, 6, 6), (3, 10, 2, 5, 5)],
                         ids=["one_task", "three_tasks"])
def test_rot90_by_gather_matches_jax(shape, rng):
    """The class-level quarter turns of float images (5 classes, 2 images
    each), bit for bit JAX's; a leading task axis rotates each task by its
    own operand, as JAX's vmap does."""
    x = rng.randn(*shape).astype(np.float32)
    ks = rng.randint(0, 4, size=shape[:-4] + (5,)).astype(np.int32)
    got = common.rot90_by_gather(torch.from_numpy(x), torch.from_numpy(ks))
    fn = jcommon.rot90_by_gather
    for _ in shape[:-4]:
        fn = jax.vmap(fn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(fn(jnp.asarray(x), jnp.asarray(ks))))


@pytest.mark.parametrize("seed, stream", [(77, 0), (77, 1), (1234, 0), (5, 0), (5, 1),
                                          (2**32 - 1, 1)])
def test_crop_flip_by_key_matches_jax(seed, stream):
    """The keyed crop and flip of cifar-sized images, bit for bit JAX's for
    the seeds and streams of tests/test_wire_codec.py:287-324; the two
    streams draw apart."""
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (6, 3, 32, 32)).astype(np.float32) / 255.0
    got = common.crop_flip_by_key(torch.from_numpy(x), seed, 4, stream)
    want = jcommon.crop_flip_by_key(jnp.asarray(x), jnp.uint32(seed), 4, stream)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = common.crop_flip_by_key(torch.from_numpy(x), seed, 4, 1 - stream)
    assert not torch.equal(got, other)


def test_decode_train_batch_matches_jax(rng):
    """The batch-level decode with each augmentation: uint8 Omniglot wire
    and quarter turns, cifar's deferred-normalization wire and episode
    seeds (crop and flip between the descale and the normalization); and
    the plain decode without an operand."""
    ks = rng.randint(0, 4, size=(2, 5)).astype(np.int32)
    omni = (rng.rand(2, 10, 1, 8, 8) > 0.5).astype(np.uint8)
    cifar = rng.randint(0, 256, (2, 5, 3, 32, 32)).astype(np.uint8)
    seeds = np.asarray([77, 1234], np.uint32)
    ys = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    cases = [
        (omni, omni[:, :5], ks, (1.0, None, None), ("rot90", 4)),
        (cifar, cifar, seeds, (255.0, mean, std), ("crop_flip", 4)),
        (omni, omni[:, :5], None, (1.0, None, None), None),
    ]
    for xs, xt, aug, codec, augment in cases:
        batch = (xs, xt, np.repeat(ys, xs.shape[1] // 5, axis=1), ys)
        batch += () if aug is None else (aug,)
        got = common.decode_train_batch(
            tuple(torch.from_numpy(a) for a in batch), common.WireCodec(*codec),
            torch.float32, None if augment is None else common.DeviceAugment(*augment),
        )
        want = jcommon.decode_train_batch(
            tuple(jnp.asarray(a) for a in batch), jcommon.WireCodec(*codec),
            jnp.float32, None if augment is None else jcommon.DeviceAugment(*augment),
        )
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_device_augment_for_matches_jax(tmp_path):
    """The parser's spec: rot90 on Omniglot, crop_flip on cifar with the
    uint8 wire (refused without it), nothing on ImageNet or when off."""
    cases = [
        ({"dataset_name": "omniglot_dataset", "device_augment": True}, "rot90"),
        ({"dataset_name": "cifar10", "device_augment": True,
          "transfer_dtype": "uint8", "classification_mean": [0.5] * 3,
          "classification_std": [0.25] * 3}, "crop_flip"),
        ({"dataset_name": "mini_imagenet_full_size", "device_augment": True}, None),
        ({"dataset_name": "omniglot_dataset", "device_augment": False}, None),
    ]
    for args, kind in cases:
        got = parser_utils.device_augment_for(args)
        want = j_parser.device_augment_for(make_args(tmp_path, **args))
        assert (got and tuple(got)) == (want and tuple(want))
        assert (got and got.kind) == kind
    with pytest.raises(ValueError, match="uint8"):
        parser_utils.device_augment_for({"dataset_name": "cifar100", "device_augment": True})


@pytest.mark.parametrize("load_into_memory", [False, True], ids=["disk", "ram"])
def test_loader_batches_match_the_jax_loader(omniglot_env, load_into_memory):
    """With ``device_augment`` the train batches are 6-tuples (raw pixels,
    labels, seeds, the (B, N) int32 quarter turns), bit for bit the JAX
    loader's; the turns are those the host would have applied; eval
    batches carry no operand."""
    args = make_args(omniglot_env, device_augment=True, load_into_memory=load_into_memory)
    jloader = JLoader(args, current_iter=3)
    loader = MetaLearningSystemDataLoader(args, current_iter=3)
    try:
        for split, kw in (("train", {"augment_images": True}), ("val", {})):
            want = next(getattr(jloader, f"get_{split}_batches")(total_batches=2, **kw))
            got = next(getattr(loader, f"get_{split}_batches")(total_batches=2, **kw))
            assert len(got) == len(want) == (6 if split == "train" else 5)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[-1].dtype == np.int64  # the val seeds
    finally:
        loader.close()
    ds = FewShotLearningDataset(args)
    host = FewShotLearningDataset(make_args(omniglot_env, load_into_memory=load_into_memory))
    raw = ds.get_set("train", seed=7, augment_images=True)
    rotated = host.get_set("train", seed=7, augment_images=True)
    assert raw[5].dtype == np.int32 and raw[5].shape == (5,)
    turned = common.rot90_by_gather(torch.from_numpy(raw[0].reshape(5, 1, 28, 28)),
                                    torch.from_numpy(raw[5]))
    np.testing.assert_array_equal(turned.numpy().reshape(rotated[0].shape), rotated[0])


def _batch(ds, seeds):
    episodes = [ds.get_set("train", seed=s, augment_images=True) for s in seeds]
    cols = list(zip(*episodes))
    return tuple(np.stack(c) for c in cols[:4]) + tuple(np.asarray(c) for c in cols[5:])


@pytest.mark.parametrize(
    "cls", [MAMLFewShotLearner, GradientDescentLearner, MatchingNetsLearner,
            ProtoNetsLearner],
    ids=["maml", "gd", "matching_nets", "protonets"],
)
def test_device_rotation_training_is_bitwise_host_rotation(omniglot_env, cls):
    """Training on raw-pixel episodes with the in-step rotation is bit for
    bit training on host-rotated episodes (uint8 wire, three updates; MAML
    at K=1 and in a K=2 group), and eval applies no augmentation on either
    side."""
    args_host = _learner_args(omniglot_env, transfer_dtype="uint8")
    args_dev = _learner_args(omniglot_env, transfer_dtype="uint8", device_augment=True)
    ds_host, ds_dev = FewShotLearningDataset(args_host), FewShotLearningDataset(args_dev)
    lh = cls(parser_utils.args_to_maml_config(vars(args_host)))
    ld = cls(parser_utils.args_to_maml_config(vars(args_dev)))
    assert ld.cfg.device_augment == common.DeviceAugment("rot90")
    sh = lh.init_state(torch.Generator().manual_seed(21), "cpu")
    sd = ld.init_state(torch.Generator().manual_seed(21), "cpu")
    for it in range(3):
        seeds = [1000 + 10 * it, 2000 + 10 * it]
        bh, bd = _batch(ds_host, seeds), _batch(ds_dev, seeds)
        assert len(bh) == 4 and len(bd) == 5
        sh, mh = lh.run_train_iter(sh, bh, epoch=0)
        sd, md = ld.run_train_iter(sd, bd, epoch=0)
        assert torch.equal(mh["loss"], md["loss"]), it
    if cls is MAMLFewShotLearner:
        group_h = [_batch(ds_host, [s, s + 1]) for s in (3000, 3100)]
        group_d = [_batch(ds_dev, [s, s + 1]) for s in (3000, 3100)]
        sh, mh = lh.run_train_iters(sh, group_h, epoch=0)
        sd, md = ld.run_train_iters(sd, group_d, epoch=0)
        assert torch.equal(mh["loss"], md["loss"])
    for a, b in zip(tree_leaves(sh), tree_leaves(sd)):
        assert torch.equal(a, b)
    eval_batch = _batch(ds_host, [31, 32])
    _, eh, ph = lh.run_validation_iter(sh, eval_batch)
    _, ed, pd = ld.run_validation_iter(sd, eval_batch)
    assert torch.equal(eh["loss"], ed["loss"]) and torch.equal(ph, pd)

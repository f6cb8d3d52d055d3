"""The port's host data path and command line against the JAX package's
(CPU): the first train, val and test batches of the two loaders are
bit-identical on the same tree and args, the sampler replays the recorded
episodes of the original implementation, and every experiment config
parses to the same values."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import howtotrainyourmamlpytorch_tpu.data.fast_synth as j_fast_synth
from howtotrainyourmamlpytorch_tpu.data import (
    MetaLearningSystemDataLoader as JLoader,
)
from howtotrainyourmamlpytorch_tpu.utils import parser_utils as j_parser
from howtotrainyourmamlpytorch_tpu_torch.data import (
    FewShotLearningDataset,
    MetaLearningSystemDataLoader,
)
from howtotrainyourmamlpytorch_tpu_torch.data import dataset as port_dataset
from howtotrainyourmamlpytorch_tpu_torch.data import fast_synth
from howtotrainyourmamlpytorch_tpu_torch.utils import parser_utils

from test_data import make_args, make_dataset_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "experiment_config", "*.json")))


def make_presplit_rgb_dir(root, n_classes=5, n_imgs=4, size=12):
    """``<root>/{train,val,test}/<class>/<i>.png``, RGB noise."""
    rng = np.random.RandomState(1)
    for split in ("train", "val", "test"):
        for c in range(n_classes):
            d = root / split / f"n{c:04d}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n_imgs):
                pixels = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
                Image.fromarray(pixels, mode="RGB").save(str(d / f"{i}.png"))


# name: (tree, make_args overrides)
TREES = {
    "omniglot": ("omniglot", {}),
    "omniglot_ram": ("omniglot", {"load_into_memory": True}),
    "imagenet": ("imagenet", {}),
    "imagenet_ram": ("imagenet", {"load_into_memory": True}),
    "imagenet_ram_uint8": ("imagenet", {"load_into_memory": True,
                                        "transfer_dtype": "uint8"}),
}


def _args(root, tree, overrides):
    if tree == "imagenet":
        overrides = dict(
            dict(dataset_name="imagenet_mini", dataset_path=str(root / "imagenet_mini"),
                 image_height=12, image_width=12, image_channels=3,
                 sets_are_pre_split=True),
            **overrides,
        )
    return make_args(root, **overrides)


def _first(batches):
    batch = next(batches)
    batches.close()
    return batch


@pytest.mark.parametrize("assembly", ["native", "numpy"])
@pytest.mark.parametrize("name", list(TREES))
def test_first_batches_bit_identical_to_the_jax_loader(tmp_path, monkeypatch,
                                                       name, assembly):
    tree, overrides = TREES[name]
    if tree == "omniglot":
        make_dataset_dir(tmp_path / "omniglot_mini")
    else:
        make_presplit_rgb_dir(tmp_path / "imagenet_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    if assembly == "numpy":
        monkeypatch.setattr(j_fast_synth, "_lib", None)
        monkeypatch.setattr(fast_synth, "_state", {"lib": None})
    else:
        assert fast_synth.native_available()
    jloader = JLoader(_args(tmp_path, tree, overrides), current_iter=3)
    loader = MetaLearningSystemDataLoader(_args(tmp_path, tree, overrides),
                                          current_iter=3)
    try:
        for augment in (True, False):
            want = _first(jloader.get_train_batches(total_batches=4,
                                                    augment_images=augment))
            got = _first(loader.get_train_batches(total_batches=4,
                                                  augment_images=augment))
            assert len(got) == len(want) == 5
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        for split in ("val", "test"):
            want = _first(getattr(jloader, f"get_{split}_batches")(total_batches=2))
            got = _first(getattr(loader, f"get_{split}_batches")(total_batches=2))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    finally:
        loader.close()


@pytest.mark.parametrize("config", CONFIGS, ids=os.path.basename)
def test_every_config_parses_as_in_jax(config, tmp_path, monkeypatch):
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    argv = ["--name_of_args_json_file", config]
    want, _ = j_parser.get_args(argv)
    got, device = parser_utils.get_args(argv, device="cpu")
    assert str(device) == "cpu"
    assert vars(got) == vars(want)


def test_get_args_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parser_utils.get_args([])


# ---------------------------------------------------------------------------
# The recorded episodes of the original implementation
# (tests/fixtures/reference_episodes.json, as tests/test_golden_episodes.py
# replays them on the JAX package)
# ---------------------------------------------------------------------------

with open(os.path.join(REPO, "tests", "fixtures", "reference_episodes.json")) as f:
    GOLDEN = json.load(f)


@pytest.mark.parametrize("cfg_idx", range(len(GOLDEN["configs"])))
def test_get_set_matches_the_recorded_episodes(cfg_idx, monkeypatch):
    entry = GOLDEN["configs"][cfg_idx]
    cfg = entry["config"]
    ds = FewShotLearningDataset.__new__(FewShotLearningDataset)
    ds.num_classes_per_set = cfg["num_classes_per_set"]
    ds.num_samples_per_class = cfg["num_samples_per_class"]
    ds.num_target_samples = cfg["num_target_samples"]
    ds.image_channel = 1
    ds.dataset_name = "omniglot_dataset"
    ds.args = parser_utils.Bunch({})
    ds.data_loaded_in_memory = False
    keys = [f"c{i:03d}" for i in range(cfg["n_classes"])]
    ds.datasets = {"train": {
        k: [f"{k}/s{j:02d}" for j in range(cfg["samples_per_class"])] for k in keys
    }}
    ds.dataset_size_dict = {"train": {k: cfg["samples_per_class"] for k in keys}}
    per_class = cfg["num_samples_per_class"] + cfg["num_target_samples"]
    for episode in entry["episodes"]:
        loads, ks = [], []
        monkeypatch.setattr(
            ds, "load_image",
            lambda raw: (loads.append(raw), np.zeros((1, 1, 1), np.float32))[1],
        )
        monkeypatch.setattr(
            port_dataset, "augment_image",
            lambda image, k, **kw: (ks.append(int(k)), image)[1],
        )
        _, _, ys, yt, out_seed = ds.get_set(
            "train", seed=episode["seed"], augment_images=False
        )
        n = cfg["num_classes_per_set"]
        assert [loads[ci * per_class].split("/")[0] for ci in range(n)] == (
            episode["selected_classes"]
        )
        assert [
            [int(p.split("/s")[1]) for p in loads[ci * per_class:(ci + 1) * per_class]]
            for ci in range(n)
        ] == episode["sample_indices"]
        assert ks[::per_class] == episode["rotation_k"]
        assert ys.astype(int).tolist() == episode["support_labels"]
        assert yt.astype(int).tolist() == episode["target_labels"]
        assert int(out_seed) == episode["returned_seed"]


@pytest.mark.parametrize("split_idx", range(len(GOLDEN["splits"])))
def test_ratio_split_matches_the_recording(split_idx):
    rec = GOLDEN["splits"][split_idx]
    ds = FewShotLearningDataset.__new__(FewShotLearningDataset)
    ds.args = parser_utils.Bunch({"sets_are_pre_split": False, "load_into_memory": False})
    ds.seed = {"val": rec["derived_val_seed"]}
    ds.train_val_test_split = rec["split"]
    keys = [f"c{i:03d}" for i in range(rec["n_classes"])]
    ds.load_datapaths = lambda: ({k: ["x"] for k in keys}, {k: k for k in keys}, None)
    splits = ds.load_dataset()
    assert list(splits["train"]) == rec["train_classes"]
    assert list(splits["val"]) == rec["val_classes"]
    assert list(splits["test"]) == rec["test_classes"]


def test_many_threads_give_the_one_thread_batches(tmp_path, monkeypatch):
    """16 synthesis threads (more than the cores) with a short switch
    interval give the batches of one thread, in order: the threads share
    the dataset's lazily filled caches and per-thread RandomStates."""
    import sys

    make_dataset_dir(tmp_path / "omniglot_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    one = MetaLearningSystemDataLoader(
        make_args(tmp_path, load_into_memory=True, num_dataprovider_workers=1))
    many = MetaLearningSystemDataLoader(
        make_args(tmp_path, load_into_memory=True, num_dataprovider_workers=16))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        want = list(one.get_train_batches(total_batches=12, augment_images=True))
        got = list(many.get_train_batches(total_batches=12, augment_images=True))
    finally:
        sys.setswitchinterval(interval)
        one.close()
        many.close()
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)

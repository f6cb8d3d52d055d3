"""The per-class image order, and with it every episode, follows
``os.walk``'s listing, unsorted, in the JAX package and in the port alike
(port ``data/dataset.py`` ``get_data_paths``, JAX ``data/dataset.py``).

On ``chip_smoke.write_omniglot_tree`` (30 of its classes here) the first
train batch of the two loaders is bit-identical, with the directory
listing as the filesystem gives it and with every directory's file list
reversed; reversing it changes the batch. So a tree whose directories list
in another order (another filesystem, another machine) gives other
episodes in both packages: the reference's behaviour, which the port
keeps (ROADMAP C, "the CLI's episodes differ from call to call").
"""

import os

import numpy as np

from chip_smoke import write_omniglot_tree
from howtotrainyourmamlpytorch_tpu.data import MetaLearningSystemDataLoader as JLoader
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader

from test_data import make_args


def _first_train_batch(loader):
    batches = loader.get_train_batches(total_batches=1, augment_images=True)
    batch = next(batches)
    batches.close()
    return batch


def test_episodes_follow_the_unsorted_walk_order_in_both_packages(tmp_path, monkeypatch):
    tree = tmp_path / "omniglot_synth"
    write_omniglot_tree(str(tree), classes=30)
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    args = make_args(tmp_path, dataset_name="omniglot_synth", dataset_path=str(tree),
                     reset_stored_filepaths=True, load_into_memory=True, batch_size=8)
    walk = os.walk
    batches = {}
    for order in ("listed", "reversed"):
        if order == "reversed":
            def reversed_walk(top, *a, **k):
                for d, dirs, files in walk(top, *a, **k):
                    yield d, dirs, files[::-1]
            monkeypatch.setattr(os, "walk", reversed_walk)
        want = _first_train_batch(JLoader(args, current_iter=0))
        loader = MetaLearningSystemDataLoader(args, current_iter=0)
        try:
            got = _first_train_batch(loader)
        finally:
            loader.close()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), order
        batches[order] = got
    assert not all(np.array_equal(a, b) for a, b in zip(batches["listed"][:2],
                                                         batches["reversed"][:2]))

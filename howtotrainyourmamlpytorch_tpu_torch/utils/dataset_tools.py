"""Dataset bootstrap: auto-extract + integrity check
(``howtotrainyourmamlpytorch_tpu/utils/dataset_tools.py``, after the
original PyTorch implementation's ``utils/dataset_tools.py:4-56``):
if the dataset folder is missing, extract ``$DATASET_DIR/<name>.tar.bz2``
(pbzip2 when available, plain bz2 otherwise); verify by file count
(Omniglot 1623x20, mini-imagenet 100x600) and delete-and-retry on mismatch.
"""

from __future__ import annotations

import os
import shutil
import subprocess


def unzip_file(filepath_pack: str, filepath_to_store: str) -> None:
    """``tar -I pbzip2 -xf`` with a plain-bz2 fallback (reference ``:54-56``)."""
    if shutil.which("pbzip2"):
        cmd = ["tar", "-I", "pbzip2", "-xf", filepath_pack, "-C", filepath_to_store]
    else:
        cmd = ["tar", "-xjf", filepath_pack, "-C", filepath_to_store]
    subprocess.run(cmd, check=True)


def _count_images(dataset_path: str) -> int:
    total = 0
    for _subdir, _dirs, files in os.walk(dataset_path):
        for file in files:
            if file.lower().endswith((".jpeg", ".jpg", ".png", ".pkl")):
                total += 1
    return total


def maybe_unzip_dataset(args, _depth: int = 0) -> None:
    """Ensures ``args.dataset_path`` exists and passes the file-count
    integrity check (reference ``:4-51``)."""
    dataset_name = args.dataset_name
    dataset_path = args.dataset_path.rstrip("/")

    if not os.path.exists(dataset_path):
        zip_directory = "{}.tar.bz2".format(
            os.path.join(os.environ["DATASET_DIR"], dataset_name)
        )
        if not os.path.exists(os.path.abspath(zip_directory)):
            raise FileNotFoundError(
                f"{os.path.abspath(zip_directory)} dataset zip file not found; "
                "place dataset in datasets folder as explained in README"
            )
        print("Found zip file, unpacking")
        unzip_file(zip_directory, os.environ["DATASET_DIR"])
        args.reset_stored_filepaths = True

    total_files = _count_images(dataset_path)
    known_counts = {"omniglot_dataset": 1623 * 20}
    if "mini_imagenet_pkl" in dataset_name:
        expected = 3
    elif "mini_imagenet" in dataset_name:
        expected = 100 * 600
    else:
        expected = known_counts.get(dataset_name)

    if expected is None or total_files == expected:
        return
    if _depth >= 1:
        raise RuntimeError(
            f"{dataset_name}: {total_files} files after re-extract "
            f"(expected {expected})"
        )
    print(f"file count {total_files} != {expected}; re-extracting")
    shutil.rmtree(dataset_path, ignore_errors=True)
    maybe_unzip_dataset(args, _depth=_depth + 1)

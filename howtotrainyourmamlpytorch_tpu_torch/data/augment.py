"""Per-dataset image augmentation in NumPy
(``howtotrainyourmamlpytorch_tpu/data/augment.py``), after the original
PyTorch implementation's transform tables (``data.py:17-108``):

* Omniglot — class-level k*90-degree rotation at train time only
  (``rotate_image``, ``data.py:17-34``; selected per class in ``get_set``,
  ``data.py:492-493``); evaluation applies no rotation.
* cifar10/cifar100 — random crop with 4px padding + horizontal flip +
  per-channel mean/std normalization at train time; normalization only at
  eval (``data.py:80-89``).
* imagenet — ImageNet mean/std normalization in both phases
  (``data.py:98-107``).

Layout note: the reference composes PIL/torchvision transforms over HWC
arrays and finishes with ``ToTensor`` (HWC -> CHW, and /255 only for uint8
inputs — our loader already yields floats, so no extra scaling happens
there either). Here images stay HWC float32 through augmentation and are
transposed to CHW once at the end.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def rotate_image(image: np.ndarray, k: int) -> np.ndarray:
    """Rotates an HWC image by ``k * 90`` degrees (``data.py:17-34``)."""
    return np.ascontiguousarray(np.rot90(image, k=k, axes=(0, 1)))


def _normalize(image: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (image - mean) / std


def _random_crop(image: np.ndarray, size: int, padding: int, rng) -> np.ndarray:
    """torchvision ``RandomCrop(size, padding)`` semantics on HWC."""
    padded = np.pad(
        image, ((padding, padding), (padding, padding), (0, 0)), mode="constant"
    )
    top = rng.randint(0, padded.shape[0] - size + 1)
    left = rng.randint(0, padded.shape[1] - size + 1)
    return padded[top : top + size, left : left + size]


def get_transforms_for_dataset(
    dataset_name: str, args, k: int, defer_normalization: bool = False,
    defer_augment: bool = False,
):
    """Returns ``(train_transforms, eval_transforms)`` — lists of callables
    ``(hwc_image, rng) -> hwc_image`` (``data.py:80-108``).

    ``defer_normalization`` drops the mean/std step: the uint8 wire codec
    (``--transfer_dtype uint8``) applies it on the device instead, so host
    pixels must stay at k/255 (models/common.WireCodec). ``defer_augment``
    drops the stochastic train transforms (Omniglot's rotation, cifar's
    crop and flip): ``--device_augment`` runs them in the train step
    (models/common.DeviceAugment)."""
    if "cifar10" in dataset_name or "cifar100" in dataset_name:
        mean = np.asarray(args.classification_mean, np.float32)
        std = np.asarray(args.classification_std, np.float32)
        train = [] if defer_augment else [
            lambda im, rng: _random_crop(im, 32, 4, rng),
            lambda im, rng: im[:, ::-1] if rng.rand() < 0.5 else im,
        ]
        evaluate = []
        if not defer_normalization:
            train.append(lambda im, rng: _normalize(im, mean, std))
            evaluate.append(lambda im, rng: _normalize(im, mean, std))
    elif "omniglot" in dataset_name:
        train = [] if defer_augment else [lambda im, rng, k=k: rotate_image(im, k)]
        evaluate = []
    elif "imagenet" in dataset_name:
        if defer_normalization:
            train = []
        else:
            train = [
                lambda im, rng: _normalize(im, IMAGENET_MEAN, IMAGENET_STD)
            ]
        evaluate = list(train)
    else:
        train, evaluate = [], []
    return train, evaluate


def augment_image(
    image: np.ndarray,
    k: int,
    channels: int,
    augment_bool: bool,
    args,
    dataset_name: str,
    rng: np.random.RandomState,
    defer_normalization: bool = False,
    defer_augment: bool = False,
) -> np.ndarray:
    """Applies the dataset's train/eval transform chain to one HWC image and
    returns CHW float32 (the reference's trailing ``ToTensor``,
    ``data.py:55-77``). ``rng`` drives the stochastic transforms (crop/flip)
    and must come from the episode's deterministic RandomState."""
    del channels
    train, evaluate = get_transforms_for_dataset(
        dataset_name, args, k, defer_normalization, defer_augment
    )
    for fn in train if augment_bool else evaluate:
        image = fn(image, rng)
    return np.ascontiguousarray(np.transpose(image, (2, 0, 1)).astype(np.float32))

"""Dataset-agnostic N-way K-shot episode sampler
(``howtotrainyourmamlpytorch_tpu/data/dataset.py``), after the original
PyTorch implementation's ``FewShotLearningDatasetParallel``
(``data.py:111-552``); NumPy and PIL on the host:

* class -> filepath-list index built by directory scan and cached as JSON
  under ``$DATASET_DIR`` with the reference's exact filenames
  (``{name}.json``, ``map_to_label_name_{name}.json``,
  ``label_name_to_map_{name}.json`` — ``data.py:244-268``), so existing
  dataset index files are drop-in compatible;
* ratio split (seeded class shuffle + cumulative fractions) or pre-split
  ``train/val/test`` top-level folders (``data.py:169-211``);
* per-episode deterministic RNG with the reference's exact call order
  (``data.py:478-524``): ``RandomState(seed)`` -> ``choice`` of N classes
  (no replacement) -> ``shuffle`` -> per-class rotation ``randint(0, 4)``
  -> per-class ``choice`` of K+T sample indices — so fixed-seed
  class/sample/rotation selection matches the reference bit for bit (see
  tests/test_golden_episodes.py). Stochastic augmentation draws (cifar
  crop/flip) come from a separate stream forked from the episode seed —
  the reference draws those from global torch RNG, so its augmented pixel
  streams are not reproducible at all; selection parity is the invariant;
* derived split seeds: ``RandomState(args.X_seed).randint(1, 999999)`` with
  the test seed equal to the val seed (``data.py:131-142`` — a documented
  reference quirk, SURVEY §5);
* optional full in-RAM preload via a thread pool (``data.py:213-230``);
* corrupted-image detection during the scan (``data.py:280-300``).

Episode arrays are CHW float32: Omniglot is resized with LANCZOS and kept
unscaled (PIL resizes mode-'1' images with NEAREST, values stay 0/1);
everything else is RGB / 255 (``data.py:374-395``).
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import os

import numpy as np
from PIL import Image, ImageFile

from .augment import augment_image
from .fast_synth import (
    assemble_episode_native,
    gather_rot_chw,
    native_available,
)

ImageFile.LOAD_TRUNCATED_IMAGES = True

_IMAGE_EXTS = (".jpeg", ".png", ".jpg")


class FewShotLearningDataset:
    # Lazily created per instance in get_set (class-level default so that
    # fixture-driven construction via __new__ — tests/test_golden_episodes —
    # works without __init__).
    _class_key_cache: dict | None = None
    # Thread-local reusable RandomState pair (same __new__-safe pattern).
    _episode_tls: threading.local | None = None
    # Per-dataset {class_key: base address} of the preloaded stores (lazy,
    # __new__-safe) for the one-call native episode assembly.
    _class_addr_cache: dict | None = None
    # __new__-safe default for fixture-driven construction; __init__ derives
    # the real value from the wire codec (--transfer_dtype uint8).
    defer_normalization = False
    # __new__-safe default; __init__ derives the real value from
    # --device_augment (the train step rotates or crops, see get_set).
    defer_augment = False
    """Episode synthesizer with deterministic per-index task sampling."""

    def __init__(self, args):
        self.args = args
        self.data_path = args.dataset_path
        self.dataset_name = args.dataset_name
        self.data_loaded_in_memory = False
        self.image_height = args.image_height
        self.image_width = args.image_width
        self.image_channel = args.image_channels
        self.indexes_of_folders_indicating_class = (
            args.indexes_of_folders_indicating_class
        )
        self.reverse_channels = args.reverse_channels
        self.labels_as_int = args.labels_as_int
        self.train_val_test_split = args.train_val_test_split
        self.current_set_name = "train"
        self.num_target_samples = args.num_target_samples
        self.reset_stored_filepaths = args.reset_stored_filepaths
        self.num_samples_per_class = args.num_samples_per_class
        self.num_classes_per_set = args.num_classes_per_set
        self.augment_images = False
        # uint8 wire format (--transfer_dtype uint8): normalization moves
        # onto the device (models/common.WireCodec carries mean/std), so the
        # host pipeline must keep pixels at k/255 and skip it here. (Imported
        # here: a spawned loader worker rebuilds the dataset without
        # __init__, and so without the parser's torch modules.)
        from ..utils.parser_utils import wire_codec_for

        codec = wire_codec_for(vars(args))
        self.defer_normalization = codec is not None and codec.mean is not None
        # --device_augment: Omniglot's rotation and cifar's crop and flip
        # move into the train step (models/common.DeviceAugment). Train
        # episodes then carry raw pixels and a trailing operand; the
        # episode RNG still draws the rotations at the same point, so the
        # class and sample selection is the same either way.
        name = self.dataset_name.lower()
        self.defer_augment = bool(getattr(args, "device_augment", False)) and (
            "omniglot" in name or "cifar10" in name or "cifar100" in name
        )

        # Derived split seeds (data.py:131-142); test seed == val seed.
        val_seed = np.random.RandomState(seed=args.val_seed).randint(1, 999999)
        train_seed = np.random.RandomState(seed=args.train_seed).randint(1, 999999)
        self.init_seed = {"train": train_seed, "val": val_seed, "test": val_seed}
        self.seed = dict(self.init_seed)

        self.datasets = self.load_dataset()
        self.dataset_size_dict = {
            set_name: {key: len(value) for key, value in classes.items()}
            for set_name, classes in self.datasets.items()
        }
        self.data_length = {
            set_name: int(np.sum([len(v) for v in classes.values()]))
            for set_name, classes in self.datasets.items()
        }

    # ------------------------------------------------------------------
    # Index construction / caching
    # ------------------------------------------------------------------

    def _index_paths(self) -> tuple[str, str, str]:
        dataset_dir = os.environ["DATASET_DIR"]
        return (
            f"{dataset_dir}/{self.dataset_name}.json",
            f"{dataset_dir}/map_to_label_name_{self.dataset_name}.json",
            f"{dataset_dir}/label_name_to_map_{self.dataset_name}.json",
        )

    def load_datapaths(self):
        """Loads (or builds and caches) the class->filepaths JSON index
        (``data.py:234-268``). Returns ``(data_image_paths,
        index_to_label_name, label_to_index)`` with JSON string keys."""
        data_path_file, idx_to_name_file, name_to_idx_file = self._index_paths()

        if not os.path.exists(data_path_file):
            self.reset_stored_filepaths = True
        if self.reset_stored_filepaths:
            if os.path.exists(data_path_file):
                os.remove(data_path_file)
            self.reset_stored_filepaths = False

        try:
            with open(data_path_file) as f:
                data_image_paths = json.load(f)
            with open(name_to_idx_file) as f:
                label_to_index = json.load(f)
            with open(idx_to_name_file) as f:
                index_to_label_name = json.load(f)
            return data_image_paths, index_to_label_name, label_to_index
        except (OSError, json.JSONDecodeError):
            print("Mapped data paths can't be found, remapping paths..")
            data_image_paths, idx_to_name, name_to_idx = self.get_data_paths()
            for filename, payload in (
                (data_path_file, data_image_paths),
                (idx_to_name_file, idx_to_name),
                (name_to_idx_file, name_to_idx),
            ):
                with open(os.path.abspath(filename), "w") as f:
                    json.dump(payload, f)
            return self.load_datapaths()

    def get_label_from_path(self, filepath: str):
        """Class label from configured path components (``data.py:366-372``)."""
        bits = filepath.split("/")
        label = "/".join(
            bits[idx] for idx in self.indexes_of_folders_indicating_class
        )
        return int(label) if self.labels_as_int else label

    def _check_image(self, filepath: str) -> str | None:
        """Returns the path if the image opens, else None (``data.py:280-300``)."""
        try:
            Image.open(filepath)
            return filepath
        except Exception:
            print("Broken image", filepath)
            return None

    def get_data_paths(self):
        """Scans ``dataset_path`` for images, verifying each opens
        (``data.py:303-334``)."""
        print("Get images from", self.data_path)
        raw_paths = []
        labels = set()
        for subdir, _dirs, files in os.walk(self.data_path):
            for file in files:
                if file.lower().endswith(_IMAGE_EXTS):
                    filepath = os.path.abspath(os.path.join(subdir, file))
                    raw_paths.append(filepath)
                    labels.add(self.get_label_from_path(filepath))
        labels = sorted(labels)
        idx_to_label_name = {idx: label for idx, label in enumerate(labels)}
        label_name_to_idx = {label: idx for idx, label in enumerate(labels)}
        data_image_paths = {idx: [] for idx in idx_to_label_name}
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            for image_file in pool.map(self._check_image, raw_paths):
                if image_file is not None:
                    label = self.get_label_from_path(image_file)
                    data_image_paths[label_name_to_idx[label]].append(image_file)
        return data_image_paths, idx_to_label_name, label_name_to_idx

    # ------------------------------------------------------------------
    # Split
    # ------------------------------------------------------------------

    def load_dataset(self):
        """Builds ``{train,val,test} -> {class -> samples}`` (``data.py:
        169-230``): pre-split by top-level folder, or seeded-shuffle ratio
        split over classes."""
        rng = np.random.RandomState(seed=self.seed["val"])
        data_image_paths, index_to_label_name, _ = self.load_datapaths()

        if getattr(self.args, "sets_are_pre_split", False):
            dataset_splits = {}
            for key, value in data_image_paths.items():
                label = index_to_label_name[key]
                set_name, class_label = label.split("/")[0], label.split("/")[1]
                dataset_splits.setdefault(set_name, {})[class_label] = value
        else:
            total = len(data_image_paths)
            order = np.arange(total, dtype=np.int32)
            rng.shuffle(order)
            keys = list(data_image_paths.keys())
            shuffled = {keys[i]: data_image_paths[keys[i]] for i in order}
            split = self.train_val_test_split
            i_train = int(split[0] * total)
            i_val = int(np.sum(split[:2]) * total)
            shuffled_keys = list(shuffled.keys())
            dataset_splits = {
                "train": {k: shuffled[k] for k in shuffled_keys[:i_train]},
                "val": {k: shuffled[k] for k in shuffled_keys[i_train:i_val]},
                "test": {k: shuffled[k] for k in shuffled_keys[i_val:]},
            }

        if getattr(self.args, "load_into_memory", False):
            print("Loading data into RAM")
            loaded = {}
            for set_name, classes in dataset_splits.items():
                with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
                    loaded[set_name] = dict(
                        pool.map(self._load_class, classes.items())
                    )
            dataset_splits = loaded
            self.data_loaded_in_memory = True
        return dataset_splits

    def _load_class(self, item):
        class_label, paths = item
        images = np.array(
            [self.load_image(p) for p in paths], dtype=np.float32
        )
        return class_label, self.preprocess_data(images)

    # ------------------------------------------------------------------
    # Image loading
    # ------------------------------------------------------------------

    def load_image(self, image_path) -> np.ndarray:
        """One HWC float32 image (``data.py:374-395``): Omniglot LANCZOS
        resize, unscaled; others RGB / 255."""
        if self.data_loaded_in_memory:
            return image_path  # already an array
        image = Image.open(image_path)
        if "omniglot" in self.dataset_name:
            image = image.resize(
                (self.image_height, self.image_width), resample=Image.LANCZOS
            )
            image = np.array(image, np.float32)
            if self.image_channel == 1:
                image = np.expand_dims(image, axis=2)
        else:
            image = image.resize((self.image_height, self.image_width)).convert(
                "RGB"
            )
            image = np.array(image, np.float32) / 255.0
        return image

    def preprocess_data(self, x: np.ndarray) -> np.ndarray:
        """Optional BGR flip (``reverse_channels``, ``data.py:442-457``)."""
        if self.reverse_channels:
            x = x[..., ::-1].copy()
        return x

    # ------------------------------------------------------------------
    # Episode synthesis
    # ------------------------------------------------------------------

    def _fast_assembly_ok(self, augment_images: bool) -> bool:
        """The batched gather/rotate path applies when images are preloaded
        and the phase's transform chain draws no RNG: everything except
        cifar's train-time random crop/flip (``data.py:80-89``), unless the
        train step does those (``defer_augment``)."""
        if not self.data_loaded_in_memory:
            return False
        name = self.dataset_name
        if "cifar10" in name or "cifar100" in name:
            return not augment_images or self.defer_augment
        return True

    def _fast_normalization(self):
        """``(mean, std)`` broadcastable over ``(N,M,C,H,W)`` for datasets
        whose (RNG-free) transform chain normalizes, else None."""
        name = self.dataset_name
        if "cifar10" in name or "cifar100" in name:
            mean = np.asarray(self.args.classification_mean, np.float32)
            std = np.asarray(self.args.classification_std, np.float32)
        elif "imagenet" in name:
            from .augment import IMAGENET_MEAN, IMAGENET_STD

            mean, std = IMAGENET_MEAN, IMAGENET_STD
        else:
            return None
        return mean.reshape(-1, 1, 1), std.reshape(-1, 1, 1)

    def get_set(self, dataset_name: str, seed: int, augment_images: bool = False):
        """One N-way K-shot episode, deterministically from ``seed``
        (``data.py:478-524``; RNG call order preserved exactly).

        Returns ``(support_images (N,K,C,H,W), target_images (N,T,C,H,W),
        support_labels (N,K), target_labels (N,T), seed)``, and with
        ``defer_augment`` in a train episode the on-device augmentation's
        operand after it: the ``(N,)`` int32 quarter turns (Omniglot) or
        the uint32 episode seed (cifar).
        """
        # Thread-local RandomState reuse: re-seeding an existing instance
        # runs the same MT19937 legacy seeding as construction (identical
        # stream, asserted by tests/test_golden_episodes.py) but skips the
        # ~280us instance setup — the single largest episode-synthesis cost.
        tls = self._episode_tls
        if tls is None:
            tls = self._episode_tls = threading.local()
        try:
            rng, aug_rng = tls.rng, tls.aug_rng
        except AttributeError:
            rng = tls.rng = np.random.RandomState()
            aug_rng = tls.aug_rng = np.random.RandomState()
        rng.seed(seed)
        # Stochastic augmentation (cifar crop/flip) draws from a SEPARATE
        # stream forked from the episode seed: the reference's torchvision
        # transforms consume global/torch RNG, not the episode RandomState,
        # so feeding `rng` to them would desynchronize class/sample
        # selection from the reference on those datasets (ADVICE r1).
        aug_rng.seed((seed + 0x5EED) % (2**32))
        size_dict = self.dataset_size_dict[dataset_name]
        # Cached ndarray of the class keys: RandomState.choice converts a
        # list argument to an array anyway, so draws are identical, and this
        # skips rebuilding an N-hundred-element list per episode.
        cache = self._class_key_cache
        if cache is None:
            cache = self._class_key_cache = {}
        keys = cache.get(dataset_name)
        if keys is None:
            keys = np.asarray(list(size_dict.keys()))
            cache[dataset_name] = keys
        selected_classes = rng.choice(
            keys, size=self.num_classes_per_set, replace=False
        )
        rng.shuffle(selected_classes)
        k_list = rng.randint(0, 4, size=self.num_classes_per_set)
        k_dict = dict(zip(selected_classes, k_list))
        class_to_episode_label = {
            cls: label for label, cls in enumerate(selected_classes)
        }

        # RNG call order is fixed above/below regardless of assembly path.
        sample_lists = [
            rng.choice(
                size_dict[class_entry],
                size=self.num_samples_per_class + self.num_target_samples,
                replace=False,
            )
            for class_entry in selected_classes
        ]

        if self._fast_assembly_ok(augment_images):
            # Gather + rotate + HWC->CHW, bit-identical to the per-image
            # loop below. Preferred: the whole episode in ONE native call
            # (N class stores addressed by pointer — ctypes marshalling per
            # class was ~2/3 of the per-class path's cost).
            rotate = (
                augment_images
                and "omniglot" in self.dataset_name
                and not self.defer_augment
            )
            store = self.datasets[dataset_name]
            sample_idx = np.ascontiguousarray(sample_lists, np.int64)
            ks = (
                np.ascontiguousarray(k_list, np.int32)
                if rotate
                else np.zeros(len(selected_classes), np.int32)
            )
            first = store[selected_classes[0]]
            h, w = first.shape[1], first.shape[2]
            x_images = None
            if native_available() and (
                h == w or not (rotate and np.any(ks % 2))
            ):
                addr_cache = self._class_addr_cache
                if addr_cache is None:
                    addr_cache = self._class_addr_cache = {}
                addrs = addr_cache.get(dataset_name)
                if addrs is None:
                    # Base addresses of the (immutable, C-contiguous fp32)
                    # preloaded class stores; the dict also pins liveness
                    # assumptions to self.datasets, which owns the arrays.
                    addrs = addr_cache[dataset_name] = {
                        key: arr.ctypes.data for key, arr in store.items()
                    }
                src_addrs = np.fromiter(
                    (addrs[c] for c in selected_classes),
                    np.int64, count=len(selected_classes),
                )
                x_images = assemble_episode_native(
                    src_addrs, first.shape[1:], sample_idx, ks
                )
            if x_images is None:  # no native lib (or non-square odd rot)
                x_images = np.stack([
                    gather_rot_chw(store[class_entry], samples, int(k))
                    for class_entry, samples, k in zip(
                        selected_classes, sample_lists, ks
                    )
                ])  # (N, K+T, C, H, W)
            norm = None if self.defer_normalization else self._fast_normalization()
            if norm is not None:
                mean, std = norm
                x_images = (x_images - mean) / std
            y_labels = np.repeat(
                np.arange(len(selected_classes), dtype=np.int32)[:, None],
                x_images.shape[1], axis=1,
            )
        else:
            x_images, y_labels = [], []
            for class_entry, choose_samples_list in zip(
                selected_classes, sample_lists
            ):
                class_image_samples = []
                class_labels = []
                for sample in choose_samples_list:
                    raw = self.datasets[dataset_name][class_entry][sample]
                    x = self.load_image(raw)
                    if self.data_loaded_in_memory:
                        x = np.asarray(x, np.float32)
                    x = augment_image(
                        image=x,
                        k=int(k_dict[class_entry]),
                        channels=self.image_channel,
                        augment_bool=augment_images,
                        args=self.args,
                        dataset_name=self.dataset_name,
                        rng=aug_rng,
                        defer_normalization=self.defer_normalization,
                        defer_augment=self.defer_augment,
                    )
                    class_image_samples.append(x)
                    class_labels.append(class_to_episode_label[class_entry])
                x_images.append(np.stack(class_image_samples))
                y_labels.append(class_labels)

            x_images = np.stack(x_images)  # (N, K+T, C, H, W)
            y_labels = np.array(y_labels, dtype=np.int32)
        k = self.num_samples_per_class
        episode = (
            x_images[:, :k],
            x_images[:, k:],
            y_labels[:, :k],
            y_labels[:, k:],
            seed,
        )
        if self.defer_augment and augment_images:
            if "omniglot" in self.dataset_name:
                episode += (np.ascontiguousarray(k_list, np.int32),)
            else:
                episode += (np.uint32(seed % (1 << 32)),)
        return episode

    # ------------------------------------------------------------------
    # Iteration contract (data.py:526-552)
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self.data_length[self.current_set_name]

    def set_augmentation(self, augment_images: bool) -> None:
        self.augment_images = augment_images

    def switch_set(self, set_name: str, current_iter: int | None = None) -> None:
        self.current_set_name = set_name
        if set_name == "train":
            self.seed[set_name] = self.init_seed[set_name] + current_iter

    def __getitem__(self, idx: int):
        return self.get_set(
            self.current_set_name,
            seed=self.seed[self.current_set_name] + idx,
            augment_images=self.augment_images,
        )

"""Trainer plumbing shared by the learners
(``howtotrainyourmamlpytorch_tpu/models/common.py:39-441``): dtype casts,
the divergence sentinel, the epoch-wise cosine LR, the outer Adam with an
injected learning rate, the uint8 image wire format, the on-device train
augmentation, batch preparation, the staged dispatch group and its
host-to-device copy, the learners' checkpoint methods with the lane-padding
templates and inference state (``:444-690``), and the trainer contract of
the learners that share one parameter tree over every task (gradient
descent, matching nets, prototypical networks).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.layout import pad_tree, strip_tree, trees_same_shapes
from ..utils import checkpoint, threefry
from ..utils.platform import resolve_device, set_f32_numerics
from ..utils.trees import Tree, tree_leaves, tree_map, tree_unflatten
from .backbone import build_backbone

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_floats(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype``: the one boundary
    cast of the float32 master parameters to the compute dtype. The
    identity (the same tree, no copy) for float32. Gradients flow back
    through the cast to the float32 masters, and Adam updates them in
    float32."""
    if dtype == torch.float32:
        return tree
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


def nonfinite_flag(*values) -> torch.Tensor:
    """``0.0`` when every entry of every value is finite, else ``1.0``, as a
    float32 scalar on the values' device: no host sync."""
    ok = torch.stack([torch.isfinite(v).all() for v in values]).all()
    return (~ok).to(torch.float32)


def discard_nonfinite_update(flag, new_tree, old_tree):
    """Leafwise ``new`` where ``flag`` is 0, else ``old``, on the device."""
    keep_new = flag == 0.0
    return tree_map(lambda n, o: torch.where(keep_new, n, o), new_tree, old_tree)


def guard_nonfinite_update(skip: bool, nonfinite, new_state, old_state):
    """The sentinel's ``skip`` policy (train steps only): a tripped step
    keeps ``old_state`` whole while the iteration counter still advances.
    Both states are NamedTuples with an ``iteration`` field."""
    if not skip:
        return new_state
    return discard_nonfinite_update(nonfinite, new_state, old_state)._replace(
        iteration=old_state.iteration + 1
    )


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt`` of the sum of squares over every leaf, in float32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


def cosine_epoch_lr(
    epoch: int, meta_learning_rate: float, min_learning_rate: float, total_epochs: int
) -> float:
    """``eta_min + (lr0 - eta_min) * (1 + cos(pi * epoch / T_max)) / 2``:
    torch ``CosineAnnealingLR``'s closed form, constant within an epoch."""
    frac = min(epoch / total_epochs, 1.0)
    return min_learning_rate + 0.5 * (meta_learning_rate - min_learning_rate) * (
        1.0 + math.cos(math.pi * frac)
    )


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; the moments
    are ``None`` at frozen leaves) and the injected learning rate, a
    float32 scalar."""

    count: torch.Tensor
    mu: Tree
    nu: Tree
    learning_rate: torch.Tensor


class InjectedAdam:
    """Functional Adam with torch's defaults and optax's formula, over any
    tree; the learning rate is read from the state (``set_injected_lr``).
    An optional elementwise clip of the gradients comes first (the
    reference's +-10 on ImageNet). Leaves without moments are frozen: they
    get no update, like ``optax.set_to_zero``."""

    def __init__(self, learning_rate: float, clip_grad_value: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.clip_grad_value = clip_grad_value
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree, trainable: Tree | None = None) -> AdamState:
        """Zero moments for the leaves ``trainable`` marks (all by default)."""
        if trainable is None:
            trainable = tree_map(lambda _: True, params)
        zeros = lambda m, p: torch.zeros_like(p) if m else None  # noqa: E731
        device = tree_leaves(params)[0].device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, trainable, params),
            nu=tree_map(zeros, trainable, params),
            learning_rate=torch.tensor(
                self.learning_rate, dtype=torch.float32, device=device
            ),
        )

    def step(self, params: Tree, grads: Tree, state: AdamState):
        """``(new_params, new_state)`` after one update."""
        b1, b2 = self.b1, self.b2
        if self.clip_grad_value is not None:
            c = self.clip_grad_value
            grads = tree_map(lambda g: g.clamp(-c, c), grads)
        count = state.count + 1
        c32 = count.to(torch.float32)
        bias1 = 1 - torch.full_like(c32, b1) ** c32
        bias2 = 1 - torch.full_like(c32, b2) ** c32
        mu = tree_map(lambda m, g: (1 - b1) * g + b1 * m, state.mu, grads)
        nu = tree_map(lambda v, g: (1 - b2) * g.square() + b2 * v, state.nu, grads)
        step_size = -state.learning_rate

        def update(p, m, v):
            if m is None:
                return p
            return p + (m / bias1) / (torch.sqrt(v / bias2) + self.eps) * step_size

        params = tree_map(update, params, mu, nu)
        return params, state._replace(count=count, mu=mu, nu=nu)


def make_injected_adam(
    learning_rate: float, clip_grad_value: float | None = None
) -> InjectedAdam:
    """Adam (torch defaults) with a runtime-settable learning rate and an
    optional elementwise clip first."""
    return InjectedAdam(learning_rate, clip_grad_value)


def set_injected_lr(state: AdamState, lr: float) -> AdamState:
    """The state with its learning rate set to ``lr``."""
    return state._replace(learning_rate=torch.tensor(
        lr, dtype=torch.float32, device=state.learning_rate.device
    ))


class WireCodec(NamedTuple):
    """uint8 image wire format: ``wire = rint(x * scale)``, exact for images
    whose pixels are ``k / scale``, k in [0, 255] (Omniglot: scale 1, pixels
    0/1). ``mean``/``std`` (per channel) move the dataset normalization
    after the decode."""

    scale: float = 1.0
    mean: tuple | None = None
    std: tuple | None = None


def encode_images(x: np.ndarray, codec: WireCodec) -> np.ndarray:
    """float32 host images -> uint8 wire, clipped to [0, 255] first so an
    out-of-range value cannot wrap."""
    x = np.asarray(x)
    if codec.scale != 1.0:
        scratch = np.multiply(x, np.float32(codec.scale), dtype=np.float32)
        np.rint(scratch, out=scratch)
    else:
        scratch = np.rint(np.asarray(x, np.float32))
    np.clip(scratch, 0.0, 255.0, out=scratch)
    return scratch.astype(np.uint8)


def _descale(x: torch.Tensor, codec: WireCodec) -> torch.Tensor:
    x = x.float()
    return x / codec.scale if codec.scale != 1.0 else x


def _normalize(x: torch.Tensor, codec: WireCodec) -> torch.Tensor:
    if codec.mean is None:
        return x
    # Filled on the device, not copied from the host: a copy would
    # synchronize, which a captured train step (models/step_graph.py) may
    # not do.
    shape = (-1, 1, 1)
    mean = torch.stack([x.new_full((), m) for m in codec.mean])
    std = torch.stack([x.new_full((), s) for s in codec.std])
    return (x - mean.reshape(shape)) / std.reshape(shape)


def decode_images(x: torch.Tensor, codec: WireCodec | None, dtype) -> torch.Tensor:
    """uint8 wire (or float images when ``codec`` is None) -> compute-dtype
    images: descale, then normalize, as the host pipeline orders it."""
    if codec is None:
        return x.to(dtype)
    return _normalize(_descale(x, codec), codec).to(dtype)


class DeviceAugment(NamedTuple):
    """The on-device (in-step) train augmentation (``--device_augment``).

    ``kind``: ``"rot90"``, Omniglot's class-level quarter turns as a
    gather over the four rotations (``rot90_by_gather``), bit for bit the
    host rotation; or ``"crop_flip"``, cifar's ``pad``-pixel random crop
    and horizontal flip drawn from the episode seed (``crop_flip_by_key``),
    the JAX package's draws, which follow the host transform's laws but
    not its stream. The host then ships the raw pixels and the operand:
    ``(B, N)`` int32 quarter turns, or ``(B,)`` uint32 episode seeds."""

    kind: str
    pad: int = 4


def rot90_by_gather(x: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Class-level ``k``-quarter-turn rotation (``jnp.rot90`` over the
    last two axes) of a task's images ``x`` ``(..., M, C, H, W)``,
    class-major with ``M = N * S``, by ``ks`` ``(..., N)``: the four
    rotations are made and a gather picks one for each image. Pure data
    movement, exact in any dtype. Needs ``H == W``."""
    n, m = ks.shape[-1], x.shape[-4]
    variants = torch.stack(
        [x if k == 0 else torch.rot90(x, k, dims=(-2, -1)) for k in range(4)]
    )
    per_image = ks.long().repeat_interleave(m // n, dim=-1)
    index = per_image[(None, ..., None, None, None)].expand(1, *x.shape)
    return variants.gather(0, index)[0]


def crop_flip_by_key(x: torch.Tensor, seed, pad: int, stream: int) -> torch.Tensor:
    """A random crop after ``pad`` pixels of zero padding, then a random
    horizontal flip, of one task's images ``x`` ``(M, C, H, W)``, drawn
    from ``jax.random`` keyed by the episode ``seed`` folded with
    ``stream`` (0 the support, 1 the target), bit for bit the JAX
    package's (``utils/threefry``). Runs on raw pixels, before the
    normalization, as the host pads before it normalizes."""
    m, c, h, w = x.shape
    key = threefry.fold_in(threefry.prng_key(seed, x.device), stream)
    k_off, k_flip = threefry.split(key)
    offs = threefry.randint(k_off, (m, 2), 0, 2 * pad + 1).long()
    flips = threefry.bernoulli(k_flip, 0.5, (m,))
    padded = F.pad(x, (pad, pad, pad, pad))
    rows = offs[:, 0, None] + torch.arange(h, device=x.device)
    cols = offs[:, 1, None] + torch.arange(w, device=x.device)
    cropped = padded[
        torch.arange(m, device=x.device)[:, None, None, None],
        torch.arange(c, device=x.device)[None, :, None, None],
        rows[:, None, :, None],
        cols[:, None, None, :],
    ]
    return torch.where(flips[:, None, None, None], cropped.flip(-1), cropped)


def decode_augment_images(x, codec: WireCodec | None, dtype,
                          augment: DeviceAugment | None = None, aug=None,
                          stream: int = 0) -> torch.Tensor:
    """Wire decode and on-device train augmentation of one task's images
    (``(M, C, H, W)``; ``aug`` its operand). Without ``augment`` or
    ``aug``, ``decode_images``. The rotation commutes with the elementwise
    decode and follows it; the crop and flip come between the descale and
    the normalization, as the host orders crop, flip, normalize."""
    if augment is None or aug is None:
        return decode_images(x, codec, dtype)
    if augment.kind == "rot90":
        return rot90_by_gather(decode_images(x, codec, dtype), aug)
    if augment.kind != "crop_flip":
        raise ValueError(f"unknown device augmentation kind {augment.kind!r}")
    if codec is None or codec.mean is None:
        raise ValueError(
            "crop_flip device augmentation requires the deferred-"
            "normalization uint8 wire codec (--transfer_dtype uint8): the "
            "host otherwise ships normalized pixels, and zero-padding them "
            "diverges from the reference's pad-before-normalize order"
        )
    x = crop_flip_by_key(_descale(x, codec), aug, augment.pad, stream)
    return _normalize(x, codec).to(dtype)


def decode_train_batch(batch, codec: WireCodec | None, dtype,
                       augment: DeviceAugment | None = None) -> tuple:
    """``(xs, xt, ys, yt)`` of a device batch ``(xs (B, S, C, H, W), xt (B,
    Q, C, H, W), ys, yt[, aug])``: images decoded to ``dtype``, each task
    augmented on the device (support stream 0, target stream 1) when both
    ``augment`` and the operand are there; labels as int64."""
    xs, xt, ys, yt, *aug = batch
    if augment is None or not aug:
        xs, xt = decode_images(xs, codec, dtype), decode_images(xt, codec, dtype)
    elif augment.kind == "rot90":
        xs = rot90_by_gather(decode_images(xs, codec, dtype), aug[0])
        xt = rot90_by_gather(decode_images(xt, codec, dtype), aug[0])
    else:
        xs, xt = (
            torch.stack([
                decode_augment_images(x, codec, dtype, augment, a, stream)
                for x, a in zip(images, aug[0])
            ])
            for stream, images in enumerate((xs, xt))
        )
    return xs, xt, ys.long(), yt.long()


def prepare_batch(data_batch, codec: WireCodec | None = None):
    """``(B, N, K, C, H, W)`` numpy episode batch -> ``(x_support,
    x_target, y_support, y_target[, aug])`` numpy arrays with the shots
    flattened: ``(B, N*K, C, H, W)`` images (uint8 wire with ``codec``) and
    ``(B, N*K)`` int32 labels. A fifth element, the on-device augmentation
    operand of a defer-augment loader, rides through unchanged."""
    xs, xt, ys, yt, *aug = data_batch
    if codec is not None:
        xs, xt = encode_images(xs, codec), encode_images(xt, codec)
    else:
        xs, xt = np.asarray(xs, np.float32), np.asarray(xt, np.float32)
    ys, yt = np.asarray(ys, np.int32), np.asarray(yt, np.int32)
    b = xs.shape[0]
    xs = xs.reshape(b, -1, *xs.shape[-3:])
    xt = xt.reshape(b, -1, *xt.shape[-3:])
    out = (xs, xt, ys.reshape(b, -1), yt.reshape(b, -1))
    if aug:
        out += (np.asarray(aug[0]),)
    return out


class StagedBatch(NamedTuple):
    """A dispatch group already on the learner's device
    (``data/device_prefetch.DevicePrefetcher``).

    ``arrays`` holds the ``prepare_batch`` fields (four, or five with an
    augmentation operand) stacked on a leading K axis, K = 1 included: the
    pre-stacked form ``run_train_iters`` replays over, with no
    ``prepare_batch`` or copy of its own."""

    arrays: tuple
    n_iters: int
    first_iter: int


def dispatch_multiplier(data_batches) -> int:
    """The number K of meta-updates one train dispatch of ``data_batches``
    performs, for each form ``run_train_iters`` takes: a
    :class:`StagedBatch` (its ``n_iters``), the pre-stacked 4- or 5-tuple
    (its leading axis), a sequence of K episode batches (its length); a
    single episode batch is 1."""
    if isinstance(data_batches, StagedBatch):
        return max(int(data_batches.n_iters), 1)
    try:
        n = len(data_batches)
    except TypeError:
        return 1
    if is_stacked(data_batches):
        first = data_batches[0]
        return max(int(np.shape(first)[0]), 1) if first.ndim > 0 else 1
    return max(n, 1)


def is_stacked(data_batches) -> bool:
    """Whether ``data_batches`` is the pre-stacked form: a 4- or 5-tuple of
    arrays, not a sequence of episode batches (tuples)."""
    return len(data_batches) in (4, 5) and all(
        hasattr(b, "ndim") for b in data_batches
    )


def to_device(prepared: list, device) -> tuple:
    """The K ``prepare_batch`` outputs of ``prepared`` -> one tensor a
    field on ``device``, stacked on a leading K axis.

    For a CUDA device the host side is one page-locked buffer a field,
    filled in place, and the copy is issued ``non_blocking`` on the
    current stream: the host does not wait for it, and the caching host
    allocator keeps each buffer until its copy is done."""
    device = torch.device(device)
    fields = list(zip(*prepared))
    if device.type == "cpu":
        return tuple(torch.from_numpy(np.stack(f)) for f in fields)
    out = []
    for field in fields:
        first = np.asarray(field[0])
        dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
        host = torch.empty((len(field), *first.shape), dtype=dtype, pin_memory=True)
        np.stack(field, out=host.numpy())
        out.append(host.to(device, non_blocking=True))
    return tuple(out)


class InferenceState(NamedTuple):
    """Parameters and BN running statistics of a shared-weights learner:
    what its serving half reads. The prefix of ``GDState``,
    ``MatchingNetsState`` and ``ProtoNetsState`` in the archive's leaf
    order, so that a full training checkpoint restores it without building
    the optimizer (MAML's is ``MAMLInferenceState``, with ``lslr``)."""

    theta: Tree
    bn_state: Tree


class CheckpointableLearner:
    """Checkpoint methods of the trainer contract
    (``howtotrainyourmamlpytorch_tpu/models/common.py:459``): a train state
    and the experiment state in one archive of the JAX package's format,
    rebuilt on load from a fresh state of this learner's config. The state
    is replicated on every rank, so nothing is gathered. The archive's
    layout follows the state (``utils/checkpoint``); a learner with
    serve-time state beyond the
    checkpoint's prefix overrides ``load_inference_state``.

    Archives never hold lane padding (``ops/layout.py``): a learner whose
    backbone pads strips its state to the unpadded layout before a save
    and pads a restored state into its own fresh state after a load, so
    padded and unpadded learners read each other's checkpoints."""

    def _path_leaves(self, state) -> list:
        return checkpoint.train_state_paths(
            state, clip=self.cfg.clip_grad_value is not None
        )

    def _unpadded_template(self, init_fn_name: str):
        """A CPU state from ``init_fn_name`` of this learner's unpadded
        twin, where lane padding changes the state's shapes; else ``None``.
        Made once per learner and name."""
        cache = self.__dict__.setdefault("_unpadded_templates", {})
        if init_fn_name not in cache:
            result = None
            bb = self.cfg.backbone
            if bb.lane_pad_channels:
                twin = type(self)(dataclasses.replace(
                    self.cfg, backbone=dataclasses.replace(bb, lane_pad_channels=False)
                ))
                gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
                unpadded = getattr(twin, init_fn_name)(gen(), "cpu")
                padded = getattr(self, init_fn_name)(gen(), "cpu")
                if not trees_same_shapes(unpadded, padded):
                    result = unpadded
            cache[init_fn_name] = result
        return cache[init_fn_name]

    def _archived(self, state):
        """``state`` as archives hold it: lane padding stripped."""
        template = self._unpadded_template("init_state")
        return state if template is None else strip_tree(state, template)

    def save_model(self, model_save_dir: str, state, experiment_state: dict) -> None:
        checkpoint.save_checkpoint(
            model_save_dir, self._path_leaves(self._archived(state)), experiment_state
        )

    def snapshot_model(self, state, experiment_state: dict):
        """The critical-path half of ``save_model`` (the state, stripped of
        lane padding, copied to the host), for ``AsyncCheckpointWriter``."""
        return checkpoint.snapshot_for_save(
            self._path_leaves(self._archived(state)), experiment_state
        )

    def _restore(self, template, leaves):
        device = tree_leaves(template.theta)[0].device
        leaves = [torch.from_numpy(a).to(device) for a in leaves]
        return checkpoint.train_state_from_leaves(
            template, leaves, clip=self.cfg.clip_grad_value is not None
        )

    def _load(self, load, filepath: str, init_fn_name: str, device):
        """The state of ``init_fn_name``'s structure that ``load`` reads
        from ``filepath``, on ``device``; a lane-padded learner reads the
        unpadded layout and pads it into its fresh state."""
        template = getattr(self, init_fn_name)(torch.Generator().manual_seed(0), device)
        unpadded = self._unpadded_template(init_fn_name)
        archived = template if unpadded is None else unpadded
        leaves, experiment_state = load(filepath, self._path_leaves(archived))
        state = self._restore(archived, leaves)
        if unpadded is not None:
            state = pad_tree(state, template)
        return state, experiment_state

    def load_model(self, model_save_dir: str, model_name: str, model_idx,
                   device=None):
        """``(state, experiment_state)`` of ``<dir>/<name>_<idx>``, on
        ``device`` (the card by default)."""
        filepath = os.path.join(model_save_dir, f"{model_name}_{model_idx}")
        return self._load(checkpoint.load_checkpoint, filepath, "init_state", device)

    def replicate(self, state):
        """``state`` replicated over the ranks of a multi-process learner:
        rank 0's values on every rank (one broadcast per dtype bucket),
        after init and after every load, so no rank trains from a state of
        its own. The identity on one process. Checkpoints hold no layout:
        a fleet's resumes on one process and the other way round."""
        mesh = getattr(self, "mesh", None)
        if mesh is None or mesh.world <= 1:
            return state
        from ..parallel.collectives import broadcast_tree

        return broadcast_tree(state)

    def load_inference_state(self, filepath: str, device=None):
        """``(inference_state, experiment_state)``: the parameters, LSLR
        rates and BN statistics of a full training checkpoint, with no
        optimizer state built."""
        return self._load(checkpoint.load_for_inference, filepath,
                          "init_inference_state", device)


def shared(tree: Tree, tasks: int) -> Tree:
    """Every leaf of ``tree`` with a leading axis of ``tasks``, a view that
    copies nothing: the backbone's per-task operand for a tree all tasks
    share. The gradient of an ``expand`` sums over the tasks."""
    return tree_map(lambda a: a.expand(tasks, *a.shape), tree)


class SharedWeightsLearner(CheckpointableLearner):
    """The trainer contract of the learners whose tasks all use one
    parameter tree, with no inner-loop fast weights: gradient descent,
    matching nets and prototypical networks (each JAX module repeats it).

    The state is ``state_type(theta, bn_state, opt_state, iteration)``, one
    Adam over every leaf of ``theta`` at the epoch's cosine learning rate.
    A subclass gives ``_run_batch(state, batch, training)`` -> ``(new_state,
    metrics, logits)`` over a device batch of ``(x_support (B, S, C, H, W),
    x_target (B, Q, C, H, W), y_support (B, S), y_target (B, Q))``."""

    state_type: type
    #: The metrics ``run_validation_iter`` reports.
    eval_keys = ("loss", "accuracy")

    def __init__(self, cfg):
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone)
        self.tx = make_injected_adam(cfg.meta_learning_rate, cfg.clip_grad_value)
        self.current_epoch = 0
        set_f32_numerics()

    def init_inference_state(self, generator: torch.Generator, device=None) -> InferenceState:
        """Fresh parameters and unit running statistics from ``generator``
        (drawn on the CPU, then moved)."""
        device = resolve_device(device)
        theta, bn_state = self.backbone.init(generator)
        return InferenceState(
            *(tree_map(lambda a: a.to(device), t) for t in (theta, bn_state))
        )

    def init_state(self, generator: torch.Generator, device=None):
        """``init_inference_state``, zero Adam moments over all of theta
        and iteration 0."""
        istate = self.init_inference_state(generator, device)
        device = tree_leaves(istate.theta)[0].device
        return self.state_type(
            istate.theta, istate.bn_state, self.tx.init(istate.theta),
            torch.zeros((), dtype=torch.int32, device=device),
        )

    def inference_state(self, state) -> InferenceState:
        return InferenceState(state.theta, state.bn_state)

    def _epoch_lr(self, epoch: int) -> float:
        cfg = self.cfg
        return cosine_epoch_lr(
            epoch, cfg.meta_learning_rate, cfg.min_learning_rate, cfg.total_epochs
        )

    def _device_batch(self, state, data_batch) -> tuple:
        """A host episode batch through ``prepare_batch`` onto the state's
        device, or the one batch of a staged group of K = 1."""
        if isinstance(data_batch, StagedBatch):
            return tuple(a[0] for a in data_batch.arrays)
        prepared = prepare_batch(data_batch, codec=self.cfg.wire_codec)
        device = tree_leaves(state.theta)[0].device
        return tuple(a[0] for a in to_device([prepared], device))

    def _decode(self, batch, training: bool = True) -> tuple:
        """``decode_train_batch``, the augmentation operand read in
        training only (as JAX, eval batches carry none)."""
        cfg = self.cfg
        return decode_train_batch(batch, cfg.wire_codec, cfg.dtype,
                                  cfg.device_augment if training else None)

    def _embed(self, theta, bn_state, *images):
        """The backbone over each of ``images`` (``(T, N, C, H, W)``) in
        turn, ``theta`` (cast to the compute dtype) and ``bn_state`` shared
        by the ``T`` tasks and the running statistics threaded from one set
        to the next. Returns ``(outputs (T, N, classes) per set, bn_state
        per task or None)``."""
        tasks = images[0].shape[0]
        theta = cast_floats(theta, self.cfg.dtype)
        params, bn = shared(theta, tasks), shared(bn_state, tasks)
        outputs = []
        for x in images:
            out, bn = self.backbone.apply(params, bn, x, 0)
            outputs.append(out)
        return outputs, bn

    @torch.no_grad()
    def _embed_task(self, theta, images):
        """One task's float32 outputs ``(N, classes)`` of wire-dtype images
        ``(N, C, H, W)``, no running statistics kept: the serving halves'
        embedding."""
        x = decode_images(images, self.cfg.wire_codec, self.cfg.dtype)[None]
        (out,), _ = self._embed(theta, None, x)
        return out[0].float()

    def _grads(self, loss_fn, theta):
        """``(loss, aux, grads over theta)`` of ``loss_fn(theta) -> (loss,
        aux)``; nothing of the graph is kept."""
        leaves = [a.detach().requires_grad_() for a in tree_leaves(theta)]
        with torch.enable_grad():
            loss, aux = loss_fn(tree_unflatten(theta, leaves))
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), aux, tree_unflatten(theta, list(grads))

    def run_train_iter(self, state, data_batch, epoch):
        """One training pass over an episode batch (``(B, N, K, C, H, W)``
        numpy images and ``(B, N, K)`` labels, or a staged group of one).
        Returns ``(new_state, losses)``: ``loss``, ``accuracy`` and
        ``nonfinite`` as device scalars, the learning rate as a float. The
        state passed in is not changed."""
        epoch = int(epoch)
        self.current_epoch = epoch
        batch = self._device_batch(state, data_batch)
        lr = self._epoch_lr(epoch)
        state = state._replace(opt_state=set_injected_lr(state.opt_state, lr))
        new_state, metrics, _ = self._run_batch(state, batch, training=True)
        return new_state, {**metrics, "learning_rate": lr}

    def run_validation_iter(self, state, data_batch):
        """``(state, losses, logits (B, Q, classes))``: the state the eval
        pass returns (gradient descent fine-tunes in eval by design; the
        others return the one given)."""
        batch = self._device_batch(state, data_batch)
        new_state, metrics, logits = self._run_batch(state, batch, training=False)
        losses = {k: metrics[k] for k in self.eval_keys}
        return new_state, losses, logits

"""MAML / MAML++ serving: configuration, inference state, and the learner's
adapt and classify (``howtotrainyourmamlpytorch_tpu/models/maml.py:75-195,
238-248,563-572,1130-1241``). Training comes with a later slice.

``serve_adapt`` runs the inner loop of an eval episode: per step a support
forward, the inner gradient and the LSLR update, at first order (the
gradient is taken without a graph, the counterpart of ``lax.stop_gradient``
at ``maml.py:1214``). ``serve_classify`` runs the query forward with the
adapted fast weights at step ``serve_adapt_steps - 1``. Both take the task
axis explicitly (JAX vmaps a one-task function): ``T`` tasks go through the
backbone at once, their statistics kept apart (``models/backbone.py``).
The inner loss is the sum of the per-task mean losses, so its gradient with
respect to task ``t``'s fast weights is task ``t``'s own gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..inner_loop import init_lslr, lslr_update
from ..ops.losses import nll
from ..utils.platform import resolve_device
from ..utils.trees import merge, partition, tree_leaves, tree_map, tree_unflatten
from .backbone import BackboneConfig, build_backbone
from .common import DTYPES, WireCodec, cast_floats, decode_images

Tree = Any


@dataclasses.dataclass(frozen=True)
class MAMLConfig:
    """The JAX ``MAMLConfig``'s fields and checks, less four that only the
    train path reads and that arrive with it: ``remat_inner_steps``,
    ``task_chunk``, ``collective_fusion`` and ``device_augment``."""

    backbone: BackboneConfig = dataclasses.field(default_factory=BackboneConfig)

    # Inner loop
    number_of_training_steps_per_iter: int = 5
    number_of_evaluation_steps_per_iter: int = 5
    task_learning_rate: float = 0.1
    learnable_per_layer_per_step_inner_loop_learning_rate: bool = True
    second_order: bool = True
    first_order_to_second_order_epoch: int = -1

    # MSL
    use_multi_step_loss_optimization: bool = True
    multi_step_loss_num_epochs: int = 10

    # Outer loop
    meta_learning_rate: float = 0.001
    min_learning_rate: float = 1e-5
    total_epochs: int = 100
    total_iter_per_epoch: int = 500
    clip_grad_value: float | None = None

    # BN learnability
    learnable_bn_gamma: bool = True
    learnable_bn_beta: bool = True

    skip_nonfinite_updates: bool = False
    compute_dtype: str = "float32"
    wire_codec: WireCodec | None = None

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def __post_init__(self):
        # A mismatch would silently collapse per-step BN onto the last row
        # (the step index is clamped), so it is refused.
        if (
            self.backbone.per_step_bn_statistics
            and self.backbone.num_steps != self.number_of_training_steps_per_iter
        ):
            raise ValueError(
                "backbone.num_steps"
                f" ({self.backbone.num_steps}) must equal"
                " number_of_training_steps_per_iter"
                f" ({self.number_of_training_steps_per_iter}) when"
                " per_step_bn_statistics is on"
            )
        # The LSLR table has training_steps + 1 rows.
        if (
            self.number_of_evaluation_steps_per_iter
            > self.number_of_training_steps_per_iter + 1
        ):
            raise ValueError(
                "number_of_evaluation_steps_per_iter"
                f" ({self.number_of_evaluation_steps_per_iter}) may exceed"
                " number_of_training_steps_per_iter"
                f" ({self.number_of_training_steps_per_iter}) by at most 1"
                " (the LSLR table has training_steps + 1 rows)"
            )
        if self.compute_dtype not in DTYPES:
            raise ValueError(
                "compute_dtype must be float32 | bfloat16, got"
                f" {self.compute_dtype!r}"
            )


class MAMLInferenceState(NamedTuple):
    """What adapt and classify read: parameters, LSLR rates, BN running
    statistics (the last never reach an output)."""

    theta: Tree
    lslr: Tree
    bn_state: Tree


class MAMLFewShotLearner:
    """The serving half of the MAML/MAML++ learner."""

    def __init__(self, cfg: MAMLConfig):
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "bfloat16 compute is ROADMAP item A8; the port serves float32"
            )
        self.cfg = cfg
        self.backbone = build_backbone(cfg.backbone)

    def adapt_mask(self, theta: Tree) -> Tree:
        """True on the leaves the inner loop adapts."""
        return self.backbone.inner_loop_mask(theta)

    @property
    def serve_adapt_steps(self) -> int:
        """Inner updates that determine the eval prediction."""
        return min(
            self.cfg.number_of_training_steps_per_iter,
            self.cfg.number_of_evaluation_steps_per_iter,
        )

    def init_inference_state(
        self, generator: torch.Generator, device=None
    ) -> MAMLInferenceState:
        """Fresh parameters from ``generator`` (drawn on the CPU, then moved),
        LSLR rates at ``task_learning_rate``, unit running stats."""
        device = resolve_device(device)
        theta, bn_state = self.backbone.init(generator)
        theta, bn_state = (
            tree_map(lambda a: a.to(device), t) for t in (theta, bn_state)
        )
        adapt, _ = partition(theta, self.adapt_mask(theta))
        lslr = init_lslr(
            adapt,
            self.cfg.number_of_training_steps_per_iter,
            self.cfg.task_learning_rate,
        )
        return MAMLInferenceState(theta=theta, lslr=lslr, bn_state=bn_state)

    def inference_state(self, state) -> MAMLInferenceState:
        return MAMLInferenceState(state.theta, state.lslr, state.bn_state)

    def _fused(self) -> str:
        return "vjp" if self.cfg.backbone.use_pallas_fused_norm else "off"

    def serve_adapt(self, istate: MAMLInferenceState, x_support, y_support):
        """Adapts ``T`` tasks: ``x_support`` ``(T, N, C, H, W)`` (wire
        dtype), ``y_support`` ``(T, N)``. Returns the fast-weight tree (the
        adapted leaves with a leading ``T`` axis, ``None`` where frozen),
        detached. Runs with autograd on even under ``torch.no_grad()``."""
        tasks = x_support.shape[0]
        adapt0, frozen = partition(istate.theta, self.adapt_mask(istate.theta))
        adapt0 = cast_floats(adapt0, self.cfg.dtype)
        frozen = tree_map(
            lambda a: a.expand(tasks, *a.shape), cast_floats(frozen, self.cfg.dtype)
        )
        x = decode_images(x_support, self.cfg.wire_codec, self.cfg.dtype)
        y = y_support.long()
        leaves = [a.expand(tasks, *a.shape) for a in tree_leaves(adapt0)]
        with torch.enable_grad():
            for step in range(self.serve_adapt_steps):
                leaves = [a.detach().requires_grad_() for a in leaves]
                fast = tree_unflatten(adapt0, leaves)
                logits, _ = self.backbone.apply(
                    merge(fast, frozen), None, x, step, fused=self._fused()
                )
                loss = nll(logits, y).mean(dim=-1).sum()
                grads = torch.autograd.grad(loss, leaves)
                fast = lslr_update(
                    fast, tree_unflatten(adapt0, grads), istate.lslr, step
                )
                leaves = tree_leaves(fast)
        return tree_unflatten(adapt0, [a.detach() for a in leaves])

    @torch.no_grad()
    def serve_classify(self, istate: MAMLInferenceState, adapted, x_query):
        """Query logits ``(T, Q, num_classes)`` float32 for ``T`` tasks with
        their adapted fast weights; ``x_query`` ``(T, Q, C, H, W)``."""
        tasks = x_query.shape[0]
        _, frozen = partition(istate.theta, self.adapt_mask(istate.theta))
        frozen = tree_map(
            lambda a: a.expand(tasks, *a.shape), cast_floats(frozen, self.cfg.dtype)
        )
        x = decode_images(x_query, self.cfg.wire_codec, self.cfg.dtype)
        logits, _ = self.backbone.apply(
            merge(adapted, frozen), None, x, self.serve_adapt_steps - 1,
            fused=self._fused(),
        )
        return logits.float()

"""MAML / MAML++: configuration, train state, the meta-train and eval steps,
and the serving half (``howtotrainyourmamlpytorch_tpu/models/maml.py``).

The task axis is written out (JAX vmaps a one-task function): ``T`` tasks
go through the backbone at once, their statistics kept apart
(``models/backbone.py``). The inner loss is the sum of the per-task mean
losses, so its gradient with respect to task ``t``'s fast weights is task
``t``'s own gradient.

Training (``run_train_iter``): per inner step a support forward, the inner
gradient by ``torch.autograd.grad`` with ``create_graph`` at second order
(without it at first order, the counterpart of ``lax.stop_gradient`` at
``maml.py:740-741``), the LSLR update, and a target forward weighted by the
MSL importance vector. The fast weights start as the ``theta`` leaves
``expand``ed over tasks, so the outer gradient reaches ``theta`` and the
LSLR rates through every step. The outer loss is the task mean of the
weighted target losses; outer Adam updates the trainable leaves. Past the
MSL horizon (``final_only``) only the last step's target pass runs.

Several meta-updates a dispatch (``run_train_iters``): on the card, each
replays the train step captured as a CUDA graph (``models/step_graph.py``),
``run_train_iter`` being the dispatch of one; on the CPU the eager step runs
K times.

Serving (``serve_adapt``, its masked twin for geometry-padded support
sets, ``serve_classify``) and eval
(``run_validation_iter``) adapt at first order with the fast weights
detached every step.

Compute dtype. Under ``compute_dtype="bfloat16"`` the adapted and frozen
leaves are cast once, at the step's boundary (``cast_floats``, the identity
in float32), so the inner loop, its gradients and the activations run in
bfloat16; the LSLR table, the BN statistics, the outer gradients and Adam
stay float32 (``maml.py:683-706``).

Task chunks (``task_chunk``, ``maml.py:802-872``). JAX scans chunks of the
task axis through one vmapped program; here each chunk's forward and outer
backward run before the next chunk's forward, its loss scaled by chunk/B
and the gradients summed, so live activations are bounded by the chunk.
The per-task metrics are put back on the full ``(B, ...)`` task axis.

Data parallel (``mesh``, ``maml.py:920-962``). On a dp layout of ``dp``
ranks (``parallel/mesh.py``) each rank runs the meta-loss on its own
slice of the tasks, chunked by ``task_chunk / dp`` where chunking is on,
its loss scaled by the same expression as a chunk's (its tasks over the
global count) and its accuracy and BN state by ``1 / dp``; the four are
all-reduced with the ``collective_fusion`` the config selects (one
all-reduce per dtype bucket by default) and Adam runs on every rank on
the reduced gradients, so the state stays replicated. Two ranks therefore
add the same two gradient terms as the single-process step with
``task_chunk = B/2``, bit for bit. On a card the captured step is split
at that seam (``models/step_graph.py``). ANIL inherits all of it.

Tensor parallel (``mesh.mp > 1``, JAX's mp mesh axis). The state is this
rank's blocks (``common.CheckpointableLearner.shard_state``, the
``MP_STATE_RULES`` layout) and the backbone runs on its ``ModelShard``
(``models/backbone.py``). The fast weights stay sharded through the inner
loop: the LSLR update is elementwise, and the rates of a sharded leaf
enter it through ``CopyToShards``, so their gradient is summed over the mp
group once. (JAX re-anchors the inner gradients as replicated instead,
``parallel/mesh.mp_grad_anchor``, a workaround for its partitioner.) The
meta-gradient of a sharded leaf is its block's; of a replicated leaf,
whole on every rank. ``_reduce`` sums over the dp group only, Adam runs on
the blocks, so the moments stay sharded, the BN state is all-gathered over
the mp group at the step's end (it stays replicated, as in JAX), and the
sentinel's global norm sums the sharded leaves' squares over the group.
Every backward runs on the calling thread, so every rank issues the
backbone's collectives in one order. The card runs the eager step there
(``models/step_graph.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..inner_loop import init_lslr, lslr_update
from ..ops.losses import masked_cross_entropy, nll
from ..parallel.collectives import (
    ModelShard,
    all_gather_cat,
    all_reduce_,
    guard_task_chunk,
    reduce_fn,
)
from ..utils import sanitize
from ..utils.platform import resolve_device, set_f32_numerics
from ..utils.trees import (
    merge,
    partition,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_unflatten,
)
from .backbone import BackboneConfig, build_backbone
from .common import (
    DTYPES,
    CheckpointableLearner,
    StagedBatch,
    WireCodec,
    cast_floats,
    cosine_epoch_lr,
    decode_images,
    decode_train_batch,
    global_norm,
    guard_nonfinite_update,
    is_stacked,
    make_injected_adam,
    nonfinite_flag,
    prepare_batch,
    set_injected_lr,
    to_device,
)
from .step_graph import StepGraphs

Tree = Any


@dataclasses.dataclass(frozen=True)
class MAMLConfig:
    """The JAX ``MAMLConfig``'s fields, defaults and checks."""

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
    # Each inner step under torch.utils.checkpoint: its activations are
    # recomputed in the outer backward instead of kept.
    remat_inner_steps: bool = True
    compute_dtype: str = "float32"
    # Tasks a chunk of the meta-batch (0: all at once); must divide it.
    task_chunk: int = 0
    # Multi-device reduction form; no effect on one device, as in JAX.
    collective_fusion: str = "bucketed"
    wire_codec: WireCodec | None = None
    # models/common.DeviceAugment, or None: the train augmentation runs on
    # the host.
    device_augment: Any = None

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
        if self.task_chunk < 0:
            raise ValueError(f"task_chunk must be >= 0, got {self.task_chunk}")
        if self.collective_fusion not in ("bucketed", "per_leaf"):
            raise ValueError(
                "collective_fusion must be bucketed | per_leaf, got"
                f" {self.collective_fusion!r}"
            )
        if self.compute_dtype not in DTYPES:
            raise ValueError(
                "compute_dtype must be float32 | bfloat16, got"
                f" {self.compute_dtype!r}"
            )


def _task_cat(parts):
    """Per-task tensors of the task chunks, joined on the task axis (the one
    chunk's own tensor when there is one)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def per_step_loss_importance(
    epoch: int, num_steps: int, msl_num_epochs: int
) -> np.ndarray:
    """MSL importance vector with the reference's annealing: early-step
    weights decay linearly to a floor while the final step's grows."""
    weights = np.ones(num_steps, np.float32) * (1.0 / num_steps)
    decay = 1.0 / num_steps / msl_num_epochs
    min_nonfinal = 0.03 / num_steps
    for i in range(num_steps - 1):
        weights[i] = max(weights[i] - epoch * decay, min_nonfinal)
    weights[-1] = min(
        weights[-1] + epoch * (num_steps - 1) * decay,
        1.0 - (num_steps - 1) * min_nonfinal,
    )
    return weights


def final_step_importance(num_steps: int, final_index: int | None = None) -> np.ndarray:
    """One-hot importance on a single step's target loss."""
    weights = np.zeros(num_steps, np.float32)
    weights[final_index if final_index is not None else num_steps - 1] = 1.0
    return weights


class TrainState(NamedTuple):
    """Everything a train step reads and writes. ``opt_state`` is an
    ``AdamState`` over ``{"theta", "lslr"}``; ``iteration`` an int32
    scalar."""

    theta: Tree
    lslr: Tree
    bn_state: Tree
    opt_state: Any
    iteration: torch.Tensor


class MAMLInferenceState(NamedTuple):
    """What adapt and classify read: parameters, LSLR rates, BN running
    statistics (the last never reach an output)."""

    theta: Tree
    lslr: Tree
    bn_state: Tree


class MAMLFewShotLearner(CheckpointableLearner):
    """The MAML/MAML++ learner: the train and eval steps of the reference
    trainer contract, and the serving half."""

    supports_model_sharding = True

    def __init__(self, cfg: MAMLConfig, mesh=None):
        """``mesh``: a ``parallel.mesh.Mesh`` of ``dp x mp`` ranks, or None
        on one process."""
        self.cfg = cfg
        self.mesh = mesh
        guard_task_chunk(mesh, cfg.task_chunk)
        #: The dp extent: the ranks the task axis is split over.
        self.dp = 1 if mesh is None else int(mesh.dp)
        #: The mp extent: the ranks each sharded leaf is split over.
        self.mp = 1 if mesh is None else int(mesh.mp)
        shard = (ModelShard(mesh.mp_group, mesh.mp, mesh.mp_index)
                 if self.mp > 1 else None)
        self.backbone = build_backbone(cfg.backbone, shard)
        self.tx = make_injected_adam(cfg.meta_learning_rate, cfg.clip_grad_value)
        self.current_epoch = 0
        # The captured train steps, made at the first dispatch on a card.
        self._step_graphs: StepGraphs | None = None
        set_f32_numerics()

    def adapt_mask(self, theta: Tree) -> Tree:
        """True on the leaves the inner loop adapts."""
        return self.backbone.inner_loop_mask(theta)

    def trainable_mask(self, outer: Tree) -> Tree:
        """True on the ``{"theta", "lslr"}`` leaves outer Adam updates: BN
        gamma/beta unless frozen by config, never the layer norm's weight
        (frozen at 1, as in the reference), the LSLR rates when learnable
        (``maml.py:622-648``)."""
        cfg = self.cfg

        def theta_label(path, _):
            if "norm" in path:
                if cfg.backbone.norm_layer == "layer_norm" and path[-1] == "weight":
                    return False
                if path[-1] == "gamma":
                    return cfg.learnable_bn_gamma
                if path[-1] == "beta":
                    return cfg.learnable_bn_beta
            return True

        lslr_on = cfg.learnable_per_layer_per_step_inner_loop_learning_rate
        return {
            "theta": tree_map_with_path(theta_label, outer["theta"]),
            "lslr": tree_map(lambda _: lslr_on, outer["lslr"]),
        }

    @property
    def serve_adapt_steps(self) -> int:
        """Inner updates that determine the eval prediction."""
        return min(
            self.cfg.number_of_training_steps_per_iter,
            self.cfg.number_of_evaluation_steps_per_iter,
        )

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

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

    def init_state(self, generator: torch.Generator, device=None) -> TrainState:
        """``init_inference_state`` plus zero Adam moments for the trainable
        leaves and iteration 0."""
        istate = self.init_inference_state(generator, device)
        outer = {"theta": istate.theta, "lslr": istate.lslr}
        device = tree_leaves(istate.theta)[0].device
        return TrainState(
            theta=istate.theta,
            lslr=istate.lslr,
            bn_state=istate.bn_state,
            opt_state=self.tx.init(outer, self.trainable_mask(outer)),
            iteration=torch.zeros((), dtype=torch.int32, device=device),
        )

    def inference_state(self, state) -> MAMLInferenceState:
        return MAMLInferenceState(state.theta, state.lslr, state.bn_state)

    # ------------------------------------------------------------------
    # Inner loop over all tasks
    # ------------------------------------------------------------------

    def _meta_loss(
        self, outer, bn_state, batch, importance, num_steps, second_order,
        pred_step=None, final_only=False, outer_grad=True,
    ):
        """Inner-loop adaptation and target losses of ``T`` tasks at once
        (``maml.py:654-879``, the task axis written out).

        ``outer``: ``{"theta", "lslr"}``. ``batch``: ``(x_support (T, S, C,
        H, W), x_target (T, Q, C, H, W), y_support (T, S), y_target (T,
        Q)[, aug])`` on the device, ``aug`` the train augmentation's
        operand. Returns ``(task mean of the weighted target losses,
        aux)``, aux holding the prediction step's target ``logits``
        (float32), per-task ``accuracy`` and the evolved ``bn_state``
        (leading ``T`` axis). Without ``outer_grad`` (eval) no graph
        outlives a step."""
        cfg = self.cfg
        theta, lslr = outer["theta"], self._shard_rates(outer["lslr"])
        # The one boundary cast of the float32 masters (the identity in
        # float32); the LSLR table and the BN statistics stay float32.
        adapt0, frozen = partition(theta, self.adapt_mask(theta))
        adapt0 = cast_floats(adapt0, cfg.dtype)
        xs, xt, ys, yt = decode_train_batch(
            batch, cfg.wire_codec, cfg.dtype, cfg.device_augment
        )
        tasks = xs.shape[0]
        frozen = tree_map(
            lambda a: a.expand(tasks, *a.shape), cast_floats(frozen, cfg.dtype)
        )
        # The any-order op on train paths (even first order differentiates
        # through the fast weights), the one-level pair on eval (JAX
        # maml.py:710-724).
        if outer_grad:
            fused = "jvp" if self.backbone.cfg.fused_norm_train else "off"
        else:
            fused = self._fused()
        bn = tree_map(lambda a: a.expand(tasks, *a.shape), bn_state)

        def forward(leaves, bn, x, step):
            fast = tree_unflatten(adapt0, leaves)
            return self.backbone.apply(merge(fast, frozen), bn, x, step, fused=fused)

        def inner_update(step, bn, *leaves):
            if not outer_grad:
                leaves = [a.detach().requires_grad_() for a in leaves]
            logits, bn = forward(leaves, bn, xs, step)
            loss = nll(logits, ys).mean(dim=-1).sum()
            grads = torch.autograd.grad(loss, leaves, create_graph=second_order)
            fast = lslr_update(
                tree_unflatten(adapt0, leaves), tree_unflatten(adapt0, grads),
                lslr, step,
            )
            return bn, *tree_leaves(fast)

        def target(step, bn, *leaves):
            logits, bn = forward(leaves, bn, xt, step)
            return bn, logits

        def run(fn, *args):
            # Checkpointed steps keep only their inputs for the outer
            # backward; without an outer gradient there is nothing to keep.
            # The step draws no random numbers, so there is no RNG state to
            # restore for the recomputation (reading the card's would stop
            # a CUDA-graph capture).
            if cfg.remat_inner_steps and outer_grad:
                return checkpoint(
                    fn, *args, use_reentrant=False, preserve_rng_state=False
                )
            return fn(*args)

        leaves = [a.expand(tasks, *a.shape) for a in tree_leaves(adapt0)]
        target_logits = []
        with torch.enable_grad():
            for step in range(num_steps):
                bn, *leaves = run(inner_update, step, bn, *leaves)
                if final_only:
                    continue
                with torch.set_grad_enabled(outer_grad):
                    bn, logits = run(target, step, bn, *leaves)
                target_logits.append(logits)
            if final_only:
                with torch.set_grad_enabled(outer_grad):
                    bn, logits = target(num_steps - 1, bn, *leaves)
                target_logits = [logits]
                pred_step = 0
        t_losses = torch.stack([nll(lg, yt).mean(dim=-1) for lg in target_logits])
        if final_only:
            weighted = t_losses[0]
        else:
            weighted = (importance[:, None] * t_losses).sum(dim=0)
            pred_step = num_steps - 1 if pred_step is None else pred_step
        logits = target_logits[pred_step].float()
        accuracy = (logits.argmax(-1) == yt).float().mean(dim=-1)
        return weighted.mean(), dict(logits=logits, accuracy=accuracy, bn_state=bn)

    def _shard_rates(self, lslr: Tree) -> Tree:
        """The LSLR rates, those of sharded leaves entering the sharded
        update through ``CopyToShards`` (the identity off a tensor-parallel
        layout)."""
        shard = self.backbone.shard
        if shard is None:
            return lslr
        sharded = self.sharded_theta()
        sharded, _ = partition(sharded, self.adapt_mask(sharded))
        return tree_map(lambda lr, s: shard.copy(lr) if s else lr, lslr, sharded)

    def _gather_bn(self, bn_state: Tree, whole: Tree) -> Tree:
        """Running statistics of sharded sites, a rank's channel block,
        all-gathered over the mp group to ``whole``'s shapes."""
        mesh = self.mesh
        return tree_map(
            lambda a, w: a if a.shape == w.shape
            else all_gather_cat(a, a.dim() - 1, mesh.mp_group, mesh.mp),
            bn_state, whole,
        )

    def _global_norm(self, grads: Tree) -> torch.Tensor:
        """``common.global_norm`` of the whole meta-gradient: the squares of
        sharded leaves summed over the mp group, replicated leaves counted
        once."""
        if self.backbone.shard is None:
            return global_norm(grads)
        sq = lambda g: g.float().square().sum()  # noqa: E731
        zero = torch.zeros((), device=tree_leaves(grads)[0].device)
        own, rest = [zero], [zero] + [sq(g) for g in tree_leaves(grads["lslr"])]
        tree_map(lambda g, s: (own if s else rest).append(sq(g)),
                 grads["theta"], self.sharded_theta())
        total = all_reduce_(torch.stack(own).sum(), self.mesh.mp_group)
        return torch.sqrt(total + torch.stack(rest).sum())

    # ------------------------------------------------------------------
    # Meta step
    # ------------------------------------------------------------------

    def _task_chunks(self, batch) -> list:
        """``batch`` cut on its task axis into chunks of ``task_chunk``
        tasks (``task_chunk / dp`` on a rank's slice); the whole batch,
        alone, when that is 0 or at least the task count
        (``maml.py:826-835``)."""
        tasks, chunk = batch[0].shape[0], self.cfg.task_chunk // self.dp
        if not 0 < chunk < tasks:
            return [batch]
        if tasks % chunk:
            raise ValueError(
                f"task_chunk ({chunk}) must divide the meta-batch's task "
                f"count ({tasks})"
            )
        return [tuple(a[i:i + chunk] for a in batch) for i in range(0, tasks, chunk)]

    def _meta_grads_local(self, state: TrainState, batch, importance, *,
                          second_order, final_only):
        """This rank's ``(loss, accuracy_mean, bn_state_mean, grads)`` of one
        meta-step (``maml.py:881-962``); ``grads`` over ``{"theta",
        "lslr"}``, the BN state averaged over tasks. With task chunks, each
        chunk's loss (its task mean times chunk/B, B the global task count)
        is differentiated before the next chunk runs and the gradients are
        summed. On ``dp`` ranks the accuracy and BN state carry ``1 / dp``:
        the sum over ranks is the whole meta-step's."""
        outer = {"theta": state.theta, "lslr": state.lslr}
        leaves = [a.detach().requires_grad_() for a in tree_leaves(outer)]
        tasks = batch[0].shape[0] * self.dp
        losses, grads, accuracy, bn_states = [], None, [], []
        for chunk in self._task_chunks(batch):
            share = chunk[0].shape[0] / tasks
            # Every backward runs on this thread. On a card, autograd
            # otherwise runs it on a device thread, where the inner
            # gradients' graph (create_graph) is recorded with that thread's
            # node numbering; the outer backward orders nodes of the two
            # numberings by comparing them, so the order in which a leaf's
            # gradients are summed, and their bits, would depend on how many
            # nodes each thread had made before in the process.
            with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
                loss, aux = self._meta_loss(
                    tree_unflatten(outer, leaves), state.bn_state, chunk,
                    importance, self.cfg.number_of_training_steps_per_iter,
                    second_order, None, final_only,
                )
                if share != 1.0:
                    loss = loss * share
                part = torch.autograd.grad(loss, leaves, allow_unused=True)
            part = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, part)]
            grads = part if grads is None else [g + p for g, p in zip(grads, part)]
            losses.append(loss.detach())
            accuracy.append(aux["accuracy"])
            bn_states.append(aux["bn_state"])
        bn_mean = tree_map(lambda *s: self._rank_share(_task_cat(s).mean(dim=0)),
                           *bn_states)
        if self.mp > 1:
            bn_mean = self._gather_bn(bn_mean, state.bn_state)
        return (
            sum(losses[1:], losses[0]), self._rank_share(_task_cat(accuracy).mean()),
            bn_mean, tree_unflatten(outer, grads),
        )

    def _rank_share(self, value: torch.Tensor) -> torch.Tensor:
        """A rank's mean as its share of the mean over ranks (``/ dp``)."""
        return value if self.dp == 1 else value / self.dp

    def _reduce(self, parts):
        """The sum over the dp group's ranks of a rank's metric and gradient
        parts (the identity without dp ranks)."""
        if self.dp == 1:
            return parts
        return reduce_fn(self.cfg.collective_fusion)(parts, self.mesh.dp_group)

    def _meta_grads(self, state: TrainState, batch, importance, *,
                    second_order, final_only):
        """``(loss, accuracy_mean, bn_state_mean, grads)`` of one meta-step
        over every rank's tasks."""
        return self._reduce(self._meta_grads_local(
            state, batch, importance,
            second_order=second_order, final_only=final_only,
        ))

    @torch.no_grad()
    def _train_step(self, state: TrainState, batch, importance, *,
                    second_order, final_only=False):
        """One meta-update (``maml.py:964-996``): meta-gradients, Adam on
        the trainable leaves, the divergence sentinel."""
        return self._apply_meta_update(state, self._meta_grads(
            state, batch, importance,
            second_order=second_order, final_only=final_only,
        ))

    @torch.no_grad()
    def _apply_meta_update(self, state: TrainState, reduced):
        """Adam on the reduced gradients and the sentinel on the reduced
        loss and gradients: the half of the step after the reduction."""
        loss, accuracy, bn_state, grads = reduced
        outer = {"theta": state.theta, "lslr": state.lslr}
        outer, opt_state = self.tx.step(outer, grads, state.opt_state)
        new_state = TrainState(
            theta=outer["theta"],
            lslr=outer["lslr"],
            bn_state=bn_state,
            opt_state=opt_state,
            iteration=state.iteration + 1,
        )
        # The classic second-order failure is a non-finite meta-gradient
        # under a finite loss, so both are checked.
        nonfinite = nonfinite_flag(loss, self._global_norm(grads))
        new_state = guard_nonfinite_update(
            self.cfg.skip_nonfinite_updates, nonfinite, new_state, state
        )
        return new_state, dict(loss=loss, accuracy=accuracy, nonfinite=nonfinite)

    def _evaluation_step(self, state, batch, importance, *, final_only=False):
        """Adaptation and target evaluation at first order, chunk by chunk
        of tasks; the BN state is discarded (``maml.py:998-1019``). On ``dp``
        ranks the loss and accuracy are reduced over ranks and the logits
        are this rank's tasks'."""
        cfg = self.cfg
        tasks = batch[0].shape[0] * self.dp
        losses, accuracy, logits = [], [], []
        for chunk in self._task_chunks(batch):
            share = chunk[0].shape[0] / tasks
            with torch.autograd.set_multithreading_enabled(self.mp == 1):
                loss, aux = self._meta_loss(
                    {"theta": state.theta, "lslr": state.lslr}, state.bn_state,
                    chunk, importance, cfg.number_of_evaluation_steps_per_iter,
                    False, None if final_only else self.serve_adapt_steps - 1,
                    final_only, outer_grad=False,
                )
            losses.append(loss.detach() if share == 1.0 else loss.detach() * share)
            accuracy.append(aux["accuracy"])
            logits.append(aux["logits"])
        loss, accuracy = self._reduce((
            sum(losses[1:], losses[0]), self._rank_share(_task_cat(accuracy).mean())
        ))
        return dict(loss=loss, accuracy=accuracy), _task_cat(logits)

    # ------------------------------------------------------------------
    # Reference trainer contract
    # ------------------------------------------------------------------

    def _use_second_order(self, epoch: int) -> bool:
        return self.cfg.second_order and epoch > self.cfg.first_order_to_second_order_epoch

    def _train_importance(self, epoch: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.number_of_training_steps_per_iter
        if cfg.use_multi_step_loss_optimization and epoch < cfg.multi_step_loss_num_epochs:
            return per_step_loss_importance(epoch, n, cfg.multi_step_loss_num_epochs)
        return final_step_importance(n)

    def _eval_importance(self) -> np.ndarray:
        # Only the target loss at the training final-step index counts.
        n_eval = self.cfg.number_of_evaluation_steps_per_iter
        return final_step_importance(n_eval, self.serve_adapt_steps - 1)

    def _epoch_lr(self, epoch: int) -> float:
        cfg = self.cfg
        return cosine_epoch_lr(
            epoch, cfg.meta_learning_rate, cfg.min_learning_rate, cfg.total_epochs
        )

    def _device(self, state) -> torch.device:
        return tree_leaves(state.theta)[0].device

    def _device_batch(self, state, data_batch):
        """One host episode batch through ``prepare_batch``, onto the
        state's device."""
        prepared = prepare_batch(data_batch, codec=self.cfg.wire_codec)
        return tuple(a[0] for a in to_device([prepared], self._device(state)))

    def _device_group(self, state, data_batches):
        """A dispatch group on the state's device, each field with a
        leading K axis, from any form ``run_train_iters`` takes."""
        device = self._device(state)
        if isinstance(data_batches, StagedBatch):
            return tuple(data_batches.arrays)
        if is_stacked(data_batches):
            if all(isinstance(b, torch.Tensor) for b in data_batches):
                return tuple(b.to(device) for b in data_batches)
            return to_device(list(zip(*data_batches)), device)
        prepared = [prepare_batch(b, codec=self.cfg.wire_codec) for b in data_batches]
        return to_device(prepared, device)

    def _importance(self, state, weights: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(weights).to(self._device(state))

    def _final_only(self, epoch: int) -> bool:
        """Past the MSL horizon the importance is one-hot on the last step:
        only that step's target pass runs."""
        cfg = self.cfg
        return not (
            cfg.use_multi_step_loss_optimization
            and epoch < cfg.multi_step_loss_num_epochs
        )

    def _train_group(self, state: TrainState, group, epoch: int):
        """``len(group[0])`` meta-updates of ``epoch``'s program variant.
        Returns ``(new_state, metrics)`` with ``(K,)`` ``loss``,
        ``accuracy`` and ``nonfinite``. On a card each is a replay of the
        captured step (the eager step under ``--debug_nans`` and on a
        tensor-parallel layout); on the CPU the eager step."""
        importance = self._train_importance(epoch)
        lr = self._epoch_lr(epoch)
        branch = dict(second_order=self._use_second_order(epoch),
                      final_only=self._final_only(epoch))
        device = self._device(state)
        # A tensor-parallel step's collectives go through the host on gloo,
        # which a CUDA graph cannot capture: the eager step runs there.
        if device.type == "cuda" and not sanitize.debug_nans_enabled() and self.mp == 1:
            if self._step_graphs is None:
                self._step_graphs = StepGraphs(device)
            new_state, rows = self._step_graphs.run(
                self, state, group, importance, lr, **branch
            )
            return new_state, dict(zip(("loss", "accuracy", "nonfinite"), rows))
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"the learner runs on cuda or cpu, got {device}")
        state = state._replace(opt_state=set_injected_lr(state.opt_state, lr))
        weights = self._importance(state, importance)
        steps = []
        for k in range(group[0].shape[0]):
            state, metrics = self._train_step(
                state, tuple(a[k] for a in group), weights, **branch
            )
            steps.append(metrics)
        return state, {key: torch.stack([m[key] for m in steps])
                       for key in ("loss", "accuracy", "nonfinite")}

    def _train_losses(self, metrics: dict, epoch: int) -> dict:
        """The metrics and the reference's float keys: the MSL importance
        vector and the learning rate."""
        cfg = self.cfg
        losses = dict(metrics)
        msl_vector = per_step_loss_importance(
            epoch, cfg.number_of_training_steps_per_iter,
            cfg.multi_step_loss_num_epochs,
        )
        for i, v in enumerate(msl_vector):
            losses[f"loss_importance_vector_{i}"] = float(v)
        losses["learning_rate"] = self._epoch_lr(epoch)
        return losses

    def run_train_iter(self, state: TrainState, data_batch, epoch):
        """One meta-update on a ``(x_support, x_target, y_support,
        y_target)`` numpy episode batch of shape ``(B, N, K, C, H, W)`` /
        ``(B, N, K)``. Returns ``(new_state, losses)``: ``loss``,
        ``accuracy`` and ``nonfinite`` as device scalars (no host sync), the
        MSL importance vector and the learning rate as floats
        (``maml.py:1047-1086``). The state passed in is not changed."""
        epoch = int(epoch)
        self.current_epoch = epoch
        group = self._device_group(state, [data_batch])
        new_state, metrics = self._train_group(state, group, epoch)
        return new_state, self._train_losses(
            {k: v[0] for k, v in metrics.items()}, epoch
        )

    def run_train_iters(self, state: TrainState, data_batches, epoch):
        """K meta-updates in one dispatch (``maml.py:418-479``).

        ``data_batches``: a sequence of K episode batches, the pre-stacked
        form (a 4- or 5-tuple of ``prepare_batch``-layout arrays, each with
        a leading K axis) or a ``StagedBatch``. Returns ``(new_state,
        losses)`` with the keys of ``run_train_iter``; ``loss``,
        ``accuracy`` and ``nonfinite`` are ``(K,)`` device tensors, one
        sample per meta-update. The state passed in is not changed."""
        epoch = int(epoch)
        self.current_epoch = epoch
        group = self._device_group(state, data_batches)
        new_state, metrics = self._train_group(state, group, epoch)
        return new_state, self._train_losses(metrics, epoch)

    def run_validation_iter(self, state: TrainState, data_batch):
        """Evaluation episode batch -> ``(state, losses, logits (B, Q,
        classes))``; the state is returned unchanged
        (``maml.py:1088-1119``)."""
        cfg = self.cfg
        batch = self._device_batch(state, data_batch)
        final_only = (
            cfg.number_of_evaluation_steps_per_iter
            <= cfg.number_of_training_steps_per_iter
        )
        metrics, logits = self._evaluation_step(
            state, batch, self._importance(state, self._eval_importance()),
            final_only=final_only,
        )
        return state, metrics, logits

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def _fused(self) -> str:
        """The fused-norm variant of the paths without an outer gradient
        (serve and eval): the one-level kernel pair or none."""
        return "vjp" if self.cfg.backbone.use_pallas_fused_norm else "off"

    def serve_adapt(self, istate: MAMLInferenceState, x_support, y_support):
        """Adapts ``T`` tasks: ``x_support`` ``(T, N, C, H, W)`` (wire
        dtype), ``y_support`` ``(T, N)``. Returns the fast-weight tree (the
        adapted leaves with a leading ``T`` axis, ``None`` where frozen),
        detached. Runs with autograd on even under ``torch.no_grad()``."""
        return self._serve_adapt(istate, x_support, y_support, None)

    def serve_adapt_masked(self, istate: MAMLInferenceState, x_support,
                           y_support, support_mask):
        """``serve_adapt`` of geometry-padded support sets
        (``serve/geometry.py``, JAX ``maml.py:1175-1186``): rows where
        ``support_mask`` ``(T, N)`` is 0 add exactly zero to each task's
        inner loss and its gradient (``ops/losses.masked_cross_entropy``)."""
        return self._serve_adapt(istate, x_support, y_support, support_mask)

    def _serve_adapt(self, istate, x_support, y_support, support_mask):
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
                if support_mask is None:
                    loss = nll(logits, y).mean(dim=-1).sum()
                else:
                    loss = torch.stack([
                        masked_cross_entropy(*task)
                        for task in zip(logits, y, support_mask)
                    ]).sum()
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

"""The plain gradient-descent (transfer) baseline
(``howtotrainyourmamlpytorch_tpu/models/gradient_descent.py``).

The conv backbone of MAML, but every "inner step" is a real Adam update of
the shared weights on one task's support loss, and after the steps the
task's target loss takes one more Adam update; task after task, the
weights, the running statistics and Adam's moments threading through. No
meta-learning: the weights persist across tasks and iterations.

Kept from the reference, as the JAX package keeps them:

* evaluation fine-tunes the shared weights too, and ``run_validation_iter``
  returns the state it made;
* the reported loss and accuracy are the last task's.

Each task runs alone (``T = 1`` on the backbone's task axis), so on the card
the fused-norm kernels see one task's 64 channels.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..ops.losses import masked_cross_entropy, nll
from ..utils.trees import tree_map
from .common import (
    SharedWeightsLearner,
    decode_images,
    global_norm,
    guard_nonfinite_update,
    nonfinite_flag,
)

Tree = Any


class GDState(NamedTuple):
    theta: Tree
    bn_state: Tree
    opt_state: Any
    iteration: torch.Tensor


class GDInferenceState(NamedTuple):
    """The serving state: ``InferenceState``'s fields and the fine-tune
    learning rate as a float32 scalar (data, so that a checkpoint of
    another epoch brings its own). Never a checkpoint template:
    ``init_inference_state`` gives the plain ``InferenceState``."""

    theta: Tree
    bn_state: Tree
    fine_tune_lr: torch.Tensor


class GradientDescentLearner(SharedWeightsLearner):
    """The reference trainer contract, ``run_train_iter`` and
    ``run_validation_iter``, and the serving half."""

    state_type = GDState
    eval_keys = ("loss", "accuracy", "nonfinite")

    def _task_step(self, theta, bn, x, y, mask=None):
        """``(loss, logits (N, classes), bn_state, grads)`` of one task's
        loss on ``x`` ``(1, N, C, H, W)``, ``y`` ``(1, N)``, threading
        ``bn`` (``None`` skips the running statistics)."""

        def loss_fn(params):
            (logits,), new_bn = self._embed(params, bn, x)
            if mask is None:
                return nll(logits[0], y[0]).mean(), (logits[0], new_bn)
            return masked_cross_entropy(logits[0], y[0], mask), (logits[0], new_bn)

        loss, (logits, new_bn), grads = self._grads(loss_fn, theta)
        if new_bn is not None:
            new_bn = tree_map(lambda a: a[0], new_bn)
        return loss, logits.detach().float(), new_bn, grads

    @torch.no_grad()
    def _run_batch(self, state: GDState, batch, *, training: bool):
        """Each task in turn: ``num_steps`` Adam updates on its support
        loss, then one on its target loss (``gradient_descent.py:155-237``).
        Returns ``(new_state, metrics, target logits (B, Q, classes))``."""
        cfg = self.cfg
        num_steps = (cfg.number_of_training_steps_per_iter if training
                     else cfg.number_of_evaluation_steps_per_iter)
        xs_b, xt_b, ys_b, yt_b = self._decode(batch, training)
        theta, bn, opt = state.theta, state.bn_state, state.opt_state
        t_losses, accs, logits, grad_norms = [], [], [], []
        for t in range(xs_b.shape[0]):
            task = slice(t, t + 1)
            for _ in range(num_steps):
                _, _, bn, grads = self._task_step(theta, bn, xs_b[task], ys_b[task])
                theta, opt = self.tx.step(theta, grads, opt)
            loss, t_logits, bn, grads = self._task_step(
                theta, bn, xt_b[task], yt_b[task]
            )
            theta, opt = self.tx.step(theta, grads, opt)
            t_losses.append(loss)
            accs.append((t_logits.argmax(-1) == yt_b[t]).float().mean())
            logits.append(t_logits)
            grad_norms.append(global_norm(grads))
        t_losses, grad_norms = torch.stack(t_losses), torch.stack(grad_norms)
        new_state = GDState(theta, bn, opt, state.iteration + 1)
        # The sentinel covers every task's target loss and update gradient;
        # it skips only in training, as eval fine-tunes by design.
        nonfinite = nonfinite_flag(t_losses, grad_norms)
        new_state = guard_nonfinite_update(
            training and cfg.skip_nonfinite_updates, nonfinite, new_state, state
        )
        metrics = dict(loss=t_losses[-1], accuracy=accs[-1], nonfinite=nonfinite)
        return new_state, metrics, torch.stack(logits)

    # ------------------------------------------------------------------
    # Serving: the eval fine-tune on one task's support set from the
    # served weights with fresh Adam moments, then the query forward
    # (``gradient_descent.py:279-402``).
    # ------------------------------------------------------------------

    def inference_state(self, state) -> GDInferenceState:
        """The serving state of a ``GDState`` (its injected learning rate),
        or of a bare ``InferenceState`` (the schedule's start)."""
        if isinstance(state, GDInferenceState):
            return state
        if isinstance(state, GDState):
            lr = state.opt_state.learning_rate
        else:
            lr = torch.tensor(self.cfg.meta_learning_rate, dtype=torch.float32,
                              device=state.theta["linear"]["weight"].device)
        return GDInferenceState(state.theta, state.bn_state, lr)

    def load_inference_state(self, filepath: str, device=None):
        """The parameters and BN statistics of a training checkpoint, with
        the fine-tune learning rate that training injected in the epoch its
        ``current_iter`` falls in."""
        loaded, experiment_state = super().load_inference_state(filepath, device)
        epoch = int(
            int(experiment_state.get("current_iter", 0))
            / max(int(self.cfg.total_iter_per_epoch), 1)
        )
        lr = torch.tensor(self._epoch_lr(epoch), dtype=torch.float32,
                          device=loaded.theta["linear"]["weight"].device)
        return GDInferenceState(loaded.theta, loaded.bn_state, lr), experiment_state

    def serve_adapt(self, istate: GDInferenceState, x_support, y_support):
        """One task's fine-tuned parameter tree: ``x_support`` ``(N, C, H,
        W)`` (wire dtype), ``y_support`` ``(N,)``."""
        return self._serve_adapt(istate, x_support, y_support, None)

    def serve_adapt_masked(self, istate: GDInferenceState, x_support, y_support,
                           support_mask):
        """``serve_adapt`` where support rows with ``support_mask == 0`` add
        exactly zero to the loss and its gradient."""
        return self._serve_adapt(istate, x_support, y_support, support_mask)

    @torch.no_grad()
    def _serve_adapt(self, istate, x_support, y_support, support_mask):
        x = decode_images(x_support, self.cfg.wire_codec, self.cfg.dtype)[None]
        y = y_support.long()[None]
        opt = self.tx.init(istate.theta)
        opt = opt._replace(learning_rate=istate.fine_tune_lr.to(torch.float32))
        theta = istate.theta
        for _ in range(self.cfg.number_of_evaluation_steps_per_iter):
            _, _, _, grads = self._task_step(theta, None, x, y, support_mask)
            theta, opt = self.tx.step(theta, grads, opt)
        return theta

    def serve_classify(self, istate: GDInferenceState, adapted, x_query):
        """One task's query logits ``(Q, classes)`` float32 with its
        fine-tuned parameters."""
        return self._embed_task(adapted, x_query)

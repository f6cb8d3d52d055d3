"""Prototypical networks (``howtotrainyourmamlpytorch_tpu/models/protonets.py``).

Each class is the mean of its support embeddings (the prototype; the
backbone's linear head included, as for matching nets), and a query's
logits are its negative squared distances to the prototypes. No inner
loop. Training is episodic: every task's loss on the shared weights at
once, one Adam update on their mean, the running statistics averaged over
the tasks. Eval is pure.

The tasks go through the backbone at once, folded into channels
(``models/backbone.py``), where JAX vmaps a one-task loss; the shared
leaves are ``expand``ed, so their gradient sums over the tasks.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.losses import nll
from ..utils.trees import tree_map
from .common import (
    SharedWeightsLearner,
    global_norm,
    guard_nonfinite_update,
    nonfinite_flag,
)

Tree = Any


class ProtoNetsState(NamedTuple):
    theta: Tree
    bn_state: Tree
    opt_state: Any
    iteration: torch.Tensor


def class_prototypes(support_emb, y_support, num_classes: int, support_mask=None):
    """Per-class mean support embeddings ``(..., num_classes, feat)``, by a
    one-hot contraction; an absent class gets a zero prototype (its count
    clamped to 1). Rows with ``support_mask == 0`` add exactly zero."""
    onehot = F.one_hot(y_support.long(), num_classes).to(support_emb.dtype)
    if support_mask is not None:
        onehot = onehot * support_mask.to(onehot.dtype)[..., None]
    counts = onehot.sum(dim=-2)
    return (onehot.transpose(-1, -2) @ support_emb) / counts.clamp_min(1.0)[..., None]


def squared_distance_logits(query_emb, prototypes):
    """``-|query - prototype|^2``, ``(..., Q, num_classes)``."""
    diff = query_emb[..., :, None, :] - prototypes[..., None, :, :]
    return -(diff ** 2).sum(dim=-1)


def prototype_logits(support_emb, y_support, query_emb, num_classes: int,
                     support_mask=None):
    """The episode head: prototypes, then distance logits."""
    protos = class_prototypes(support_emb, y_support, num_classes, support_mask)
    return squared_distance_logits(query_emb, protos)


class ProtoNetsLearner(SharedWeightsLearner):
    """The reference trainer contract, ``run_train_iter`` and
    ``run_validation_iter``, and the serving half."""

    state_type = ProtoNetsState

    def _batch_loss(self, theta, bn, xs, ys, xt, yt):
        """``(mean loss, (losses (T,), accuracies (T,), logits (T, Q,
        classes), bn_state (T, ...)))`` of the ``T`` tasks at once."""
        (support_emb, target_emb), bn = self._embed(theta, bn, xs, xt)
        logits = prototype_logits(
            support_emb.float(), ys, target_emb.float(), self.cfg.backbone.num_classes
        )
        losses = nll(logits, yt).mean(dim=-1)
        accs = (logits.argmax(-1) == yt).float().mean(dim=-1)
        return losses.mean(), (losses, accs, logits, bn)

    @torch.no_grad()
    def _run_batch(self, state: ProtoNetsState, batch, *, training: bool):
        """One Adam update on the task-mean loss in training; the same
        forward on the given state in eval (``protonets.py:206-254``).
        Returns ``(new_state, metrics, logits (B, Q, classes))``."""
        xs, xt, ys, yt = self._decode(batch, training)
        if training:
            loss, (losses, accs, logits, bns), grads = self._grads(
                lambda p: self._batch_loss(p, state.bn_state, xs, ys, xt, yt),
                state.theta,
            )
            theta, opt = self.tx.step(state.theta, grads, state.opt_state)
            bn = tree_map(lambda s: s.mean(dim=0), bns)
            new_state = ProtoNetsState(theta, bn, opt, state.iteration + 1)
            # Every task's loss and the update's gradient: a finite mean
            # over one non-finite task must not reach theta.
            nonfinite = nonfinite_flag(losses, global_norm(grads))
            new_state = guard_nonfinite_update(
                self.cfg.skip_nonfinite_updates, nonfinite, new_state, state
            )
        else:
            # The running statistics never reach an output: none are kept.
            loss, (losses, accs, logits, _) = self._batch_loss(
                state.theta, None, xs, ys, xt, yt
            )
            nonfinite = nonfinite_flag(losses)
            new_state = state
        metrics = dict(loss=loss, accuracy=accs.mean(), nonfinite=nonfinite)
        return new_state, metrics, logits.detach()

    # ------------------------------------------------------------------
    # Serving: "adapt" is one support forward and the class means; the
    # artifact is the (classes, feat) prototype matrix
    # (``protonets.py:319-373``).
    # ------------------------------------------------------------------

    def serve_adapt(self, istate, x_support, y_support):
        """One task's prototypes: ``x_support`` ``(N, C, H, W)`` (wire
        dtype), ``y_support`` ``(N,)``."""
        return self.serve_adapt_masked(istate, x_support, y_support, None)

    def serve_adapt_masked(self, istate, x_support, y_support, support_mask):
        """``serve_adapt`` where rows with ``support_mask == 0`` add exactly
        zero to every prototype."""
        emb = self._embed_task(istate.theta, x_support)
        return {"prototypes": class_prototypes(
            emb, y_support, self.cfg.backbone.num_classes, support_mask
        )}

    def serve_classify(self, istate, adapted, x_query):
        """One task's logits ``(Q, classes)`` float32 against the adapted
        prototypes."""
        return squared_distance_logits(
            self._embed_task(istate.theta, x_query), adapted["prototypes"]
        )

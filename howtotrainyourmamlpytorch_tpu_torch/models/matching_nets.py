"""The matching-networks baseline
(``howtotrainyourmamlpytorch_tpu/models/matching_nets.py``).

The backbone, linear head included, embeds the support and the target
images; each target attends over the support embeddings by a cosine-style
similarity, and the attention mixes the support labels into class
probabilities. Training takes one Adam update per task, task after task;
eval is pure and discards the running statistics.

``parity_bug=True`` reproduces the reference bug for bug, as the JAX
package does: the element-magnitude divisor, the softmax over the target
axis, support-indexed mixing, and the probabilities fed to the
cross-entropy as logits against the support labels (only meaningful when
support, target and class counts are equal), with the last task's metrics
reported. Without it the loss is the NLL of the target labels and the
metrics are the batch mean.

Training runs each task alone (``T = 1`` on the backbone's task axis), as
the Adam updates make the tasks sequential; eval runs the batch's tasks at
once, each on the weights and statistics it was given.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..utils.trees import tree_map
from .common import (
    SharedWeightsLearner,
    global_norm,
    guard_nonfinite_update,
    nonfinite_flag,
)

Tree = Any


class MatchingNetsState(NamedTuple):
    theta: Tree
    bn_state: Tree
    opt_state: Any
    iteration: torch.Tensor


def cosine_attention_predictions(support_emb, target_emb, y_support,
                                 num_classes: int, support_mask=None):
    """Class probabilities ``(..., Q, num_classes)`` of the targets
    (``matching_nets.py:74-105``): ``sim[q, s] = <target_q, support_s> *
    rsqrt(max(|support_s|^2, eps))``, normalised on the support side only,
    a softmax over the support axis, mixed with the one-hot support labels.
    Support rows with ``support_mask == 0`` get ``-inf`` before the softmax,
    so exactly zero attention. Leading task axes are batched."""
    inv_mag = torch.rsqrt((support_emb ** 2).sum(-1).clamp_min(1e-10))
    sims = torch.einsum("...qf,...sf->...qs", target_emb, support_emb)
    sims = sims * inv_mag[..., None, :]
    if support_mask is not None:
        sims = torch.where(support_mask[..., None, :] > 0, sims, -torch.inf)
    attention = torch.softmax(sims, dim=-1)
    onehot = F.one_hot(y_support.long(), num_classes).to(attention.dtype)
    return attention @ onehot


class MatchingNetsLearner(SharedWeightsLearner):
    """The reference trainer contract, ``run_train_iter`` and
    ``run_validation_iter``, and the serving half."""

    state_type = MatchingNetsState

    def __init__(self, cfg, mesh=None, parity_bug: bool = False):
        super().__init__(cfg, mesh)
        self.parity_bug = parity_bug

    def _predictions(self, support_emb, target_emb, ys):
        """Class probabilities from the two embedding sets (float32)."""
        num_classes = self.cfg.backbone.num_classes
        if self.parity_bug:
            # The reference's DistanceNetwork sums the squared support
            # vector over a size-1 dim, so the divisor is the t-th element's
            # magnitude (conforms only where feature dim == targets); the
            # softmax runs over the target axis and mixes support-indexed
            # one-hots (conforms only where S == T).
            inv_mag = torch.rsqrt((support_emb ** 2).clamp_min(1e-10))
            sims = torch.einsum("...sf,...tf->...st", support_emb, target_emb) * inv_mag
            onehot = F.one_hot(ys.long(), num_classes).to(sims.dtype)
            return torch.softmax(sims, dim=-1) @ onehot
        return cosine_attention_predictions(support_emb, target_emb, ys, num_classes)

    def _task_losses(self, theta, bn, xs, ys, xt, yt):
        """Per-task ``(losses (T,), accuracies (T,), predictions (T, Q,
        classes), bn_state (T, ...))`` of ``T`` tasks on shared ``theta``
        and ``bn``: the support embedding, then the target's."""
        (support_emb, target_emb), bn = self._embed(theta, bn, xs, xt)
        preds = self._predictions(support_emb.float(), target_emb.float(), ys)
        if self.parity_bug:
            log_probs = torch.log_softmax(preds, dim=-1)
            picked = log_probs.gather(-1, ys[..., None]).squeeze(-1)
        else:
            picked = torch.log(preds.gather(-1, yt[..., None]).squeeze(-1) + 1e-12)
        losses = -picked.mean(dim=-1)
        accs = (preds.argmax(-1) == yt).float().mean(dim=-1)
        return losses, accs, preds, bn

    @torch.no_grad()
    def _run_batch(self, state: MatchingNetsState, batch, *, training: bool):
        """Training: per task in turn, the loss, its gradient and one Adam
        update (``matching_nets.py:234-284``). Eval: every task at once on
        the given state. Returns ``(new_state, metrics, predictions (B, Q,
        classes))``."""
        xs_b, xt_b, ys_b, yt_b = self._decode(batch, training)
        if training:
            theta, bn, opt = state.theta, state.bn_state, state.opt_state
            losses, accs, preds, grad_norms = [], [], [], []
            for t in range(xs_b.shape[0]):
                task = slice(t, t + 1)

                def loss_fn(params, task=task, bn=bn):
                    loss, acc, pred, new_bn = self._task_losses(
                        params, bn, xs_b[task], ys_b[task], xt_b[task], yt_b[task]
                    )
                    return loss[0], (acc[0], pred[0], new_bn)

                loss, (acc, pred, bn), grads = self._grads(loss_fn, theta)
                bn = tree_map(lambda a: a[0], bn)
                theta, opt = self.tx.step(theta, grads, opt)
                losses.append(loss)
                accs.append(acc)
                preds.append(pred.detach())
                grad_norms.append(global_norm(grads))
            losses, accs = torch.stack(losses), torch.stack(accs)
            preds, grad_norms = torch.stack(preds), torch.stack(grad_norms)
            new_state = MatchingNetsState(theta, bn, opt, state.iteration + 1)
        else:
            # The running statistics never reach an output: none are kept.
            losses, accs, preds, _ = self._task_losses(
                state.theta, None, xs_b, ys_b, xt_b, yt_b
            )
            grad_norms = torch.zeros_like(losses)
            new_state = state
        nonfinite = nonfinite_flag(losses, grad_norms)
        new_state = guard_nonfinite_update(
            training and self.cfg.skip_nonfinite_updates, nonfinite, new_state, state
        )
        if self.parity_bug:
            metrics = dict(loss=losses[-1], accuracy=accs[-1])
        else:
            metrics = dict(loss=losses.mean(), accuracy=accs.mean())
        return new_state, {**metrics, "nonfinite": nonfinite}, preds

    # ------------------------------------------------------------------
    # Serving: "adapt" embeds the support set; classify attends over it
    # (``matching_nets.py:286-390``).
    # ------------------------------------------------------------------

    @torch.no_grad()
    def serve_adapt(self, istate, x_support, y_support):
        """One task's support embeddings and labels: ``x_support`` ``(N, C,
        H, W)`` (wire dtype), ``y_support`` ``(N,)``."""
        return {"support_emb": self._embed_task(istate.theta, x_support),
                "support_labels": y_support}

    def serve_adapt_masked(self, istate, x_support, y_support, support_mask):
        """``serve_adapt`` with the support mask in the artifact: rows with
        ``support_mask == 0`` drop out of the attention at classify time."""
        if self.parity_bug:
            raise NotImplementedError(
                "a support mask is undefined under parity_bug (the reference "
                "head only conforms when S == T == classes)"
            )
        adapted = self.serve_adapt(istate, x_support, y_support)
        adapted["support_mask"] = support_mask.float()
        return adapted

    @torch.no_grad()
    def serve_classify(self, istate, adapted, x_query):
        """One task's class probabilities ``(Q, classes)`` float32 against
        the adapted support embeddings."""
        target_emb = self._embed_task(istate.theta, x_query)
        mask = adapted.get("support_mask")
        if mask is not None:
            return cosine_attention_predictions(
                adapted["support_emb"], target_emb, adapted["support_labels"],
                self.cfg.backbone.num_classes, mask,
            )
        return self._predictions(
            adapted["support_emb"], target_emb, adapted["support_labels"]
        )

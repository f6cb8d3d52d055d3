"""Classification losses and metrics
(``howtotrainyourmamlpytorch_tpu/ops/losses.py``), float32 softmax."""

from __future__ import annotations

import torch

from .norm import wide


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row negative log-likelihood, shaped like ``labels``."""
    log_probs = torch.log_softmax(wide(logits), dim=-1)
    return -log_probs.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every row."""
    return nll(logits, labels).mean()


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Cross-entropy averaged over the rows where ``mask`` is 1; masked rows
    add exactly zero to the value and its gradient."""
    mask = mask.float()
    return (nll(logits, labels) * mask).sum() / mask.sum()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean argmax accuracy."""
    return (logits.argmax(-1) == labels.long()).float().mean()

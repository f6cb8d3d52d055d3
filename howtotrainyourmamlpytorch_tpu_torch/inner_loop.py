"""Inner-loop rules (``howtotrainyourmamlpytorch_tpu/inner_loop.py``): plain
SGD and MAML++'s LSLR, one learnable learning-rate vector over inner steps
per adapted parameter tensor, ``(num_steps + 1,)`` long (the last row is
allocated, as in the reference, and never read)."""

from __future__ import annotations

import torch

from .utils.trees import Tree, tree_map


def sgd_update(params: Tree, grads: Tree, learning_rate) -> Tree:
    """Differentiable SGD: ``w' = w - lr * g`` per leaf."""
    return tree_map(lambda w, g: w - learning_rate * g, params, grads)


def init_lslr(
    adapt_params: Tree, num_steps: int, init_learning_rate: float,
    dtype=torch.float32,
) -> Tree:
    """Per adapted leaf, ``(num_steps + 1,)`` rates at ``init_learning_rate``,
    on the leaf's device."""
    return tree_map(
        lambda w: torch.full(
            (num_steps + 1,), init_learning_rate, dtype=dtype, device=w.device
        ),
        adapt_params,
    )


def lslr_update(params: Tree, grads: Tree, lslr: Tree, step: int) -> Tree:
    """``w' = w - lslr[step] * g`` per leaf, in float32 (float64 for a
    float64 leaf), cast back to the leaf's dtype (the identity for float32
    leaves)."""
    def update(w, g, lr):
        wide = torch.promote_types(w.dtype, torch.float32)
        return (w.to(wide) - lr[step] * g.to(wide)).to(w.dtype)

    return tree_map(update, params, grads, lslr)

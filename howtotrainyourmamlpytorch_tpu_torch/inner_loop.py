"""The MAML++ LSLR inner-loop rule
(``howtotrainyourmamlpytorch_tpu/inner_loop.py:35-56``): one learnable
learning-rate vector over inner steps per adapted parameter tensor,
``(num_steps + 1,)`` long (the last row is allocated, as in the reference,
and never read)."""

from __future__ import annotations

import torch

from .utils.trees import Tree, tree_map


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
    """``w' = w - lslr[step] * g`` per leaf, in float32, cast back to the
    leaf's dtype (the identity for float32 leaves)."""
    return tree_map(
        lambda w, g, lr: (w.float() - lr[step] * g.float()).to(w.dtype),
        params, grads, lslr,
    )

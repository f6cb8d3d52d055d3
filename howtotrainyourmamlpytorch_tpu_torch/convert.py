"""Moves inference states and fast-weight trees between numpy and the port.

The numpy side is plain nested dicts and tuples of arrays: what
``jax.tree.map(np.asarray, istate)`` gives for a JAX ``MAMLInferenceState``
once its ``BatchNormState``s are ``(running_mean, running_var)`` tuples. No
JAX type is read, so this module needs neither JAX nor the JAX package.
Leaves are carried over one by one; ``None`` stays ``None``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.maml import MAMLInferenceState
from .ops.norm import BatchNormState
from .utils.platform import resolve_device
from .utils.trees import Tree, tree_map


def tree_from_numpy(tree: Tree, device=None) -> Tree:
    """Nested dicts/tuples of numpy arrays -> the same of tensors on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree
    )


def tree_to_numpy(tree: Tree) -> Tree:
    """Tensors -> numpy arrays, keeping dicts, tuples and ``None``; a
    ``BatchNormState`` becomes a plain ``(running_mean, running_var)``."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to_numpy(v) for v in tree)
    if tree is None:
        return None
    return tree.detach().cpu().numpy()


def inference_state_from_numpy(tree, device=None) -> MAMLInferenceState:
    """``(theta, lslr, bn_state)`` of numpy arrays -> ``MAMLInferenceState``
    on ``device``; each ``bn_state`` entry is ``(running_mean,
    running_var)``."""
    theta, lslr, bn_state = (tree_from_numpy(t, device) for t in tuple(tree))
    return MAMLInferenceState(
        theta=theta,
        lslr=lslr,
        bn_state={k: BatchNormState(*v) for k, v in bn_state.items()},
    )


def inference_state_to_numpy(state: MAMLInferenceState) -> tuple:
    """The inverse of :func:`inference_state_from_numpy`."""
    return tuple(tree_to_numpy(t) for t in state)

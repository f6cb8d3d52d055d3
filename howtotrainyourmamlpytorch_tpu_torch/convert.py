"""Moves train states, inference states and fast-weight trees between numpy
and the port.

The numpy side is plain nested dicts and tuples of arrays: what
``jax.tree.map(np.asarray, istate)`` gives for a JAX ``MAMLInferenceState``
once its ``BatchNormState``s are ``(running_mean, running_var)`` tuples. A
train state is ``(theta, lslr, bn_state, (mu, nu, count), iteration)``:
the optimizer reduced to Adam's moments over ``{"theta", "lslr"}``
(``None`` at frozen leaves, where optax keeps a ``MaskedNode``) and its
update count; ANIL's is the same. The state of a shared-weights learner
(``GDState``, ``MatchingNetsState``, ``ProtoNetsState``) is ``(theta,
bn_state, (mu, nu, count), iteration)``, Adam over all of theta. No JAX
type is read, so this module needs neither JAX nor
the JAX package. Leaves are carried over one by one; ``None`` stays
``None``.

The checkpoint archive's leaf order, the JAX state's, is
``utils/checkpoint.train_state_paths``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.common import AdamState
from .models.maml import MAMLInferenceState, TrainState
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


def bn_state_from_numpy(tree, device=None):
    """A BN-state tree of numpy arrays -> the same of ``BatchNormState``s
    on ``device``: dicts at any depth (the VGG's ``conv{i}``, ResNet-12's
    ``res{i}/conv{j}|shortcut``) down to ``(running_mean, running_var)``
    pairs."""
    if isinstance(tree, dict):
        return {k: bn_state_from_numpy(v, device) for k, v in tree.items()}
    return BatchNormState(*tree_from_numpy(tuple(tree), device))


def inference_state_from_numpy(tree, device=None) -> MAMLInferenceState:
    """``(theta, lslr, bn_state)`` of numpy arrays -> ``MAMLInferenceState``
    on ``device``; ``bn_state`` as :func:`bn_state_from_numpy` takes it."""
    theta, lslr, bn_state = tuple(tree)
    return MAMLInferenceState(
        theta=tree_from_numpy(theta, device),
        lslr=tree_from_numpy(lslr, device),
        bn_state=bn_state_from_numpy(bn_state, device),
    )


def inference_state_to_numpy(state: MAMLInferenceState) -> tuple:
    """The inverse of :func:`inference_state_from_numpy`."""
    return tuple(tree_to_numpy(t) for t in state)


def train_state_from_numpy(tree, learning_rate: float, device=None) -> TrainState:
    """``(theta, lslr, bn_state, (mu, nu, count), iteration)`` of numpy
    arrays -> ``TrainState`` on ``device``, the optimizer's learning rate
    at ``learning_rate`` (``run_train_iter`` sets it every step)."""
    theta, lslr, bn_state, moments, iteration = tree
    istate = inference_state_from_numpy((theta, lslr, bn_state), device)
    device = istate.theta["linear"]["weight"].device
    return TrainState(
        *istate,
        opt_state=_adam_from_numpy(moments, learning_rate, device),
        iteration=tree_from_numpy(np.asarray(iteration, np.int32), device),
    )


def train_state_to_numpy(state: TrainState) -> tuple:
    """The inverse of :func:`train_state_from_numpy` (the learning rate is
    not carried)."""
    opt = state.opt_state
    return (
        *inference_state_to_numpy(MAMLInferenceState(*state[:3])),
        tuple(tree_to_numpy(t) for t in (opt.mu, opt.nu, opt.count)),
        tree_to_numpy(state.iteration),
    )


def _adam_from_numpy(moments, learning_rate: float, device) -> AdamState:
    mu, nu, count = moments
    count = tree_from_numpy(np.asarray(count, np.int32), device)
    return AdamState(
        count=count,
        mu=tree_from_numpy(mu, device),
        nu=tree_from_numpy(nu, device),
        learning_rate=torch.tensor(
            learning_rate, dtype=torch.float32, device=count.device
        ),
    )


def shared_state_from_numpy(tree, state_type, learning_rate: float, device=None):
    """``(theta, bn_state, (mu, nu, count), iteration)`` of numpy arrays ->
    ``state_type`` (``GDState``, ``MatchingNetsState`` or
    ``ProtoNetsState``) on ``device``, the learning rate at
    ``learning_rate``."""
    theta, bn_state, moments, iteration = tree
    device = resolve_device(device)
    return state_type(
        theta=tree_from_numpy(theta, device),
        bn_state=bn_state_from_numpy(bn_state, device),
        opt_state=_adam_from_numpy(moments, learning_rate, device),
        iteration=tree_from_numpy(np.asarray(iteration, np.int32), device),
    )


def shared_state_to_numpy(state) -> tuple:
    """The inverse of :func:`shared_state_from_numpy` (the learning rate is
    not carried)."""
    opt = state.opt_state
    return (
        tree_to_numpy(state.theta), tree_to_numpy(state.bn_state),
        tuple(tree_to_numpy(t) for t in (opt.mu, opt.nu, opt.count)),
        tree_to_numpy(state.iteration),
    )

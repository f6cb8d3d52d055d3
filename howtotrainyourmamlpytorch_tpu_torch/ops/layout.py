"""Lane-padded compute layout: conv channel dims zero-padded up to a
lane-friendly width (``howtotrainyourmamlpytorch_tpu/ops/layout.py``).

The JAX package pads the north star's 48-filter stages to 64 so that its
norm, elementwise and pool passes tile the TPU's 128-lane registers. On
Hopper the option is kept for compatibility (a padded checkpoint, config
or experiment runs here as it does there), not for speed.

Why it is exact: a zero conv filter row with a zero bias gives an all-zero
channel; batch norm of it is ``(0 - 0) * rsqrt(0 + eps) * gamma + beta =
beta = 0``; LeakyReLU and max pool keep 0; the next conv's zero weight
columns ignore it; and the head slices the features back to the real
channels. Every padded leaf's gradient is then exactly zero, so Adam, the
LSLR update and the inner loop keep the padding at zero.

Archives never hold padding: ``strip_tree`` cuts a padded state back to the
unpadded template's shapes before a save, and ``pad_tree`` embeds a
restored unpadded state in a padded template, whose padding lanes hold the
initial values (zero weights and moments, unit gamma and running
variance), after a load.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.trees import Tree, tree_leaves, tree_map

#: A channel axis that is a multiple of one of these widths packs the TPU's
#: (sublane, 128-lane) tiles without waste; at or above one full lane the
#: width rounds up to a lane multiple.
LANE_WIDTH = 128
SUBLANE_WIDTHS = (8, 16, 32, 64, 128)


def lane_padded_width(channels: int, lane: int = LANE_WIDTH) -> int:
    """The smallest lane-friendly width >= ``channels`` (48 -> 64, 64 ->
    64, 160 -> 256): below one lane the next power-of-two sublane width,
    at or above it the next multiple of ``lane``."""
    if channels <= 0:
        raise ValueError(f"channels must be positive, got {channels}")
    if channels >= lane:
        return -(-channels // lane) * lane
    return next(w for w in SUBLANE_WIDTHS if channels <= w)


def zero_pad_to(arr: torch.Tensor, target_shape) -> torch.Tensor:
    """``arr`` zero-padded at the end of each axis up to ``target_shape``
    (itself when the shapes already match)."""
    target_shape = tuple(target_shape)
    if tuple(arr.shape) == target_shape:
        return arr
    if arr.dim() != len(target_shape) or any(
        t < s for s, t in zip(arr.shape, target_shape)
    ):
        raise ValueError(
            f"cannot zero-pad shape {tuple(arr.shape)} to {target_shape}"
        )
    pads = []
    for s, t in zip(reversed(arr.shape), reversed(target_shape)):
        pads += [0, t - s]
    return F.pad(arr, pads)


def _corner(shape) -> tuple:
    return tuple(slice(0, s) for s in shape)


def strip_tree(padded: Tree, unpadded_template: Tree) -> Tree:
    """A padded state in the unpadded layout: each leaf sliced to the
    template leaf's shape (a view; the leaf itself where the shapes
    agree). The structures must match: padding changes shapes only."""
    def strip(leaf, tmpl):
        shape = tuple(tmpl.shape)
        if tuple(leaf.shape) == shape:
            return leaf
        if leaf.dim() != len(shape) or any(
            s < t for s, t in zip(leaf.shape, shape)
        ):
            raise ValueError(
                f"cannot strip leaf of shape {tuple(leaf.shape)} to {shape}"
            )
        return leaf[_corner(shape)]

    return tree_map(strip, padded, unpadded_template)


def pad_tree(unpadded: Tree, padded_template: Tree) -> Tree:
    """An unpadded state in the padded layout: each leaf written into a
    copy of the matching ``padded_template`` leaf (on its device and in its
    dtype), whose padding lanes keep their initial values."""
    def pad(leaf, tmpl):
        if tuple(leaf.shape) == tuple(tmpl.shape):
            return leaf.to(tmpl.device)
        if leaf.dim() != tmpl.dim() or any(
            s > t for s, t in zip(leaf.shape, tmpl.shape)
        ):
            raise ValueError(
                f"cannot pad leaf of shape {tuple(leaf.shape)} into "
                f"{tuple(tmpl.shape)}"
            )
        out = tmpl.clone()
        out[_corner(leaf.shape)] = leaf.to(device=tmpl.device, dtype=tmpl.dtype)
        return out

    return tree_map(pad, unpadded, padded_template)


def trees_same_shapes(a: Tree, b: Tree) -> bool:
    """Whether every pair of corresponding leaves has the same shape (the
    padding changes nothing, as at the 64-filter flagship)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        tuple(x.shape) == tuple(y.shape) for x, y in zip(la, lb)
    )

"""Dtype casts and the uint8 image wire format
(``howtotrainyourmamlpytorch_tpu/models/common.py:39-57,130-204``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.trees import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_floats(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype``; the identity (no
    copy) for float32."""
    if dtype == torch.float32:
        return tree
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


class WireCodec(NamedTuple):
    """uint8 image wire format: ``wire = rint(x * scale)``, exact for images
    whose pixels are ``k / scale``, k in [0, 255] (Omniglot: scale 1, pixels
    0/1). ``mean``/``std`` (per channel) move the dataset normalization
    after the decode."""

    scale: float = 1.0
    mean: tuple | None = None
    std: tuple | None = None


def encode_images(x: np.ndarray, codec: WireCodec) -> np.ndarray:
    """float32 host images -> uint8 wire, clipped to [0, 255] first so an
    out-of-range value cannot wrap."""
    x = np.asarray(x)
    if codec.scale != 1.0:
        scratch = np.multiply(x, np.float32(codec.scale), dtype=np.float32)
        np.rint(scratch, out=scratch)
    else:
        scratch = np.rint(np.asarray(x, np.float32))
    np.clip(scratch, 0.0, 255.0, out=scratch)
    return scratch.astype(np.uint8)


def decode_images(x: torch.Tensor, codec: WireCodec | None, dtype) -> torch.Tensor:
    """uint8 wire (or float images when ``codec`` is None) -> compute-dtype
    images: descale, then normalize, as the host pipeline orders it."""
    if codec is None:
        return x.to(dtype)
    x = x.float()
    if codec.scale != 1.0:
        x = x / codec.scale
    if codec.mean is not None:
        shape = (-1, 1, 1)
        mean = torch.tensor(codec.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(codec.std, dtype=torch.float32, device=x.device)
        x = (x - mean.reshape(shape)) / std.reshape(shape)
    return x.to(dtype)

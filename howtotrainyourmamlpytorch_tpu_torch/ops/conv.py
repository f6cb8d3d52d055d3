"""2D convolution, NCHW/OIHW (``howtotrainyourmamlpytorch_tpu/ops/conv.py``;
the JAX package's NHWC layout switch is a TPU experiment and is not
ported). cuDNN on the card, with TF32 off and deterministic algorithms on
the serve path (``utils/platform.set_serve_numerics``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """``(N, C, H, W)`` x ``(O, C/groups, kH, kW)`` -> ``(N, O, H', W')``,
    symmetric integer padding. Weights are cast to the input dtype, as the
    JAX op does."""
    out = F.conv2d(
        x, weight.to(x.dtype), None, stride=stride, padding=padding,
        dilation=dilation, groups=groups,
    )
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out

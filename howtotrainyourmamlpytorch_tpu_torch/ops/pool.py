"""2x2 max pooling and average pooling
(``howtotrainyourmamlpytorch_tpu/ops/pool.py``).

VALID windows, floor mode: an odd trailing row or column is dropped. On a
tie inside a window the gradient goes to the first maximum in row-major
order, as ``lax.reduce_window``'s select-and-scatter does; the tests pin
this on binary images, where ties are the common case.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding=0, ceil_mode=False)


def avg_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Average pooling over ``(N, C, H, W)``, non-overlapping VALID windows
    (floor mode). Differentiable to any order: autograd differentiates its
    backward again (the MAML outer gradient over the inner one)."""
    return F.avg_pool2d(x, window, window, padding=0, ceil_mode=False)

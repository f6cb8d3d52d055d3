"""2x2 max pooling (``howtotrainyourmamlpytorch_tpu/ops/pool.py:14-23``).

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

"""Dense layer ``x @ weight.T + bias``
(``howtotrainyourmamlpytorch_tpu/ops/linear.py``)."""

from __future__ import annotations

import torch


def linear(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """``x``: ``(..., in)``; ``weight``: ``(..., out, in)``; ``bias``:
    ``(..., out)``. Leading axes of ``weight``/``bias`` batch with ``x``'s
    (one head per task: ``x`` ``(T, N, in)``, ``weight`` ``(T, out, in)``)."""
    out = torch.matmul(x, weight.to(x.dtype).transpose(-1, -2))
    if bias is not None:
        out = out + bias.to(out.dtype).unsqueeze(-2)
    return out

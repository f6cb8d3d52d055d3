"""Xavier-uniform init over torch-layout shapes
(``howtotrainyourmamlpytorch_tpu/ops/initializers.py``). The numbers differ
from ``jax.random``'s for the same seed; parity tests copy weights across."""

from __future__ import annotations

import math

import torch


def _fans(shape: tuple[int, ...]) -> tuple[int, int]:
    if len(shape) == 2:  # (out, in) — linear
        fan_out, fan_in = shape
    else:  # (out, in, kh, kw) — conv
        receptive = math.prod(shape[2:])
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


def xavier_uniform(
    generator: torch.Generator, shape: tuple[int, ...], dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Glorot/Xavier uniform with gain 1, drawn from ``generator``."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (2 * limit) - limit

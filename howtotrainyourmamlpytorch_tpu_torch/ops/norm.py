"""Batch normalization on batch statistics with explicit (per-step) running
state (``howtotrainyourmamlpytorch_tpu/ops/norm.py:34-122``), and layer
normalization (``:125-142``).

As in the reference, outputs are always normalized with the current batch's
statistics; the running statistics are a side output that never influences
any result. With per-step statistics (MAML++), gamma/beta and the running
arrays carry a leading ``(num_steps,)`` axis indexed by the inner step,
clamped to the last row. The running update follows torch: biased variance
normalizes, unbiased variance feeds ``new = (1 - m) * old + m * batch``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BatchNormState(NamedTuple):
    """Running statistics: ``(features,)`` or per-step ``(num_steps,
    features)`` arrays."""

    running_mean: torch.Tensor
    running_var: torch.Tensor


def init_batch_norm_state(
    num_features: int, num_steps: int | None = None, dtype=torch.float32,
    device=None,
) -> BatchNormState:
    """Zero mean, unit variance."""
    shape = (num_features,) if num_steps is None else (num_steps, num_features)
    return BatchNormState(
        running_mean=torch.zeros(shape, dtype=dtype, device=device),
        running_var=torch.ones(shape, dtype=dtype, device=device),
    )


def step_row(a: torch.Tensor, step: int) -> torch.Tensor:
    """Row ``min(step, S - 1)`` of a per-step ``(S, C)`` array; ``(C,)``
    arrays pass through."""
    return a[min(int(step), a.shape[0] - 1)] if a.dim() == 2 else a


def update_running(
    state: BatchNormState, step: int, mean, var, n: int, momentum: float
) -> BatchNormState:
    """The running-stat update from the batch's ``mean`` and biased ``var``
    over ``n`` elements per channel (row ``min(step, S - 1)`` when
    per-step)."""
    var_unbiased = var * (n / max(n - 1, 1))
    m = momentum

    def mix(old, new):
        if old.dim() == 2:
            s = min(int(step), old.shape[0] - 1)
            out = old.clone()
            out[s] = (1.0 - m) * old[s] + m * new
            return out
        return (1.0 - m) * old + m * new

    return BatchNormState(
        running_mean=mix(state.running_mean, mean),
        running_var=mix(state.running_var, var_unbiased),
    )


def batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    state: BatchNormState | None,
    step: int,
    *,
    momentum: float = 0.1,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, BatchNormState | None]:
    """Batch norm over ``(N, C, H, W)`` with float32 statistics.

    ``gamma``/``beta``: ``(C,)`` or per-step ``(S, C)``. ``state``: running
    stats, or ``None`` to skip their update (the serve path, whose outputs
    they never reach). Returns ``(normalized, new_state)``."""
    in_dtype = x.dtype
    x = x.float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    gamma, beta = step_row(gamma, step), step_row(beta, step)
    b = lambda a: a[None, :, None, None]  # noqa: E731
    out = (x - b(mean)) * b(torch.rsqrt(var + eps))
    out = (out * b(gamma) + b(beta)).to(in_dtype)
    if state is None:
        return out, None
    return out, update_running(
        state, step, mean.detach(), var.detach(), n, momentum
    )


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
    normalized_ndim: int | None = None,
) -> torch.Tensor:
    """Layer norm with float32 statistics over the trailing
    ``normalized_ndim`` dims of ``x`` (``weight.ndim`` by default, as in
    JAX), then ``* weight + bias``, both broadcast against ``x``'s trailing
    dims. A leading task axis on ``weight``/``bias`` takes
    ``normalized_ndim`` explicitly, so that no statistic spans tasks."""
    ndim = weight.dim() if normalized_ndim is None else normalized_ndim
    dims = tuple(range(x.dim() - ndim, x.dim()))
    in_dtype = x.dtype
    x = x.float()
    var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(in_dtype)

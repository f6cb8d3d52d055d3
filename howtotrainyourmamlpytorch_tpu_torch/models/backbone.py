"""The 4-stage VGG conv backbone with an explicit task axis
(``howtotrainyourmamlpytorch_tpu/models/backbone.py``).

Each stage is 3x3 conv -> per-step batch norm on batch statistics ->
LeakyReLU(0.01) -> 2x2 max pool; a linear head follows. The parameter tree
is the JAX package's::

    params = {
      "conv0": {"conv": {"weight": (F, C, k, k), "bias": (F,)},
                "norm": {"gamma": (S, F) | (F,), "beta": (S, F) | (F,)}},
      ...,
      "linear": {"weight": (num_classes, feat), "bias": (num_classes,)},
    }

Task axis. JAX serves many tasks by ``jax.vmap`` of a one-task function.
Here ``apply`` takes the task axis itself: images are ``(T, N, C, H, W)``
and every parameter and running-stat leaf carries a leading ``T`` axis
(shared leaves are ``expand``ed, which copies nothing). Tasks are folded
into channels: the activation is ``(N, T·C, H, W)``, the per-task convs are
one grouped convolution (``groups=T``), and per-task batch norm over
``(N, H, W)`` is per-channel batch norm of the folded tensor, so the norm
kernels never mix tasks. The head is one batched matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.conv import conv2d
from ..ops.fused_norm import (
    fused_bn_leaky_relu,
    fused_bn_leaky_relu_ho,
    fused_bn_leaky_relu_pool,
)
from ..ops.initializers import xavier_uniform
from ..ops.linear import linear
from ..ops.norm import (
    BatchNormState,
    batch_norm,
    init_batch_norm_state,
    step_row,
    update_running,
)
from ..ops.pool import max_pool2d
from ..utils.trees import tree_map_with_path

Params = dict[str, Any]

SLOPE = 0.01


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Architecture hyperparameters, field for field the JAX package's. The
    port's VGG takes the values the flagship runs: ``vgg``, ``batch_norm``,
    ``conv_norm``, max pooling, no lane padding; the rest raise
    ``NotImplementedError`` naming their slice."""

    architecture: str = "vgg"
    num_stages: int = 4
    num_filters: int = 64
    resnet_widths: tuple[int, int, int, int] | None = None
    kernel_size: int = 3
    conv_padding: int = 1
    max_pooling: bool = True
    norm_layer: str = "batch_norm"
    block_order: str = "conv_norm"
    per_step_bn_statistics: bool = False
    num_steps: int = 5
    enable_inner_loop_optimizable_bn_params: bool = False
    num_classes: int = 5
    image_channels: int = 1
    image_height: int = 28
    image_width: int = 28
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    # Fused norm + LeakyReLU: in the port, the Hopper kernels of
    # ops/fused_norm.py (the name is the JAX package's config key).
    use_pallas_fused_norm: bool = False
    fused_norm_train: bool = False
    fused_norm_pool: bool = False
    lane_pad_channels: bool = False

    @property
    def conv_stride(self) -> int:
        return 1 if self.max_pooling else 2

    def stage_spatial_shapes(self) -> list[tuple[int, int]]:
        """Post-stage (H, W): floor-division conv, VALID 2x2 pooling."""
        h, w = self.image_height, self.image_width
        shapes = []
        for _ in range(self.num_stages):
            h = (h + 2 * self.conv_padding - self.kernel_size) // self.conv_stride + 1
            w = (w + 2 * self.conv_padding - self.kernel_size) // self.conv_stride + 1
            if self.max_pooling:
                h, w = h // 2, w // 2
            shapes.append((h, w))
        return shapes

    @property
    def feature_dim(self) -> int:
        h, w = self.stage_spatial_shapes()[-1]
        return self.num_filters * h * w

    @property
    def per_step_affine(self) -> bool:
        """Whether gamma/beta carry the per-step axis."""
        return (
            self.per_step_bn_statistics
            and self.norm_layer == "batch_norm"
            and not self.enable_inner_loop_optimizable_bn_params
        )


_UNPORTED = (
    ("norm_layer", "batch_norm", "layer_norm is ROADMAP item A1"),
    ("block_order", "conv_norm", "norm_conv is ROADMAP item A3"),
    ("max_pooling", True, "stride-2 convs with average pooling are ROADMAP item A3"),
    ("lane_pad_channels", False, "lane padding is ROADMAP item A8"),
)


def leaky_relu(x: torch.Tensor, slope: float = SLOPE) -> torch.Tensor:
    """Positive branch at ``x >= 0``, gradient included (``jax.nn.leaky_relu``;
    ``F.leaky_relu``'s backward takes the slope branch at 0)."""
    return torch.where(x >= 0, x, slope * x)


def _fold(a: torch.Tensor) -> torch.Tensor:
    """Per-task ``(T, S, F)`` -> ``(S, T·F)``; ``(T, F)`` -> ``(T·F,)``."""
    if a.dim() == 3:
        return a.transpose(0, 1).reshape(a.shape[1], -1)
    return a.reshape(-1)


def _unfold(a: torch.Tensor, tasks: int) -> torch.Tensor:
    """Inverse of :func:`_fold`."""
    if a.dim() == 2:
        return a.reshape(a.shape[0], tasks, -1).transpose(0, 1)
    return a.reshape(tasks, -1)


class VGGBackbone:
    """``init`` makes the trees, ``apply`` runs them."""

    def __init__(self, cfg: BackboneConfig):
        for field, supported, why in _UNPORTED:
            if getattr(cfg, field) != supported:
                raise NotImplementedError(
                    f"{field}={getattr(cfg, field)!r} is not ported yet: {why}"
                )
        self.cfg = cfg

    def init(
        self, generator: torch.Generator, dtype=torch.float32, device=None
    ) -> tuple[Params, Params]:
        """``(params, bn_state)``: Xavier-uniform weights, zero biases,
        gamma ones, beta zeros, drawn from ``generator`` in stage order."""
        cfg = self.cfg
        params: Params = {}
        bn_state: Params = {}
        in_ch = cfg.image_channels
        k = cfg.kernel_size
        f = cfg.num_filters
        affine = (cfg.num_steps, f) if cfg.per_step_affine else (f,)
        for i in range(cfg.num_stages):
            params[f"conv{i}"] = {
                "conv": {
                    "weight": xavier_uniform(
                        generator, (f, in_ch, k, k), dtype, device
                    ),
                    "bias": torch.zeros(f, dtype=dtype, device=device),
                },
                "norm": {
                    "gamma": torch.ones(affine, dtype=dtype, device=device),
                    "beta": torch.zeros(affine, dtype=dtype, device=device),
                },
            }
            bn_state[f"conv{i}"] = init_batch_norm_state(
                f, cfg.num_steps if cfg.per_step_bn_statistics else None,
                dtype, device,
            )
            in_ch = f
        params["linear"] = {
            "weight": xavier_uniform(
                generator, (cfg.num_classes, cfg.feature_dim), dtype, device
            ),
            "bias": torch.zeros(cfg.num_classes, dtype=dtype, device=device),
        }
        return params, bn_state

    def apply(
        self,
        params: Params,
        bn_state: Params | None,
        x: torch.Tensor,
        step: int,
        *,
        fused: "bool | str | None" = None,
    ) -> tuple[torch.Tensor, Params | None]:
        """Forward pass of ``T`` tasks at once.

        Args:
          params: parameter tree, every leaf with a leading ``T`` axis.
          bn_state: running stats with a leading ``T`` axis on every array,
            or ``None`` to skip their update (they never reach an output).
          x: images ``(T, N, C, H, W)``.
          step: inner-loop step; selects per-step BN rows, clamped.
          fused: ``None`` (config default), ``"off"``/``False``,
            ``"vjp"``/``True`` (the one-level kernel pair) or ``"jvp"`` (the
            any-order op, for the train path).

        Returns:
          ``(logits (T, N, num_classes), new_bn_state or None)``.
        """
        cfg = self.cfg
        variant = resolve_fused_variant(cfg, fused)
        tasks, n = x.shape[:2]
        out = x.transpose(0, 1).reshape(n, tasks * x.shape[2], *x.shape[3:])
        new_bn_state: Params | None = None if bn_state is None else {}
        for i in range(cfg.num_stages):
            stage = params[f"conv{i}"]
            weight = stage["conv"]["weight"]
            out = conv2d(
                out,
                weight.reshape(-1, *weight.shape[2:]),
                stage["conv"]["bias"].reshape(-1),
                stride=cfg.conv_stride,
                padding=cfg.conv_padding,
                groups=tasks,
            )
            gamma = _fold(stage["norm"]["gamma"])
            beta = _fold(stage["norm"]["beta"])
            state = None
            if bn_state is not None:
                state = BatchNormState(*(_fold(a) for a in bn_state[f"conv{i}"]))
            # Fuse the 2x2 max pool into the norm where it is exact: floor-mode
            # pooling drops an odd trailing row or column that the
            # statistics still cover (JAX backbone.py:369-386). The conv's
            # output is the pre-pool shape.
            pool = (
                cfg.fused_norm_pool and variant != "off"
                and out.shape[2] % 2 == 0 and out.shape[3] % 2 == 0
            )
            if variant != "off":
                out, state = fused_norm_act(
                    out, gamma, beta, state, step,
                    eps=cfg.bn_eps, momentum=cfg.bn_momentum,
                    variant=variant, pool=pool,
                )
            else:
                out, state = batch_norm(
                    out, gamma, beta, state, step,
                    momentum=cfg.bn_momentum, eps=cfg.bn_eps,
                )
                out = leaky_relu(out)
            if new_bn_state is not None:
                new_bn_state[f"conv{i}"] = BatchNormState(
                    *(_unfold(a, tasks) for a in state)
                )
            if not pool:
                out = max_pool2d(out, 2, 2)
        features = out.reshape(n, tasks, -1).transpose(0, 1)
        logits = linear(
            features, params["linear"]["weight"], params["linear"]["bias"]
        )
        return logits, new_bn_state

    def inner_loop_mask(self, params: Params) -> Params:
        """True on the leaves the inner loop adapts: everything but the
        norm parameters, unless ``enable_inner_loop_optimizable_bn_params``."""
        enable_bn = self.cfg.enable_inner_loop_optimizable_bn_params
        return tree_map_with_path(
            lambda path, _: enable_bn or "norm" not in path, params
        )


def resolve_fused_variant(cfg: BackboneConfig, fused) -> str:
    """``apply(fused=...)`` -> ``"off"``, ``"vjp"`` or ``"jvp"``; ``None``
    reads the config (``use_pallas_fused_norm`` -> ``"vjp"``, else
    ``fused_norm_train`` -> ``"jvp"``)."""
    if fused is None:
        if cfg.use_pallas_fused_norm:
            return "vjp"
        return "jvp" if cfg.fused_norm_train else "off"
    if fused is False:
        return "off"
    if fused is True:
        return "vjp"
    if fused in ("off", "vjp", "jvp"):
        return fused
    raise ValueError(f"unknown fused variant {fused!r}")


def fused_norm_act(x, gamma, beta, state, step, *, eps, momentum, slope=SLOPE,
                   variant="vjp", pool=False):
    """Fused norm + LeakyReLU [+ 2x2 max pool] on the per-step row of
    ``gamma``/``beta``, plus the running-stat update of
    ``ops/norm.batch_norm`` when ``state`` is given.

    ``variant``: ``"vjp"``, the one-level kernel pair; ``"jvp"``, the
    any-order op. The pooled op is any-order and serves both, as in JAX
    (``backbone.py:457-510``)."""
    if pool:
        op = fused_bn_leaky_relu_pool
    elif variant == "jvp":
        op = fused_bn_leaky_relu_ho
    else:
        op = fused_bn_leaky_relu
    out, mean, var = op(
        x, step_row(gamma, step).float(), step_row(beta, step).float(),
        eps, slope,
    )
    if state is None:
        return out, None
    # The running statistics never reach an output: no graph for them.
    n = x.shape[0] * x.shape[2] * x.shape[3]
    return out, update_running(
        state, step, mean.detach(), var.detach(), n, momentum
    )


def build_backbone(cfg: BackboneConfig) -> VGGBackbone:
    if cfg.architecture == "vgg":
        return VGGBackbone(cfg)
    if cfg.architecture == "resnet12":
        raise NotImplementedError("ResNet-12 is ROADMAP item A9 (learner zoo)")
    raise ValueError(f"unknown backbone architecture {cfg.architecture!r}")

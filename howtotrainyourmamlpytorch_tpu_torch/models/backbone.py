"""The 4-stage VGG conv backbone with an explicit task axis
(``howtotrainyourmamlpytorch_tpu/models/backbone.py``), and the pieces the
ResNet-12 backbone (``models/resnet.py``) shares with it.

Each stage is 3x3 conv -> per-step batch norm on batch statistics ->
LeakyReLU(0.01) -> 2x2 max pool; a linear head follows. The options of
the JAX backbone are all taken: ``layer_norm`` over each task's ``(C, H,
W)``, ``norm_conv`` (norm of the stage input, then conv and LeakyReLU,
never fused), without max pooling, stride-2 convs and a global average
pool, and lane padding (``ops/layout.py``: conv channel dims padded with
structurally zero filters, the head slicing the real features back). The
parameter tree is the JAX package's::

    params = {
      "conv0": {"conv": {"weight": (F, C, k, k), "bias": (F,)},
                "norm": {"gamma": (S, F) | (F,), "beta": (S, F) | (F,)}},
      ...,
      "linear": {"weight": (num_classes, feat), "bias": (num_classes,)},
    }

with ``layer_norm``, ``"norm": {"weight": (C, h, w), "bias": (C, h, w)}``
and no running state.

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
from ..ops.layout import lane_padded_width, zero_pad_to
from ..ops.linear import linear
from ..ops.norm import (
    BatchNormState,
    batch_norm,
    init_batch_norm_state,
    layer_norm,
    step_row,
    update_running,
)
from ..ops.pool import avg_pool2d, max_pool2d
from ..utils.trees import tree_map_with_path

Params = dict[str, Any]

SLOPE = 0.01


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Architecture hyperparameters, field for field the JAX package's."""

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
    # Conv channel dims zero-padded to the lane-friendly width (48 -> 64;
    # ops/layout.py); logits and gradients are the unpadded program's and
    # checkpoints hold no padding. Batch norm after the conv only.
    lane_pad_channels: bool = False

    @property
    def conv_channels(self) -> int:
        """The compute layout's conv width: ``num_filters``, lane-padded
        with ``lane_pad_channels`` (the head keeps the real width)."""
        if self.lane_pad_channels:
            return lane_padded_width(self.num_filters)
        return self.num_filters

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
        """Features entering the head: ResNet-12's last stage width after
        its global average pool; the VGG's flattened last stage, or its
        ``num_filters`` after the global average pool without max
        pooling."""
        if self.architecture == "resnet12":
            if self.resnet_widths is not None:
                return self.resnet_widths[-1]
            return 8 * self.num_filters
        if self.max_pooling:
            h, w = self.stage_spatial_shapes()[-1]
            return self.num_filters * h * w
        return self.num_filters

    @property
    def per_step_affine(self) -> bool:
        """Whether gamma/beta carry the per-step axis."""
        return (
            self.per_step_bn_statistics
            and self.norm_layer == "batch_norm"
            and not self.enable_inner_loop_optimizable_bn_params
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
        if cfg.block_order not in ("conv_norm", "norm_conv"):
            raise ValueError(f"unknown block_order {cfg.block_order!r}")
        if cfg.norm_layer not in ("batch_norm", "layer_norm"):
            raise ValueError(f"unknown norm_layer {cfg.norm_layer!r}")
        if cfg.lane_pad_channels and (
            cfg.block_order != "conv_norm" or cfg.norm_layer != "batch_norm"
        ):
            # The zero-channel argument holds for per-channel batch norm
            # after the conv; a layer norm mixes channels, and norm_conv
            # normalizes the stage input (JAX backbone.py:189-197).
            raise ValueError(
                "lane_pad_channels requires norm_layer='batch_norm' and "
                "block_order='conv_norm' (the zero-channel equivalence "
                f"argument; got {cfg.norm_layer!r}/{cfg.block_order!r})"
            )
        self.cfg = cfg

    def _norm_spatial_shape(self, stage: int) -> tuple[int, int]:
        """(H, W) the norm of ``stage`` sees: the conv output for
        ``conv_norm``, the stage input for ``norm_conv``."""
        cfg = self.cfg
        h, w = cfg.image_height, cfg.image_width
        if cfg.block_order == "norm_conv":
            return (h, w) if stage == 0 else cfg.stage_spatial_shapes()[stage - 1]
        if stage:
            h, w = cfg.stage_spatial_shapes()[stage - 1]
        conv = lambda a: (a + 2 * cfg.conv_padding - cfg.kernel_size) // cfg.conv_stride + 1  # noqa: E731
        return conv(h), conv(w)

    def init(
        self, generator: torch.Generator, dtype=torch.float32, device=None
    ) -> tuple[Params, Params]:
        """``(params, bn_state)``: Xavier-uniform weights, zero biases,
        gamma (or the layer norm's weight) ones, beta (bias) zeros, drawn
        from ``generator`` in stage order. ``norm_conv`` normalizes the
        stage input, so its norm follows the input channels. With lane
        padding the real widths drive the draws and the padded widths the
        shapes, so a padded and an unpadded backbone agree on the real
        slice."""
        cfg = self.cfg
        params: Params = {}
        bn_state: Params = {}
        in_ch = in_pad = cfg.image_channels
        k = cfg.kernel_size
        f, f_pad = cfg.num_filters, cfg.conv_channels
        for i in range(cfg.num_stages):
            norm_ch = in_ch if cfg.block_order == "norm_conv" else f_pad
            if cfg.norm_layer == "layer_norm":
                shape = (norm_ch, *self._norm_spatial_shape(i))
                norm = {
                    "weight": torch.ones(shape, dtype=dtype, device=device),
                    "bias": torch.zeros(shape, dtype=dtype, device=device),
                }
            else:
                affine = (cfg.num_steps, norm_ch) if cfg.per_step_affine else (norm_ch,)
                norm = {
                    "gamma": torch.ones(affine, dtype=dtype, device=device),
                    "beta": torch.zeros(affine, dtype=dtype, device=device),
                }
                bn_state[f"conv{i}"] = init_batch_norm_state(
                    norm_ch, cfg.num_steps if cfg.per_step_bn_statistics else None,
                    dtype, device,
                )
            params[f"conv{i}"] = {
                "conv": {
                    "weight": zero_pad_to(
                        xavier_uniform(generator, (f, in_ch, k, k), dtype, device),
                        (f_pad, in_pad, k, k),
                    ),
                    "bias": torch.zeros(f_pad, dtype=dtype, device=device),
                },
                "norm": norm,
            }
            in_ch, in_pad = f, f_pad
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
            any-order op, for the train path). ``norm_conv`` has no
            norm-activation pair and runs ``"off"``.

        Returns:
          ``(logits (T, N, num_classes), new_bn_state or None)``.
        """
        cfg = self.cfg
        variant = resolve_fused_variant(cfg, fused)
        if cfg.block_order != "conv_norm":
            variant = "off"
        tasks, n = x.shape[:2]
        out = x.transpose(0, 1).reshape(n, tasks * x.shape[2], *x.shape[3:])
        new_bn_state: Params | None = None if bn_state is None else {}

        def conv(out, stage):
            weight = stage["conv"]["weight"]
            return conv2d(
                out,
                weight.reshape(-1, *weight.shape[2:]),
                stage["conv"]["bias"].reshape(-1),
                stride=cfg.conv_stride,
                padding=cfg.conv_padding,
                groups=tasks,
            )

        def norm(out, stage, i, activate, pool=False):
            if cfg.norm_layer == "layer_norm":
                out = task_layer_norm(out, stage["norm"], tasks, cfg.bn_eps)
                return leaky_relu(out) if activate else out
            state = None if bn_state is None else bn_state[f"conv{i}"]
            out, state = norm_act(
                out, stage["norm"], state, step, cfg, tasks,
                variant=variant, activate=activate, pool=pool,
            )
            if new_bn_state is not None:
                new_bn_state[f"conv{i}"] = state
            return out

        for i in range(cfg.num_stages):
            stage = params[f"conv{i}"]
            pool = False
            if cfg.block_order == "norm_conv":
                out = leaky_relu(conv(norm(out, stage, i, activate=False), stage))
            else:
                out = conv(out, stage)
                # Fuse the 2x2 max pool into the norm where it is exact:
                # floor-mode pooling drops an odd trailing row or column
                # that the statistics still cover (JAX backbone.py:369-386).
                # The conv's output is the pre-pool shape.
                pool = (
                    cfg.fused_norm_pool and cfg.max_pooling and variant != "off"
                    and cfg.norm_layer == "batch_norm"
                    and out.shape[2] % 2 == 0 and out.shape[3] % 2 == 0
                )
                out = norm(out, stage, i, activate=True, pool=pool)
            if cfg.max_pooling and not pool:
                out = max_pool2d(out, 2, 2)
        if not cfg.max_pooling:
            out = avg_pool2d(out, out.shape[2])
        features = real_features(out, tasks, cfg.num_filters)
        logits = linear(
            features, params["linear"]["weight"], params["linear"]["bias"]
        )
        return logits, new_bn_state

    def inner_loop_mask(self, params: Params) -> Params:
        """True on the leaves the inner loop adapts: everything but the
        norm parameters, unless ``enable_inner_loop_optimizable_bn_params``."""
        return norm_excluded_mask(self.cfg, params)


def real_features(out: torch.Tensor, tasks: int, channels: int) -> torch.Tensor:
    """``(T, N, features)`` of the folded ``(N, T·C', ...)`` activation, the
    lane padding (channels past ``channels`` of each task) sliced off: the
    padded channels are structurally zero, so the features and their
    gradients are the unpadded program's."""
    n = out.shape[0]
    out = out.reshape(n, tasks, -1, *out.shape[2:])
    if out.shape[2] != channels:
        out = out[:, :, :channels]
    return out.reshape(n, tasks, -1).transpose(0, 1)


def norm_excluded_mask(cfg: BackboneConfig, params: Params) -> Params:
    """The inner-loop mask of both backbones (the reference's
    ``get_inner_loop_parameter_dict``): every leaf but those under a
    ``norm`` key, unless ``enable_inner_loop_optimizable_bn_params``."""
    enable_bn = cfg.enable_inner_loop_optimizable_bn_params
    return tree_map_with_path(
        lambda path, _: enable_bn or "norm" not in path, params
    )


def task_layer_norm(x, norm: Params, tasks: int, eps: float) -> torch.Tensor:
    """Layer norm of the folded ``(N, T·C, H, W)`` activation over each
    task's own ``(C, H, W)``; ``norm``'s ``weight``/``bias`` are ``(T, C, H,
    W)``."""
    n, _, h, w = x.shape
    out = layer_norm(
        x.reshape(n, tasks, -1, h, w), norm["weight"], norm["bias"],
        eps=eps, normalized_ndim=3,
    )
    return out.reshape(x.shape)


def norm_act(x, norm: Params, state: BatchNormState | None, step, cfg, tasks,
             *, variant: str, activate: bool, slope: float = SLOPE,
             pool: bool = False):
    """Per-task batch norm of the folded activation, LeakyReLU(``slope``)
    when ``activate`` and the pooled epilogue when ``pool``: the fused op
    for an activated site when ``variant`` is not ``"off"``, the plain
    ``batch_norm`` otherwise. ``norm``'s ``gamma``/``beta`` and ``state``'s
    arrays carry the leading ``T`` axis. Returns ``(out, new state with
    the T axis, or None)``."""
    gamma, beta = _fold(norm["gamma"]), _fold(norm["beta"])
    if state is not None:
        state = BatchNormState(*(_fold(a) for a in state))
    if activate and variant != "off":
        x, state = fused_norm_act(
            x, gamma, beta, state, step, eps=cfg.bn_eps,
            momentum=cfg.bn_momentum, slope=slope, variant=variant, pool=pool,
        )
    else:
        x, state = batch_norm(
            x, gamma, beta, state, step, momentum=cfg.bn_momentum, eps=cfg.bn_eps,
        )
        if activate:
            x = leaky_relu(x, slope)
    if state is None:
        return x, None
    return x, BatchNormState(*(_unfold(a, tasks) for a in state))


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


def build_backbone(cfg: BackboneConfig):
    """The backbone of ``cfg.architecture``: ``VGGBackbone`` or
    ``ResNet12Backbone``."""
    if cfg.architecture == "vgg":
        return VGGBackbone(cfg)
    if cfg.architecture == "resnet12":
        from .resnet import ResNet12Backbone

        return ResNet12Backbone(cfg)
    raise ValueError(f"unknown backbone architecture {cfg.architecture!r}")

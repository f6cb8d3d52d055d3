"""The ResNet-12 backbone with an explicit task axis
(``howtotrainyourmamlpytorch_tpu/models/resnet.py``).

Four residual stages, each::

    3x (3x3 conv -> BN -> LeakyReLU(0.1))   [the third conv's BN is not
    + 1x1 conv -> BN projection shortcut     activated: the activation
    -> 2x2 max pool                          follows the residual add]

then a global average pool in float32 and a linear head. Stage widths are
``num_filters x (1, 2, 4, 8)`` or ``resnet_widths``. The parameter tree is
the JAX package's::

    params = {
      "res0": {
        "conv0": {"conv": {"weight", "bias"}, "norm": {"gamma", "beta"}},
        "conv1": {...}, "conv2": {...},
        "shortcut": {"conv": {"weight", "bias"}, "norm": {"gamma", "beta"}},
      },
      ..., "linear": {"weight", "bias"},
    }
    bn_state = {"res0": {"conv0": BatchNormState, ..., "shortcut": ...}, ...}

As in the VGG backbone (``models/backbone.py``), images are ``(T, N, C, H,
W)``, tasks are folded into channels and every convolution, the 1x1
shortcut included, is grouped (``groups=T``). The fused norm kernels take
the two activated sites of a stage (conv0, conv1) at slope 0.1 when a fused
variant is on; conv2's norm and the shortcut's always take the plain batch
norm, as JAX's do. The stage pool follows the residual add, so the pooled
epilogue (``fused_norm_pool``) has no site here.
"""

from __future__ import annotations

import torch

from ..ops.conv import conv2d
from ..ops.initializers import xavier_uniform
from ..ops.layout import lane_padded_width, zero_pad_to
from ..ops.linear import linear
from ..ops.norm import init_batch_norm_state
from ..ops.pool import max_pool2d
from .backbone import (
    BackboneConfig,
    Params,
    conv_input,
    head,
    leaky_relu,
    local_state,
    norm_act,
    norm_excluded_mask,
    resolve_fused_variant,
)

LEAKY_SLOPE = 0.1  # the few-shot ResNet-12 convention (the VGG's is 0.01)


class ResNet12Backbone:
    """``init`` makes the trees, ``apply`` runs them; the interface of
    ``VGGBackbone``."""

    NUM_STAGES = 4
    CONVS_PER_STAGE = 3

    def __init__(self, cfg: BackboneConfig, shard=None):
        if cfg.norm_layer != "batch_norm":
            raise ValueError(
                "resnet12 supports norm_layer='batch_norm' only "
                f"(got {cfg.norm_layer!r})"
            )
        if cfg.resnet_widths is not None and len(cfg.resnet_widths) != self.NUM_STAGES:
            raise ValueError(
                f"resnet_widths needs exactly {self.NUM_STAGES} stage widths "
                f"(got {cfg.resnet_widths!r})"
            )
        self.cfg = cfg
        self.shard = shard

    @property
    def real_widths(self) -> tuple[int, int, int, int]:
        if self.cfg.resnet_widths is not None:
            return tuple(self.cfg.resnet_widths)
        f = self.cfg.num_filters
        return (f, 2 * f, 4 * f, 8 * f)

    @property
    def widths(self) -> tuple[int, int, int, int]:
        """The compute layout's stage widths: ``real_widths``, lane-padded
        with ``lane_pad_channels`` (160 and 320 pad to 256 and 384; the
        head slices back to ``real_widths[-1]``)."""
        if self.cfg.lane_pad_channels:
            return tuple(lane_padded_width(w) for w in self.real_widths)
        return self.real_widths

    def init(
        self, generator: torch.Generator, dtype=torch.float32, device=None
    ) -> tuple[Params, Params]:
        """``(params, bn_state)``: Xavier-uniform convs, zero biases, gamma
        ones and beta zeros (per step with MAML++), unit running stats at
        every norm site; drawn from ``generator`` stage by stage (conv0,
        conv1, conv2, shortcut), then the head. With lane padding the real
        widths drive the draws and the padded widths the shapes."""
        cfg = self.cfg
        steps = cfg.num_steps if cfg.per_step_bn_statistics else None

        def affine(f):
            return (cfg.num_steps, f) if cfg.per_step_affine else (f,)

        def unit(in_c, out_c, ksize, in_pad, out_pad):
            return {
                "conv": {
                    "weight": zero_pad_to(
                        xavier_uniform(
                            generator, (out_c, in_c, ksize, ksize), dtype, device
                        ),
                        (out_pad, in_pad, ksize, ksize),
                    ),
                    "bias": torch.zeros(out_pad, dtype=dtype, device=device),
                },
                "norm": {
                    "gamma": torch.ones(affine(out_pad), dtype=dtype, device=device),
                    "beta": torch.zeros(affine(out_pad), dtype=dtype, device=device),
                },
            }

        params: Params = {}
        bn_state: Params = {}
        in_ch = in_pad = cfg.image_channels
        for i, (width, width_pad) in enumerate(zip(self.real_widths, self.widths)):
            stage: Params = {}
            c, c_pad = in_ch, in_pad
            for j in range(self.CONVS_PER_STAGE):
                stage[f"conv{j}"] = unit(c, width, 3, c_pad, width_pad)
                c, c_pad = width, width_pad
            stage["shortcut"] = unit(in_ch, width, 1, in_pad, width_pad)
            params[f"res{i}"] = stage
            bn_state[f"res{i}"] = {
                name: init_batch_norm_state(width_pad, steps, dtype, device)
                for name in stage
            }
            in_ch, in_pad = width, width_pad
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
        """Forward pass of ``T`` tasks at once; arguments and results as
        ``VGGBackbone.apply``'s, the running stats nested per stage."""
        cfg = self.cfg
        variant = resolve_fused_variant(cfg, fused)
        shard = self.shard
        tasks, n = x.shape[:2]
        out = x.transpose(0, 1).reshape(n, tasks * x.shape[2], *x.shape[3:])
        new_bn_state: Params | None = None if bn_state is None else {}
        sharded = False  # whether ``out`` holds this rank's channel block

        def conv(h, unit, padding):
            weight = unit["conv"]["weight"]
            return conv2d(
                h, weight.reshape(-1, *weight.shape[2:]),
                unit["conv"]["bias"].reshape(-1), stride=1, padding=padding,
                groups=tasks,
            )

        def norm(h, stage, state, name, activate, sharded):
            state = None if state is None else state[name]
            if sharded and state is not None:
                state = local_state(shard, state, h.shape[1] // tasks)
            return norm_act(
                h, stage[name]["norm"], state, step, cfg, tasks,
                variant=variant, activate=activate, slope=LEAKY_SLOPE,
            )

        for i, width in enumerate(self.widths):
            stage = params[f"res{i}"]
            state = None if bn_state is None else bn_state[f"res{i}"]
            new_state: Params = {}
            wide = shard is not None and shard.divides(width)
            h = x_in = conv_input(shard, out, sharded, tasks, width)
            for j in range(self.CONVS_PER_STAGE):
                name = f"conv{j}"
                if j:
                    h = conv_input(shard, h, wide, tasks, width)
                h, new_state[name] = norm(
                    conv(h, stage[name], 1), stage, state, name,
                    j < self.CONVS_PER_STAGE - 1, wide,
                )
            sc, new_state["shortcut"] = norm(
                conv(x_in, stage["shortcut"], 0), stage, state, "shortcut", False, wide
            )
            out = max_pool2d(leaky_relu(h + sc, LEAKY_SLOPE), 2, 2)
            sharded = wide
            if new_bn_state is not None:
                new_bn_state[f"res{i}"] = new_state
        features = out.float().mean(dim=(2, 3)).to(out.dtype)
        logits = head(shard, features, sharded, params["linear"], tasks,
                      self.real_widths[-1], self.widths[-1], cfg.feature_dim)
        return logits, new_bn_state

    def inner_loop_mask(self, params: Params) -> Params:
        """The VGG backbone's rule: every leaf but the norm parameters,
        unless ``enable_inner_loop_optimizable_bn_params``."""
        return norm_excluded_mask(self.cfg, params)

"""Experiment JSON -> ``MAMLConfig``, with the JAX package's keys, defaults
and mapping (``howtotrainyourmamlpytorch_tpu/utils/parser_utils.py:321-330,
471-565``). There is no command line yet: ``load_maml_config`` reads a JSON
file and takes keyword overrides, e.g. ``use_pallas_fused_norm=True``.
"""

from __future__ import annotations

import json

from ..models.backbone import BackboneConfig
from ..models.common import WireCodec
from ..models.maml import MAMLConfig

#: The parser defaults of every key the config mapping reads.
DEFAULTS = {
    "image_height": 28,
    "image_width": 28,
    "image_channels": 1,
    "dataset_name": "omniglot_dataset",
    "architecture_name": None,
    "resnet_widths": None,
    "num_stages": 4,
    "cnn_num_filters": 64,
    "conv_padding": "True",
    "max_pooling": "False",
    "norm_layer": "batch_norm",
    "block_order": "conv_norm",
    "use_pallas_fused_norm": "False",
    "fused_norm_train": "False",
    "fused_norm_pool": "False",
    "lane_pad_channels": "False",
    "per_step_bn_statistics": "False",
    "number_of_training_steps_per_iter": 1,
    "number_of_evaluation_steps_per_iter": 1,
    "enable_inner_loop_optimizable_bn_params": "False",
    "num_classes_per_set": 20,
    "task_learning_rate": None,
    "init_inner_loop_learning_rate": 0.1,
    "learnable_per_layer_per_step_inner_loop_learning_rate": "False",
    "second_order": "False",
    "first_order_to_second_order_epoch": -1,
    "use_multi_step_loss_optimization": "False",
    "multi_step_loss_num_epochs": 10,
    "meta_learning_rate": 0.001,
    "min_learning_rate": 0.00001,
    "total_epochs": 200,
    "total_iter_per_epoch": 500,
    "learnable_bn_gamma": "True",
    "learnable_bn_beta": "True",
    "on_nonfinite": "halt",
    "compute_dtype": "auto",
    "transfer_dtype": "float32",
    "task_chunk": 0,
    "device_augment": "False",
}

# data/augment.py's ImageNet statistics, as float32 values.
_IMAGENET_MEAN = (0.48500001430511475, 0.4560000002384186, 0.4059999883174896)
_IMAGENET_STD = (0.2290000021457672, 0.2240000069141388, 0.22499999403953552)


def load_args(json_path: str, **overrides) -> dict:
    """Defaults, then the JSON's keys (all but ``continue_from*`` and
    ``gpu_to_use*``), then ``overrides``; ``"true"``/``"false"`` strings
    become bools."""
    args = dict(DEFAULTS)
    with open(json_path) as f:
        for key, value in json.load(f).items():
            if "continue_from" not in key and "gpu_to_use" not in key:
                args[key] = value
    args.update(overrides)
    for key, value in args.items():
        if str(value).lower() == "true":
            args[key] = True
        elif str(value).lower() == "false":
            args[key] = False
    return args


def resolve_compute_dtype(value) -> str:
    """``auto`` is float32 off the TPU, hence always here."""
    name = str(value or "auto").lower()
    if name not in ("auto", "float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype must be auto | float32 | bfloat16, got {value!r}"
        )
    return "float32" if name == "auto" else name


def wire_codec_for(args: dict) -> WireCodec | None:
    """The uint8 wire codec when ``transfer_dtype`` is uint8."""
    if str(args.get("transfer_dtype", "float32")).lower() != "uint8":
        return None
    name = args["dataset_name"].lower()
    if "omniglot" in name:
        return WireCodec(1.0, None, None)
    if "imagenet" in name:
        return WireCodec(255.0, _IMAGENET_MEAN, _IMAGENET_STD)
    if "cifar10" in name or "cifar100" in name:
        return WireCodec(
            255.0,
            tuple(float(v) for v in args["classification_mean"]),
            tuple(float(v) for v in args["classification_std"]),
        )
    return None


def device_augment_for(args: dict):
    """``None``: on-device augmentation is not ported. The JAX parser
    ignores the flag on ImageNet, so only omniglot and cifar raise."""
    if not bool(args.get("device_augment", False)):
        return None
    name = args["dataset_name"].lower()
    if "omniglot" in name or "cifar10" in name or "cifar100" in name:
        raise NotImplementedError(
            "on-device augmentation (device_augment) is ROADMAP item A7"
        )
    return None


def args_to_maml_config(args: dict) -> MAMLConfig:
    arch_raw = (args.get("architecture_name") or "").lower()
    known = {
        "": "vgg",
        "vgg": "vgg",
        "vggrelunormnetwork": "vgg",
        "resnet12": "resnet12",
        "resnet-12": "resnet12",
    }
    if arch_raw not in known:
        raise ValueError(
            f"unknown architecture_name {arch_raw!r}; expected one of {sorted(known)}"
        )
    widths = args.get("resnet_widths")
    backbone = BackboneConfig(
        architecture=known[arch_raw],
        resnet_widths=tuple(int(w) for w in widths) if widths else None,
        num_stages=int(args["num_stages"]),
        num_filters=int(args["cnn_num_filters"]),
        conv_padding=int(bool(args["conv_padding"])),
        max_pooling=bool(args["max_pooling"]),
        norm_layer=args["norm_layer"],
        block_order=args["block_order"],
        use_pallas_fused_norm=bool(args["use_pallas_fused_norm"]),
        fused_norm_train=bool(args["fused_norm_train"]),
        fused_norm_pool=bool(args["fused_norm_pool"]),
        lane_pad_channels=bool(args["lane_pad_channels"]),
        per_step_bn_statistics=bool(args["per_step_bn_statistics"]),
        num_steps=int(args["number_of_training_steps_per_iter"]),
        enable_inner_loop_optimizable_bn_params=bool(
            args["enable_inner_loop_optimizable_bn_params"]
        ),
        num_classes=int(args["num_classes_per_set"]),
        image_channels=int(args["image_channels"]),
        image_height=int(args["image_height"]),
        image_width=int(args["image_width"]),
    )
    # An explicit task_learning_rate wins; otherwise the configs'
    # init_inner_loop_learning_rate (see the JAX parser's note).
    raw_task_lr = args.get("task_learning_rate")
    if raw_task_lr is not None:
        task_lr = float(raw_task_lr)
    else:
        task_lr = float(args.get("init_inner_loop_learning_rate", 0.1))
    return MAMLConfig(
        backbone=backbone,
        number_of_training_steps_per_iter=int(
            args["number_of_training_steps_per_iter"]
        ),
        number_of_evaluation_steps_per_iter=int(
            args["number_of_evaluation_steps_per_iter"]
        ),
        task_learning_rate=task_lr,
        learnable_per_layer_per_step_inner_loop_learning_rate=bool(
            args["learnable_per_layer_per_step_inner_loop_learning_rate"]
        ),
        second_order=bool(args["second_order"]),
        first_order_to_second_order_epoch=int(
            args["first_order_to_second_order_epoch"]
        ),
        use_multi_step_loss_optimization=bool(
            args["use_multi_step_loss_optimization"]
        ),
        multi_step_loss_num_epochs=int(args["multi_step_loss_num_epochs"]),
        meta_learning_rate=float(args["meta_learning_rate"]),
        min_learning_rate=float(args["min_learning_rate"]),
        total_epochs=int(args["total_epochs"]),
        total_iter_per_epoch=int(args["total_iter_per_epoch"]),
        clip_grad_value=10.0 if "imagenet" in args["dataset_name"].lower() else None,
        learnable_bn_gamma=bool(args["learnable_bn_gamma"]),
        learnable_bn_beta=bool(args["learnable_bn_beta"]),
        skip_nonfinite_updates=str(args["on_nonfinite"]).lower() == "skip",
        compute_dtype=resolve_compute_dtype(args["compute_dtype"]),
        task_chunk=int(args.get("task_chunk", 0) or 0),
        wire_codec=wire_codec_for(args),
        device_augment=device_augment_for(args),
    )


def load_maml_config(json_path: str, **overrides) -> MAMLConfig:
    """``MAMLConfig`` of an experiment JSON, e.g.
    ``load_maml_config(path, use_pallas_fused_norm=True)``."""
    return args_to_maml_config(load_args(json_path, **overrides))

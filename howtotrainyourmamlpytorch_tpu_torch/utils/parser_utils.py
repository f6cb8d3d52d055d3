"""Command line and experiment JSON -> ``args`` -> ``MAMLConfig``, with the
JAX package's flags, defaults and merge order
(``howtotrainyourmamlpytorch_tpu/utils/parser_utils.py``), so every
``experiment_config/*.json`` parses to the same values:

* the flags and their defaults (``get_parser``);
* a JSON named by ``--name_of_args_json_file`` overrides every flag except
  the keys holding ``continue_from`` or ``gpu_to_use`` (a restart keeps the
  command line's ``latest``);
* ``"true"``/``"false"`` strings become bools;
* ``dataset_path`` is joined onto ``$DATASET_DIR``.

``get_args`` returns ``(args, device)``: the card, or a raise unless the
caller asks for the CPU, in its argument or with ``--device cpu`` (which the
dispatcher and the chaos harness pass on to the runs they start). It runs
after ``parallel.initialize_distributed_from_argv`` and stamps the process
group's identity on ``args`` (``process_index``/``process_count``, and the
loader's ``data_shard_index``/``data_shard_count`` unless the config sets
them: the rank's dp index of the dp extent, the ranks of an mp group
sharing one shard); a rank's card is ``cuda:<local rank mod device
count>``.
``load_maml_config`` reads a JSON alone (no command line, no
``DATASET_DIR``) for the entry points that take no data.

The operations plane's flags keep the JAX defaults: ``--telemetry True``,
``--watchdog True`` with ``--watchdog_min_s 600`` and ``--watchdog_factor
20``, ``--profile_trace_path`` / ``--profile_num_iters`` /
``--profile_trigger_path``, ``--peak_flops`` (0: from the card's name),
``--debug_nans`` (``utils/sanitize.set_debug_nans``) and ``--on_nonfinite
halt|skip|rollback``. ``--check_tracer_leaks`` is accepted and has no
effect: PyTorch has no tracers to leak.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..models.backbone import BackboneConfig
from ..models.common import DeviceAugment, WireCodec
from ..models.maml import MAMLConfig
from . import sanitize
from ..parallel.distributed import local_rank, process_count, process_index
from ..parallel.mesh import rank_device
from .platform import resolve_device


class Bunch:
    """Attribute access to the parsed flags (``vars(bunch)`` is the dict)."""

    def __init__(self, adict):
        self.__dict__.update(adict)


def get_parser() -> argparse.ArgumentParser:
    """The JAX package's flags and defaults, one for one. Flags of JAX-only
    mechanisms are accepted so that every config parses; the experiment
    builder reports the ones it does not port."""
    parser = argparse.ArgumentParser(
        description="MAML++ training on an NVIDIA GPU (PyTorch port)"
    )
    add = parser.add_argument
    add("--batch_size", nargs="?", type=int, default=32)
    add("--image_height", nargs="?", type=int, default=28)
    add("--image_width", nargs="?", type=int, default=28)
    add("--image_channels", nargs="?", type=int, default=1)
    add("--reset_stored_filepaths", type=str, default="False")
    add("--reverse_channels", type=str, default="False")
    add("--num_of_gpus", type=int, default=1)
    add("--indexes_of_folders_indicating_class", nargs="+", default=[-2, -3])
    add("--train_val_test_split", nargs="+",
        default=[0.73982737361, 0.26, 0.13008631319])
    add("--samples_per_iter", nargs="?", type=int, default=1)
    add("--labels_as_int", type=str, default="False")
    add("--seed", type=int, default=104)
    add("--train_seed", type=int, default=0)
    add("--val_seed", type=int, default=0)
    add("--gpu_to_use", type=int)
    add("--num_dataprovider_workers", nargs="?", type=int, default=4)
    add("--max_models_to_save", nargs="?", type=int, default=5)
    add("--dataset_name", type=str, default="omniglot_dataset")
    add("--dataset_path", type=str, default="datasets/omniglot_dataset")
    add("--experiment_name", nargs="?", type=str)
    add("--architecture_name", nargs="?", type=str)
    add("--continue_from_epoch", nargs="?", type=str, default="latest")
    add("--num_target_samples", type=int, default=15)
    add("--second_order", type=str, default="False")
    add("--total_epochs", type=int, default=200)
    add("--total_iter_per_epoch", type=int, default=500)
    add("--min_learning_rate", type=float, default=0.00001)
    add("--meta_learning_rate", type=float, default=0.001)
    # None, so that an explicit 0.1 wins over init_inner_loop_learning_rate.
    add("--task_learning_rate", type=float, default=None)
    add("--norm_layer", type=str, default="batch_norm")
    add("--block_order", type=str, default="conv_norm")
    # The fused batch norm + LeakyReLU kernels: on the eval and serve paths,
    # on the train path (any order), and with the 2x2 max pool fused in.
    add("--use_pallas_fused_norm", type=str, default="False")
    add("--fused_norm_train", type=str, default="False")
    add("--fused_norm_pool", type=str, default="False")
    add("--dataprovider_backend", type=str, default="thread")
    add("--replay_manifest", type=str, default="")
    add("--replay_every", type=int, default=8)
    add("--max_pooling", type=str, default="False")
    add("--per_step_bn_statistics", type=str, default="False")
    add("--num_classes_per_set", type=int, default=20)
    add("--number_of_training_steps_per_iter", type=int, default=1)
    add("--number_of_evaluation_steps_per_iter", type=int, default=1)
    add("--cnn_num_filters", type=int, default=64)
    add("--num_samples_per_class", type=int, default=1)
    add("--name_of_args_json_file", type=str, default="None")
    add("--num_stages", type=int, default=4)
    add("--conv_padding", type=str, default="True")
    add("--num_evaluation_tasks", type=int, default=600)
    add("--multi_step_loss_num_epochs", type=int, default=10)
    add("--use_multi_step_loss_optimization", type=str, default="False")
    add("--learnable_per_layer_per_step_inner_loop_learning_rate", type=str,
        default="False")
    add("--enable_inner_loop_optimizable_bn_params", type=str, default="False")
    add("--learnable_bn_gamma", type=str, default="True")
    add("--learnable_bn_beta", type=str, default="True")
    add("--first_order_to_second_order_epoch", type=int, default=-1)
    add("--total_epochs_before_pause", type=int, default=100)
    add("--evaluate_on_test_set_only", type=str, default="False")
    add("--sets_are_pre_split", type=str, default="False")
    add("--load_into_memory", type=str, default="False")
    add("--init_inner_loop_learning_rate", type=float, default=0.1)
    add("--weight_decay", type=float, default=0.0)
    add("--compute_dtype", type=str, default="auto")
    add("--lane_pad_channels", type=str, default="False")
    add("--task_chunk", type=int, default=0)
    # No effect here: set_f32_numerics pins float32 convolutions and
    # matmuls (TF32 off), which is the JAX flag's "highest".
    add("--matmul_precision", type=str, default="default",
        choices=["default", "high", "highest", "float32"])
    add("--transfer_dtype", type=str, default="float32",
        choices=["float32", "uint8"])
    add("--iters_per_dispatch", type=int, default=1)
    add("--device_prefetch", type=int, default=-1)
    add("--device_augment", type=str, default="False")
    add("--data_parallel_devices", type=int, default=0)
    add("--coordinator_address", type=str, default=None)
    add("--num_processes", type=int, default=0)
    add("--process_id", type=int, default=-1)
    add("--distributed_init_timeout_s", type=float, default=None)
    add("--model_parallel_devices", type=int, default=1)
    add("--profile_trace_path", type=str, default="")
    add("--profile_num_iters", type=int, default=20)
    add("--profile_trigger_path", type=str, default="")
    add("--telemetry", type=str, default="True")
    add("--peak_flops", type=float, default=0.0)
    add("--debug_nans", type=str, default="False")
    add("--check_tracer_leaks", type=str, default="False")
    add("--on_nonfinite", type=str, default="halt",
        choices=["halt", "skip", "rollback"])
    add("--watchdog", type=str, default="True")
    add("--watchdog_min_s", type=float, default=600.0)
    add("--watchdog_factor", type=float, default=20.0)
    add("--checkpoint_async", type=str, default="True")
    add("--checkpoint_interval_s", type=float, default=0.0)
    add("--data_fault_budget", type=int, default=8)
    add("--resnet_widths", nargs="+", type=int, default=None)
    add("--parity_bug", type=str, default="False")
    return parser


def extract_args_from_json(json_file_path: str, args_dict: dict) -> dict:
    """The JSON's keys over ``args_dict``, all but ``continue_from*`` and
    ``gpu_to_use*``."""
    with open(json_file_path) as f:
        summary_dict = json.load(f)
    for key in summary_dict:
        if "continue_from" not in key and "gpu_to_use" not in key:
            args_dict[key] = summary_dict[key]
    return args_dict


def _coerce_bools(args_dict: dict) -> dict:
    for key, value in args_dict.items():
        if str(value).lower() == "true":
            args_dict[key] = True
        elif str(value).lower() == "false":
            args_dict[key] = False
    return args_dict


def get_args(argv=None, device=None):
    """``(args, device)``: the flags of ``argv`` (``sys.argv`` by default)
    under the JSON they name, as a ``Bunch``; ``device`` is the card unless
    the caller passes another (``resolve_device``)."""
    # ``--device`` is the port's own and stays out of ``args``.
    device_flag = argparse.ArgumentParser(add_help=False)
    device_flag.add_argument("--device", default=None)
    flags, argv = device_flag.parse_known_args(argv)
    args_dict = vars(get_parser().parse_args(argv))
    if args_dict["name_of_args_json_file"] != "None":
        args_dict = extract_args_from_json(
            args_dict["name_of_args_json_file"], args_dict
        )
    args_dict = _coerce_bools(args_dict)
    args_dict["dataset_path"] = os.path.join(
        os.environ["DATASET_DIR"], args_dict["dataset_path"]
    )
    args = Bunch(args_dict)
    args.compute_dtype = resolve_compute_dtype(args.compute_dtype)
    # The process group's identity (0 of 1 without one), read once here
    # for telemetry, the loader's shard and the checkpoint writer.
    args.process_index, args.process_count = process_index(), process_count()
    want_procs = int(getattr(args, "num_processes", 0) or 0)
    if want_procs > 1 and args.process_count != want_procs:
        raise ValueError(
            f"--num_processes {want_procs} but the process group spans "
            f"{args.process_count} process(es); was "
            "initialize_distributed_from_argv called before get_args, with a "
            "reachable --coordinator_address and a --process_id?"
        )
    if int(getattr(args, "data_shard_count", 0) or 0) < 1:
        # The ranks of an mp group share their dp index's tasks.
        mp = int(getattr(args, "model_parallel_devices", 1) or 1)
        mp = mp if mp > 0 and args.process_count % mp == 0 else 1
        args.data_shard_index = args.process_index // mp
        args.data_shard_count = args.process_count // mp
    sanitize.set_debug_nans(bool(args.debug_nans))
    device = device if device is not None else flags.device
    if args.process_count > 1:
        device = rank_device(local_rank(), device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    device = resolve_device(device)
    print("use device", device)
    return args, device


def load_args(json_path: str, **overrides) -> dict:
    """The parser's defaults, then the JSON's keys (all but
    ``continue_from*`` and ``gpu_to_use*``), then ``overrides``;
    ``"true"``/``"false"`` strings become bools."""
    args = extract_args_from_json(json_path, vars(get_parser().parse_args([])))
    args.update(overrides)
    return _coerce_bools(args)


# data/augment.py's ImageNet statistics, as float32 values.
_IMAGENET_MEAN = (0.48500001430511475, 0.4560000002384186, 0.4059999883174896)
_IMAGENET_STD = (0.2290000021457672, 0.2240000069141388, 0.22499999403953552)


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
    """The on-device train augmentation of ``--device_augment``, or None:
    Omniglot's class-level rotation as the in-step gather (bit for bit the
    host's), cifar's crop and flip keyed by the episode seed, which needs
    the uint8 wire (the crop pads raw pixels before the deferred
    normalization, as the host does). ImageNet has no stochastic train
    transform: the flag does nothing there."""
    if not bool(args.get("device_augment", False)):
        return None
    name = args["dataset_name"].lower()
    if "omniglot" in name:
        return DeviceAugment("rot90")
    if "cifar10" in name or "cifar100" in name:
        codec = wire_codec_for(args)
        if codec is None or codec.mean is None:
            raise ValueError(
                "--device_augment on cifar requires --transfer_dtype uint8 "
                "(the on-device crop must pad raw pixels before the "
                "deferred normalization, matching the host transform order)"
            )
        return DeviceAugment("crop_flip", pad=4)
    return None


def args_to_maml_config(args) -> MAMLConfig:
    """The ``MAMLConfig`` of parsed flags (a dict or a ``Bunch``); a key
    they lack takes the parser's default."""
    args = {
        **_coerce_bools(vars(get_parser().parse_args([]))),
        **(args if isinstance(args, dict) else vars(args)),
    }
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

#!/usr/bin/env python3
"""Where one meta-training iteration of the PyTorch port spends its time,
run eagerly and replayed as a CUDA graph.

    python3 tools/port_train_profile.py [--remat]
        [--config flagship|north_star|resnet12] [--step eager graph]

Builds the MAML++ learner of the Omniglot flagship (default), of the
mini-ImageNet north star (84x84x3, 48 filters) or of the Omniglot ResNet-12
config (64/128/256/512 channels) with fused_norm_train=True
and fused_norm_pool=True (remat_inner_steps off unless ``--remat``, as
chip_smoke.py's train phase runs it; the CLI keeps the config default, on),
random weights from seed 104, and one synthetic binary batch of the
config's shape: meta-batch, way, shots and targets (flagship: 8 tasks,
5-way 1-shot, 1 target per class; north star: 2 tasks, 5-way 5-shot, 15
targets per class). For each form of the step in ``--step`` (both by
default, in one process): ``eager`` calls the learner's ``_train_step``
as the port ran every iteration before the graph; ``graph`` calls
``run_train_iter``, a replay of the step captured as a CUDA graph. After a
warm-up (the capture, for the graph) it times ITERS second-order
iterations at epoch 0 on the host clock (each ends in a synchronize) with
the peak device memory, then traces ITERS more with ``torch.profiler``.
Prints the wall time per iteration, the device's busy time (the union of
traced kernel intervals) and idle share, the operators and kernels by
device time, and the share of the fused-norm kernels ``bn_stats``,
``bn_stats_act`` and K5 (``bn_act_pool_apply``). If the trace holds no
device time it says so and times the iterations with CUDA events instead.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.models.common import set_injected_lr  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (  # noqa: E402
    args_to_maml_config,
    load_args,
)
from port_serve_profile import busy_ms  # noqa: E402

CONFIGS = {
    "flagship": "experiment_config/omniglot_maml++-omniglot_1_8_0.1_64_5_0.json",
    "north_star": "experiment_config/mini-imagenet_maml++-mini-imagenet_5_2_0.01_48_5_0.json",
    "resnet12": "experiment_config_local/omniglot_maml++-omniglot-resnet12_1_8_0.1_64_5_1.json",
}
ITERS = 3
# Kernel-name fragments of the fused-norm kernels in csrc/fused_norm.cu.
FUSED = {
    "bn_stats": ("bn_fwd_kernel<false>",),
    "bn_stats_act": ("bn_fwd_kernel<true>",),
    "K5 bn_act_pool_apply": ("bn_act_pool_apply_kernel",),
}


def batch(rng, args):
    """Binary ``(B, N, K|T, C, H, W)`` images and their labels."""
    b, n = args["batch_size"], args["num_classes_per_set"]
    image = (args["image_channels"], args["image_height"], args["image_width"])
    shots, targets = args["num_samples_per_class"], args["num_target_samples"]
    xs = (rng.rand(b, n, shots, *image) > 0.8).astype(np.float32)
    xt = (rng.rand(b, n, targets, *image) > 0.8).astype(np.float32)
    ys = np.tile(np.arange(n).reshape(1, n, 1), (b, 1, shots))
    yt = np.tile(np.arange(n).reshape(1, n, 1), (b, 1, targets))
    return xs, xt, ys, yt


def stepper(learner, data, form):
    """One second-order MSL iteration at epoch 0: ``state -> state``."""
    if form == "graph":
        return lambda state: learner.run_train_iter(state, data, epoch=0)[0]
    importance = learner._train_importance(0)

    def eager(state):
        state = state._replace(opt_state=set_injected_lr(
            state.opt_state, learner._epoch_lr(0)
        ))
        return learner._train_step(
            state, learner._device_batch(state, data),
            learner._importance(state, importance),
            second_order=True, final_only=False,
        )[0]
    return eager


def profile_form(learner, state, data, form, label) -> None:
    step = stepper(learner, data, form)
    for _ in range(2):
        state = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            state = step(state)
        torch.cuda.synchronize()
    busy = busy_ms(prof.events()) / ITERS
    print(f"device: {torch.cuda.get_device_name(0)} | {label} | step {form}")
    print(f"[{form}] per iteration: wall {wall_ms:.3f} ms, peak memory {peak_gb:.3f} GB")
    if busy == 0.0:
        print(f"[{form}] the trace holds no device time: timing with CUDA events")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            state = step(state)
        end.record()
        torch.cuda.synchronize()
        print(f"[{form}] CUDA-event ms per iteration "
              f"{start.elapsed_time(end) / ITERS:.3f}")
        return
    print(f"[{form}] device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")

    averages = prof.key_averages()
    kernels = [
        e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels)
    print(f"[{form}] kernel | calls per iteration | device ms per iteration | share")
    for e in kernels[:20]:
        print(f"{e.key[:100]} | {e.count / ITERS:.1f} | "
              f"{e.self_device_time_total / 1e3 / ITERS:.4f} | "
              f"{e.self_device_time_total / total:.3f}")
    ops = [
        e for e in averages
        if e.key.startswith("aten::") and e.device_time_total > 0
    ]
    ops.sort(key=lambda e: -e.device_time_total)
    print(f"[{form}] operator | calls per iteration | device ms per iteration "
          "(incl. children)")
    for e in ops[:15]:
        print(f"{e.key} | {e.count / ITERS:.1f} | "
              f"{e.device_time_total / 1e3 / ITERS:.4f}")
    print(f"[{form}] fused-norm kernel | calls per iteration | device ms per "
          "iteration | share")
    for name, fragments in FUSED.items():
        hits = [e for e in kernels if any(f in e.key for f in fragments)]
        t = sum(e.self_device_time_total for e in hits)
        calls = max((e.count for e in hits), default=0)
        print(f"{name} | {calls / ITERS:.1f} | {t / 1e3 / ITERS:.4f} | "
              f"{t / total:.4f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each inner step (remat_inner_steps)")
    parser.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    parser.add_argument("--step", nargs="+", choices=["eager", "graph"],
                        default=["eager", "graph"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device", file=sys.stderr)
        return 1
    run_args = load_args(os.path.join(REPO, CONFIGS[args.config]),
                         fused_norm_train=True, fused_norm_pool=True)
    cfg = dataclasses.replace(args_to_maml_config(run_args),
                              remat_inner_steps=args.remat)
    learner = MAMLFewShotLearner(cfg)
    state = learner.init_state(torch.Generator().manual_seed(104))
    data = batch(np.random.RandomState(3), run_args)
    for form in args.step:
        profile_form(learner, state, data, form,
                     f"{args.config} | remat {args.remat}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

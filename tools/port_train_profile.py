#!/usr/bin/env python3
"""Where one flagship meta-training iteration of the PyTorch port spends its
time.

    python3 tools/port_train_profile.py [--remat]

Builds the MAML++ Omniglot flagship learner with fused_norm_train=True and
fused_norm_pool=True (remat_inner_steps off unless ``--remat``, as
chip_smoke.py runs it), random weights from seed 104, and one synthetic
binary batch of 8 tasks, 5-way 1-shot, 1 target per class. After a warm-up
it times ITERS second-order iterations at epoch 0 on the host clock (each
ends in a synchronize) with the peak device memory, then traces ITERS more
with ``torch.profiler``. Prints the wall time per iteration, the device's
busy time (the union of traced kernel intervals) and idle share, the
operators and kernels by device time, and the share of the fused-norm
kernels ``bn_stats``, ``bn_stats_act`` and K5 (``bn_act_pool_apply``). If the trace holds no device time it says so and
times the iterations with CUDA events instead. Needs a CUDA device;
imports nothing of JAX.
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
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (  # noqa: E402
    load_maml_config,
)
from port_serve_profile import busy_ms  # noqa: E402

FLAGSHIP = os.path.join(
    REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json"
)
ITERS = 3
# Kernel-name fragments of the fused-norm kernels in csrc/fused_norm.cu.
FUSED = {
    "bn_stats": ("bn_fwd_kernel<false>",),
    "bn_stats_act": ("bn_fwd_kernel<true>",),
    "K5 bn_act_pool_apply": ("bn_act_pool_apply_kernel",),
}


def batch(rng, tasks=8):
    xs = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    xt = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    ys = np.tile(np.arange(5).reshape(1, 5, 1), (tasks, 1, 1))
    return xs, xt, ys, ys.copy()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint each inner step (remat_inner_steps)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device", file=sys.stderr)
        return 1
    cfg = load_maml_config(FLAGSHIP, fused_norm_train=True, fused_norm_pool=True)
    cfg = dataclasses.replace(cfg, remat_inner_steps=args.remat)
    learner = MAMLFewShotLearner(cfg)
    state = learner.init_state(torch.Generator().manual_seed(104))
    rng = np.random.RandomState(3)
    data = batch(rng)
    for _ in range(2):
        state, _ = learner.run_train_iter(state, data, epoch=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, m = learner.run_train_iter(state, data, epoch=0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            state, m = learner.run_train_iter(state, data, epoch=0)
        torch.cuda.synchronize()
    busy = busy_ms(prof.events()) / ITERS
    print(f"device: {torch.cuda.get_device_name(0)} | remat {args.remat}")
    print(f"per iteration: wall {wall_ms:.3f} ms, peak memory {peak_gb:.3f} GB")
    if busy == 0.0:
        print("the trace holds no device time: timing with CUDA events")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            state, m = learner.run_train_iter(state, data, epoch=0)
        end.record()
        torch.cuda.synchronize()
        print(f"CUDA-event ms per iteration {start.elapsed_time(end) / ITERS:.3f}")
        return 0
    print(f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")

    averages = prof.key_averages()
    kernels = [
        e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels)
    print("kernel | calls per iteration | device ms per iteration | share")
    for e in kernels[:20]:
        print(f"{e.key[:100]} | {e.count / ITERS:.1f} | "
              f"{e.self_device_time_total / 1e3 / ITERS:.4f} | "
              f"{e.self_device_time_total / total:.3f}")
    ops = [
        e for e in averages
        if e.key.startswith("aten::") and e.device_time_total > 0
    ]
    ops.sort(key=lambda e: -e.device_time_total)
    print("operator | calls per iteration | device ms per iteration (incl. children)")
    for e in ops[:15]:
        print(f"{e.key} | {e.count / ITERS:.1f} | "
              f"{e.device_time_total / 1e3 / ITERS:.4f}")
    print("fused-norm kernel | calls per iteration | device ms per iteration | share")
    for name, fragments in FUSED.items():
        hits = [e for e in kernels if any(f in e.key for f in fragments)]
        t = sum(e.self_device_time_total for e in hits)
        calls = max((e.count for e in hits), default=0)
        print(f"{name} | {calls / ITERS:.1f} | {t / 1e3 / ITERS:.4f} | "
              f"{t / total:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

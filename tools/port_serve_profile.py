#!/usr/bin/env python3
"""Where a flagship serve dispatch of the PyTorch port spends its time.

    python3 tools/port_serve_profile.py

Builds the MAML++ Omniglot flagship engine (use_pallas_fused_norm=True,
random weights from a seed, meta_batch_size=4), warms it up, then traces
dispatches of 4 cache-missing 5x1x15 episodes with ``torch.profiler``.
Prints the wall time per dispatch (untraced, host clock over work that ends
in a synchronize), the device's busy time per dispatch (the union of traced
kernel intervals) and the idle share between them, the kernels by total
device time, and the fused-norm kernels with the norm forward's and
backward's device time per dispatch. The episodes are timed with their host
preparation. It uses only the engine's public surface, so the same file
profiles an earlier commit of the port too. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.serve import (  # noqa: E402
    ServeConfig,
    ServingEngine,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (  # noqa: E402
    load_maml_config,
)

FLAGSHIP = os.path.join(
    REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json"
)
DISPATCHES = 5
# Kernel-name fragments of the fused-norm kernels of csrc/fused_norm.cu; the
# backward's also match the three kernels (bn_act_bwd_partial, _finalize,
# _apply) that bn_bwd_kernel replaced.
NORM_FORWARD = ("bn_fwd_kernel",)
NORM_BACKWARD = ("bn_bwd_kernel", "bn_act_bwd_")


def episodes(engine, rng, count):
    return [
        engine.prepare_episode(
            (rng.rand(5, 1, 28, 28) > 0.8).astype(np.float32),
            np.arange(5),
            (rng.rand(15, 1, 28, 28) > 0.8).astype(np.float32),
        )
        for _ in range(count)
    ]


def busy_ms(events) -> float:
    """Union of the device kernel intervals, in milliseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    total, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3  # microseconds -> ms


def main() -> int:
    if not torch.cuda.is_available():
        print("port_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    cfg = load_maml_config(FLAGSHIP, use_pallas_fused_norm=True)
    learner = MAMLFewShotLearner(cfg)
    istate = learner.init_inference_state(torch.Generator().manual_seed(104))
    engine = ServingEngine(learner, istate, ServeConfig(meta_batch_size=4))
    rng = np.random.RandomState(1)
    for _ in range(3):
        engine.dispatch(episodes(engine, rng, 4))
    # Wall time without the profiler, then the same work traced.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCHES):
        engine.dispatch(episodes(engine, rng, 4))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DISPATCHES
    groups = [episodes(engine, rng, 4) for _ in range(DISPATCHES)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for group in groups:
            engine.dispatch(group)
        torch.cuda.synchronize()
    busy = busy_ms(prof.events()) / DISPATCHES
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"per dispatch of 4 episodes: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
    rows = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        or getattr(e, "self_device_time_total", 0) > 0
    ]
    rows.sort(key=lambda e: -e.self_device_time_total)
    print("kernel | calls per dispatch | device ms per dispatch")
    for e in rows[:15]:
        print(f"{e.key[:90]} | {e.count / DISPATCHES:.1f} | "
              f"{e.self_device_time_total / 1e3 / DISPATCHES:.4f}")
    print("fused-norm kernel | calls per dispatch | device ms per dispatch")
    for part, fragments in (("forward", NORM_FORWARD), ("backward", NORM_BACKWARD)):
        hits = [e for e in rows if any(f in e.key for f in fragments)]
        for e in hits:
            print(f"{e.key[:90]} | {e.count / DISPATCHES:.1f} | "
                  f"{e.self_device_time_total / 1e3 / DISPATCHES:.4f}")
        print(f"norm {part}: {sum(e.count for e in hits) / DISPATCHES:.1f} device "
              f"launches, {sum(e.self_device_time_total for e in hits) / 1e3 / DISPATCHES:.4f}"
              " ms per dispatch")
    return 0


if __name__ == "__main__":
    sys.exit(main())

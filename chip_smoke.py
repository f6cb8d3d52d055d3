#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA card and checks it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. build   - compiles the Hopper kernels (csrc/fused_norm.cu) with nvcc for
             sm_90a; prints the build seconds and the card's name and power
             limit.
2. kernels - runs K1-K4 through ``FusedBNLeakyReLU`` at the shapes the
             flagship serve path gives them (4 tasks x 64 filters folded
             into 256 channels; support N=5 and query N=15 at the 28, 14, 7
             and 3 pixel stages) and at one north-star shape (25, 96, 84,
             84). Holds forward y/mean/var and backward dx/dgamma/dbeta to
             the plain PyTorch version and times each kernel beside its
             plain version, its bound and the library yardsticks.
3. serve   - the MAML++ Omniglot flagship config with
             use_pallas_fused_norm=True, random weights from a seed: a
             ServingEngine(meta_batch_size=4) serves 32 binary-image
             episodes of bucket 5x1x15 (one support set repeated, so one is
             a cache hit). The launch counts are zeroed just before and
             read just after; every kernel must have run. Logits must be
             finite, the same when served again, and match a
             use_pallas_fused_norm=False engine on the same state (the
             tolerances below say how).
4. result  - one JSON line listing the kernels, the nvidia-smi line, and
             the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(
    REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json"
)
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Norm-wise tolerance of a kernel against its plain version:
# max|kernel - plain| <= ATOL + RTOL * max|plain|. Reductions over up to
# 176,400 elements are summed in another order than PyTorch's; elementwise
# outputs differ by rsqrtf and fused multiply-add rounding.
RTOL, ATOL = 1e-4, 1e-5
# Served logits, fused-kernel engine against the plain-norm engine, both in
# float32 with TF32 off and deterministic cuDNN; their batch statistics
# differ in rounding (shifted single pass against two-pass).
# - Classify alone, on the same adapted weights: a forward pass, continuous
#   in its inputs. Measured 3.6e-6 against logits up to 6.9.
CLASSIFY_RTOL, CLASSIFY_ATOL = 1e-4, 1e-4
# - Whole episodes: the inner gradient routes through LeakyReLU branches and
#   max-pool argmaxes, and where two values lie within rounding of each
#   other the two versions can route differently; five inner steps carry
#   such a flip into the logits. Measured on an H100: 1 of 32 episodes
#   moved by 1.03e-2, the rest stayed within 1e-4. So the median episode
#   must agree to EPISODE_MEDIAN_ATOL and every episode to EPISODE_MAX_ATOL.
EPISODE_MEDIAN_ATOL, EPISODE_MAX_ATOL = 1e-4, 5e-2

FLAGSHIP_SHAPES = [
    (n, 256, hw, hw) for n in (5, 15) for hw in (28, 14, 7, 3)
]
NORTH_STAR_SHAPE = (25, 96, 84, 84)
# Flops per element each kernel does, counted from its source.
FLOPS_PER_ELEMENT = {
    "bn_stats": 4, "bn_act_apply": 6, "bn_act_bwd_reduce": 8,
    "bn_act_bwd_apply": 12,
}
REPLACES = {
    "bn_stats": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py:93,183",
    "bn_act_apply": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py:93,194",
    "bn_act_bwd_reduce": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py:113,206",
    "bn_act_bwd_apply": "howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py:113,226",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 5) -> float:
    """Milliseconds per ``fn()`` over ``reps`` back-to-back eager calls
    between CUDA events, after ``warmup`` calls. For small kernels this is
    the host's launch rate, not the kernel's device time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, calls: int, replays: int = 10) -> float:
    """Device milliseconds per ``fn()``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The replay runs
    the same kernels without the Python and launch cost of each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def err_ok(got, want) -> tuple[float, bool]:
    err = float((got - want).abs().max())
    return err, err <= ATOL + RTOL * float(want.abs().max())


def bound_ms(name: str, shape) -> tuple[float, str]:
    """Least time for the work: bytes each input read once and each output
    written once, against float32 operations at the non-tensor peak."""
    n, c, h, w = shape
    elems = n * c * h * w
    tensors = {"bn_stats": 1, "bn_act_apply": 2, "bn_act_bwd_reduce": 2,
               "bn_act_bwd_apply": 3}[name]
    vectors = {"bn_stats": 2, "bn_act_apply": 4, "bn_act_bwd_reduce": 6,
               "bn_act_bwd_apply": 6}[name]
    t_bytes = 4 * (tensors * elems + vectors * c) / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT[name] * elems / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_and_time_kernels(torch, fn, shape, gen, reps) -> dict:
    """K1-K4 through the Function against the plain version, then times."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    x = torch.randn(shape, device=dev, generator=gen)
    c = shape[1]
    gamma = torch.rand(c, device=dev, generator=gen) + 0.5
    beta = 0.1 * torch.randn(c, device=dev, generator=gen)
    g = torch.randn(shape, device=dev, generator=gen)

    # Through the Function: forward K1+K2, backward K3+K4.
    xk, gk, bk = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y, mean, var = fn.FusedBNLeakyReLU.apply(xk, gk, bk, fn.EPS, fn.SLOPE)
    dx, dgamma, dbeta = torch.autograd.grad(y, (xk, gk, bk), g)
    torch.cuda.synchronize()
    # Plain version: its own statistics for the forward; for the backward
    # the Function's saved statistics, so that both take the same LeakyReLU
    # branch where pre lies within rounding of 0.
    p_mean, p_var = fn.plain_stats(x)
    p_y = fn.plain_apply(x, p_mean, p_var, gamma, beta)
    mean, var = mean.detach(), var.detach()
    p_dgamma, p_dbeta = fn.plain_bwd_reduce(x, g, mean, var, gamma, beta)
    p_dx = fn.plain_bwd_apply(x, g, mean, var, gamma, beta, p_dgamma, p_dbeta)
    checks = {
        "bn_stats": [(mean, p_mean), (var, p_var)],
        "bn_act_apply": [(y.detach(), p_y)],
        "bn_act_bwd_reduce": [(dgamma, p_dgamma), (dbeta, p_dbeta)],
        "bn_act_bwd_apply": [(dx, p_dx)],
    }
    out = {}
    for name, pairs in checks.items():
        errs = [err_ok(a, b) for a, b in pairs]
        if not all(ok for _, ok in errs):
            fail(f"{name} at {shape} disagrees with its plain version: "
                 f"max_abs_err {[e for e, _ in errs]}")
        out[name] = {"max_abs_err": max(e for e, _ in errs)}

    runs = {
        "bn_stats": (lambda: fn.bn_stats(x), lambda: fn.plain_stats(x)),
        "bn_act_apply": (
            lambda: fn.bn_act_apply(x, mean, var, gamma, beta),
            lambda: fn.plain_apply(x, mean, var, gamma, beta),
        ),
        "bn_act_bwd_reduce": (
            lambda: fn.bn_act_bwd_reduce(x, g, mean, var, gamma, beta),
            lambda: fn.plain_bwd_reduce(x, g, mean, var, gamma, beta),
        ),
        "bn_act_bwd_apply": (
            lambda: fn.bn_act_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta),
            lambda: fn.plain_bwd_apply(x, g, mean, var, gamma, beta, dgamma, dbeta),
        ),
    }
    calls = max(2, reps // 5)
    for name, (kernel, plain) in runs.items():
        b, by = bound_ms(name, shape)
        out[name].update(
            ms=graph_ms(torch, kernel, calls),
            plain_ms=graph_ms(torch, plain, calls),
            eager_ms=cuda_ms(torch, kernel, reps),
            eager_plain_ms=cuda_ms(torch, plain, reps),
            bound_ms=b, bound_by=by, library_ms=None,
        )
    out["bn_stats"]["library_ms"] = graph_ms(
        torch, lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0), calls
    )

    # Pair yardsticks: the whole forward and backward against PyTorch's
    # batch norm (training mode) + LeakyReLU and their autograd backward.
    xl, gl, bl = (t.clone().requires_grad_() for t in (x, gamma, beta))

    def lib_fwd():
        return F.leaky_relu(
            F.batch_norm(xl, None, None, gl, bl, training=True, eps=fn.EPS),
            fn.SLOPE,
        )

    y_lib = lib_fwd()
    y_fused = fn.FusedBNLeakyReLU.apply(xk, gk, bk, fn.EPS, fn.SLOPE)[0]
    out["pairs"] = {
        "forward_ms": cuda_ms(
            torch, lambda: fn.FusedBNLeakyReLU.apply(x, gamma, beta, fn.EPS, fn.SLOPE),
            reps,
        ),
        "library_forward_ms": cuda_ms(torch, lib_fwd, reps),
        "backward_ms": cuda_ms(
            torch,
            lambda: torch.autograd.grad(y_fused, (xk, gk, bk), g, retain_graph=True),
            reps,
        ),
        "library_backward_ms": cuda_ms(
            torch,
            lambda: torch.autograd.grad(y_lib, (xl, gl, bl), g, retain_graph=True),
            reps,
        ),
    }
    return out


def make_episodes(rng, count, query=15):
    """Binary 28x28 episodes, sparse strokes on a blank ground like
    Omniglot's 0/1 pixels; episode count // 2 repeats episode 0's support."""
    eps = []
    for i in range(count):
        xs = (rng.rand(5, 1, 1, 28, 28) > 0.8).astype(np.float32)
        if i == count // 2:
            xs = eps[0][0]
        xq = (rng.rand(query, 1, 28, 28) > 0.8).astype(np.float32)
        eps.append((xs, np.arange(5).reshape(5, 1), xq))
    return eps


def serve_phase(torch, fn):
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        ServeConfig,
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        load_maml_config,
    )

    cfg = load_maml_config(FLAGSHIP, use_pallas_fused_norm=True)
    learner = MAMLFewShotLearner(cfg)
    istate = learner.init_inference_state(torch.Generator().manual_seed(104))
    plain_cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_fused_norm=False)
    )
    plain_learner = MAMLFewShotLearner(plain_cfg)
    engine = ServingEngine(learner, istate, ServeConfig(meta_batch_size=4))
    plain = ServingEngine(plain_learner, istate, ServeConfig(meta_batch_size=4))
    rng = np.random.RandomState(0)
    warm = [engine.prepare_episode(*e) for e in make_episodes(rng, 4)]
    engine.dispatch(warm)
    plain.dispatch([plain.prepare_episode(*e) for e in make_episodes(rng, 4)])
    engine.stats = type(engine.stats)()

    raw = make_episodes(rng, 32)
    eps = [engine.prepare_episode(*e) for e in raw]
    if {ep.bucket for ep in eps} != {(5, 1, 15)}:
        fail(f"unexpected buckets {sorted({ep.bucket for ep in eps})}")
    fn.reset_launch_counts()
    t0 = time.perf_counter()
    logits = engine.dispatch(eps)
    wall = time.perf_counter() - t0
    launches = dict(fn.launch_counts)
    if not all(launches[k] > 0 for k in fn.KERNELS):
        fail(f"the serve path skipped a kernel: launches {launches}")
    stats = engine.stats
    if stats.cache_hits != 1:
        fail(f"expected one cache hit, got {stats.cache_hits}")
    got = np.stack(logits)
    if got.shape != (32, 15, 5) or not np.isfinite(got).all():
        fail(f"logits of shape {got.shape}, finite={np.isfinite(got).all()}")
    # The same logits run to run: a second engine, empty cache, serves again.
    again = ServingEngine(learner, istate, ServeConfig(meta_batch_size=4))
    if not np.array_equal(np.stack(again.dispatch(eps)), got):
        fail("serving the same episodes again gave other logits")

    # Classify alone: both learners on the plain engine's adapted weights.
    dev = torch.device("cuda")
    xs, ys, xq = (
        torch.from_numpy(np.stack([getattr(ep, k) for ep in eps[:4]])).to(dev)
        for k in ("x_support", "y_support", "x_query")
    )
    fast = plain_learner.serve_adapt(istate, xs, ys)
    a = learner.serve_classify(istate, fast, xq)
    b = plain_learner.serve_classify(istate, fast, xq)
    classify_err = float((a - b).abs().max())
    if classify_err > CLASSIFY_ATOL + CLASSIFY_RTOL * float(b.abs().max()):
        fail(f"fused classify differs from the plain-norm one by {classify_err}")

    # Whole episodes against the plain-norm engine.
    ref = np.stack(plain.dispatch([plain.prepare_episode(*e) for e in raw]))
    per_episode = np.abs(got - ref).reshape(len(eps), -1).max(axis=1)
    if (np.median(per_episode) > EPISODE_MEDIAN_ATOL
            or per_episode.max() > EPISODE_MAX_ATOL):
        fail(f"fused episodes differ from the plain-norm engine: per-episode "
             f"max abs {per_episode.tolist()}")
    serve = {
        "episodes": len(eps),
        "dispatches": stats.batches_dispatched,
        "cache_hits": stats.cache_hits,
        "adapt_p50_ms": float(np.median(stats.adapt_ms)),
        "classify_p50_ms": float(np.median(stats.classify_ms)),
        "episodes_per_s": len(eps) / wall,
        "classify_max_abs_err_vs_plain": classify_err,
        "episode_max_abs_err_vs_plain": float(per_episode.max()),
        "episode_median_abs_err_vs_plain": float(np.median(per_episode)),
        "episodes_over_1e-4": int((per_episode > 1e-4).sum()),
        "max_abs_logit": float(np.abs(ref).max()),
        "launches": launches,
    }
    return serve


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as fn

    # 1. build
    path, build_s, compiler_out = fn.build()
    smi = gpu_line()
    print(f"[build] {os.path.relpath(path, REPO)} in {build_s:.2f} s")
    for line in compiler_out.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {smi}", flush=True)

    # 2. kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape = {}
    for shape in FLAGSHIP_SHAPES + [NORTH_STAR_SHAPE]:
        reps = 20 if shape == NORTH_STAR_SHAPE else 100
        res = check_and_time_kernels(torch, fn, shape, gen, reps)
        per_shape[shape] = res
        cells = " ".join(
            f"{k}={v['ms']:.4f}/{v['plain_ms']:.4f}/{v['bound_ms']:.4f}"
            f"/{v['eager_ms']:.4f}/{v['eager_plain_ms']:.4f}"
            for k, v in res.items() if k != "pairs"
        )
        pairs = " ".join(f"{k}={v:.4f}" for k, v in res["pairs"].items())
        print(f"[kernels] {shape} ms graph/plain graph/bound/eager/plain eager "
              f"{cells} | var_mean graph={res['bn_stats']['library_ms']:.4f} "
              f"| eager pairs {pairs}", flush=True)
    errs = {
        k: max(r[k]["max_abs_err"] for r in per_shape.values()) for k in fn.KERNELS
    }
    print(f"[kernels] max_abs_err over all shapes {errs}")

    # 3. serve
    serve = serve_phase(torch, fn)
    print(f"[serve] {json.dumps(serve)}", flush=True)

    # 4. result: kernel numbers at the support stage-0 shape, the serve
    # path's most launched and largest adapt shape.
    main_shape = FLAGSHIP_SHAPES[0]
    kernels = []
    for name in fn.KERNELS:
        r = per_shape[main_shape][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "howtotrainyourmamlpytorch_tpu_torch/csrc/fused_norm.cu",
            "replaces": REPLACES[name], "launches": serve["launches"][name],
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

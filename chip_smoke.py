#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA card and checks it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. build   - compiles the Hopper kernels (csrc/fused_norm.cu) with nvcc for
             sm_90a; prints the build seconds and the card's name and power
             limit.
2. kernels - runs the forward (``bn_stats_act``, and ``bn_stats`` alone)
             and the backward (``bn_act_bwd``, directly and through
             ``FusedBNLeakyReLU``, from the Function's saved statistics) at
             the shapes the flagship serve path gives them (4 tasks x 64
             filters folded into 256 channels; support N=5 and query N=15
             at the 28, 14, 7 and 3 pixel stages), at those of the train
             path (8 tasks, 512 channels, N=5) and at the north-star
             support and target stage-0 shapes (25|75, 96, 84, 84); both
             also on their streamed path, forced, at (25, 96, 84, 84).
             Holds forward y/mean/var and backward dx/dgamma/dbeta to the
             plain PyTorch version, each kernel's two calls, the forward's
             two entries' statistics and the backward's two routes to each
             other bitwise, and times each kernel beside its plain version,
             its bound and the library yardsticks, with its launch plan.
   pool    - K5 (``bn_act_pool_apply``) against ``plain_pool_apply`` at the
             train path's pooled stages (5, 512, 28, 28) and (5, 512, 14,
             14) and at the north-star shape; the same timings.
   functions - the any-order Functions on the card: forward, first-order
             gradients of a loss over y, mean and var, and the
             reverse-over-reverse composition, against the plain
             composition differentiated by autograd, at (5, 512, 28, 28)
             (pooled) and (5, 512, 7, 7) (any order).
3. serve   - the MAML++ Omniglot flagship config with
             use_pallas_fused_norm=True, random weights from a seed: a
             ServingEngine(meta_batch_size=4) serves 32 binary-image
             episodes of bucket 5x1x15 (one support set repeated, so one is
             a cache hit). The launch counts are zeroed just before and
             read just after; each kernel must have run as often as the
             path calls it (per dispatch: bn_stats_act 24, bn_act_bwd 20,
             bn_stats 0). Logits must be
             finite, the same when served again, and match a
             use_pallas_fused_norm=False engine on the same state (the
             tolerances below say how).
4. train   - the same flagship config with fused_norm_train=True and
             fused_norm_pool=True (remat_inner_steps=False), learner from
             seed 104: 10 second-order ``run_train_iter`` at epoch 0 on one
             synthetic binary batch of 8 tasks, 5-way 1-shot, 1 target per
             class, with the launch counts zeroed just before and read
             just after (per iteration bn_stats 20, bn_stats_act 20, K5 20).
             Losses finite and
             falling; a rerun from the same state bitwise equal; the first
             loss and meta-gradient against a plain-norm learner on the
             same state; one past-horizon iteration's launches; one
             ``run_validation_iter`` with finite logits.
5. result  - one JSON line listing the kernels, the nvidia-smi line, and
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

# Meta-gradient of the fused train step against the plain-norm learner's,
# per leaf: max|fused - plain| <= GRAD_ATOL + GRAD_RTOL * max|plain|. Where
# a LeakyReLU branch or a pool argmax routes differently (two values within
# rounding, see the serve tolerances above) a leaf may move further; it is
# printed with its gap and held to ROUTING_RTOL * max|plain|.
GRAD_RTOL, GRAD_ATOL, ROUTING_RTOL = 1e-3, 1e-5, 5e-2
TRAIN_LOSS_RTOL = 1e-4
TRAIN_ITERS = 10

FLAGSHIP_SHAPES = [
    (n, 256, hw, hw) for n in (5, 15) for hw in (28, 14, 7, 3)
]
# The train path: 8 tasks x 64 filters folded into 512 channels, N=5 for
# the support and the target set alike.
TRAIN_SHAPES = [(5, 512, hw, hw) for hw in (28, 14, 7, 3)]
NORTH_STAR_SHAPE = (25, 96, 84, 84)
# The north-star target set: 15 queries x 5 classes, 2 tasks folded.
NORTH_STAR_TARGET = (75, 96, 84, 84)
# Both kernels forced onto their streamed path (the backward takes it at
# NORTH_STAR_TARGET; the forward at no shape of the repo).
STREAMED_SHAPE = NORTH_STAR_SHAPE
POOL_SHAPES = [TRAIN_SHAPES[0], TRAIN_SHAPES[1], NORTH_STAR_SHAPE]
FORWARD = ("bn_stats", "bn_stats_act")
# Launches of each kernel per serve dispatch of 4 episodes (4 stages x (5
# adapt steps + 1 classify) forwards, 5 x 4 backwards) and per flagship
# MSL train iteration (5 steps x support and target x 4 stages; stages 0-1
# pooled).
SERVE_LAUNCHES = {"bn_stats": 0, "bn_stats_act": 24, "bn_act_bwd": 20,
                  "bn_act_pool_apply": 0}
TRAIN_LAUNCHES = {"bn_stats": 20, "bn_stats_act": 20, "bn_act_bwd": 0,
                  "bn_act_pool_apply": 20}
# Flops per input element each kernel does, counted from its source
# (bn_act_bwd: 8 in the reduce, 10 in the apply, the LeakyReLU's slope
# product counted on every element).
FLOPS_PER_ELEMENT = {
    "bn_stats": 4, "bn_stats_act": 8, "bn_act_bwd": 18, "bn_act_pool_apply": 6,
}
# Full-size tensors each kernel reads or writes (the pooled output is a
# quarter of one), and per-channel vectors.
TENSORS = {"bn_stats": 1, "bn_stats_act": 2, "bn_act_bwd": 3, "bn_act_pool_apply": 1.25}
VECTORS = {"bn_stats": 2, "bn_stats_act": 4, "bn_act_bwd": 6, "bn_act_pool_apply": 4}
PALLAS = "howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py"
REPLACES = {
    "bn_stats": f"{PALLAS}:147,248",
    "bn_stats_act": f"{PALLAS}:93,183,194",
    "bn_act_bwd": f"{PALLAS}:113,206,226",
    "bn_act_pool_apply": f"{PALLAS}:147,267",
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
    t_bytes = 4 * (TENSORS[name] * elems + VECTORS[name] * c) / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT[name] * elems / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _inputs(torch, shape, gen):
    dev = torch.device("cuda")
    x = torch.randn(shape, device=dev, generator=gen)
    c = shape[1]
    gamma = torch.rand(c, device=dev, generator=gen) + 0.5
    beta = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, gamma, beta


def check_and_time_forward(torch, fn, x, gamma, beta, reps, streamed=False):
    """``bn_stats_act`` and ``bn_stats`` on ``x`` against the plain version,
    two calls bitwise equal and both entries' statistics bitwise equal;
    then times, with the launch plan."""
    plan = fn.fwd_plan(x, streamed=streamed)
    y, mean, var = fn.bn_stats_act(x, gamma, beta, plan=plan)
    again = fn.bn_stats_act(x, gamma, beta, plan=plan)
    stats = fn.bn_stats(x, plan=plan)
    torch.cuda.synchronize()
    shape = tuple(x.shape)
    if not all(torch.equal(a, b) for a, b in zip((y, mean, var), again)):
        fail(f"bn_stats_act at {shape} ({plan}) differs between two calls")
    if not all(torch.equal(a, b) for a, b in zip((mean, var), stats)):
        fail(f"bn_stats and bn_stats_act statistics differ at {shape} ({plan})")
    p_mean, p_var = fn.plain_stats(x)
    p_y = fn.plain_apply(x, p_mean, p_var, gamma, beta)
    out = {}
    for name, pairs in (
        ("bn_stats", [(mean, p_mean), (var, p_var)]),
        ("bn_stats_act", [(y, p_y), (mean, p_mean), (var, p_var)]),
    ):
        errs = [err_ok(a, b) for a, b in pairs]
        if not all(ok for _, ok in errs):
            fail(f"{name} at {shape} ({plan}) disagrees with its plain version: "
                 f"max_abs_err {[e for e, _ in errs]}")
        out[name] = {"max_abs_err": max(e for e, _ in errs), "plan": plan._asdict()}
    runs = {
        "bn_stats": (lambda: fn.bn_stats(x, plan=plan), lambda: fn.plain_stats(x)),
        "bn_stats_act": (
            lambda: fn.bn_stats_act(x, gamma, beta, plan=plan),
            lambda: fn.plain_apply(x, *fn.plain_stats(x), gamma, beta),
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
    return out


def check_and_time_backward(torch, fn, x, gamma, beta, g, reps, streamed=False):
    """``bn_act_bwd`` from the statistics ``FusedBNLeakyReLU`` saved, called
    directly and (on its own plan) through the Function's backward, against
    ``plain_bwd`` on the same statistics, so that both take the same
    LeakyReLU branch where pre lies within rounding of 0; two calls and the
    two routes bitwise equal; then times, with the launch plan."""
    shape = tuple(x.shape)
    plan = fn.bwd_plan(x, streamed=streamed)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y, mean, var = fn.FusedBNLeakyReLU.apply(*leaves, fn.EPS, fn.SLOPE)
    through = torch.autograd.grad(y, leaves, g)
    mean, var = mean.detach(), var.detach()
    got = fn.bn_act_bwd(x, g, mean, var, gamma, beta, plan=plan)
    again = fn.bn_act_bwd(x, g, mean, var, gamma, beta, plan=plan)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"bn_act_bwd at {shape} ({plan}) differs between two calls")
    if not streamed and not all(torch.equal(a, b) for a, b in zip(got, through)):
        fail(f"bn_act_bwd at {shape} ({plan}) differs from the Function's backward")
    want = fn.plain_bwd(x, g, mean, var, gamma, beta)
    errs = [err_ok(a, b) for a, b in zip((*got, *through), (*want, *want))]
    if not all(ok for _, ok in errs):
        fail(f"bn_act_bwd at {shape} ({plan}) disagrees with its plain version: "
             f"max_abs_err {[e for e, _ in errs]}")
    kernel = lambda: fn.bn_act_bwd(x, g, mean, var, gamma, beta, plan=plan)  # noqa: E731
    plain = lambda: fn.plain_bwd(x, g, mean, var, gamma, beta)  # noqa: E731
    b, by = bound_ms("bn_act_bwd", shape)
    calls = max(2, reps // 5)
    return {
        "max_abs_err": max(e for e, _ in errs), "plan": plan._asdict(),
        "ms": graph_ms(torch, kernel, calls), "plain_ms": graph_ms(torch, plain, calls),
        "eager_ms": cuda_ms(torch, kernel, reps),
        "eager_plain_ms": cuda_ms(torch, plain, reps),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }


def check_and_time_kernels(torch, fn, shape, gen, reps) -> dict:
    """The forward and the backward (above), then the pair yardsticks."""
    import torch.nn.functional as F

    x, gamma, beta = _inputs(torch, shape, gen)
    g = torch.randn(shape, device=x.device, generator=gen)
    out = check_and_time_forward(torch, fn, x, gamma, beta, reps)
    out["bn_act_bwd"] = check_and_time_backward(torch, fn, x, gamma, beta, g, reps)

    # Pair yardsticks: the whole forward and backward against PyTorch's
    # batch norm (training mode) + LeakyReLU and their autograd backward.
    xk, gk, bk = (t.clone().requires_grad_() for t in (x, gamma, beta))
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


def check_and_time_pool(torch, fn, shape, gen, reps) -> dict:
    """K5 against ``plain_pool_apply`` on the same statistics, then times."""
    x, gamma, beta = _inputs(torch, shape, gen)
    mean, var = fn.bn_stats(x)
    got = fn.bn_act_pool_apply(x, mean, var, gamma, beta)
    torch.cuda.synchronize()
    err, ok = err_ok(got, fn.plain_pool_apply(x, mean, var, gamma, beta))
    if not ok:
        fail(f"bn_act_pool_apply at {shape} disagrees with its plain version: "
             f"max_abs_err {err}")
    kernel = lambda: fn.bn_act_pool_apply(x, mean, var, gamma, beta)  # noqa: E731
    plain = lambda: fn.plain_pool_apply(x, mean, var, gamma, beta)  # noqa: E731
    b, by = bound_ms("bn_act_pool_apply", shape)
    calls = max(2, reps // 5)
    return {
        "max_abs_err": err, "ms": graph_ms(torch, kernel, calls),
        "plain_ms": graph_ms(torch, plain, calls),
        "eager_ms": cuda_ms(torch, kernel, reps),
        "eager_plain_ms": cuda_ms(torch, plain, reps),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }


def check_functions(torch, fn, gen) -> dict:
    """Both any-order Functions against the plain composition differentiated
    by autograd: forward, the first-order gradients of a loss over y, mean
    and var, and the reverse-over-reverse composition. The plain composition
    takes the kernels' statistics as values (with its own gradient), so both
    take the same LeakyReLU branch and window maximum where two values lie
    within rounding."""
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def plain_op(x, gamma, beta, pool, stats):
        mean, var = fn.plain_stats(x)
        mean = mean + (stats[0] - mean).detach()
        var = var + (stats[1] - var).detach()
        y = fn.plain_apply(x, mean, var, gamma, beta)
        return (F.max_pool2d(y, 2, 2) if pool else y), mean, var

    out = {}
    for name, op, shape in (
        ("pool", fn.fused_bn_leaky_relu_pool, TRAIN_SHAPES[0]),
        ("ho", fn.fused_bn_leaky_relu_ho, TRAIN_SHAPES[2]),
    ):
        pool = name == "pool"
        x = torch.randn(shape, device=dev, generator=gen)
        gamma = torch.rand(shape[1], device=dev, generator=gen) + 0.5
        beta = 0.1 * torch.randn(shape[1], device=dev, generator=gen)
        stats = fn.bn_stats(x)
        t = torch.randn_like(op(x, gamma, beta)[0])

        def grads(f):
            leaves = [a.clone().requires_grad_() for a in (x, gamma, beta)]
            y, mean, var = f(*leaves)
            first = torch.autograd.grad(
                (y * t).sum() + mean.sum() + var.sum(), leaves
            )
            xx, gg = (a.clone().requires_grad_() for a in (x, gamma))
            (g,) = torch.autograd.grad(
                (f(xx, gg, beta)[0] ** 2).sum(), gg, create_graph=True
            )
            (second,) = torch.autograd.grad(f(xx, gg - 0.1 * g, beta)[0].sum(), xx)
            return [a.detach() for a in (y, *first, second)]

        got = grads(op)
        want = grads(lambda *a: plain_op(*a, pool, stats))  # noqa: B023
        torch.cuda.synchronize()
        errs = [err_ok(a, b) for a, b in zip(got, want)]
        out[name] = dict(zip(("y", "dx", "dgamma", "dbeta", "rev_over_rev_dx"),
                             (e for e, _ in errs)))
        if not all(ok for _, ok in errs):
            fail(f"the {name} Function at {shape} disagrees with the plain "
                 f"composition: {out[name]}")
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
    stats = engine.stats
    want = {k: n * stats.batches_dispatched for k, n in SERVE_LAUNCHES.items()}
    if launches != want:
        fail(f"serve launches {launches} over {stats.batches_dispatched} "
             f"dispatches, expected {SERVE_LAUNCHES} per dispatch")
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
        "launches_per_dispatch": {
            k: v / stats.batches_dispatched for k, v in launches.items()
        },
    }
    return serve


def train_batch(rng, tasks=8):
    """Binary 28x28 episodes of 5 classes, 1 support and 1 target image
    each: ``(B, N, K, C, H, W)`` images and ``(B, N, K)`` labels."""
    xs = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    xt = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    ys = np.tile(np.arange(5).reshape(1, 5, 1), (tasks, 1, 1))
    return xs, xt, ys, ys.copy()


def train_phase(torch, fn):
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        load_maml_config,
    )
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import (
        tree_leaves,
        tree_map_with_path,
    )

    cfg = load_maml_config(FLAGSHIP, fused_norm_train=True, fused_norm_pool=True)
    cfg = dataclasses.replace(cfg, remat_inner_steps=False)
    learner = MAMLFewShotLearner(cfg)
    plain = MAMLFewShotLearner(dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, fused_norm_train=False, fused_norm_pool=False
    )))
    state0 = learner.init_state(torch.Generator().manual_seed(104))
    rng = np.random.RandomState(2)
    batch = train_batch(rng)
    learner.run_train_iter(state0, train_batch(rng), epoch=0)  # warm-up
    torch.cuda.synchronize()

    def run():
        state, losses, step_ms = state0, [], []
        for _ in range(TRAIN_ITERS):
            t0 = time.perf_counter()
            state, m = learner.run_train_iter(state, batch, epoch=0)
            losses.append(float(m["loss"]))  # synchronizes
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, step_ms

    fn.reset_launch_counts()
    state, losses, step_ms = run()
    launches = dict(fn.launch_counts)
    if launches != {k: n * TRAIN_ITERS for k, n in TRAIN_LAUNCHES.items()}:
        fail(f"train launches {launches} over {TRAIN_ITERS} iterations, "
             f"expected {TRAIN_LAUNCHES} per iteration")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    again, losses_again, _ = run()
    same = losses_again == losses and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(state))
    )
    if not same:
        fail(f"a rerun from the same state differs: {losses} vs {losses_again}")

    # The first step against the plain-norm learner on the same state.
    dbatch = learner._device_batch(state0, batch)
    importance = learner._importance(state0, learner._train_importance(0))
    fused_loss, _, _, fused_grads = learner._meta_grads(
        state0, dbatch, importance, second_order=True, final_only=False
    )
    plain_loss, _, _, plain_grads = plain._meta_grads(
        state0, dbatch, importance, second_order=True, final_only=False
    )
    loss_gap = abs(float(fused_loss) - float(plain_loss)) / abs(float(plain_loss))
    if loss_gap > TRAIN_LOSS_RTOL:
        fail(f"first loss {float(fused_loss)} vs plain {float(plain_loss)}")
    worst, routed = 0.0, []
    names = tree_leaves(tree_map_with_path(
        lambda p, a: None if a is None else "/".join(p), plain_grads
    ))
    for name, a, b in zip(names, tree_leaves(fused_grads), tree_leaves(plain_grads)):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        worst = max(worst, gap / (GRAD_ATOL + GRAD_RTOL * scale))
        if gap > GRAD_ATOL + GRAD_RTOL * scale:
            routed.append((name, gap, scale))
            print(f"[train] routing gap: {name} max|fused-plain| {gap:.3e} "
                  f"against max|plain| {scale:.3e}")
            if gap > ROUTING_RTOL * scale:
                fail(f"meta-gradient leaf {name} off by {gap} (max|plain| {scale})")

    # One past-horizon iteration: only the last step's target pass runs.
    fn.reset_launch_counts()
    learner.run_train_iter(state, batch, epoch=cfg.multi_step_loss_num_epochs)
    torch.cuda.synchronize()
    final_only_launches = dict(fn.launch_counts)  # one iteration

    _, vm, logits = learner.run_validation_iter(state, train_batch(rng))
    if logits.shape != (8, 5, 5) or not torch.isfinite(logits).all():
        fail(f"validation logits {tuple(logits.shape)} not finite")
    return {
        "iterations": TRAIN_ITERS,
        "meta_iters_per_s": TRAIN_ITERS / (sum(step_ms) / 1e3),
        "step_p50_ms": float(np.median(step_ms)),
        "step_ms": step_ms,
        "losses": losses,
        "rerun_bitwise_equal": same,
        "first_loss_rel_gap_vs_plain": loss_gap,
        "worst_grad_gap_over_tolerance": worst,
        "routing_gap_leaves": routed,
        "launches": launches,
        "launches_per_iter": {k: v / TRAIN_ITERS for k, v in launches.items()},
        "final_only_launches_per_iter": final_only_launches,
        "validation_loss": float(vm["loss"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def kernel_cells(res) -> str:
    """One shape's kernel times (graph, plain graph, bound, eager, plain
    eager) and, once for each plan, the launch plan."""
    cells, last_plan = [], None
    for k, v in res.items():
        if k == "pairs":
            continue
        plan = tuple(v["plan"].values())
        cells.append(
            f"{k}={v['ms']:.4f}/{v['plain_ms']:.4f}/{v['bound_ms']:.4f}"
            f"/{v['eager_ms']:.4f}/{v['eager_plain_ms']:.4f}"
            + ("" if plan == last_plan else f" plan {plan}")
        )
        last_plan = plan
    return " ".join(cells)


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
    big = (NORTH_STAR_SHAPE, NORTH_STAR_TARGET)
    for shape in FLAGSHIP_SHAPES + TRAIN_SHAPES + list(big):
        res = check_and_time_kernels(torch, fn, shape, gen, 20 if shape in big else 100)
        per_shape[shape] = res
        pairs = " ".join(f"{k}={v:.4f}" for k, v in res["pairs"].items())
        print(f"[kernels] {shape} ms graph/plain graph/bound/eager/plain eager "
              f"{kernel_cells(res)} | var_mean graph="
              f"{res['bn_stats']['library_ms']:.4f} | eager pairs {pairs}", flush=True)
    x, gamma, beta = _inputs(torch, STREAMED_SHAPE, gen)
    streamed = check_and_time_forward(torch, fn, x, gamma, beta, 20, streamed=True)
    g = torch.randn(STREAMED_SHAPE, device=x.device, generator=gen)
    streamed["bn_act_bwd"] = check_and_time_backward(
        torch, fn, x, gamma, beta, g, 20, streamed=True
    )
    print(f"[kernels] {STREAMED_SHAPE} streamed ms graph/plain graph/bound/eager/"
          f"plain eager {kernel_cells(streamed)} | var_mean graph="
          f"{streamed['bn_stats']['library_ms']:.4f}", flush=True)
    errs = {
        k: max(r[k]["max_abs_err"] for r in [*per_shape.values(), streamed] if k in r)
        for k in fn.KERNELS if k != "bn_act_pool_apply"
    }
    pool = {}
    for shape in POOL_SHAPES:
        pool[shape] = r = check_and_time_pool(
            torch, fn, shape, gen, 20 if shape == NORTH_STAR_SHAPE else 100
        )
        print(f"[pool] {shape} bn_act_pool_apply ms graph/plain graph/bound/"
              f"eager/plain eager {r['ms']:.4f}/{r['plain_ms']:.4f}/"
              f"{r['bound_ms']:.4f}/{r['eager_ms']:.4f}/{r['eager_plain_ms']:.4f}"
              f" max_abs_err {r['max_abs_err']:.3e}", flush=True)
    errs["bn_act_pool_apply"] = max(r["max_abs_err"] for r in pool.values())
    print(f"[kernels] max_abs_err over all shapes {errs}")
    functions = check_functions(torch, fn, gen)
    print(f"[functions] max_abs_err vs plain composition {json.dumps(functions)}",
          flush=True)

    # 3. serve
    serve = serve_phase(torch, fn)
    print(f"[serve] {json.dumps(serve)}", flush=True)

    # 4. train
    train = train_phase(torch, fn)
    print(f"[train] meta_iters_per_s {train['meta_iters_per_s']:.3f} step_p50_ms "
          f"{train['step_p50_ms']:.2f} | {json.dumps(train)}", flush=True)

    # 5. result: bn_stats_act and bn_act_bwd at the serve path's support stage-0
    # shape, its most launched and largest adapt shape; bn_stats and K5 at
    # the train path's stage 0, where they run together. Launches are those
    # of the serve run and the train run together.
    kernels = []
    for name in fn.KERNELS:
        if name == "bn_act_pool_apply":
            r = pool[POOL_SHAPES[0]]
        elif name == "bn_stats":
            r = per_shape[TRAIN_SHAPES[0]][name]
        else:
            r = per_shape[FLAGSHIP_SHAPES[0]][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "howtotrainyourmamlpytorch_tpu_torch/csrc/fused_norm.cu",
            "replaces": REPLACES[name],
            "launches": serve["launches"][name] + train["launches"][name],
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

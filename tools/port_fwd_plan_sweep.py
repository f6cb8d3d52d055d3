#!/usr/bin/env python3
"""Times the port's cluster kernels, the fused-norm forward (``bn_stats``
and ``bn_stats_act``) and backward (``bn_act_bwd``), under every launch
plan a shape can take, beside ``torch.var_mean``; or, given kernel sources,
the same plans under each source.

    python3 tools/port_fwd_plan_sweep.py [N,C,H,W ...]
    python3 tools/port_fwd_plan_sweep.py --source A.cu --source B.cu [N,C,H,W ...]

For each shape (by default the north-star stages and the flagship train and
serve stage 0) it times, by CUDA graph replay as ``chip_smoke.py`` does, the
plan ``fwd_plan`` picks, each staged cluster size whose slice fits a
block's shared memory, and the streamed path; then the same for the
backward (``bwd_plan``, staged plans of 8 bytes a row); and prints ms and
the byte bound.

With ``--source`` (two or more forms of ``csrc/fused_norm.cu`` with the
same C entries) it builds each, then for each shape times ``fwd_plan``'s
and ``bwd_plan``'s plans under the sources in order and again in reverse
(A B B A), so that drift on the card falls on both alike, and says whether
every source gave the same bits. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as fn  # noqa: E402

SHAPES = [(25, 96, 84, 84), (75, 96, 84, 84), (25, 96, 42, 42),
          (75, 96, 42, 42), (75, 96, 21, 21), (5, 512, 28, 28), (5, 256, 28, 28)]
FORWARD = ("bn_stats", "bn_stats_act")
BACKWARD = ("bn_act_bwd",)


def plans(x, backward: bool):
    """The plan the wrappers pick, each staged cluster size whose slice
    fits, and the streamed plan, all from the planner in
    ``ops/fused_norm.py``."""
    planned = fn.bwd_plan if backward else fn.fwd_plan
    row_bytes = fn.BWD_ROW_BYTES if backward else fn.FWD_ROW_BYTES
    rows = x.shape[0] * x.shape[2] * x.shape[3]
    out = {"auto": planned(x)}
    max_smem = fn._limits(x.device)[1]
    if rows > fn.WARP_ROWS:
        for k in fn.CLUSTER_SIZES:
            plan = fn._staged_plan(x.shape, k, row_bytes)
            if plan.smem_bytes <= max_smem:
                out[f"staged k{k}"] = plan
    out["streamed"] = planned(x, streamed=True)
    return out


def runnable(x, plan, names) -> bool:
    return all(fn._active_clusters(x.device, plan, n) > 0 for n in names)


def time_plan(x, gamma, beta, plan) -> tuple[float, float]:
    a = cs.graph_ms(torch, lambda: fn.bn_stats(x, plan=plan), 20, 20)
    b = cs.graph_ms(torch, lambda: fn.bn_stats_act(x, gamma, beta, plan=plan), 20, 20)
    return a, b


def time_bwd_plan(x, g, stats, gamma, beta, plan) -> float:
    return cs.graph_ms(
        torch, lambda: fn.bn_act_bwd(x, g, *stats, gamma, beta, plan=plan), 20, 20
    )


def inputs(shape, gen):
    """x, gamma, beta, a cotangent, and x's statistics."""
    x, gamma, beta = cs._inputs(torch, shape, gen)
    g = torch.randn(shape, device=x.device, generator=gen)
    return x, gamma, beta, g, fn.plain_stats(x)


def use_source(path: str) -> None:
    """Builds ``path`` if needed and makes it the library the wrappers call."""
    fn.SOURCE = os.path.abspath(path)
    fn._lib = None
    fn._device_limits.clear()
    fn._checked_plans.clear()
    fn._plans.clear()
    fn._load()


def sweep_plans(shapes, gen) -> None:
    for shape in shapes:
        x, gamma, beta, g, stats = inputs(shape, gen)
        b1, b2 = cs.bound_ms("bn_stats", shape)[0], cs.bound_ms("bn_stats_act", shape)[0]
        b3 = cs.bound_ms("bn_act_bwd", shape)[0]
        for name, plan in plans(x, backward=False).items():
            if not runnable(x, plan, FORWARD):
                print(f"{shape} {name} {tuple(plan)}: the card holds no cluster")
                continue
            a, b = time_plan(x, gamma, beta, plan)
            print(f"{shape} {name} {tuple(plan)} bn_stats {a:.4f} (bound {b1:.4f}) "
                  f"bn_stats_act {b:.4f} (bound {b2:.4f})", flush=True)
        for name, plan in plans(x, backward=True).items():
            if not runnable(x, plan, BACKWARD):
                print(f"{shape} backward {name} {tuple(plan)}: the card holds no cluster")
                continue
            t = time_bwd_plan(x, g, stats, gamma, beta, plan)
            print(f"{shape} backward {name} {tuple(plan)} bn_act_bwd {t:.4f} "
                  f"(bound {b3:.4f})", flush=True)
        vm = cs.graph_ms(torch, lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0), 20, 20)  # noqa: B023
        print(f"{shape} var_mean {vm:.4f}", flush=True)


def sweep_sources(sources, shapes, gen) -> None:
    for src in sources:
        fn.SOURCE = os.path.abspath(src)
        path, seconds, _ = fn.build()
        print(f"built {src} -> {os.path.relpath(path, REPO)} in {seconds:.1f} s")
    order = [*sources, *reversed(sources)]
    for shape in shapes:
        x, gamma, beta, g, stats = inputs(shape, gen)
        b1, b2 = cs.bound_ms("bn_stats", shape)[0], cs.bound_ms("bn_stats_act", shape)[0]
        b3 = cs.bound_ms("bn_act_bwd", shape)[0]
        outs = []
        for src in order:
            use_source(src)
            plan, bplan = fn.fwd_plan(x), fn.bwd_plan(x)
            if not (runnable(x, plan, FORWARD) and runnable(x, bplan, BACKWARD)):
                print(f"{shape} {src} {tuple(plan)} {tuple(bplan)}: the card "
                      "holds no cluster")
                continue
            outs.append((*fn.bn_stats_act(x, gamma, beta), *fn.bn_stats(x),
                         *fn.bn_act_bwd(x, g, *stats, gamma, beta)))
            a, b = time_plan(x, gamma, beta, plan)
            t = time_bwd_plan(x, g, stats, gamma, beta, bplan)
            print(f"{shape} {src} {tuple(plan)} bn_stats {a:.4f} (bound {b1:.4f}) "
                  f"bn_stats_act {b:.4f} (bound {b2:.4f}) | {tuple(bplan)} "
                  f"bn_act_bwd {t:.4f} (bound {b3:.4f})", flush=True)
        same = all(torch.equal(p, q) for o in outs[1:] for p, q in zip(outs[0], o))
        print(f"{shape} every source gave the same bits: {same}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="a form of csrc/fused_norm.cu; give two or more")
    ap.add_argument("shapes", nargs="*", help="N,C,H,W")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_fwd_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    shapes = [tuple(int(v) for v in a.split(",")) for a in args.shapes] or SHAPES
    print(f"device: {torch.cuda.get_device_name(0)} | {cs.gpu_line()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.source:
        sweep_sources(args.source, shapes, gen)
    else:
        fn.build()
        sweep_plans(shapes, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())

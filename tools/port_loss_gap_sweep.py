#!/usr/bin/env python3
"""How far the fused-norm learner's first train step lies from the
plain-norm learner's, batch by batch, with and without remat; and, with
``--oracle``, where the two float32 paths part, against a float64 oracle.

    python3 tools/port_loss_gap_sweep.py [--seeds 2 3 4 5 6 7]
    python3 tools/port_loss_gap_sweep.py --oracle [--oracle-device cuda|cpu]
        [--configs flagship north_star] [--seeds 3]

Sweep. For the Omniglot flagship (8 tasks of binary 28x28 images, the
batch ``chip_smoke.train_batch`` draws) and the mini-ImageNet north star
(2 tasks of random normalised 84x84 RGB images,
``chip_smoke.north_star_batch``), one batch per seed and one state (seed
104): the first second-order MSL step's loss of the learner with the three
fused flags and of the learner without them, each with
``remat_inner_steps`` off and on. Prints each loss, the fused-against-plain
relative gap and the remat-against-no-remat difference.

Oracle. On the batch of seed 3 at both widths (the flagship batch whose
fused-plain gap was 1.211e-4 on an H100, and the north-star batch that
showed 18 leaves over the gradient bar with remat): the same first step
composed in float64 from the port's plain ops (``ops/conv.py``,
``ops/fused_norm.plain_stats``/``plain_apply``, ``ops/pool.py``,
``ops/linear.py``, the log-softmax of ``ops/losses.nll`` without its
float32 cast), one task at a time, on the learner's converted weights. It
prints the error against the oracle of the first loss and of each
meta-gradient leaf for both float32 paths, then, for every norm call of the
inner loop (step, support or target set, stage): how far the two float32
paths' inputs lie apart and from the oracle's, the LeakyReLU signs on which
they disagree and the 2x2 pool windows whose first maximum they pick
differently, each with the oracle's distance from the tie (|pre| and the
gap between a window's two largest values, relative to the tensor's
largest). The float32 paths run remat off there (remat changes no bit,
which the sweep shows), so each call is recorded once. The first call
with a disagreement is where they part. Each call also gives both paths'
batch statistics against the float64 statistics of their own input. A
summary line per batch counts the disagreements before the paths' inputs
first lie 1e-5 apart and on which side float64 falls. Needs a CUDA device
for the float32 paths; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.models import backbone as backbone_mod  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.models.common import prepare_batch  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops.conv import conv2d  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops.linear import linear  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops.norm import step_row  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.ops.pool import max_pool2d  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import (  # noqa: E402
    tree_leaves,
    tree_map_with_path,
    tree_unflatten,
)

CONFIGS = {
    "flagship": (chip_smoke.FLAGSHIP, chip_smoke.train_batch),
    "north_star": (chip_smoke.NORTH_STAR, chip_smoke.north_star_batch),
}
ORACLE_SEED = 3
#: A relative gap between the two float32 paths' norm inputs above which
#: they no longer differ by rounding alone (rounding gives ~1e-6).
JUMP = 1e-5


def sweep(seeds) -> None:
    for tag, (config, make) in CONFIGS.items():
        learners = {
            (name, remat): type(base)(dataclasses.replace(base.cfg, remat_inner_steps=remat))
            for name, base in zip(("fused", "plain"), chip_smoke.fused_and_plain(config))
            for remat in (False, True)
        }
        state0 = learners["fused", False].init_state(torch.Generator().manual_seed(104))
        for seed in seeds:
            batch = make(np.random.RandomState(seed))
            loss = {key: float(chip_smoke.first_step(learner, state0, batch)[0])
                    for key, learner in learners.items()}
            cells = []
            for remat in (False, True):
                f, p = loss["fused", remat], loss["plain", remat]
                cells.append(f"remat {remat}: fused {f:.8f} plain {p:.8f} "
                             f"rel gap {abs(f - p) / abs(p):.3e}")
            moved = max(abs(loss[name, True] - loss[name, False])
                        for name in ("fused", "plain"))
            print(f"{tag} seed {seed}: " + " | ".join(cells)
                  + f" | remat moved a loss by {moved:.3e}", flush=True)
        del learners, state0
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The float64 oracle
# ---------------------------------------------------------------------------


def _nll64(logits, labels):
    """``ops/losses.nll`` without its float32 cast."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def oracle_forward(cfg, params, x, step, log):
    """One task's VGG forward in the dtype of ``params`` and ``x`` (N, C, H,
    W): conv, per-step batch norm on batch statistics, LeakyReLU, 2x2 max
    pool, linear head. Appends each stage's conv output and
    pre-activation to ``log``."""
    out = x
    for i in range(cfg.num_stages):
        stage = params[f"conv{i}"]
        out = conv2d(out, stage["conv"]["weight"], stage["conv"]["bias"],
                     stride=cfg.conv_stride, padding=cfg.conv_padding)
        gamma = step_row(stage["norm"]["gamma"], step)
        beta = step_row(stage["norm"]["beta"], step)
        mean, var = fused_norm.plain_stats(out)
        inv = torch.rsqrt(var + cfg.bn_eps)
        pre = (out - mean[None, :, None, None]) * inv[None, :, None, None]
        pre = pre * gamma[None, :, None, None] + beta[None, :, None, None]
        log.append({"x": out.detach(), "pre": pre.detach()})
        out = max_pool2d(torch.where(pre >= 0, pre, fused_norm.SLOPE * pre), 2, 2)
    features = out.reshape(out.shape[0], -1)
    return linear(features, params["linear"]["weight"], params["linear"]["bias"])


def oracle_first_step(learner, state, batch, device, dtype=torch.float64):
    """The first second-order MSL step's loss and meta-gradient, composed in
    ``dtype`` one task at a time from the plain ops, and each task's norm
    calls in the learner's order. Returns ``(loss, grads {"theta",
    "lslr"}, calls)``; ``calls[c]`` lists the tasks' records of call c."""
    cfg, bb = learner.cfg, learner.backbone.cfg
    steps = cfg.number_of_training_steps_per_iter
    importance = torch.from_numpy(learner._train_importance(0)).to(device, dtype)
    outer = {"theta": state.theta, "lslr": state.lslr}
    leaves = [a.detach().to(device, dtype).requires_grad_() for a in tree_leaves(outer)]
    outer = tree_unflatten(outer, leaves)
    mask = learner.adapt_mask(outer["theta"])
    xs, xt, ys, yt = (torch.from_numpy(np.asarray(a)).to(device)
                      for a in prepare_batch(batch, codec=cfg.wire_codec))
    xs, xt = xs.to(dtype), xt.to(dtype)
    task_losses, calls = [], []
    for t in range(xs.shape[0]):
        log: list = []
        fast = outer["theta"]
        t_losses = []
        for s in range(steps):
            loss = _nll64(oracle_forward(bb, fast, xs[t], s, log), ys[t]).mean()
            paths = [p for p, m in _flat_mask(mask) if m]
            adapt = [_get(fast, p) for p in paths]
            grads = torch.autograd.grad(loss, adapt, create_graph=True)
            for p, w, g in zip(paths, adapt, grads):
                fast = _set(fast, p, w - _get(outer["lslr"], p)[s] * g)
            t_losses.append(_nll64(oracle_forward(bb, fast, xt[t], s, log), yt[t]).mean())
        task_losses.append((importance * torch.stack(t_losses)).sum())
        for c, rec in enumerate(log):
            if t == 0:
                calls.append([])
            calls[c].append(rec)
    loss = torch.stack(task_losses).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten({"theta": state.theta, "lslr": state.lslr},
                                         grads), calls


def _flat_mask(mask, path=()):
    if isinstance(mask, dict):
        for k, v in mask.items():
            yield from _flat_mask(v, path + (k,))
    else:
        yield path, mask


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    """``tree`` with the leaf at ``path`` replaced (new dicts on the path)."""
    if not path:
        return value
    return {**tree, path[0]: _set(tree[path[0]], path[1:], value)}


class NormLog:
    """Records every norm call of the backbone while active: for the fused
    path its input, affine row and statistics (the pre-activation is then
    recomputed as the any-order backward recomputes it for its masks); for
    the plain path its input and pre-activation."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self.saved = {name: getattr(backbone_mod, name) for name in
                      ("fused_bn_leaky_relu_ho", "fused_bn_leaky_relu_pool",
                       "batch_norm")}

        def fused(op):
            def record(x, gamma, beta, eps, slope):
                y, mean, var = op(x, gamma, beta, eps, slope)
                b = lambda a: a.detach()[None, :, None, None]  # noqa: E731
                xhat = (x.detach() - b(mean)) * b(torch.rsqrt(var + eps))
                self.calls.append({"x": x.detach(), "pre": xhat * b(gamma) + b(beta),
                                   "mean": mean.detach(), "var": var.detach()})
                return y, mean, var
            return record

        def plain(x, *args, **kwargs):
            out, state = self.saved["batch_norm"](x, *args, **kwargs)
            # batch_norm's own statistics, recomputed the same way.
            var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
            self.calls.append({"x": x.detach(), "pre": out.detach(),
                               "mean": mean, "var": var})
            return out, state

        backbone_mod.fused_bn_leaky_relu_ho = fused(self.saved["fused_bn_leaky_relu_ho"])
        backbone_mod.fused_bn_leaky_relu_pool = fused(self.saved["fused_bn_leaky_relu_pool"])
        backbone_mod.batch_norm = plain
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(backbone_mod, name, fn)


def _fold(records):
    """The tasks' ``(N, C, H, W)`` records of one call as the learner's
    ``(N, T*C, H, W)``."""
    return {k: torch.cat([r[k] for r in records], dim=1) for k in records[0]}


def _windows(a):
    """``(..., 4)`` 2x2 windows of the floor-cropped activation."""
    n, c, h, w = a.shape
    a = a[:, :, : h // 2 * 2, : w // 2 * 2]
    return (a.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
            .reshape(n, c, h // 2, w // 2, 4))


def _act(pre):
    return torch.where(pre >= 0, pre, fused_norm.SLOPE * pre)


def stat_errors(r) -> tuple[float, float]:
    """A float32 path's batch statistics against the float64 statistics of
    its own input: ``max|mean - mean64| / std64`` (what moves a
    pre-activation's sign) and ``max|var - var64| / var64`` over the
    channels."""
    x = r["x"].double()
    var64, mean64 = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    return (float(((r["mean"].double() - mean64).abs() / var64.sqrt()).max()),
            float(((r["var"].double() - var64).abs() / var64).max()))


def compare_call(f, p, o) -> dict:
    """One norm call of the fused (f), plain (p) and oracle (o) runs."""
    o = {k: v.to(f["x"].device) for k, v in o.items()}
    scale_x = float(o["x"].abs().max())
    scale_pre = float(o["pre"].abs().max())
    out = {
        "x_fused_vs_plain": float((f["x"] - p["x"]).abs().max()) / scale_x,
        "x_fused_vs_oracle": float((f["x"].double() - o["x"]).abs().max()) / scale_x,
        "x_plain_vs_oracle": float((p["x"].double() - o["x"]).abs().max()) / scale_x,
    }
    (out["mean_err_fused"], out["var_err_fused"]) = stat_errors(f)
    (out["mean_err_plain"], out["var_err_plain"]) = stat_errors(p)
    flips = (f["pre"] >= 0) != (p["pre"] >= 0)
    out["sign_flips"] = int(flips.sum())
    if out["sign_flips"]:
        oracle_pre = o["pre"][flips]
        out["sign_flip_oracle_pre_max"] = float(oracle_pre.abs().max()) / scale_pre
        out["sign_flip_fused_agrees_with_oracle"] = int(
            ((f["pre"][flips] >= 0) == (oracle_pre >= 0)).sum()
        )
        out["sign_flip_plain_agrees_with_oracle"] = int(
            ((p["pre"][flips] >= 0) == (oracle_pre >= 0)).sum()
        )
    wf, wp, wo = (_windows(_act(r["pre"])) for r in (f, p, o))
    first_f, first_p = wf.argmax(-1), wp.argmax(-1)
    moved = first_f != first_p
    out["pool_flips"] = int(moved.sum())
    if out["pool_flips"]:
        top2 = wo[moved].topk(2, dim=-1).values
        scale_act = float(wo.abs().max())
        out["pool_flip_oracle_gap_max"] = float((top2[:, 0] - top2[:, 1]).max()) / scale_act
        first_o = wo.argmax(-1)[moved]
        out["pool_flip_fused_agrees_with_oracle"] = int((first_f[moved] == first_o).sum())
        out["pool_flip_plain_agrees_with_oracle"] = int((first_p[moved] == first_o).sum())
    return out


def leaf_errors(grads, oracle) -> list:
    """``(name, max|g - g_oracle|, that over the grad bar 1e-5 + 1e-3 *
    max|g_oracle|, max|g_oracle|)`` per meta-gradient leaf."""
    names = tree_leaves(tree_map_with_path(lambda p, a: "/".join(p), oracle))
    out = []
    for name, g, o in zip(names, tree_leaves(grads), tree_leaves(oracle)):
        o = o.to(g.device)
        scale = float(o.abs().max())
        err = float((g.double() - o).abs().max())
        out.append((name, err, err / (chip_smoke.GRAD_ATOL + chip_smoke.GRAD_RTOL * scale),
                    scale))
    return out


def oracle(configs, oracle_device, seeds) -> None:
    for tag in configs:
        config, make = CONFIGS[tag]
        fused_l, plain_l = (
            type(base)(dataclasses.replace(base.cfg, remat_inner_steps=False))
            for base in chip_smoke.fused_and_plain(config)
        )
        state0 = fused_l.init_state(torch.Generator().manual_seed(104))
        for seed in seeds:
            oracle_batch(tag, fused_l, plain_l, state0, make(np.random.RandomState(seed)),
                         seed, oracle_device)
        del fused_l, plain_l, state0
        torch.cuda.empty_cache()


def oracle_batch(tag, fused_l, plain_l, state0, batch, seed, oracle_device) -> None:
    """The oracle's lines for one batch, and its summary line: the
    errors, and the ties on which the two paths disagree before their
    inputs first lie JUMP apart, with which path sides with float64."""
    runs = {}
    for name, learner in (("fused", fused_l), ("plain", plain_l)):
        with NormLog() as log:
            loss, grads = chip_smoke.first_step(learner, state0, batch)
        runs[name] = (float(loss), grads, log.calls)
    o_loss, o_grads, o_calls = oracle_first_step(
        fused_l, state0, batch, torch.device(oracle_device)
    )
    o_loss = float(o_loss)
    loss_err = {n: abs(runs[n][0] - o_loss) / abs(o_loss) for n in runs}
    print(f"[oracle] {tag} seed {seed}: loss float64 {o_loss:.12f} | "
          + " | ".join(f"{n} {runs[n][0]:.8f} rel err {loss_err[n]:.3e}" for n in runs)
          + f" | fused-plain rel gap "
          f"{abs(runs['fused'][0] - runs['plain'][0]) / abs(runs['plain'][0]):.3e}",
          flush=True)
    over = {}
    for n in ("fused", "plain"):
        errs = leaf_errors(runs[n][1], o_grads)
        worst = max(errs, key=lambda e: e[2])
        over[n] = sum(e[2] > 1 for e in errs)
        print(f"[oracle] {tag} seed {seed} {n} meta-gradient against float64: "
              f"{over[n]} of {len(errs)} leaves over the grad bar; worst {worst[0]} "
              f"at {worst[2]:.3f} of the bar (max abs err {worst[1]:.3e}, "
              f"max|oracle| {worst[3]:.3e}); median "
              f"{float(np.median([e[2] for e in errs])):.3e} of the bar", flush=True)
    stages = fused_l.backbone.cfg.num_stages
    parted = jumped = None
    ties = {"flips": 0, "fused": 0, "plain": 0, "oracle_gap_max": 0.0}
    stats = {"mean_err_fused": 0.0, "mean_err_plain": 0.0,
             "var_err_fused": 0.0, "var_err_plain": 0.0}
    for c, (f, p) in enumerate(zip(runs["fused"][2], runs["plain"][2])):
        step, rest = divmod(c, 2 * stages)
        where = (f"step {step} {'support' if rest < stages else 'target'} "
                 f"stage {rest % stages} {tuple(f['x'].shape)}")
        cells = compare_call(f, p, _fold(o_calls[c]))
        print(f"[oracle] {tag} seed {seed} {where}: " + " ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in cells.items()), flush=True)
        if parted is None and (cells["sign_flips"] or cells["pool_flips"]):
            parted = where
        if jumped is None and cells["x_fused_vs_plain"] > JUMP:
            jumped = where
        if jumped is None:
            for kind in ("sign_flip", "pool_flip"):
                n = cells[f"{kind}s"]
                if n:
                    ties["flips"] += n
                    ties["fused"] += cells[f"{kind}_fused_agrees_with_oracle"]
                    ties["plain"] += cells[f"{kind}_plain_agrees_with_oracle"]
                    gap = cells.get(f"{kind}_oracle_pre_max",
                                    cells.get(f"{kind}_oracle_gap_max", 0.0))
                    ties["oracle_gap_max"] = max(ties["oracle_gap_max"], gap)
            for k in stats:
                stats[k] = max(stats[k], cells[k])
    print(f"[oracle] {tag} seed {seed}: the float32 paths first part at "
          f"{parted or 'no norm call (no sign or pool flip)'}; their inputs first "
          f"lie over {JUMP:.0e} apart at {jumped or 'no norm call'}", flush=True)
    print(f"[oracle] {tag} seed {seed} summary: loss rel err fused "
          f"{loss_err['fused']:.3e} plain {loss_err['plain']:.3e} | leaves over "
          f"the grad bar fused {over['fused']} plain {over['plain']} | before the "
          f"inputs part: {ties['flips']} flips, within {ties['oracle_gap_max']:.2e} "
          f"(relative) of a float64 tie; float64 sides with fused on "
          f"{ties['fused']}, plain on {ties['plain']} | statistics' error, max "
          "over those calls: " + " ".join(f"{k} {v:.2e}" for k, v in stats.items()),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=None,
                        help="batch seeds (sweep: 2-7; oracle: 3)")
    parser.add_argument("--oracle", action="store_true",
                        help="the float64 oracle and the parting point instead of the sweep")
    parser.add_argument("--oracle-device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS),
                        choices=list(CONFIGS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_loss_gap_sweep: no CUDA device", file=sys.stderr)
        return 1
    fused_norm.build()
    print(chip_smoke.gpu_line())
    if args.oracle:
        oracle(args.configs, args.oracle_device, args.seeds or [ORACLE_SEED])
    else:
        sweep(args.seeds or [2, 3, 4, 5, 6, 7])
    return 0


if __name__ == "__main__":
    sys.exit(main())

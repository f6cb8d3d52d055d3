#!/usr/bin/env python3
"""How far the fused-norm learner's first train step lies from the
plain-norm learner's, batch by batch, with and without remat.

    python3 tools/port_loss_gap_sweep.py [--seeds 2 3 4 5 6 7]

For the Omniglot flagship (8 tasks of binary 28x28 images, the batch
``chip_smoke.train_batch`` draws) and the mini-ImageNet north star (2 tasks
of random normalised 84x84 RGB images, ``chip_smoke.north_star_batch``),
one batch per seed and one state (seed 104): the first second-order MSL
step's loss of the learner with the three fused flags and of the learner
without them, each with ``remat_inner_steps`` off and on. Prints each
loss, the fused-against-plain relative gap and the remat-against-no-remat
difference. The two versions' batch statistics differ in rounding, and
where a LeakyReLU input or two max-pool candidates lie within rounding of
each other they route the inner gradient differently; five inner steps
carry that into the loss. Needs a CUDA device; imports nothing of JAX.
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
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4, 5, 6, 7])
    seeds = parser.parse_args().seeds
    if not torch.cuda.is_available():
        print("port_loss_gap_sweep: no CUDA device", file=sys.stderr)
        return 1
    fused_norm.build()
    print(chip_smoke.gpu_line())
    for tag, config, make in (
        ("flagship", chip_smoke.FLAGSHIP, chip_smoke.train_batch),
        ("north_star", chip_smoke.NORTH_STAR, chip_smoke.north_star_batch),
    ):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The tensor-parallel meta-update against one process's in float64, where
rounding cannot hide a layout fault.

    python3 tools/port_tp_float64.py [--filters 64] [--steps 3] [--float32]

Two gloo ranks on the CPU at dp x mp = 1 x 2 (this script started once per
rank) and one process take ``--steps`` second-order MSL meta-updates of the
Omniglot flagship learner (``experiment_config/omniglot_maml++-omniglot_1_8_
0.1_64_5_0.json`` at ``--filters`` filters, plain norm as in
``chip_smoke.py``'s float64 check, seed-104 weights) on the binary episodes
``chip_smoke.train_batch`` draws (seed 2).
The state, the importance vector and the images are float64; the learner's
batch decode, which casts images to the float32 compute dtype, is bypassed,
so the whole step runs in float64 (``chip_smoke.steps_in_dtype``). Prints
each process's loss per meta-update and the worst gap of rank 0's
gathered state and losses over ``chip_smoke``'s F64 bars, for the tp
step and for the tp step under a planted fault (replicated gradients
unsummed). ``--float32`` runs the same in float32, where the flagship's
binary images tie pool windows and LeakyReLU inputs and the two parts
apart by rounding. Takes a few minutes at 64 filters.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json")


def run_rank(rank: int, address: str, args) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.parallel import initialize_distributed, make_mesh
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

    dtype = torch.float32 if args.float32 else torch.float64
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    if not initialize_distributed(address, 2, rank, 600.0, cpu=True):
        raise SystemExit("the rank did not join its group")
    mesh = make_mesh(model_parallel=2, device="cpu")
    cfg = load_maml_config(FLAGSHIP, cnn_num_filters=args.filters, use_pallas_fused_norm=False,
                           fused_norm_train=False, fused_norm_pool=False)
    rng = np.random.RandomState(2)
    batches = [chip_smoke.train_batch(rng) for _ in range(args.steps)]
    init = lambda learner: learner.init_state(torch.Generator().manual_seed(104), "cpu")  # noqa: E731
    one, tp = MAMLFewShotLearner(cfg), MAMLFewShotLearner(cfg, mesh=mesh)
    runs = {}
    for name, plant in (("tp", contextlib.nullcontext()),
                        ("planted", chip_smoke.unsummed_replicated_gradients())):
        with plant:
            blocks, losses = chip_smoke.steps_in_dtype(tp, tp.replicate(init(tp)), batches, dtype)
        runs[name] = (tp.gather_state(blocks), losses)
    if rank == 0:
        whole, one_losses = chip_smoke.steps_in_dtype(one, init(one), batches, dtype)
        gaps = {name: chip_smoke.tp_float64_gaps(*run, whole, one_losses)
                for name, run in runs.items()}
        print(f"{dtype} {args.filters} filters, {args.steps} meta-updates: losses one "
              f"process {one_losses}, tp rank 0 {runs['tp'][1]}; worst gap over the F64 "
              f"bars {gaps['tp']}; with the planted fault (replicated gradients "
              f"unsummed) {gaps['planted']}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--filters", type=int, default=64)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--float32", action="store_true")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        run_rank(args.rank, args.address, args)
        return 0
    sys.path.insert(0, REPO)
    from howtotrainyourmamlpytorch_tpu_torch.parallel.distributed import find_free_port

    address = f"127.0.0.1:{find_free_port()}"
    argv = [sys.executable, os.path.abspath(__file__), "--filters", str(args.filters),
            "--steps", str(args.steps), "--address", address,
            *(["--float32"] if args.float32 else [])]
    procs = [subprocess.Popen([*argv, "--rank", str(rank)]) for rank in (0, 1)]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())

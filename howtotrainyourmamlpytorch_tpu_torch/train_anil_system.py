"""ANIL entry point of the port (``train_anil_system.py``): MAML's outer
loop with the inner loop restricted to the classifier head.

    DATASET_DIR=<datasets> python3 -m howtotrainyourmamlpytorch_tpu_torch.train_anil_system \\
        --name_of_args_json_file experiment_config/<maml config>.json \\
        [--use_pallas_fused_norm True --fused_norm_train True --fused_norm_pool True]

Runs on the card, with ``--iters_per_dispatch`` and the train step as a CUDA
graph as for MAML.
"""

from __future__ import annotations

import sys

from .models import ANILLearner
from .train_maml_system import run


def main(argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names; returns
    the ensemble's test losses. Raises without a CUDA device."""
    return run(lambda cfg, args, mesh: ANILLearner(cfg, mesh=mesh), argv)


if __name__ == "__main__":
    main(sys.argv[1:])

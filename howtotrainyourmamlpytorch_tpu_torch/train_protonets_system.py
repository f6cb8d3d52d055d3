"""Prototypical-networks entry point of the port
(``train_protonets_system.py``): class-mean prototypes of the support
embeddings and squared-distance logits, no inner loop.

    DATASET_DIR=<datasets> python3 -m howtotrainyourmamlpytorch_tpu_torch.train_protonets_system \\
        --name_of_args_json_file experiment_config/<maml config>.json \\
        [--use_pallas_fused_norm True --fused_norm_train True --fused_norm_pool True]

Runs on the card.
"""

from __future__ import annotations

import sys

from .models import ProtoNetsLearner
from .train_maml_system import run


def main(argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names; returns
    the ensemble's test losses. Raises without a CUDA device."""
    return run(lambda cfg, args, mesh: ProtoNetsLearner(cfg), argv)


if __name__ == "__main__":
    main(sys.argv[1:])

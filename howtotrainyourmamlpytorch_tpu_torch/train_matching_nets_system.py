"""Matching-networks baseline entry point of the port
(``train_matching_nets_system.py``): cosine attention over the support
embeddings, one Adam update a task.

    DATASET_DIR=<datasets> python3 -m howtotrainyourmamlpytorch_tpu_torch.train_matching_nets_system \\
        --name_of_args_json_file experiment_config/omniglot_matching-nets-omniglot_1_8_0.1_64_5_1.json \\
        [--parity_bug True] [--use_pallas_fused_norm True --fused_norm_train True --fused_norm_pool True]

Runs on the card. ``--parity_bug True`` reproduces the reference's head bug
for bug.
"""

from __future__ import annotations

import sys

from .models import MatchingNetsLearner
from .train_maml_system import run


def main(argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names; returns
    the ensemble's test losses. Raises without a CUDA device."""
    return run(
        lambda cfg, args, mesh: MatchingNetsLearner(cfg, parity_bug=bool(args.parity_bug)),
        argv,
    )


if __name__ == "__main__":
    main(sys.argv[1:])

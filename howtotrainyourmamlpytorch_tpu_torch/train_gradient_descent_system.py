"""Gradient-descent (transfer) baseline entry point of the port
(``train_gradient_descent_system.py``): every task fine-tunes the shared
weights with Adam, task after task, in training and in evaluation.

    DATASET_DIR=<datasets> python3 -m howtotrainyourmamlpytorch_tpu_torch.train_gradient_descent_system \\
        --name_of_args_json_file experiment_config/omniglot_gradient-descent-omniglot_1_8_0.1_64_5_1.json \\
        [--use_pallas_fused_norm True --fused_norm_train True --fused_norm_pool True]

Runs on the card; ``--iters_per_dispatch`` has no effect (one batch a
learner call), as in the JAX package.
"""

from __future__ import annotations

import sys

from .models import GradientDescentLearner
from .train_maml_system import run


def main(argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names; returns
    the ensemble's test losses. Raises without a CUDA device."""
    return run(lambda cfg, args, mesh: GradientDescentLearner(cfg), argv)


if __name__ == "__main__":
    main(sys.argv[1:])

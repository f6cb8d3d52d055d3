"""MAML/MAML++ training entry point of the port (``train_maml_system.py``):
args -> learner -> dataset bootstrap -> ExperimentBuilder ->
run_experiment, on the card.

    DATASET_DIR=<datasets> python3 -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system \\
        --name_of_args_json_file experiment_config/<cfg>.json \\
        [--use_pallas_fused_norm True --fused_norm_train True --fused_norm_pool True]

The experiment configs run unchanged; the run writes
``<experiment_name>/{saved_models,logs}``, resumes from ``latest`` by
default, and ends with the top-5 ensemble test.
"""

from __future__ import annotations

import sys

from .data import MetaLearningSystemDataLoader
from .experiment_builder import ExperimentBuilder
from .models import MAMLFewShotLearner
from .utils.dataset_tools import maybe_unzip_dataset
from .utils.parser_utils import args_to_maml_config, get_args


def run(make_learner, argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names with the
    learner ``make_learner(cfg, args)`` builds; returns the ensemble's test
    losses. Raises without a CUDA device."""
    args, device = get_args(argv)
    model = make_learner(args_to_maml_config(args), args)
    maybe_unzip_dataset(args)
    system = ExperimentBuilder(
        model=model, data=MetaLearningSystemDataLoader, args=args, device=device
    )
    return system.run_experiment()


def main(argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names; returns
    the ensemble's test losses. Raises without a CUDA device."""
    return run(lambda cfg, args: MAMLFewShotLearner(cfg), argv)


if __name__ == "__main__":
    main(sys.argv[1:])

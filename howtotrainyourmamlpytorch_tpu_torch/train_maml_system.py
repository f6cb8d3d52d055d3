"""MAML/MAML++ training entry point of the port (``train_maml_system.py``):
args -> learner -> dataset bootstrap -> ExperimentBuilder ->
run_experiment, on the card.

    DATASET_DIR=<datasets> python3 -m howtotrainyourmamlpytorch_tpu_torch.train_maml_system \\
        --name_of_args_json_file experiment_config/<cfg>.json \\
        [--use_pallas_fused_norm True --fused_norm_train True --fused_norm_pool True]

The experiment configs run unchanged; the run writes
``<experiment_name>/{saved_models,logs}``, resumes from ``latest`` by
default, and ends with the top-5 ensemble test.

A fleet is one such process per rank, each with ``--coordinator_address
host:port --num_processes N --process_id k`` (the dispatcher's
``--num_processes N`` starts them); each joins the process group before it
picks its card, trains on its dp index's slice of the tasks, and rank 0
alone writes the checkpoints and the summaries. With
``--model_parallel_devices M`` the N ranks are N/M mp groups of M
consecutive ranks, each rank holding one channel block of the sharded
parameters (``parallel/sharding.py``); the step runs eagerly there.
"""

from __future__ import annotations

import sys

from .data import MetaLearningSystemDataLoader
from .experiment_builder import ExperimentBuilder
from .models import MAMLFewShotLearner
from .parallel.distributed import initialize_distributed_from_argv, shutdown_distributed
from .parallel.mesh import default_mesh_from_args
from .utils.dataset_tools import maybe_unzip_dataset
from .utils.parser_utils import args_to_maml_config, get_args


def run(make_learner, argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names with the
    learner ``make_learner(cfg, args, mesh)`` builds (``mesh``: the dp x mp
    layout of a fleet, else None); returns the ensemble's test losses.
    Raises without a CUDA device."""
    argv = list(sys.argv[1:] if argv is None else argv)
    # Before the device is picked, as in the JAX entry points.
    initialize_distributed_from_argv(argv)
    try:
        args, device = get_args(argv)
        mesh = default_mesh_from_args(args, device)
        model = make_learner(args_to_maml_config(args), args, mesh)
        maybe_unzip_dataset(args)
        system = ExperimentBuilder(
            model=model, data=MetaLearningSystemDataLoader, args=args, device=device
        )
        return system.run_experiment()
    finally:
        shutdown_distributed()


def main(argv=None) -> dict:
    """Trains, validates and tests the experiment ``argv`` names; returns
    the ensemble's test losses. Raises without a CUDA device."""
    return run(lambda cfg, args, mesh: MAMLFewShotLearner(cfg, mesh=mesh), argv)


if __name__ == "__main__":
    main(sys.argv[1:])

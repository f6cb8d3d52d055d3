"""The training CLI's feedback run in the port against the JAX package's,
on the CPU: both builders start from one JAX ``train_model_0`` and train 2
epochs of 2 second-order iterations on a replay manifest (every 2nd train
episode slot a mined seed), their loaders on the ``process`` backend (the
port's spawned, the JAX package's forked) with the class stores preloaded.
Their per-epoch losses agree at the CLI bar and their train episodes are
the same; a rollback that re-enters the train loop closes each spawned
loader and unlinks its shared blocks."""

import json
import shutil
from multiprocessing import shared_memory

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.data import MetaLearningSystemDataLoader as JLoader
from howtotrainyourmamlpytorch_tpu.experiment_builder import ExperimentBuilder as JBuilder
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import save_checkpoint
from howtotrainyourmamlpytorch_tpu.utils.parser_utils import (
    args_to_maml_config as j_args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import args_to_maml_config

from test_data import make_dataset_dir
from test_experiment import _experiment_args
from test_torch_train import one_intra_op_thread  # noqa: F401

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
EPOCHS, ITERS = 2, 2


def _args(tmp, name, **overrides):
    args = _experiment_args(tmp)
    args.experiment_name = str(tmp / name)
    args.second_order = True
    args.continue_from_epoch = 0
    args.watchdog = False
    args.total_epochs = EPOCHS
    args.total_iter_per_epoch = ITERS
    args.load_into_memory = True
    args.dataprovider_backend = "process"
    args.replay_manifest = str(tmp / "replay_manifest.json")
    args.replay_every = 2
    for key, value in overrides.items():
        setattr(args, key, value)
    return args


def _stats(tmp, name):
    with open(tmp / name / "logs" / "summary_statistics.json") as f:
        return json.load(f)


class _Recorded(MetaLearningSystemDataLoader):
    """The port's loader, each instance kept with the names of its blocks."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _Recorded.made.append(
            (self, [block.name for block in self._spawned.stores.blocks]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replay")
    make_dataset_dir(tmp / "omniglot_mini")
    (tmp / "replay_manifest.json").write_text(json.dumps({
        "schema": 1, "source": "test", "learner": "maml",
        "episodes": [{"seed": s, "margin": 0.1} for s in (4242, 77, 31337)],
    }))
    env = pytest.MonkeyPatch()
    env.setenv("DATASET_DIR", str(tmp))
    try:
        jargs = _args(tmp, "jax")
        seed = tmp / "jax" / "saved_models" / "train_model_0"
        seed.parent.mkdir(parents=True)
        save_checkpoint(str(seed),
                        JLearner(j_args_to_maml_config(jargs)).init_state(
                            jax.random.PRNGKey(104)),
                        {"best_val_acc": 0.0, "best_val_iter": 0, "current_iter": 0})
        for name in ("port", "rollback"):
            (tmp / name / "saved_models").mkdir(parents=True)
            shutil.copyfile(seed, tmp / name / "saved_models" / "train_model_0")
        JBuilder(args=jargs, data=JLoader, model=JLearner(j_args_to_maml_config(jargs)),
                 device=None).run_experiment()
        args = _args(tmp, "port")
        ExperimentBuilder(args=args, data=MetaLearningSystemDataLoader,
                          model=MAMLFewShotLearner(args_to_maml_config(args)),
                          device="cpu").run_experiment()
        faultinject.activate(faultinject.FaultPlan(nan_at_iter=2))
        try:
            args = _args(tmp, "rollback", on_nonfinite="rollback")
            ExperimentBuilder(args=args, data=_Recorded,
                              model=MAMLFewShotLearner(args_to_maml_config(args)),
                              device="cpu").run_experiment()
            rollback_events = list(faultinject.events)
        finally:
            faultinject.reset()
        yield dict(tmp=tmp, jax=_stats(tmp, "jax"), port=_stats(tmp, "port"),
                   rollback_events=rollback_events)
    finally:
        env.undo()


@pytest.mark.parametrize("phase", ["train", "val"])
def test_manifest_run_losses_match_the_jax_cli(runs, phase):
    port = np.asarray(runs["port"][f"{phase}_loss_mean"])
    assert len(port) == EPOCHS and np.all(np.isfinite(port))
    np.testing.assert_allclose(port, runs["jax"][f"{phase}_loss_mean"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_manifest_run_trains_on_the_mined_episodes(runs):
    """The episodes the run's loader draws: every 2nd global slot a mined
    seed, the same in both packages' loaders."""
    args = _args(runs["tmp"], "probe")
    port, jax_ = MetaLearningSystemDataLoader(args), JLoader(args)
    try:
        seeds = np.concatenate(
            [b[4] for b in port.get_train_batches(total_batches=EPOCHS * ITERS)])
        jax_seeds = np.concatenate(
            [b[4] for b in jax_.get_train_batches(total_batches=EPOCHS * ITERS)])
    finally:
        port.close()
        jax_._pool.shutdown(wait=True)
    np.testing.assert_array_equal(seeds, jax_seeds)
    assert list(seeds[1::2]) == [4242, 77, 31337, 4242][: len(seeds[1::2])]


def test_rollback_closes_each_spawned_loader_and_unlinks_its_blocks(runs):
    assert runs["rollback_events"] == ["nan:2"]
    assert len(_Recorded.made) >= 2, "the rollback did not re-enter the train loop"
    for made, names in _Recorded.made:
        assert made._spawned.closed
        for name in names:
            with pytest.raises(FileNotFoundError):
                shared_memory.SharedMemory(name=name)
    stats = _stats(runs["tmp"], "rollback")
    assert np.all(np.isfinite(stats["train_loss_mean"]))

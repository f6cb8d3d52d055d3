"""``--on_nonfinite rollback`` in the port's builder against the JAX
builder's, on the CPU, both from one JAX ``train_model_0``: a NaN batch at
the first iteration of epoch 2 poisons the state, the epoch boundary's
sentinel trips (2 iterations), both reload epoch 1's checkpoint, move the
loader past the trip and replay. The restored iteration, the rollback and
trip counts and the epoch losses (the CLI bar: rtol 1e-4, atol 1e-5) are
the JAX run's; the budget of ``MAX_ROLLBACKS_PER_RUN`` holds."""

import json
import shutil

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.experiment_builder import (
    MAX_ROLLBACKS_PER_RUN as JAX_MAX_ROLLBACKS,
)
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.utils import faultinject as jfi
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import save_checkpoint
from howtotrainyourmamlpytorch_tpu.utils.parser_utils import (
    args_to_maml_config as j_args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch import experiment_builder as port_builder
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import args_to_maml_config

from test_data import make_dataset_dir
from test_faultinject import _builder as jax_builder
from test_faultinject import _exp_args

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5


def _args(tmp, name, **overrides):
    overrides = {"continue_from_epoch": 0, **overrides}
    return _exp_args(tmp, name, on_nonfinite="rollback", watchdog=False, **overrides)


def _stats(tmp, name):
    with open(tmp / name / "logs" / "summary_statistics.json") as f:
        return json.load(f)


def _state(tmp, name, idx):
    with np.load(tmp / name / "saved_models" / f"train_model_{idx}") as z:
        return json.loads(bytes(z["__experiment_state__"]).decode())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rollback")
    make_dataset_dir(tmp / "omniglot_mini")
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
        (tmp / "port" / "saved_models").mkdir(parents=True)
        shutil.copyfile(seed, tmp / "port" / "saved_models" / "train_model_0")
        jfi.activate(jfi.FaultPlan(nan_at_iter=2))
        jax_builder(jargs).run_experiment()
        faultinject.activate(faultinject.FaultPlan(nan_at_iter=2))
        args = _args(tmp, "port")
        port = port_builder.ExperimentBuilder(
            args=args, data=MetaLearningSystemDataLoader,
            model=MAMLFewShotLearner(args_to_maml_config(args)), device="cpu")
        port.run_experiment()
        assert faultinject.events == jfi.events == ["nan:2"]
        yield tmp
    finally:
        faultinject.reset()
        jfi.reset()
        env.undo()


def test_the_rollback_restores_and_counts_as_jax(runs):
    rollbacks = {}
    for name in ("jax", "port"):
        (event,) = [e for e in events.read_events(
            str(runs / name / "logs" / "telemetry.jsonl")) if e["type"] == "rollback"]
        rollbacks[name] = {k: event[k] for k in ("trip_iter", "restored_iter", "trips",
                                                 "rollbacks_this_run")}
        state = _state(runs, name, 2)
        assert state["current_iter"] == 4
        assert state["nonfinite_rollbacks"] == 1
        assert state["nonfinite_trips_total"] == 2.0
    assert rollbacks["port"] == rollbacks["jax"] == {
        "trip_iter": 4, "restored_iter": 2, "trips": 2.0, "rollbacks_this_run": 1}
    assert port_builder.MAX_ROLLBACKS_PER_RUN == JAX_MAX_ROLLBACKS


@pytest.mark.parametrize("phase", ["train", "val"])
def test_epoch_losses_after_the_rollback_match_the_jax_cli(runs, phase):
    jax_stats, port_stats = _stats(runs, "jax"), _stats(runs, "port")
    assert len(port_stats[f"{phase}_loss_mean"]) == 2
    np.testing.assert_allclose(port_stats[f"{phase}_loss_mean"],
                               jax_stats[f"{phase}_loss_mean"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert np.isfinite(port_stats[f"{phase}_loss_mean"]).all()


def test_one_csv_row_an_epoch(runs):
    for name in ("jax", "port"):
        with open(runs / name / "logs" / "summary_statistics.csv") as f:
            assert len(f.read().splitlines()) == 2  # resumed from epoch 0: no header


def test_the_rollback_budget_halts(runs, monkeypatch):
    """Past ``MAX_ROLLBACKS_PER_RUN`` rollbacks a process halts with
    ``NonFiniteLossError``, as the JAX builder does."""
    monkeypatch.setenv("DATASET_DIR", str(runs))
    args = _args(runs, "port", continue_from_epoch="latest")
    builder = port_builder.ExperimentBuilder(
        args=args, data=MetaLearningSystemDataLoader,
        model=MAMLFewShotLearner(args_to_maml_config(args)), device="cpu")
    try:
        builder._rollbacks_this_run = port_builder.MAX_ROLLBACKS_PER_RUN
        with pytest.raises(port_builder.NonFiniteLossError, match="rolled back"):
            builder._perform_rollback(port_builder._RollbackSignal(4, 1.0))
    finally:
        builder.data.close()

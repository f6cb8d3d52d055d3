"""The port's experiment runtime against the JAX package's, end to end on
the CPU (float32).

Both builders start from the same JAX ``init_state(PRNGKey(104))``, written
as ``saved_models/train_model_0`` by the JAX ``save_checkpoint`` (the port
reads the JAX archive), and run ``continue_from_epoch=0`` for 3 epochs of 2
second-order MAML++ iterations with a validation epoch each, on the
synthetic Omniglot tree of ``tests/test_data.make_dataset_dir``. Their
per-epoch statistics (``logs/summary_statistics.json``) are compared, and
the port's last checkpoint is loaded by the JAX learner.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.data import (
    MetaLearningSystemDataLoader as JLoader,
)
from howtotrainyourmamlpytorch_tpu.experiment_builder import (
    ExperimentBuilder as JBuilder,
)
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import save_checkpoint
from howtotrainyourmamlpytorch_tpu.utils.parser_utils import (
    args_to_maml_config as j_args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
    args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from test_data import make_dataset_dir
from test_experiment import _experiment_args
from test_torch_train import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The train slice's bar (tests/test_torch_train.py).
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
THETA_RTOL, THETA_ATOL = 1e-3, 1e-5
EPOCHS, ITERS = 3, 2
# Wall-clock columns of the summary (TrainTelemetry.epoch_stats): no two
# runs share them.
TIMING = ("_step_time_p", "_data_wait_p", "_stage_wait_p")


def _timed(key):
    return any(part in key for part in TIMING)


def _args(tmp_path, name, **overrides):
    args = _experiment_args(tmp_path)
    args.experiment_name = str(tmp_path / name)
    args.second_order = True
    args.continue_from_epoch = 0
    args.watchdog = False
    for key, value in overrides.items():
        setattr(args, key, value)
    return args


def _seed_checkpoint(tmp_path, name):
    """The JAX learner's initial state as ``<name>/saved_models/
    train_model_0``."""
    args = _args(tmp_path, name)
    learner = JLearner(j_args_to_maml_config(args))
    saved = tmp_path / name / "saved_models"
    saved.mkdir(parents=True, exist_ok=True)
    save_checkpoint(
        str(saved / "train_model_0"),
        learner.init_state(jax.random.PRNGKey(104)),
        {"best_val_acc": 0.0, "best_val_iter": 0, "current_iter": 0},
    )
    return saved / "train_model_0"


def _stats(tmp_path, name):
    with open(tmp_path / name / "logs" / "summary_statistics.json") as f:
        return json.load(f)


def _run_port(tmp_path, name, **overrides):
    args = _args(tmp_path, name, **overrides)
    builder = ExperimentBuilder(
        args=args, data=MetaLearningSystemDataLoader,
        model=MAMLFewShotLearner(args_to_maml_config(args)), device="cpu",
    )
    return builder, builder.run_experiment()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, the port's run, and the port's run paused after each
    epoch and resumed, from one starting checkpoint."""
    tmp_path = tmp_path_factory.mktemp("cli")
    make_dataset_dir(tmp_path / "omniglot_mini")
    env = pytest.MonkeyPatch()
    env.setenv("DATASET_DIR", str(tmp_path))
    try:
        seed = _seed_checkpoint(tmp_path, "jax")
        for name in ("port", "paused"):
            (tmp_path / name / "saved_models").mkdir(parents=True)
            shutil.copyfile(seed, tmp_path / name / "saved_models" / "train_model_0")

        jargs = _args(tmp_path, "jax")
        JBuilder(
            args=jargs, data=JLoader,
            model=JLearner(j_args_to_maml_config(jargs)), device=None,
        ).run_experiment()
        builder, test_losses = _run_port(tmp_path, "port")

        # Paused after every epoch, resumed from latest each time; the
        # checkpoints written on the loop's thread (checkpoint_async off).
        with pytest.raises(SystemExit):
            _run_port(tmp_path, "paused", total_epochs_before_pause=1,
                      checkpoint_async=False)
        for _ in range(EPOCHS - 1):
            try:
                _run_port(tmp_path, "paused", total_epochs_before_pause=1,
                          continue_from_epoch="latest", checkpoint_async=False)
            except SystemExit:
                pass
        yield dict(tmp_path=tmp_path, jax=_stats(tmp_path, "jax"),
                   port=_stats(tmp_path, "port"),
                   paused=_stats(tmp_path, "paused"), builder=builder,
                   test_losses=test_losses)
    finally:
        env.undo()


@pytest.mark.parametrize("phase", ["train", "val"])
def test_per_epoch_losses_match_the_jax_cli(runs, phase):
    jax_loss = np.asarray(runs["jax"][f"{phase}_loss_mean"])
    port_loss = np.asarray(runs["port"][f"{phase}_loss_mean"])
    assert len(port_loss) == EPOCHS
    np.testing.assert_allclose(port_loss, jax_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_per_epoch_accuracy_within_one_target_example(runs, phase):
    """An epoch's accuracy mean averages ``batches x tasks x 5`` target
    examples; a LeakyReLU or argmax routing flip moves one of them."""
    args = _args(runs["tmp_path"], "port")
    batches = ITERS if phase == "train" else args.num_evaluation_tasks // args.batch_size
    one_example = 1.0 / (batches * args.batch_size * args.num_classes_per_set)
    jax_acc = np.asarray(runs["jax"][f"{phase}_accuracy_mean"])
    port_acc = np.asarray(runs["port"][f"{phase}_accuracy_mean"])
    for epoch, (a, b) in enumerate(zip(port_acc, jax_acc)):
        if a != b:
            print(f"{phase} epoch {epoch}: accuracy {a} against JAX {b}")
    assert np.all(np.abs(port_acc - jax_acc) <= one_example + 1e-6)


def test_port_checkpoint_loads_in_the_jax_learner(runs):
    """The port's ``train_model_3`` through the JAX ``load_model``; theta
    against the JAX run's own ``train_model_3``."""
    tmp_path = runs["tmp_path"]
    jargs = _args(tmp_path, "jax")
    jlearner = JLearner(j_args_to_maml_config(jargs))
    port_state, port_exp = jlearner.load_model(
        str(tmp_path / "port" / "saved_models"), "train_model", 3
    )
    jax_state, _ = jlearner.load_model(
        str(tmp_path / "jax" / "saved_models"), "train_model", 3
    )
    assert port_exp["current_iter"] == EPOCHS * ITERS
    assert int(port_state.iteration) == EPOCHS * ITERS
    paths = jax.tree_util.tree_flatten_with_path(port_state.theta)[0]
    for (path, got), want in zip(paths, jax.tree.leaves(jax_state.theta)):
        got, want = np.asarray(got), np.asarray(want)
        name = jax.tree_util.keystr(path)
        if name.endswith("['conv']['bias']"):
            # A conv bias before batch norm has a zero true gradient: Adam
            # moves it by at most meta_lr a step on rounding noise.
            atol = 2 * EPOCHS * ITERS * jargs.meta_learning_rate
            np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=THETA_RTOL,
                                       atol=THETA_ATOL, err_msg=name)


def test_pause_and_resume_gives_the_unpaused_statistics(runs):
    assert set(runs["paused"]) == set(runs["port"])
    for key, values in runs["port"].items():
        if not _timed(key):
            np.testing.assert_array_equal(runs["paused"][key], values, err_msg=key)
    saved = runs["tmp_path"] / "paused" / "saved_models"
    assert os.path.samefile(saved / "train_model_latest", saved / f"train_model_{EPOCHS}")
    assert (saved / f"train_model_{EPOCHS}.ready").exists()


def test_outputs_of_the_port_run(runs):
    logs = runs["tmp_path"] / "port" / "logs"
    saved = runs["tmp_path"] / "port" / "saved_models"
    with open(logs / "summary_statistics.csv") as f:
        assert len(f.read().splitlines()) == EPOCHS  # no header: epoch 0 resume
    assert 0.0 <= runs["test_losses"]["test_accuracy_mean"] <= 1.0
    assert (logs / "test_summary.csv").exists()
    for e in range(1, EPOCHS + 1):
        assert (saved / f"train_model_{e}").exists()
        assert (saved / f"train_model_{e}.ready").exists()
    assert os.path.samefile(saved / "train_model_latest", saved / f"train_model_{EPOCHS}")


def test_corrupt_latest_is_quarantined_on_resume(runs, tmp_path, monkeypatch):
    """``latest`` truncated: the resume quarantines it and takes the newest
    epoch file."""
    monkeypatch.setenv("DATASET_DIR", str(runs["tmp_path"]))
    exp = runs["tmp_path"] / "port"
    copy = tmp_path / "exp"
    shutil.copytree(exp, copy)
    latest = copy / "saved_models" / "train_model_latest"
    data = latest.read_bytes()
    latest.unlink()
    latest.write_bytes(data[: len(data) // 2])
    args = _args(runs["tmp_path"], "port", continue_from_epoch="latest")
    args.experiment_name = str(copy)
    builder = ExperimentBuilder(
        args=args, data=MetaLearningSystemDataLoader,
        model=MAMLFewShotLearner(args_to_maml_config(args)), device="cpu",
    )
    builder.data.close()
    assert (copy / "saved_models" / "train_model_latest.corrupt").exists()
    assert builder.state["current_iter"] == EPOCHS * ITERS


def test_interval_checkpoint_resumes_mid_epoch(runs, tmp_path, monkeypatch):
    """``checkpoint_interval_s`` writes ``train_model_latest`` after every
    mid-epoch iteration here; a crash before iteration 4 resumes from
    iteration 3 and ends on the unbroken run's state and validation
    statistics. Epoch 2's train statistics lose the iteration before the
    crash, as the JAX builder's do."""
    monkeypatch.setenv("DATASET_DIR", str(runs["tmp_path"]))
    saved = tmp_path / "interval" / "saved_models"
    saved.mkdir(parents=True)
    shutil.copyfile(runs["tmp_path"] / "port" / "saved_models" / "train_model_0",
                    saved / "train_model_0")
    overrides = dict(checkpoint_interval_s=1e-9)
    crash_at = ITERS + 1
    train_iteration = ExperimentBuilder.train_iteration

    def crashing(self, *args, current_iter, **kwargs):
        if current_iter == crash_at:
            raise RuntimeError("crash")
        return train_iteration(self, *args, current_iter=current_iter, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(ExperimentBuilder, "train_iteration", crashing)
        with pytest.raises(RuntimeError, match="crash"):
            _run_port(tmp_path, "interval", **overrides)
    latest = saved / "train_model_latest"
    assert not os.path.samefile(latest, saved / "train_model_1")
    assert not (saved / "train_model_latest.ready").exists()
    builder, _ = _run_port(tmp_path, "interval", continue_from_epoch="latest",
                           **overrides)
    with open(tmp_path / "interval" / "logs" / "summary_statistics.json") as f:
        stats = json.load(f)
    for key, values in runs["port"].items():
        if _timed(key):
            continue
        if key.startswith("train_"):
            np.testing.assert_array_equal(np.delete(stats[key], 1),
                                          np.delete(values, 1), err_msg=key)
        else:
            np.testing.assert_array_equal(stats[key], values, err_msg=key)
    learner = MAMLFewShotLearner(args_to_maml_config(_args(tmp_path, "interval")))
    unbroken, _ = learner.load_model(
        str(runs["tmp_path"] / "port" / "saved_models"), "train_model", EPOCHS, "cpu"
    )
    resumed, exp = learner.load_model(str(saved), "train_model", EPOCHS, "cpu")
    assert exp["current_iter"] == EPOCHS * ITERS
    for a, b in zip(tree_leaves(resumed), tree_leaves(unbroken)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("knob, value, item", [
    ("device_augment", True, "A7"),
    ("on_nonfinite", "rollback", "A12"),
    ("num_processes", 2, "A10"),
    ("dataprovider_backend", "process", "A5"),
    ("model_parallel_devices", 2, "A10.2"),
])
def test_unported_knobs_raise(runs, monkeypatch, knob, value, item):
    """The knobs still not ported raise naming their ROADMAP item;
    ``device_augment`` (A7's, ported since) builds a run whose learner
    rotates on the device and whose loader ships the quarter turns,
    ``on_nonfinite rollback`` (A12's, ported since) builds a run under that
    policy, and ``dataprovider_backend process`` (A5's, ported since)
    builds a run whose loader synthesises in spawned worker processes.
    ``num_processes 2`` (A10's data-parallel half, ported since) needs a
    process group of two ranks, which this one process is not: it raises
    naming the flag; ``model_parallel_devices 2`` (A10.2) still raises."""
    monkeypatch.setenv("DATASET_DIR", str(runs["tmp_path"]))
    args = _args(runs["tmp_path"], "refused", continue_from_epoch="from_scratch",
                 **{knob: value})

    def build():
        return ExperimentBuilder(
            args=args, data=MetaLearningSystemDataLoader,
            model=MAMLFewShotLearner(args_to_maml_config(args)), device="cpu",
        )

    if knob == "device_augment":
        builder = build()
        assert builder.model.cfg.device_augment.kind == "rot90"
        assert builder.data.dataset.defer_augment
        return
    if knob == "on_nonfinite":
        builder = build()
        builder.data.close()
        assert builder.on_nonfinite == "rollback"
        return
    if knob == "dataprovider_backend":
        builder = build()
        try:
            assert builder.data.backend == "process"
            assert len(builder.data._spawned.worker_pids) == 2
        finally:
            builder.data.close()
        return
    if knob == "num_processes":
        with pytest.raises(ValueError, match="--num_processes 2"):
            build()
        return
    with pytest.raises(NotImplementedError, match=item):
        build()


def test_cli_raises_without_a_card(tmp_path):
    env = {**os.environ, "DATASET_DIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.train_maml_system",
         "--name_of_args_json_file",
         os.path.join(REPO, "experiment_config",
                      "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "omniglot_1_8_0.1_64_5_0")

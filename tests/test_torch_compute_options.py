"""The MAML learner's compute options through the port's command-line
runtime, against the JAX package's, on the CPU; and the kernel launches
chip_smoke.py holds the card runs of those options to.

* The experiment builder with bfloat16 compute, task chunks of 2,
  on-device rotation and lane padding (4 -> 8 filters) all on, against the
  JAX builder with the same flags from one JAX checkpoint: per-epoch
  losses at JAX's bf16 bar (rtol 0.1, atol 0.05, tests/test_bf16.py), a
  resume from ``latest``, and the port's last checkpoint loaded by JAX.
* Launches per iteration, counted on the CPU with
  tests/test_torch_zoo_launches.py's shim: bfloat16 routes every norm site
  as float32 does (the flagship's counts); a chunked iteration launches the
  full batch's once per chunk; lane padding changes no count.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.data import MetaLearningSystemDataLoader as JLoader
from howtotrainyourmamlpytorch_tpu.experiment_builder import ExperimentBuilder as JBuilder
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.utils.parser_utils import (
    args_to_maml_config as j_args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
    args_to_maml_config,
    load_maml_config,
)

import chip_smoke
from test_data import make_dataset_dir
from test_experiment import _experiment_args
from test_torch_train import one_intra_op_thread  # noqa: F401
from test_torch_zoo_launches import (  # noqa: F401 (counted)
    FUSED,
    _iteration_counts,
    _learner,
    counted,
)

OPTIONS = dict(compute_dtype="bfloat16", task_chunk=2, device_augment=True,
               lane_pad_channels=True, transfer_dtype="uint8", cnn_num_filters=6)
EPOCHS = 3
BF16_RTOL, BF16_ATOL = 0.1, 0.05


def _args(tmp_path, name, **overrides):
    args = _experiment_args(tmp_path)
    args.experiment_name = str(tmp_path / name)
    args.second_order = True
    args.continue_from_epoch = 0
    args.watchdog = False
    for key, value in {**OPTIONS, **overrides}.items():
        setattr(args, key, value)
    return args


def _stats(tmp_path, name):
    with open(tmp_path / name / "logs" / "summary_statistics.json") as f:
        return json.load(f)


def test_cli_with_every_option_tracks_jax(tmp_path, monkeypatch):
    """Three epochs of 2 second-order iterations with validation, the
    ensemble test, then a resume to a fourth epoch; JAX and the port from
    one JAX initial state, all four options on."""
    make_dataset_dir(tmp_path / "omniglot_mini")
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    jargs = _args(tmp_path, "jax")
    jlearner = JLearner(j_args_to_maml_config(jargs))
    assert jlearner.cfg.backbone.conv_channels == 8
    seed = tmp_path / "seed"
    jlearner.save_model(str(seed), jlearner.init_state(jax.random.PRNGKey(104)),
                        {"best_val_acc": 0.0, "best_val_iter": 0, "current_iter": 0})
    for name in ("jax", "port"):
        (tmp_path / name / "saved_models").mkdir(parents=True)
        shutil.copyfile(seed, tmp_path / name / "saved_models" / "train_model_0")
    JBuilder(args=jargs, data=JLoader, model=jlearner, device=None).run_experiment()

    args = _args(tmp_path, "port")
    learner = MAMLFewShotLearner(args_to_maml_config(args))
    assert learner.cfg.device_augment.kind == "rot90" and learner.cfg.task_chunk == 2
    builder = ExperimentBuilder(args=args, data=MetaLearningSystemDataLoader,
                                model=learner, device="cpu")
    assert builder.data.dataset.defer_augment
    test_losses = builder.run_experiment()
    assert 0.0 <= test_losses["test_accuracy_mean"] <= 1.0
    want, got = _stats(tmp_path, "jax"), _stats(tmp_path, "port")
    for key in ("train_loss_mean", "val_loss_mean"):
        assert len(got[key]) == EPOCHS and np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], want[key], rtol=BF16_RTOL,
                                   atol=BF16_ATOL, err_msg=key)

    resumed = ExperimentBuilder(
        args=_args(tmp_path, "port", continue_from_epoch="latest",
                   total_epochs=EPOCHS + 1),
        data=MetaLearningSystemDataLoader,
        model=MAMLFewShotLearner(args_to_maml_config(args)), device="cpu",
    )
    assert resumed.state["current_iter"] == EPOCHS * 2
    resumed.run_experiment()
    assert len(_stats(tmp_path, "port")["train_loss_mean"]) == EPOCHS + 1
    # The port's padded, bf16-trained checkpoint holds no padding: the JAX
    # learner of the same flags reads it.
    state, exp = jlearner.load_model(str(tmp_path / "port" / "saved_models"),
                                     "train_model", EPOCHS + 1)
    assert exp["current_iter"] == (EPOCHS + 1) * 2
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(state.theta))


FLAGSHIP = os.path.basename(chip_smoke.FLAGSHIP)


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_bf16_launches_what_chip_smoke_holds(counted, phase):  # noqa: F811
    """The bf16 flagship's iterations launch the float32 flagship's counts
    (chip_smoke.py's ``[cli_bf16]`` and ``[graph_bf16]``)."""
    learner = _learner(MAMLFewShotLearner, FLAGSHIP, compute_dtype="bfloat16",
                       multi_step_loss_num_epochs=2)
    assert learner.cfg.compute_dtype == "bfloat16"
    if phase == "eval":
        assert _iteration_counts(counted, learner, False) == chip_smoke.CLI_FLAGSHIP_EVAL
        return
    assert _iteration_counts(counted, learner, True, 0) == chip_smoke.CLI_FLAGSHIP_TRAIN
    assert _iteration_counts(counted, learner, True, 2) == chip_smoke.CLI_FLAGSHIP_TRAIN_FINAL


@pytest.mark.parametrize("chunk", [2, 4])
def test_chunked_launches_what_chip_smoke_holds(counted, chunk):  # noqa: F811
    """A chunked MSL iteration of the flagship's 8 tasks launches the full
    batch's counts once per chunk (chip_smoke.py's ``[task_chunk]``); the
    chunks' kernel shapes are among those it holds to the plain version."""
    learner = _learner(MAMLFewShotLearner, FLAGSHIP, task_chunk=chunk)
    got = _iteration_counts(counted, learner, True, 0)
    assert got == {k: 8 // chunk * v for k, v in chip_smoke.CLI_FLAGSHIP_TRAIN.items()}
    for hw in (28, 14, 7, 3):
        assert (5, 64 * chunk, hw, hw) in chip_smoke.KERNEL_SHAPES
    for hw in (28, 14):
        assert (5, 64 * chunk, hw, hw) in chip_smoke.POOL_SHAPES


def test_lane_padding_changes_no_launch_count(counted):  # noqa: F811
    """The flagship at 6 filters, lane-padded to 8, launches what the
    unpadded one does (chip_smoke.py's ``[lane_pad]`` holds the north
    star's replays to its unpadded counts); the padded north star's kernel
    shapes are among those held to the plain version."""
    counts = []
    for pad in (False, True):
        cfg = load_maml_config(chip_smoke.FLAGSHIP, cnn_num_filters=6,
                               lane_pad_channels=pad, **FUSED)
        learner = MAMLFewShotLearner(cfg)
        assert learner.cfg.backbone.conv_channels == (8 if pad else 6)
        counts.append(_iteration_counts(counted, learner, True, 0))
    assert counts[0] == counts[1] == chip_smoke.CLI_FLAGSHIP_TRAIN
    for n in (25, 75):
        for hw in (84, 42, 21, 10):
            assert (n, 128, hw, hw) in chip_smoke.KERNEL_SHAPES

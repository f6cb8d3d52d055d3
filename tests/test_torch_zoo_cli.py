"""The port's command line for the gradient-descent and matching-nets
learners against the JAX package's, end to end on the CPU (float32), and
the four new entry points' refusal without a card.

As in tests/test_torch_experiment.py, both builders start from one JAX
``init_state(PRNGKey(104))`` written as ``saved_models/train_model_0`` and
run ``continue_from_epoch=0`` for 3 epochs of 2 iterations with a
validation epoch each, on the synthetic Omniglot tree of
``tests/test_data.make_dataset_dir``; here with the published
gradient-descent and matching-nets settings (per-step BN off, no
multi-step loss). The port's gradient-descent run is repeated at
``iters_per_dispatch`` 5, which a learner without ``run_train_iters`` does
not act on, in the JAX builder as in the port's.
"""

import json
import os
import shutil

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
from howtotrainyourmamlpytorch_tpu.models import (
    GradientDescentLearner as JGradientDescentLearner,
    MatchingNetsLearner as JMatchingNetsLearner,
)
from howtotrainyourmamlpytorch_tpu.utils.checkpoint import save_checkpoint
from howtotrainyourmamlpytorch_tpu.utils.parser_utils import (
    args_to_maml_config as j_args_to_maml_config,
)
from howtotrainyourmamlpytorch_tpu_torch import (
    train_anil_system,
    train_gradient_descent_system,
    train_matching_nets_system,
    train_protonets_system,
)
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
from howtotrainyourmamlpytorch_tpu_torch.models import (
    GradientDescentLearner,
    MatchingNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
    args_to_maml_config,
)

from test_data import make_dataset_dir
from test_experiment import _experiment_args
from test_torch_train import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
EPOCHS, ITERS = 3, 2
LEARNERS = {
    "gd": (JGradientDescentLearner, GradientDescentLearner),
    "matching_nets": (JMatchingNetsLearner, MatchingNetsLearner),
}


def _args(tmp_path, name, **overrides):
    args = _experiment_args(tmp_path)
    args.experiment_name = str(tmp_path / name)
    args.continue_from_epoch = 0
    args.watchdog = False
    args.per_step_bn_statistics = False
    args.use_multi_step_loss_optimization = False
    args.learnable_per_layer_per_step_inner_loop_learning_rate = False
    for key, value in overrides.items():
        setattr(args, key, value)
    return args


def _stats(tmp_path, name):
    with open(tmp_path / name / "logs" / "summary_statistics.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per learner: the JAX CLI's statistics and the port's, from one
    starting checkpoint; for gradient descent also the port at K = 5."""
    tmp_path = tmp_path_factory.mktemp("zoo_cli")
    make_dataset_dir(tmp_path / "omniglot_mini")
    env = pytest.MonkeyPatch()
    env.setenv("DATASET_DIR", str(tmp_path))
    out = {"tmp_path": tmp_path}
    try:
        for kind, (jcls, cls) in LEARNERS.items():
            jargs = _args(tmp_path, f"{kind}_jax")
            jlearner = jcls(j_args_to_maml_config(jargs))
            seed = tmp_path / f"{kind}_seed"
            save_checkpoint(
                str(seed), jlearner.init_state(jax.random.PRNGKey(104)),
                {"best_val_acc": 0.0, "best_val_iter": 0, "current_iter": 0},
            )
            names = [f"{kind}_jax", f"{kind}_port"]
            if kind == "gd":
                names.append(f"{kind}_port_k5")
            for name in names:
                (tmp_path / name / "saved_models").mkdir(parents=True)
                shutil.copyfile(seed, tmp_path / name / "saved_models" / "train_model_0")
            JBuilder(args=jargs, data=JLoader, model=jlearner, device=None).run_experiment()
            out[kind] = {"jax": _stats(tmp_path, f"{kind}_jax")}
            for name in names[1:]:
                args = _args(tmp_path, name,
                             iters_per_dispatch=5 if name.endswith("k5") else 1)
                builder = ExperimentBuilder(
                    args=args, data=MetaLearningSystemDataLoader,
                    model=cls(args_to_maml_config(args)), device="cpu",
                )
                test = builder.run_experiment()
                out[kind][name[len(kind) + 1:]] = dict(
                    stats=_stats(tmp_path, name), test=test, builder=builder,
                )
        yield out
    finally:
        env.undo()


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("kind", list(LEARNERS))
def test_per_epoch_losses_match_the_jax_cli(runs, kind, phase):
    jax_loss = np.asarray(runs[kind]["jax"][f"{phase}_loss_mean"])
    port_loss = np.asarray(runs[kind]["port"]["stats"][f"{phase}_loss_mean"])
    assert len(port_loss) == EPOCHS
    np.testing.assert_allclose(port_loss, jax_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("kind", list(LEARNERS))
def test_the_summary_has_the_jax_columns(runs, kind):
    """The JAX CLI's learner statistics (gradient descent's eval reports
    its sentinel, matching nets' does not; the JAX telemetry columns wait
    for ROADMAP item A12) and one row an epoch."""
    port, jax_keys = set(runs[kind]["port"]["stats"]), set(runs[kind]["jax"])
    learner_keys = ("loss", "accuracy", "nonfinite", "learning_rate")
    assert port <= jax_keys
    assert ({k for k in port if any(w in k for w in learner_keys)}
            == {k for k in jax_keys if any(w in k for w in learner_keys)})
    assert ("val_nonfinite_trips" in port) == (kind == "gd")
    logs = runs["tmp_path"] / f"{kind}_port" / "logs"
    with open(logs / "summary_statistics.csv") as f:
        assert len(f.read().splitlines()) == EPOCHS
    assert 0.0 <= runs[kind]["port"]["test"]["test_accuracy_mean"] <= 1.0


def test_gradient_descent_at_k5_is_the_k1_run(runs):
    """``--iters_per_dispatch 5`` on a learner without ``run_train_iters``:
    one batch a learner call, the same statistics bit for bit."""
    k5 = runs["gd"]["port_k5"]
    assert k5["builder"].iters_per_dispatch == 1
    for key, values in runs["gd"]["port"]["stats"].items():
        if key != "epoch_run_time":
            np.testing.assert_array_equal(k5["stats"][key], values, err_msg=key)


def test_gradient_descent_eval_state_reaches_the_checkpoint(runs):
    """Gradient descent's eval fine-tunes the weights it returns, and the
    builder keeps them: the epoch's checkpoint counts the eval
    iterations, as the JAX CLI's does."""
    learner = GradientDescentLearner(args_to_maml_config(_args(runs["tmp_path"], "x")))
    state, exp = learner.load_model(
        str(runs["tmp_path"] / "gd_port" / "saved_models"), "train_model", EPOCHS, "cpu"
    )
    args = _args(runs["tmp_path"], "x")
    val_batches = args.num_evaluation_tasks // args.batch_size
    assert exp["current_iter"] == EPOCHS * ITERS
    assert int(state.iteration) == EPOCHS * (ITERS + val_batches)
    jlearner = JGradientDescentLearner(j_args_to_maml_config(args))
    jstate, _ = jlearner.load_model(
        str(runs["tmp_path"] / "gd_jax" / "saved_models"), "train_model", EPOCHS
    )
    assert int(jstate.iteration) == int(state.iteration)


@pytest.mark.parametrize(
    "module",
    [train_gradient_descent_system, train_matching_nets_system, train_anil_system,
     train_protonets_system],
    ids=["gradient_descent", "matching_nets", "anil", "protonets"],
)
def test_entry_point_raises_without_a_card(module, tmp_path, monkeypatch):
    """Each entry point runs on the card, and raises where there is none
    before it reads any data."""
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "experiment_config",
                          "omniglot_gradient-descent-omniglot_1_8_0.1_64_5_1.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--name_of_args_json_file", config])


@pytest.mark.parametrize("flag, want", [([], False), (["--parity_bug", "True"], True)],
                         ids=["default", "parity_bug"])
def test_parity_bug_reaches_the_matching_nets_learner(flag, want, tmp_path, monkeypatch):
    """``--parity_bug`` goes from the command line to the learner; the
    config's ``"model"`` key changes nothing (informational, as in JAX)."""
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system
    from howtotrainyourmamlpytorch_tpu_torch.utils import parser_utils

    built = []

    class Builder:
        def __init__(self, model, **kwargs):
            built.append(model)

        def run_experiment(self):
            return {}

    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    monkeypatch.setattr(train_maml_system, "ExperimentBuilder", Builder)
    monkeypatch.setattr(train_maml_system, "maybe_unzip_dataset", lambda args: None)
    monkeypatch.setattr(train_maml_system, "get_args",
                        lambda argv: parser_utils.get_args(argv, device="cpu"))
    config = os.path.join(REPO, "experiment_config",
                          "omniglot_matching-nets-omniglot_1_8_0.1_64_5_1.json")
    train_matching_nets_system.main(["--name_of_args_json_file", config, *flag])
    (model,) = built
    assert isinstance(model, MatchingNetsLearner) and model.parity_bug is want
    assert model.cfg.backbone.num_filters == 64 and not model.cfg.backbone.per_step_bn_statistics

"""The per-host data plane and the fleet's identity in the port, against
the JAX package (CPU; JAX ``tests/test_multihost.py:55-300``).

* The sharded loaders (thread and spawned-process backends), their batches
  concatenated in rank order, are the JAX single-process loader's batches
  bit for bit; a resumed shard keeps the global seed window; a shard out
  of range or a batch that does not divide raises.
* ``get_args`` stamps the process group's identity and the loader's shard;
  a ``--num_processes`` the group does not have raises.
* The heartbeat's per-rank paths are JAX's; the telemetry and the
  watchdog's ``hang`` event carry the rank.
* The builder refuses what a fleet cannot run: tensor parallelism and the
  sequential learners, a learner without the fleet's dp x mp; a
  tensor-parallel fleet's layout.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.data import (
    MetaLearningSystemDataLoader as JLoader,
)
from howtotrainyourmamlpytorch_tpu.telemetry import heartbeat as jheartbeat
from howtotrainyourmamlpytorch_tpu_torch import chaos_train
from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import _check_topology
from howtotrainyourmamlpytorch_tpu_torch.models import (
    GradientDescentLearner,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.parallel import Mesh
from howtotrainyourmamlpytorch_tpu_torch.telemetry import events as tel_events
from howtotrainyourmamlpytorch_tpu_torch.telemetry.events import EventLog, read_events
from howtotrainyourmamlpytorch_tpu_torch.telemetry.heartbeat import heartbeat_path
from howtotrainyourmamlpytorch_tpu_torch.telemetry.runtime import TrainTelemetry
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import Bunch, get_args
from howtotrainyourmamlpytorch_tpu_torch.utils.watchdog import DispatchWatchdog


@pytest.fixture(scope="module")
def tiny_workdir(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("multihost_data")
    chaos_train.make_tiny_dataset(str(workdir / "omniglot_mini"), seed=11)
    return workdir


@pytest.fixture(autouse=True)
def dataset_dir(tiny_workdir, monkeypatch):
    monkeypatch.setenv("DATASET_DIR", str(tiny_workdir))


def _loader_args(workdir, shard_index=0, shard_count=1, **overrides):
    cfg = {**chaos_train.tiny_config(), "experiment_name": str(workdir / "exp"),
           "dataset_path": str(workdir / "omniglot_mini"),
           "data_shard_index": shard_index, "data_shard_count": shard_count,
           **overrides}
    return Bunch(cfg)


def _batches(loader_cls, args, n, current_iter=0):
    loader = loader_cls(args=args, current_iter=current_iter)
    try:
        gen = loader.get_train_batches(total_batches=8, augment_images=True)
        return [next(gen) for _ in range(n)]
    finally:
        if hasattr(loader, "close"):  # the JAX loader has none
            loader.close()


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_sharded_loaders_concatenate_to_the_jax_single_process_batch(tiny_workdir,
                                                                     backend):
    """Seeds are keyed to the global episode index, so who synthesises an
    episode does not change it: the two shards of each batch, concatenated,
    are the JAX single-process loader's batch, every field."""
    full = _batches(JLoader, _loader_args(tiny_workdir), 2)
    shards = [_batches(MetaLearningSystemDataLoader,
                       _loader_args(tiny_workdir, rank, 2, dataprovider_backend=backend),
                       2)
              for rank in (0, 1)]
    for b_full, b_lo, b_hi in zip(full, *shards):
        assert len(b_full) == len(b_lo) == len(b_hi)
        for col_full, col_lo, col_hi in zip(b_full, b_lo, b_hi):
            assert col_lo.shape[0] == col_full.shape[0] // 2
            np.testing.assert_array_equal(np.concatenate([col_lo, col_hi]), col_full)


def test_a_resumed_shard_keeps_the_global_seed_window(tiny_workdir):
    full = _batches(JLoader, _loader_args(tiny_workdir), 3)
    (shard,) = _batches(MetaLearningSystemDataLoader, _loader_args(tiny_workdir, 1, 2),
                        1, current_iter=2)
    for col_full, col_shard in zip(full[2][:4], shard[:4]):
        np.testing.assert_array_equal(col_shard, col_full[col_full.shape[0] // 2:])


def test_the_loader_refuses_out_of_range_and_indivisible_shards(tiny_workdir):
    with pytest.raises(ValueError, match="out of range"):
        MetaLearningSystemDataLoader(args=_loader_args(tiny_workdir, 2, 2))
    loader = MetaLearningSystemDataLoader(args=_loader_args(tiny_workdir, 0, 3))
    try:
        with pytest.raises(ValueError, match="not divisible"):
            _ = loader.shard_size  # a batch of 2 over 3 shards
    finally:
        loader.close()
    for loader_cls in (JLoader, MetaLearningSystemDataLoader):
        loader = loader_cls(args=_loader_args(tiny_workdir, 1, 2))
        try:
            assert (loader.shard_lo, loader.shard_size, loader.global_batch) == (1, 1, 2)
        finally:
            if hasattr(loader, "close"):
                loader.close()


def test_get_args_stamps_the_identity(tiny_workdir):
    cfg = tiny_workdir / "identity.json"
    cfg.write_text(json.dumps({**chaos_train.tiny_config(),
                               "experiment_name": str(tiny_workdir / "id_exp")}))
    args, device = get_args(["--name_of_args_json_file", str(cfg)], device="cpu")
    assert (args.process_index, args.process_count) == (0, 1)
    assert (args.data_shard_index, args.data_shard_count) == (0, 1)
    assert device == torch.device("cpu")
    with pytest.raises(ValueError, match="--num_processes 2"):
        get_args(["--name_of_args_json_file", str(cfg), "--num_processes", "2"],
                 device="cpu")


def test_heartbeat_paths_are_jaxs_per_rank(tmp_path):
    for rank in range(4):
        assert (heartbeat_path(str(tmp_path), rank)
                == jheartbeat.heartbeat_path(str(tmp_path), process_index=rank))
    assert heartbeat_path(str(tmp_path)).endswith("status.json")
    assert heartbeat_path(str(tmp_path), 1).endswith("status.r1.json")


def test_telemetry_stamps_host_identity(tmp_path):
    telemetry = TrainTelemetry(str(tmp_path), enabled=True, process_index=1,
                               process_count=2)
    with telemetry.activate():
        telemetry.record_dispatch(1, n_iters=1)
        telemetry.record_dispatch(2, n_iters=1)
        telemetry.event("preemption", signal=15, iter=2)
        stats = telemetry.epoch_stats("train", epoch=0)
    assert stats["process_index"] == 1 and stats["process_count"] == 2
    events = read_events(os.path.join(str(tmp_path), "telemetry.jsonl"))
    step = next(e for e in events if e["type"] == "step")
    assert step["process_index"] == 1 and step["process_count"] == 2
    assert step["mesh_shape"] == "dp2xmp1" and step["n_devices"] == 2
    assert next(e for e in events if e["type"] == "preemption")["process_index"] == 1


def test_watchdog_hang_event_carries_identity(tmp_path):
    log = EventLog(str(tmp_path / "t.jsonl"))
    previous = tel_events.install(log)
    fired = []
    try:
        wd = DispatchWatchdog(min_deadline_s=0.2, factor=1.0, logs_dir=str(tmp_path),
                              exit_fn=fired.append,
                              identity={"process_index": 1, "process_count": 2})
        try:
            with wd.armed(7):
                deadline = time.monotonic() + 10.0
                while not fired and time.monotonic() < deadline:
                    time.sleep(0.02)
        finally:
            wd.close()
    finally:
        tel_events.install(previous)
    assert fired
    log.flush()
    events = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()
              if line.strip()]
    hang = next(e for e in events if e.get("type") == "hang")
    assert hang["process_index"] == 1 and hang["process_count"] == 2


def test_the_builder_refuses_what_a_fleet_cannot_run():
    fleet = Bunch({"process_index": 1, "process_count": 2, "num_processes": 2,
                   "data_parallel_devices": 2, "model_parallel_devices": 1})
    cfg = MAMLConfig()
    mesh = Mesh(dp=2, mp=1, rank=1, world=2, device=torch.device("cpu"))
    assert _check_topology(fleet, MAMLFewShotLearner(cfg, mesh=mesh)) == (1, 2)
    with pytest.raises(ValueError, match="cannot span 2 processes"):
        _check_topology(fleet, GradientDescentLearner(cfg))
    with pytest.raises(ValueError, match="cannot span 2 processes"):
        _check_topology(fleet, MAMLFewShotLearner(cfg))
    # A two-rank fleet at mp 2 is one mp group: its layout builds. dp 2 x
    # mp 2 needs 4 ranks, an mp below 0 raises (0 reads as 1, as in JAX),
    # and an mp of 4 exceeds the fleet, each naming what to change.
    tp = Bunch({**vars(fleet), "data_parallel_devices": 1, "model_parallel_devices": 2})
    tp_learner = MAMLFewShotLearner(cfg, mesh=Mesh(dp=1, mp=2, rank=1, world=2,
                                                   device=torch.device("cpu")))
    assert _check_topology(tp, tp_learner) == (1, 2)
    assert _check_topology(Bunch({**vars(tp), "data_parallel_devices": 0}),
                           tp_learner) == (1, 2)
    with pytest.raises(ValueError, match="--num_processes 4"):
        _check_topology(Bunch({**vars(fleet), "model_parallel_devices": 2}), tp_learner)
    with pytest.raises(ValueError, match=">= 1, got -1"):
        _check_topology(Bunch({**vars(tp), "model_parallel_devices": -1}), tp_learner)
    with pytest.raises(ValueError, match="model_parallel_devices 4 needs .* 4 ranks"):
        _check_topology(Bunch({**vars(tp), "data_parallel_devices": 0,
                               "model_parallel_devices": 4}), tp_learner)
    with pytest.raises(ValueError, match="data_parallel_devices 4"):
        _check_topology(Bunch({**vars(fleet), "data_parallel_devices": 4}),
                        MAMLFewShotLearner(cfg, mesh=mesh))
    one = Bunch({"process_index": 0, "process_count": 1})
    assert _check_topology(one, GradientDescentLearner(cfg)) == (0, 1)

"""The port's data-parallel layer (``howtotrainyourmamlpytorch_tpu_torch/parallel/``)
against the JAX package's ``parallel/`` (CPU).

* The host arithmetic (``host_batch_bounds``, ``degraded_dp_extent``,
  ``degraded_process_count``), the bring-up pre-parser and
  ``guard_task_chunk`` equal JAX's over a grid of inputs, errors included;
  the dtype buckets lay leaves out as JAX's do.
* Bring-up against an unreachable coordinator raises the typed error
  within its timeout (JAX ``tests/test_multihost.py:192``).
* One two-process gloo group (``fleet``, one launch for the module) runs
  the collectives, the fences and gathers, and the dp train step:
  ``fused_psum`` and ``per_leaf_psum`` give bitwise-equal leaves, the
  bucketed form one all-reduce per dtype; the dp ``_train_step``, second
  order, with and without ``task_chunk``, equals the single-process
  ``task_chunk = B/2`` step bit for bit in theta, LSLR and the Adam
  moments (the BN state at the chunk test's bar, rtol 1e-4 and atol
  1e-5: ranks average it as "local mean / dp, summed"); and its reduced
  loss and meta-gradient agree with the JAX single-device learner on the
  same global batch at the port's bars (loss rtol 1e-5, grads rtol 1e-3
  and atol 1e-5).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.parallel import collectives as jcollectives
from howtotrainyourmamlpytorch_tpu.parallel import distributed as jdistributed
from howtotrainyourmamlpytorch_tpu.parallel import mesh as jmesh
from howtotrainyourmamlpytorch_tpu.parallel import sharding as jsharding
from howtotrainyourmamlpytorch_tpu_torch.convert import tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import ANILLearner, MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.parallel import (
    DistributedInitError,
    Mesh,
    choose_backend,
    collectives,
    default_mesh_from_args,
    distributed,
    flatten_buckets,
    initialize_distributed,
    mesh,
    unflatten_buckets,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import Bunch
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_ATOL,
    LOSS_RTOL,
    assert_tree_close,
    episode_batch,
    jax_config,
    learner_pair,
    one_intra_op_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = 4
# The chunk test's BN-state bar (tests/test_torch_task_chunk.py).
BN_RTOL, BN_ATOL = 1e-4, 1e-5


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raises", exception type name)``."""
    try:
        return "ok", fn(*args, **kwargs)
    except (ValueError, AssertionError) as exc:
        return "raises", type(exc).__name__


# ---------------------------------------------------------------------------
# Host arithmetic, pre-parser, guards: JAX's over a grid
# ---------------------------------------------------------------------------


def test_host_batch_bounds_match_jax_over_a_grid():
    for batch in (1, 2, 4, 5, 6, 8, 12, 32):
        for count in (1, 2, 3, 4, 8):
            for index in range(count):
                assert (_outcome(mesh.host_batch_bounds, batch, index, count)
                        == _outcome(jmesh.host_batch_bounds, batch, index, count))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.host_batch_bounds(5, 0, 2)


def test_degraded_extents_match_jax_over_a_grid():
    for dp in (1, 2, 3, 4, 6, 8, 16):
        for batch in (1, 2, 3, 4, 6, 8, 12, 16, 32):
            for chunk in (0, 1, 2, 3, 4, 6, 8):
                assert (mesh.degraded_dp_extent(dp, global_batch=batch, task_chunk=chunk)
                        == jmesh.degraded_dp_extent(dp, global_batch=batch,
                                                    task_chunk=chunk))
                for local in (1, 2, 4):
                    kw = dict(global_batch=batch, local_devices=local, task_chunk=chunk)
                    assert (mesh.degraded_process_count(dp, **kw)
                            == jmesh.degraded_process_count(dp, **kw))
    assert mesh.degraded_dp_extent(8, global_batch=8) == 4
    assert mesh.degraded_process_count(2, global_batch=8) == 1
    assert mesh.degraded_process_count(1, global_batch=8) is None


@pytest.mark.parametrize("argv", [
    [],
    ["--num_processes", "2"],
    ["--coordinator_address", "127.0.0.1:9", "--process_id", "1"],
    ["--num_processes=4", "--process_id=3", "--distributed_init_timeout_s", "7"],
    ["--name_of_args_json_file", "None", "--num_processes", "2"],
    ["--name_of_args_json_file", "{cfg}"],
    ["--name_of_args_json_file", "{cfg}", "--coordinator_address", "h:1",
     "--num_processes", "2", "--process_id", "1"],
    ["--name_of_args_json_file", "{missing}", "--process_id", "0"],
    ["--num_processes"],
])
def test_the_bring_up_pre_parser_matches_jax(tmp_path, argv):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"coordinator_address": "10.0.0.1:1234",
                               "num_processes": 4, "process_id": None,
                               "distributed_init_timeout_s": 30}))
    argv = [a.format(cfg=cfg, missing=tmp_path / "none.json") for a in argv]
    assert (distributed.distributed_config_from_argv(argv)
            == jdistributed.distributed_config_from_argv(argv))


def test_guard_task_chunk_matches_jax_over_a_grid():
    devices = jax.devices()
    for dp in (1, 2, 4):
        jax_mesh = jmesh.make_mesh(devices[:dp], data_parallel=dp)
        port_mesh = Mesh(dp=dp, mp=1, rank=0, world=dp, device=torch.device("cpu"))
        for chunk in (0, 1, 2, 3, 4, 6, 8, 12):
            assert (_outcome(collectives.guard_task_chunk, port_mesh, chunk)
                    == _outcome(jsharding.guard_task_chunk, jax_mesh, chunk))
    with pytest.raises(ValueError, match="multiple of the mesh's dp extent 4"):
        collectives.guard_task_chunk(port_mesh, 6)
    collectives.guard_task_chunk(None, 3)


def test_buckets_lay_leaves_out_as_jax_does():
    rng = np.random.RandomState(0)
    # Keys in sorted order: JAX flattens a dict by its sorted keys, the
    # port in insertion order.
    tree = {"b": rng.rand(2).astype(np.float32),
            "n": {"count": np.arange(5, dtype=np.int32),
                  "scale": np.full((), 2.5, np.float32)},
            "w": rng.rand(3, 4).astype(np.float32)}
    buckets, spec = flatten_buckets(jax.tree.map(torch.from_numpy, tree))
    jbuckets, jspec = jcollectives.flatten_buckets(tree)
    assert spec.dtypes == jspec.dtypes == ("float32", "int32")
    assert spec.leaves == jspec.leaves
    for name in spec.dtypes:
        np.testing.assert_array_equal(buckets[name].numpy(), np.asarray(jbuckets[name]))
    back = unflatten_buckets(buckets, spec)
    for a, b in zip(tree_leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_backend_and_layout_rules():
    assert choose_backend(2, 1) == "gloo"  # two ranks on one card
    assert choose_backend(2, 2) == "nccl"
    assert choose_backend(1, 1) == "nccl"
    assert choose_backend(2, 8, cpu=True) == "gloo"
    assert choose_backend(2, 0) == "gloo"
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")
    assert mesh.rank_device(1, "cuda:0") == torch.device("cuda", 0)
    one = Bunch({"batch_size": 8, "num_of_gpus": 1, "samples_per_iter": 1,
                 "data_parallel_devices": 0, "model_parallel_devices": 1})
    assert default_mesh_from_args(one, "cpu") is None
    with pytest.raises(ValueError, match="--num_processes 2"):
        default_mesh_from_args(Bunch({**vars(one), "data_parallel_devices": 2}), "cpu")
    with pytest.raises(NotImplementedError, match="A10.2"):
        default_mesh_from_args(Bunch({**vars(one), "model_parallel_devices": 2}), "cpu")


def test_bring_up_fails_fast_on_an_unreachable_coordinator():
    """A wrong address raises ``DistributedInitError`` within its timeout,
    before any group exists (JAX ``tests/test_multihost.py:192``)."""
    port = distributed.find_free_port()
    t0 = time.monotonic()
    with pytest.raises(DistributedInitError, match="coordinator unreachable"):
        initialize_distributed(f"127.0.0.1:{port}", 2, 1, 2.0, cpu=True)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    # Without a signal the call is a no-op; a partial one is refused.
    assert initialize_distributed() is False
    with pytest.raises(DistributedInitError, match="--process_id"):
        initialize_distributed(f"127.0.0.1:{port}", 2, None, 2.0, cpu=True)


# ---------------------------------------------------------------------------
# A two-process gloo group
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent(
    """
    import dataclasses
    import os
    import sys

    import numpy as np
    import torch

    import time

    from howtotrainyourmamlpytorch_tpu_torch.parallel import (
        collectives, initialize_distributed, make_mesh, multihost,
    )
    from howtotrainyourmamlpytorch_tpu_torch.models import (
        ANILLearner, MAMLFewShotLearner,
    )
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
    from howtotrainyourmamlpytorch_tpu_torch.utils.watchdog import DispatchWatchdog

    address, rank, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    assert initialize_distributed(address, 2, rank, 60.0, cpu=True)
    mesh = make_mesh(device="cpu")
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    cfg, importance = inputs["cfg"], inputs["importance"]
    out = {"mesh": tuple(mesh[:4])}
    # A one-process checkpoint resumes on the fleet, rank 0's on every rank.
    learner = MAMLFewShotLearner(cfg, mesh=mesh)
    state, exp_state = learner.load_model(work, "train_model", 0, "cpu")
    out["exp_state"] = multihost.broadcast_object(exp_state)

    # A collective a peer never joins trips the watchdog, with the rank.
    log = events.EventLog(f"{work}/events{rank}.jsonl")
    previous = events.install(log)
    fired, marker = [], f"{work}/watchdog_fired"

    def on_expiry(code):
        fired.append(code)
        open(marker, "w").close()

    watchdog = DispatchWatchdog(min_deadline_s=0.5, factor=1.0, exit_fn=on_expiry,
                                identity={"process_index": rank, "process_count": 2})
    if rank == 0:
        with watchdog.armed(1):
            collectives.fused_psum({"x": torch.ones(3)})
    else:
        # Rank 1 joins only once rank 0's watchdog has fired.
        deadline = time.monotonic() + 30
        while not os.path.exists(marker):
            time.sleep(0.05)
            assert time.monotonic() < deadline
        collectives.fused_psum({"x": torch.ones(3)})
    watchdog.close()
    events.install(previous)
    log.flush()
    out["watchdog_fired"] = fired

    # Collectives: rank-dependent leaves of three dtypes.
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) / (3.0 + rank),
            "s": torch.tensor(0.1 * (rank + 1)),
            "n": torch.arange(5, dtype=torch.int32) * (rank + 1),
            "d": torch.tensor([1.0 / 3.0, 2.0], dtype=torch.float64) * (rank + 7)}
    before = collectives.collective_counts["all_reduce"]
    out["fused"] = collectives.fused_psum(tree)
    out["fused_collectives"] = collectives.collective_counts["all_reduce"] - before
    before = collectives.collective_counts["all_reduce"]
    out["per_leaf"] = collectives.per_leaf_psum(tree)
    out["per_leaf_collectives"] = collectives.collective_counts["all_reduce"] - before

    # Fences, gathers, broadcasts.
    multihost.barrier("probe")
    out["gather"] = multihost.gather_global(torch.full((2, 3), float(rank)))
    out["allgather"] = multihost.allgather_host(np.full((1, 2), rank, np.int64))
    out["object"] = multihost.broadcast_object({"rank": rank})
    out["replicated"] = collectives.broadcast_tree(tree)

    # The dp train step on this rank's half of the tasks.
    lo, hi = rank * 2, rank * 2 + 2
    batch = tuple(a[lo:hi] for a in inputs["batch"])
    for name, chunk in (("chunk0", 0), ("chunkB", 4), ("chunk2", 2)):
        learner = MAMLFewShotLearner(dataclasses.replace(cfg, task_chunk=chunk),
                                     mesh=mesh)
        st = learner.replicate(state)
        device_batch = learner._device_batch(st, batch)
        new_state, metrics = learner._train_step(
            st, device_batch, importance, second_order=True)
        out[name] = (new_state, metrics)
        if name == "chunk0":
            out["meta_grads"] = learner._meta_grads(
                st, device_batch, importance, second_order=True, final_only=False)
            _, eval_metrics, logits = learner.run_validation_iter(st, batch)
            out["eval"] = (eval_metrics, logits)
    anil = ANILLearner(cfg, mesh=mesh)
    st = anil.replicate(state)
    out["anil"] = anil._train_step(st, anil._device_batch(st, batch), importance,
                                   second_order=True)
    torch.save(out, f"{work}/rank{rank}.pt")
    """
)


def _leaves(tree):
    return [a.numpy() for a in tree_leaves(tree)]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The JAX learner and state, the port's single-process
    ``task_chunk = B/2`` twin, and both ranks' outputs."""
    rng = np.random.RandomState(3)
    jlearner, jstate, learner, state = learner_pair(jax_config(True, second_order=True))
    batch = episode_batch(rng, tasks=TASKS)
    importance = torch.tensor([0.3, 0.7])
    work = tmp_path_factory.mktemp("dp_fleet")
    torch.save({"cfg": learner.cfg, "batch": batch, "importance": importance},
               work / "inputs.pt")
    learner.save_model(str(work / "train_model_0"), state, {"current_iter": 7})
    (work / "worker.py").write_text(WORKER)
    address = f"127.0.0.1:{distributed.find_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"), address,
                               str(rank), str(work)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    # The twins start from the checkpoint too (a loaded state's dicts keep
    # the archive's order).
    state, _ = learner.load_model(str(work), "train_model", 0, "cpu")
    twins = {}
    for name, cls, chunk in (("twin", MAMLFewShotLearner, TASKS // 2),
                             ("twin_chunk1", MAMLFewShotLearner, 1),
                             ("anil_twin", ANILLearner, TASKS // 2)):
        twin = cls(dataclasses.replace(learner.cfg, task_chunk=chunk))
        twins[name] = twin._train_step(state, twin._device_batch(state, batch),
                                       importance, second_order=True)
    events = [json.loads(line) for line in (work / "events0.jsonl").read_text().splitlines()
              if line.strip()]
    return dict(jlearner=jlearner, jstate=jstate, learner=learner, state=state,
                batch=batch, importance=importance, ranks=ranks, events=events, **twins)


def test_fused_and_per_leaf_psum_agree_with_one_collective_per_dtype(fleet):
    for out in fleet["ranks"]:
        assert out["fused_collectives"] == 3  # float32, int32, float64
        assert out["per_leaf_collectives"] == 4
        for a, b in zip(_leaves(out["fused"]), _leaves(out["per_leaf"])):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(fleet["ranks"][0]["fused"]["w"].numpy(),
                                  w / np.float32(3.0) + w / np.float32(4.0))
    np.testing.assert_array_equal(fleet["ranks"][0]["fused"]["n"].numpy(),
                                  np.arange(5, dtype=np.int32) * 3)
    for a, b in zip(_leaves(fleet["ranks"][0]["fused"]), _leaves(fleet["ranks"][1]["fused"])):
        np.testing.assert_array_equal(a, b)


def test_fences_gathers_and_broadcasts_on_two_ranks(fleet):
    for rank, out in enumerate(fleet["ranks"]):
        assert out["mesh"] == (2, 1, rank, 2)
        np.testing.assert_array_equal(out["gather"],
                                      np.repeat([0.0, 1.0], 2)[:, None] * np.ones((1, 3)))
        np.testing.assert_array_equal(out["allgather"], [[0, 0], [1, 1]])
        assert out["object"] == {"rank": 0}
        for a, b in zip(_leaves(out["replicated"]), _leaves(fleet["ranks"][0]["replicated"])):
            np.testing.assert_array_equal(a, b)
    # Rank 0's values: a rank-1 leaf differs before the broadcast.
    np.testing.assert_array_equal(fleet["ranks"][1]["replicated"]["n"].numpy(),
                                  np.arange(5, dtype=np.int32))


@pytest.mark.parametrize("variant", ["chunk0", "chunkB", "anil"])
def test_dp_train_step_is_bitwise_the_chunked_single_process_step(fleet, variant):
    """Two ranks, second order, from a one-process checkpoint: theta, LSLR
    and the Adam moments bit for bit the single-process step with
    ``task_chunk = B/2`` (``chunk0``: no chunking on the ranks; ``chunkB``:
    ``task_chunk = B``, a local chunk of B/2; ``anil``: ANIL, which
    inherits the path); the loss too; the BN state at the chunk test's
    bar."""
    twin_state, twin_metrics = fleet["anil_twin" if variant == "anil" else "twin"]
    for out in fleet["ranks"]:
        assert out["exp_state"]["current_iter"] == 7
        state, metrics = out[variant]
        for field in ("theta", "lslr", "opt_state", "iteration"):
            got, want = _leaves(getattr(state, field)), _leaves(getattr(twin_state, field))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b, err_msg=field)
        assert torch.equal(metrics["loss"], twin_metrics["loss"])
        assert float(metrics["accuracy"]) == pytest.approx(float(twin_metrics["accuracy"]))
        for a, b in zip(_leaves(state.bn_state), _leaves(twin_state.bn_state)):
            np.testing.assert_allclose(a, b, rtol=BN_RTOL, atol=BN_ATOL)


def test_dp_with_smaller_local_chunks_sums_in_another_order(fleet):
    """``task_chunk = 2`` on two ranks is a local chunk of 1: the ranks'
    two-term sums are added, a reassociation of the single process's
    ``task_chunk = 1`` sum of the same four terms, held at JAX's bar for
    it (rtol 2e-5, atol 1e-7 on the gradient) through Adam's first
    moment, a tenth of the gradient after one step. (Adam's first update
    is about the gradient's sign times the learning rate, so theta itself
    is no gauge of a reassociation.)"""
    twin_state, twin_metrics = fleet["twin_chunk1"]
    state, metrics = fleet["ranks"][0]["chunk2"]
    for a, b in zip(_leaves(state.opt_state.mu), _leaves(twin_state.opt_state.mu)):
        np.testing.assert_allclose(a / 0.1, b / 0.1, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(metrics["loss"]), float(twin_metrics["loss"]),
                               rtol=1e-5, atol=1e-6)


def test_dp_meta_grads_match_the_jax_single_device_learner(fleet):
    """The reduced loss and meta-gradient of the two ranks against the JAX
    learner's on the whole batch, at the port's bars."""
    import jax.numpy as jnp

    jlearner, jstate = fleet["jlearner"], fleet["jstate"]
    jbatch = tuple(jnp.asarray(a) for a in jlearner._prepare_batch(fleet["batch"]))
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda o: jlearner._meta_loss(o, jstate.bn_state, jbatch,
                                      jnp.asarray(fleet["importance"].numpy()), 2,
                                      True, None, False),
        has_aux=True,
    )({"theta": jstate.theta, "lslr": jstate.lslr})
    for out in fleet["ranks"]:
        loss, accuracy, _, grads = out["meta_grads"]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        assert float(accuracy) == pytest.approx(float(jnp.mean(jaux["accuracy"])))
        assert_tree_close(tree_to_numpy(grads), jgrads, GRAD_RTOL, GRAD_ATOL)


def test_dp_eval_reduces_the_metrics_and_keeps_each_ranks_logits(fleet):
    learner, state = fleet["learner"], fleet["state"]
    _, metrics, logits = learner.run_validation_iter(state, fleet["batch"])
    got = [out["eval"] for out in fleet["ranks"]]
    for m, _ in got:
        np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]),
                                   rtol=1e-6, atol=1e-7)
        assert float(m["accuracy"]) == pytest.approx(float(metrics["accuracy"]))
    np.testing.assert_allclose(torch.cat([lg for _, lg in got]).numpy(),
                               logits.numpy(), rtol=1e-5, atol=1e-6)


def test_a_collective_a_peer_never_joins_trips_the_watchdog(fleet):
    """Rank 0 armed around an all-reduce that rank 1 joins only after the
    watchdog fired: the watchdog's exit code (76) and a ``hang`` event
    carrying rank 0's identity."""
    assert fleet["ranks"][0]["watchdog_fired"] == [76]
    assert fleet["ranks"][1]["watchdog_fired"] == []
    hang = next(e for e in fleet["events"] if e.get("type") == "hang")
    assert hang["process_index"] == 0 and hang["process_count"] == 2

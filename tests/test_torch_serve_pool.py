"""The port's supervised replica pool (CPU), mirroring the pool cases of
tests/test_serve_resilience.py by name on ``LocalReplica``: a crash
mid-stream with zero failed requests and no new entry in any engine's
signature table, the restart, a wedge replaced within its budget, the
circuit breaker, no healthy replica as a typed 503, the front door's
refusal of a corrupt promote and a good promote rolled to every replica,
``/admin/scale`` on a pool; the swap faults (``corrupt_swap_at``,
``nan_next_logits``); and the production shape once: two worker
processes of the port's ``serve_maml`` with ``--device cpu``, one killed,
and the command line's ``--replicas 2`` drained by SIGTERM. Answers are
held to the JAX ``ServingAPI`` on the same weights at the serve bar.

The config has 2 stages of 8 filters on 14x14 images, per-step BN over 2
inner steps, 5-way.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve import ServingAPI as JServingAPI
from howtotrainyourmamlpytorch_tpu.utils import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    NoHealthyReplicaError,
    OverloadedError,
    PoolConfig,
    ReplicaPool,
    ServeConfig,
    ServingAPI,
    SwapRejectedError,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.api import REPLICA_KILL_EXIT
from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import LocalReplica
from howtotrainyourmamlpytorch_tpu_torch.serve.resilience.replica import (
    SubprocessReplica,
    serve_maml_argv,
)
from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
from howtotrainyourmamlpytorch_tpu_torch.utils import checkpoint, faultinject
from howtotrainyourmamlpytorch_tpu_torch.utils import locksan
from test_torch_serve_http import CLI_CONFIG, run_server, stop_server
from test_torch_serve_runtime import (  # noqa: F401 (one_intra_op_thread)
    ATOL,
    RTOL,
    episode,
    fresh_state,
    one_intra_op_thread,
    tiny_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEARNER = MAMLFewShotLearner(tiny_cfg())


@pytest.fixture(autouse=True)
def _lock_sanitizer():
    """Every test of this suite runs under the port's lock sanitizer: no
    cycle in the observed acquisition order, and every lock created under
    ``howtotrainyourmamlpytorch_tpu_torch/serve`` held under 2.0 s."""
    with locksan.sanitized() as san:
        yield san


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.deactivate()
    yield
    faultinject.deactivate()


def make_api(**serve_kw):
    defaults = dict(meta_batch_size=2, max_wait_ms=0.0)
    return ServingAPI(LEARNER, fresh_state(LEARNER), ServeConfig(**{**defaults, **serve_kw}),
                      device="cpu")


def local_pool(n=2, warm_bucket=(5, 1, 3), **pool_kw):
    """A LocalReplica pool over fresh tiny APIs, each warmed."""
    def factory(index: int) -> LocalReplica:
        api = make_api()
        api.warmup([warm_bucket])
        return LocalReplica(api, replica_id=f"local-{index}")

    defaults = dict(n_replicas=n, health_interval_s=0.02, health_timeout_s=1.0,
                    unhealthy_after=2, restart_backoff_s=0.05, restart_backoff_max_s=1.0,
                    min_uptime_s=0.0)
    pool = ReplicaPool(factory, PoolConfig(**{**defaults, **pool_kw}))
    assert pool.wait_ready(timeout=120.0), "pool never became healthy"
    return pool


def compile_tables(pool):
    return {slot.index: slot.replica.api.engine.compile_table()
            for slot in pool._slots if slot.replica is not None}


def swap_checkpoint(tmp_path, name="swap_ckpt", seed=7, poison_nan=False):
    state = LEARNER.init_state(torch.Generator().manual_seed(seed), "cpu")
    if poison_nan:
        state = state._replace(theta={k: {n: torch.full_like(t, float("nan"))
                                          for n, t in v.items()}
                                      for k, v in state.theta.items()})
    path = str(tmp_path / name)
    LEARNER.save_model(path, state, {"current_iter": 0})
    return path


# ---------------------------------------------------------------------------
# Replica pool: crash, restart, wedge, circuit breaker
# ---------------------------------------------------------------------------


def test_replica_crash_mid_stream_zero_failed_requests(rng):
    """A replica dies serving request 3; the pool re-dispatches onto the
    healthy one and every request is answered, with no new signature in
    any engine's table (both were warmed at the bucket)."""
    pool = local_pool(n=2, restart_backoff_s=600.0)  # no restart mid-test
    try:
        before = compile_tables(pool)
        faultinject.activate(faultinject.FaultPlan(replica_kill_at_request=3))
        for _ in range(8):
            out = pool.classify(*episode(rng))
            assert np.asarray(out["logits"]).shape == (3, 5)
        after = compile_tables(pool)
        assert all(after[i] == before[i] for i in after)
        assert "replica-kill:3" in faultinject.events
        assert pool.metrics.retry_total.value == 1
        assert pool.metrics.replica_deaths_total.value == 1
        assert pool.metrics.request_errors.value == 0
        health = pool.healthz()
        assert health["healthy_replicas"] == 1
        assert health["degraded"] is True and health["ready"] is True
    finally:
        pool.close()


def test_supervisor_restarts_crashed_replica(rng):
    pool = local_pool(n=2, restart_backoff_s=0.02)
    try:
        faultinject.activate(faultinject.FaultPlan(replica_kill_at_request=1))
        pool.classify(*episode(rng))  # kills one replica; re-dispatched
        deadline = time.monotonic() + 60
        while pool.healthz()["healthy_replicas"] < 2:
            assert time.monotonic() < deadline, "replica never restarted"
            time.sleep(0.02)
        assert pool.metrics.replica_restarts_total.value == 1
        pool.classify(*episode(rng))
    finally:
        pool.close()


def test_wedged_replica_detected_and_replaced_within_budget(rng):
    """A replica that stops answering its probes (and holds its slot) is
    retired within ``unhealthy_after * health_interval + health_timeout``
    of its next probes and replaced."""
    cfg = dict(restart_backoff_s=0.02, health_interval_s=0.02)
    pool = local_pool(n=2, **cfg)
    try:
        faultinject.activate(faultinject.FaultPlan(wedge_replica_at_request=1))
        out = pool.classify(*episode(rng))  # arms the wedge; still answers
        assert np.asarray(out["logits"]).shape == (3, 5)
        assert "replica-wedge:1" in faultinject.events
        t0 = time.monotonic()
        while pool.metrics.replica_deaths_total.value < 1:
            assert time.monotonic() < t0 + 60, "the wedge was never detected"
            time.sleep(0.005)
        detected_s = time.monotonic() - t0
        budget = pool.config.unhealthy_after * pool.config.health_interval_s + \
            pool.config.health_timeout_s
        assert detected_s < budget + 5.0, (detected_s, budget)  # CPU scheduling slack
        while pool.healthz()["healthy_replicas"] < 2:
            assert time.monotonic() < t0 + 60, "the replacement never came up"
            time.sleep(0.02)
        assert pool.metrics.replica_restarts_total.value >= 1
        pool.classify(*episode(rng))
        assert pool.metrics.request_errors.value == 0
    finally:
        pool.close()


def test_crash_loop_trips_circuit_breaker():
    """A slot whose replica never comes up is parked (circuit open) after
    ``circuit_breaker_after`` tries; the pool serves on the other slot and
    says it is degraded."""
    calls = {"bad": 0}

    def factory(index: int):
        if index == 1:
            calls["bad"] += 1
            raise RuntimeError("this replica never comes up")
        api = make_api()
        api.warmup([(5, 1, 3)])
        return LocalReplica(api, replica_id=f"local-{index}")

    pool = ReplicaPool(factory, PoolConfig(
        n_replicas=2, health_interval_s=0.02, restart_backoff_s=0.01,
        restart_backoff_max_s=0.05, min_uptime_s=0.0, circuit_breaker_after=3))
    try:
        assert pool.wait_ready(timeout=60, healthy=1)
        deadline = time.monotonic() + 30
        while pool.metrics.circuit_open_total.value < 1:
            assert time.monotonic() < deadline, "the breaker never tripped"
            time.sleep(0.02)
        assert calls["bad"] == 3
        time.sleep(0.2)
        assert calls["bad"] == 3, "the breaker must stop the restarts"
        health = pool.healthz()
        assert health["degraded"] is True and health["ready"] is True
        assert {r["index"]: r["state"] for r in health["replicas"]}[1] == "circuit_open"
        out = pool.classify(*episode(np.random.RandomState(0)))
        assert np.asarray(out["logits"]).shape == (3, 5)
    finally:
        pool.close()


def test_no_healthy_replica_is_typed_503(rng):
    def factory(index: int):
        raise RuntimeError("fleet is down")

    pool = ReplicaPool(factory, PoolConfig(n_replicas=1, health_interval_s=0.02,
                                           restart_backoff_s=0.01, circuit_breaker_after=1))
    try:
        with pytest.raises(NoHealthyReplicaError) as err:
            pool.classify(*episode(rng))
        assert isinstance(err.value, OverloadedError)  # a 503
        assert pool.metrics.shed_total.value == 1
        assert pool.healthz()["ready"] is False
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# Promotion through the pool, and the swap faults
# ---------------------------------------------------------------------------


def test_pool_promote_rejects_corrupt_checkpoint_at_front_door(rng, tmp_path):
    """A corrupt checkpoint is refused once by the front door's verify: no
    replica loads or canaries it, and every replica keeps its logits."""
    pool = local_pool(n=2, restart_backoff_s=600.0)
    try:
        xs, ys, xq = episode(rng)
        before = [pool.classify(xs, ys, xq)["logits"] for _ in range(2)]
        ckpt = swap_checkpoint(tmp_path)
        with open(ckpt, "r+b") as f:
            f.truncate(300)
        with pytest.raises(SwapRejectedError) as err:
            pool.promote(ckpt)
        assert err.value.reason == "corrupt_checkpoint"
        for slot in pool._slots:
            assert slot.replica.api.metrics.swap_rejected_total.value == 0
        after = [pool.classify(xs, ys, xq) for _ in range(2)]
        assert [a["state_version"] for a in after] == [0, 0]
        for a, b in zip(after, before):
            np.testing.assert_array_equal(a["logits"], b)
    finally:
        pool.close()


def test_pool_promote_rolls_good_checkpoint_to_all_replicas(rng, tmp_path):
    pool = local_pool(n=2, restart_backoff_s=600.0)
    try:
        ckpt = swap_checkpoint(tmp_path)
        result = pool.promote(ckpt)
        assert result == {"promoted_replicas": 2, "state_version": 1}
        for _ in range(2):  # round-robin touches both replicas
            assert pool.classify(*episode(rng))["state_version"] == 1
        assert pool.healthz()["last_promoted_digest"] == checkpoint.checkpoint_digest(ckpt)
    finally:
        pool.close()


def test_corrupt_swap_rejected_old_state_serves_bit_exact(rng, tmp_path):
    api = make_api()
    try:
        api.warmup([(5, 1, 3)])
        xs, ys, xq = episode(rng)
        before = api.classify(xs, ys, xq)["logits"]
        faultinject.activate(faultinject.FaultPlan(corrupt_swap_at=256))
        with pytest.raises(SwapRejectedError) as err:
            api.promote(swap_checkpoint(tmp_path))
        assert err.value.reason == "corrupt_checkpoint"
        assert isinstance(err.value.__cause__, checkpoint.CheckpointCorruptError)
        assert any(e.startswith("corrupt-swap:") for e in faultinject.events)
        after = api.classify(xs, ys, xq)
        assert after["state_version"] == 0
        np.testing.assert_array_equal(after["logits"], before)
        assert api.metrics.swap_rejected_total.value == 1
    finally:
        api.close()


def test_nan_logits_fault_rejects_swap_and_emits_event(rng, tmp_path):
    """``nan_next_logits`` poisons the canary's logits: the promote is
    refused with a ``swap_rejected`` event and the old state serves."""
    api = make_api()
    log = events.EventLog(str(tmp_path / "telemetry.jsonl"))
    previous = events.install(log)
    try:
        api.warmup([(5, 1, 3)])
        faultinject.activate(faultinject.FaultPlan(nan_next_logits=1))
        with pytest.raises(SwapRejectedError) as err:
            api.promote(swap_checkpoint(tmp_path))
        assert err.value.reason == "nonfinite_logits"
        assert faultinject.events == ["nan-logits:0"]
        out = api.classify(*episode(rng))
        assert out["state_version"] == 0 and np.isfinite(out["logits"]).all()
        log.flush()
    finally:
        events.install(previous)
        api.close()
    rejected = [e for e in events.read_events(log.path) if e["type"] == "swap_rejected"]
    assert len(rejected) == 1
    assert rejected[0]["reason"] == "nonfinite_logits"
    assert rejected[0]["state_version"] == 0


def test_nan_next_logits_reaches_answers_and_the_pools_counter(rng):
    pool = local_pool(n=2, restart_backoff_s=600.0)
    try:
        faultinject.activate(faultinject.FaultPlan(nan_next_logits=1))
        out = pool.classify(*episode(rng))
        assert np.isnan(out["logits"]).all()
        assert np.isfinite(pool.classify(*episode(rng))["logits"]).all()
        assert pool.stats()["nonfinite_logits_total"] == 1
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# /admin/scale and the pool's answers against JAX
# ---------------------------------------------------------------------------


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.load(resp)


def get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.load(resp)


def test_admin_scale_resizes_a_pool_and_healthz_follows():
    pool = local_pool(n=2, restart_backoff_s=0.02)
    server, thread, base = run_server(pool)
    try:
        for size in (3, 2):
            status, body = post(f"{base}/admin/scale", {"pool_size": size})
            assert status == 200 and body["pool_size"] == size
            assert pool.wait_ready(timeout=60)
            status, health = get(f"{base}/healthz")
            assert status == 200 and health["pool_size"] == size
            assert health["healthy_replicas"] == size and not health["degraded"]
        status, body = post(f"{base}/admin/scale", {"pool_size": 2})
        assert status == 200 and (body["added"], body["removed"]) == (0, 0)
        with pytest.raises(urllib.error.HTTPError) as err:
            post(f"{base}/admin/scale", {"pool_size": 0})
        assert err.value.code == 400
    finally:
        stop_server(server, thread, pool)


def jax_reference(jlearner, jstate, raw):
    japi = JServingAPI(jlearner, jstate, JServeConfig(meta_batch_size=4, max_wait_ms=1.0))
    try:
        return [np.asarray(japi.classify(*e)["logits"]) for e in raw]
    finally:
        japi.close()


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """The JAX learner of CLI_CONFIG, its state saved as a checkpoint the
    port loads, the config's path, and the JAX answers to 6 episodes."""
    from tools.serve_maml import build_learner as jbuild_learner

    root = tmp_path_factory.mktemp("jax_served")
    config = root / "serve_cfg.json"
    config.write_text(json.dumps(CLI_CONFIG))
    os.environ.setdefault("DATASET_DIR", str(root))
    jlearner = jbuild_learner("maml", str(config))
    jstate = jlearner.init_state(jax.random.PRNGKey(11))
    ckpt = str(root / "train_model_0")
    jckpt.save_checkpoint(ckpt, jstate, {"current_iter": 0})
    raw = [episode(np.random.RandomState(40 + i), query=15) for i in range(6)]
    return {"config": str(config), "checkpoint": ckpt, "raw": raw,
            "want": jax_reference(jlearner, jstate, raw)}


def test_local_pool_answers_match_jax_across_a_death(jax_served):
    from howtotrainyourmamlpytorch_tpu_torch import serve_maml

    opts, flags = serve_maml.get_parser().parse_known_args([
        "--config", jax_served["config"], "--checkpoint", jax_served["checkpoint"],
        "--max_batch", "4", "--warmup", "5x1x15", "--use_pallas_fused_norm", "True"])

    def factory(index):
        return LocalReplica(serve_maml.build_api(opts, flags, "cpu")[0], f"local-{index}")

    pool = ReplicaPool(factory, PoolConfig(n_replicas=2, health_interval_s=0.02,
                                           restart_backoff_s=600.0, min_uptime_s=0.0))
    try:
        assert pool.wait_ready(timeout=120)
        faultinject.activate(faultinject.FaultPlan(replica_kill_at_request=2))
        got = [pool.classify(*e) for e in jax_served["raw"]]
        assert pool.metrics.retry_total.value == 1
    finally:
        pool.close()
    for g, want in zip(got, jax_served["want"]):
        np.testing.assert_allclose(g["logits"], want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The production shape: worker processes
# ---------------------------------------------------------------------------


def worker_env(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DATASET_DIR"] = str(tmp_path)
    env["OMP_NUM_THREADS"] = "1"
    env.pop(faultinject.ENV_VAR, None)
    return env


def test_subprocess_pool_end_to_end(jax_served, tmp_path):
    """Two ``serve_maml`` worker processes (``--device cpu``) under the
    pool; worker 0's first spawn exits 86 on its first episode. Every
    request is answered with JAX's logits, the dead worker respawns, and
    ``close`` leaves no worker process."""
    armed = {"fault": True}
    procs = []

    def factory(index: int) -> SubprocessReplica:
        port_file = str(tmp_path / f"replica_{index}_{time.monotonic_ns()}.port")
        env = worker_env(tmp_path)
        if index == 0 and armed.pop("fault", False):
            env[faultinject.ENV_VAR] = "replica_kill_at_request=1"
        argv = serve_maml_argv(jax_served["config"], port_file=port_file,
                               checkpoint=jax_served["checkpoint"], warmup="5x1x15",
                               max_batch=4, max_wait_ms=1.0, device="cpu",
                               train_flags=["--use_pallas_fused_norm", "True"])
        replica = SubprocessReplica(argv, replica_id=f"worker-{index}", env=env,
                                    port_file=port_file, startup_timeout_s=180.0,
                                    log_path=str(tmp_path / f"worker_{index}.log"))
        procs.append(replica)
        return replica

    pool = ReplicaPool(factory, PoolConfig(
        n_replicas=2, health_interval_s=0.2, health_timeout_s=3.0, unhealthy_after=2,
        restart_backoff_s=0.1, min_uptime_s=0.0, dispatch_timeout_s=30.0))
    try:
        assert pool.wait_ready(timeout=180.0), "the worker pool never came up"
        got = [pool.classify(*e, timeout=60.0) for e in jax_served["raw"][:4]]
        assert pool.metrics.replica_deaths_total.value >= 1
        assert pool.metrics.retry_total.value >= 1
        assert procs[0].returncode == REPLICA_KILL_EXIT
        deadline = time.monotonic() + 120
        while pool.healthz()["healthy_replicas"] < 2:
            assert time.monotonic() < deadline, "the worker never respawned"
            time.sleep(0.2)
        assert pool.metrics.replica_restarts_total.value >= 1
        got.append(pool.classify(*jax_served["raw"][4], timeout=60.0))
    finally:
        pool.close()
    assert all(p.returncode is not None for p in procs), "a worker outlived close()"
    for g, want in zip(got, jax_served["want"]):
        np.testing.assert_allclose(np.asarray(g["logits"], np.float32), want,
                                   rtol=RTOL, atol=ATOL)


def test_cli_replicas_serve_and_drain_on_sigterm(jax_served, tmp_path):
    """``python3 -m ...serve_maml --replicas 2 --device cpu``: it names its
    port, answers an episode with JAX's logits, and on SIGTERM stops both
    workers and exits 0."""
    port_file = tmp_path / "front.port"
    log = tmp_path / "front.log"
    cmd = [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve_maml",
           "--config", jax_served["config"], "--checkpoint", jax_served["checkpoint"],
           "--replicas", "2", "--warmup", "5x1x15", "--device", "cpu", "--port", "0",
           "--port_file", str(port_file), "--health_interval_s", "0.2",
           "--tier_dir", str(tmp_path / "tier")]
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, env=worker_env(tmp_path), stdout=out,
                                stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while not port_file.exists():
            assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
            time.sleep(0.05)
        base = f"http://127.0.0.1:{port_file.read_text()}"
        while True:
            try:
                if get(f"{base}/healthz")[1]["healthy_replicas"] == 2:
                    break
            except urllib.error.HTTPError:
                pass
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.2)
        xs, ys, xq = jax_served["raw"][5]
        status, body = post(f"{base}/v1/episode", {
            "support": xs.tolist(), "support_labels": ys.tolist(), "query": xq.tolist()})
        workers = [int(p) for p in subprocess.run(
            ["pgrep", "-P", str(proc.pid)], capture_output=True, text=True).stdout.split()]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert status == 200
    np.testing.assert_allclose(np.asarray(body["logits"], np.float32), jax_served["want"][5],
                               rtol=RTOL, atol=ATOL)
    assert len(workers) == 2
    assert not [pid for pid in workers if os.path.exists(f"/proc/{pid}")], "a worker survived"
    assert sorted(os.listdir(tmp_path / "tier")) == ["replica-0", "replica-1"]

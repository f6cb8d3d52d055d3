"""The port's durable serving tier (CPU), mirroring tests/test_serve_tier.py
by name: the atomic writer, the consistent-hash ring (routes equal to the
JAX ring's), the artifact spill (round trip bit for bit, identity skips,
pruning, torn and corrupt entries quarantined), a warm respawn's repeat
request served from the rehydrated spill for each learner family, the
pool's digest affinity and a dead replica's spill adopted by its ring
successor, and the executable cache's fence on a byte payload (on the CPU
the port loads no kernel library). Every answer is held to the JAX
``ServingAPI`` on the same weights (``convert.py``) and episodes at the
serve bar.

The config has 2 stages of 8 filters on 14x14 images, per-step BN over 2
inner steps, 5-way.
"""

import ctypes
import functools
import os
import threading
import time
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import (
    GradientDescentLearner as JGradientDescentLearner,
    MAMLFewShotLearner as JMAMLFewShotLearner,
    MatchingNetsLearner as JMatchingNetsLearner,
)
from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve import ServingAPI as JServingAPI
from howtotrainyourmamlpytorch_tpu.serve.tier import HashRing as JHashRing
from howtotrainyourmamlpytorch_tpu.utils import faultinject as jfi
from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    PoolConfig,
    ReplicaPool,
    ServeConfig,
    ServingAPI,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import LocalReplica
from howtotrainyourmamlpytorch_tpu_torch.serve.tier import (
    ArtifactSpill,
    ExecutableCache,
    HashRing,
    atomic_write_bytes,
    build_fence,
    serialization_available,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.tier.execcache import PROGRAM
from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject
from test_torch_serve_runtime import (  # noqa: F401 (one_intra_op_thread)
    ATOL,
    FAMILIES,
    RTOL,
    episode,
    jax_tiny_cfg,
    one_intra_op_thread,
    port_state_of,
)
from test_torch_train import port_config

JFAMILIES = {
    "maml": JMAMLFewShotLearner,
    "gradient_descent": JGradientDescentLearner,
    "matching_nets": JMatchingNetsLearner,
}


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.deactivate()
    yield
    faultinject.deactivate()


@functools.lru_cache(maxsize=None)
def family(name):
    """``(jax learner, jax state, port learner, port state)`` from one JAX
    init."""
    jcfg = jax_tiny_cfg()
    jlearner, learner = JFAMILIES[name](jcfg), FAMILIES[name](port_config(jcfg))
    jstate = jlearner.init_state(jax.random.PRNGKey(3))
    return jlearner, jstate, learner, port_state_of(jlearner, learner, jstate)


@functools.lru_cache(maxsize=None)
def jax_logits(name, seeds):
    """The JAX ``ServingAPI``'s logits of ``episode(RandomState(seed))``."""
    jlearner, jstate, _, _ = family(name)
    japi = JServingAPI(jlearner, jstate, JServeConfig(meta_batch_size=2, max_wait_ms=0.0))
    try:
        return [np.asarray(japi.classify(*episode(np.random.RandomState(s)))["logits"])
                for s in seeds]
    finally:
        japi.close()


def make_api(tier_dir, name="maml", **serve_kw):
    _, _, learner, state = family(name)
    defaults = dict(meta_batch_size=2, max_wait_ms=0.0, tier_dir=str(tier_dir))
    return ServingAPI(learner, state, ServeConfig(**{**defaults, **serve_kw}), device="cpu")


def held_to_jax(name, seeds, answers):
    for want, got in zip(jax_logits(name, tuple(seeds)), answers):
        np.testing.assert_allclose(np.asarray(got["logits"]), want, rtol=RTOL, atol=ATOL)


class Pair(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor


def toy_artifact(seed):
    gen = torch.Generator().manual_seed(seed)
    return {
        "conv": Pair(torch.rand((3, 4), generator=gen), torch.rand(4, generator=gen)),
        "half": torch.rand(5, generator=gen).to(torch.bfloat16),
        "labels": (torch.arange(5, dtype=torch.int32), None),
        "count": torch.tensor(7),
    }


def digest_of(i: int) -> str:
    return f"{i:064x}"


# ---------------------------------------------------------------------------
# Atomic writer and artifact spill
# ---------------------------------------------------------------------------


def test_atomic_write_leaves_no_temp_residue(tmp_path):
    path = tmp_path / "sub" / "artifact.bin"
    atomic_write_bytes(str(path), b"payload")
    assert path.read_bytes() == b"payload"
    assert [p.name for p in path.parent.iterdir()] == ["artifact.bin"]


def assert_same_tree(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_spill_round_trip_bit_exact(tmp_path):
    spill = ArtifactSpill(str(tmp_path))
    artifact = toy_artifact(0)
    assert spill.put(digest_of(1), artifact, learner="maml", state_version=0)
    assert not spill.put(digest_of(1), artifact, learner="maml", state_version=0)
    back = spill.get(digest_of(1), learner="maml", state_version=0)
    assert_same_tree(artifact, back)
    assert spill.stats["hits"] == 1 and spill.stats["writes"] == 1


def test_spill_version_or_learner_mismatch_is_a_skip_not_a_quarantine(tmp_path):
    spill = ArtifactSpill(str(tmp_path))
    spill.put(digest_of(2), toy_artifact(1), learner="maml", state_version=0)
    assert spill.get(digest_of(2), learner="maml", state_version=1) is None
    assert spill.get(digest_of(2), learner="gradient_descent", state_version=0) is None
    assert spill.stats["mismatch_skipped"] == 2
    assert spill.stats["corrupt_quarantined"] == 0
    assert spill.get(digest_of(2), learner="maml", state_version=0) is not None


def test_spill_prune_bounds_entry_count(tmp_path):
    spill = ArtifactSpill(str(tmp_path), max_entries=2)
    for i in range(5):
        spill.put(digest_of(i), toy_artifact(i), learner="maml", state_version=0)
        time.sleep(0.01)  # distinct mtimes: a deterministic prune order
    assert len(spill.entries()) <= 2
    assert spill.stats["pruned"] >= 3
    assert spill.get(digest_of(4), learner="maml", state_version=0) is not None


# ---------------------------------------------------------------------------
# Fault hooks: torn write, bit rot -> quarantine and the cold path
# ---------------------------------------------------------------------------


def test_torn_spill_write_is_quarantined_on_read(tmp_path):
    spill = ArtifactSpill(str(tmp_path))
    faultinject.activate(faultinject.FaultPlan(torn_spill_write_at=1))
    spill.put(digest_of(7), toy_artifact(3), learner="maml", state_version=0)
    assert any(e.startswith("torn-spill:") for e in faultinject.events)
    faultinject.deactivate()
    assert spill.get(digest_of(7), learner="maml", state_version=0) is None
    assert spill.stats["corrupt_quarantined"] == 1
    assert os.path.exists(spill.path_for(digest_of(7)) + ".corrupt")
    assert not os.path.exists(spill.path_for(digest_of(7)))


def test_corrupt_cache_entry_is_quarantined_on_read(tmp_path):
    spill = ArtifactSpill(str(tmp_path))
    spill.put(digest_of(9), toy_artifact(4), learner="maml", state_version=0)
    faultinject.activate(faultinject.FaultPlan(corrupt_cache_entry_at=1))
    assert spill.get(digest_of(9), learner="maml", state_version=0) is None
    assert any(e.startswith("corrupt-entry:") for e in faultinject.events)
    assert spill.stats["corrupt_quarantined"] == 1
    assert os.path.exists(spill.path_for(digest_of(9)) + ".corrupt")


def test_corrupt_entry_degrades_to_cold_adapt_same_answer(tmp_path):
    """A bit-flipped spill entry costs only the adapt: the respawned engine
    quarantines it, adapts cold and answers what the warm path answered,
    and what JAX answers."""
    xs, ys, xq = episode(np.random.RandomState(11))
    api1 = make_api(tmp_path)
    try:
        warm = api1.classify(xs, ys, xq)
    finally:
        api1.close()
    faultinject.activate(faultinject.FaultPlan(corrupt_cache_entry_at=1))
    api2 = make_api(tmp_path)
    try:
        cold = api2.classify(xs, ys, xq)
        stats = api2.engine.tier_stats()
    finally:
        api2.close()
    assert not cold["cache_hit"], "a corrupt entry must not serve as a hit"
    np.testing.assert_array_equal(warm["logits"], cold["logits"])
    assert stats["spill"]["corrupt_quarantined"] == 1
    held_to_jax("maml", [11], [cold])


# ---------------------------------------------------------------------------
# Warm respawn: the rehydrated hot set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JFAMILIES))
def test_respawn_first_repeat_request_hits_without_readapt(tmp_path, name):
    """Each family: the artifact one engine spilled is rehydrated bit for
    bit by the next one on the same tier, whose first repeat request is a
    cache hit with no adapt, with the same logits as JAX's."""
    xs, ys, xq = episode(np.random.RandomState(5))
    api1 = make_api(tmp_path, name)
    try:
        first = api1.classify(xs, ys, xq)
        assert not first["cache_hit"]
    finally:
        api1.close()  # lands the write-through
    api2 = make_api(tmp_path, name)
    try:
        again = api2.classify(xs, ys, xq)
        adapts = api2.metrics.adapt_latency.snapshot()["count"]
        stats = api2.engine.tier_stats()
    finally:
        api2.close()
    assert again["cache_hit"], "a rehydrated digest must hit, not adapt again"
    assert adapts == 0 and stats["spill"]["hits"] == 1
    np.testing.assert_array_equal(first["logits"], again["logits"])
    held_to_jax(name, [5], [again])


def test_spill_writes_run_off_the_dispatch_thread(tmp_path, monkeypatch):
    """The write-through (the copy to the host, the encode, the disk)
    runs on the cache's writer thread, never on the batcher's worker."""
    threads = []
    put = ArtifactSpill.put

    def recording(self, *args, **kwargs):
        threads.append(threading.current_thread().name)
        return put(self, *args, **kwargs)

    monkeypatch.setattr(ArtifactSpill, "put", recording)
    api = make_api(tmp_path)
    try:
        for seed in (1, 2):
            api.classify(*episode(np.random.RandomState(seed)))
        api.engine.cache.flush_spill()
        stats = api.engine.tier_stats()
    finally:
        api.close()
    assert threads == ["spill-writer"] * 2
    assert stats["spill"]["writes"] == 2 and stats["spill_write_s"] > 0


def test_publish_rekeys_the_spill(tmp_path):
    """After a publish, spill reads verify against the new version: the
    old entries are unreachable and new ones land under the new digest."""
    xs, ys, xq = episode(np.random.RandomState(8))
    api = make_api(tmp_path)
    try:
        api.classify(xs, ys, xq)
        _, _, _, state = family("maml")
        assert api.update_state(state) == 1
        again = api.classify(xs, ys, xq)
        api.engine.cache.flush_spill()
        stats = api.engine.tier_stats()
    finally:
        api.close()
    assert not again["cache_hit"] and again["state_version"] == 1
    assert stats["spill"]["writes"] == 2
    api2 = make_api(tmp_path)  # a respawn boots at version 0 again
    try:
        assert len(api2.engine.cache) == 1  # only the version-0 entry adopts
    finally:
        api2.close()


def test_engine_on_the_cpu_loads_no_kernel_library(tmp_path):
    api = make_api(tmp_path)
    try:
        stats = api.engine.tier_stats()
        health = api.healthz()
    finally:
        api.close()
    assert stats["kernel_library"] is None and stats["nvcc_builds"] == 0
    assert stats["exec"] == dict.fromkeys(stats["exec"], 0)
    assert health["tier"]["spill"] == stats["spill"]
    assert not serialization_available()
    _, _, learner, state = family("maml")
    plain = ServingAPI(learner, state, ServeConfig(meta_batch_size=2), device="cpu")
    try:
        assert plain.engine.tier_stats() is None and "tier" not in plain.healthz()
    finally:
        plain.close()


# ---------------------------------------------------------------------------
# The executable cache on a byte payload
# ---------------------------------------------------------------------------


def test_exec_cache_fence_names_the_build_provenance(tmp_path):
    fence = build_fence(PROGRAM, fused_norm.library_digest(), "cpu")
    for field in ("torch", "cuda", "driver", "device_name", "sm", "nvcc_flags",
                  "program", "signature"):
        assert field in fence, fence
    assert fence["torch"] == torch.__version__
    assert fence["nvcc_flags"] == " ".join(fused_norm.NVCC_FLAGS)
    cache = ExecutableCache(str(tmp_path), device="cpu")
    assert cache.get(PROGRAM, "sig") is None
    assert cache.stats["misses"] == 1


def test_exec_cache_round_trip_stale_and_corrupt_on_a_byte_payload(tmp_path):
    """A stored payload comes back verified; a drifted fence is refused as
    stale (typed, counted, the file kept for the rebuild to overwrite); a
    flipped payload byte is quarantined."""
    cache = ExecutableCache(str(tmp_path), device="cpu")
    payload = bytes(range(256)) * 40
    sig = fused_norm.library_digest()
    assert cache.put(PROGRAM, sig, payload)
    assert cache.get(PROGRAM, sig) == payload and cache.stats["hits"] == 1
    faultinject.activate(faultinject.FaultPlan(stale_exec_cache_at=1))
    assert cache.get(PROGRAM, sig) is None
    assert faultinject.events == ["stale-exec-fence"]
    assert cache.stats["stale"] == 1 and cache.has(PROGRAM, sig)
    assert cache.get(PROGRAM, sig) == payload  # one-shot
    path = cache.path_for(PROGRAM, sig)
    raw = bytearray(open(path, "rb").read())
    raw[-10] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    assert cache.get(PROGRAM, sig) is None
    assert cache.stats["corrupt_quarantined"] == 1
    assert os.path.exists(path + ".corrupt") and not cache.has(PROGRAM, sig)
    other = ExecutableCache(str(tmp_path), device="cpu")
    assert other.path_for(PROGRAM, "another digest") != path


def test_kernel_library_loads_from_its_verified_bytes():
    """``fused_norm.dlopen_bytes`` loads a library from memory (here the C
    math library this process has mapped), as a respawn loads the kernel
    library from its executable cache."""
    with open("/proc/self/maps") as f:
        path = next(line.split()[-1] for line in f if "/libm." in line)
    with open(path, "rb") as f:
        lib = fused_norm.dlopen_bytes(f.read())
    lib.cos.restype, lib.cos.argtypes = ctypes.c_double, [ctypes.c_double]
    assert lib.cos(0.0) == 1.0


# ---------------------------------------------------------------------------
# Consistent-hash ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nodes", [(0, 1, 2), (0, 1, 2, 3, 4)])
def test_ring_routes_equal_the_jax_ring(nodes):
    """1000 keys route to the same owners as on the JAX ring, before and
    after a removal, and every removed node has the same successor."""
    ring, jring = HashRing(), JHashRing()
    for node in nodes:
        ring.add(node)
        jring.add(node)
    keys = [f"episode-{i}" for i in range(1000)]
    assert [ring.route(k) for k in keys] == [jring.route(k) for k in keys]
    ring.remove(nodes[1])
    jring.remove(nodes[1])
    assert [ring.route(k) for k in keys] == [jring.route(k) for k in keys]
    assert ring.successor(nodes[1]) == jring.successor(nodes[1])
    assert ring.nodes == jring.nodes


def test_ring_spreads_keys_and_routes_deterministically():
    ring = HashRing()
    for node in (0, 1, 2):
        ring.add(node)
    keys = [f"episode-{i}" for i in range(300)]
    owners = {k: ring.route(k) for k in keys}
    assert all(sum(1 for o in owners.values() if o == n) > 0 for n in (0, 1, 2))
    assert all(ring.route(k) == owners[k] for k in keys)


def test_ring_removal_moves_only_the_dead_nodes_keys():
    ring = HashRing()
    for node in (0, 1, 2):
        ring.add(node)
    keys = [f"episode-{i}" for i in range(300)]
    before = {k: ring.route(k) for k in keys}
    ring.remove(1)
    assert 1 not in ring and len(ring) == 2
    moved = [k for k in keys if ring.route(k) != before[k]]
    assert set(moved) == {k for k in keys if before[k] == 1}
    assert ring.successor(1) in (0, 2)


def test_ring_empty_routes_none():
    ring = HashRing()
    assert ring.route("anything") is None
    ring.add(3)
    assert ring.route("anything") == 3
    ring.remove(3)
    assert ring.route("anything") is None
    with pytest.raises(ValueError):
        HashRing(vnodes=0)


# ---------------------------------------------------------------------------
# Fleet routing and a dead replica's spill
# ---------------------------------------------------------------------------


def tier_pool(tier_root, n=2, **pool_kw):
    def factory(index: int) -> LocalReplica:
        api = make_api(os.path.join(str(tier_root), f"replica-{index}"))
        api.warmup([(5, 1, 3)])
        return LocalReplica(api, replica_id=f"local-{index}")

    defaults = dict(n_replicas=n, health_interval_s=0.02, health_timeout_s=1.0,
                    unhealthy_after=2, restart_backoff_s=0.02, restart_backoff_max_s=1.0,
                    min_uptime_s=0.0, route_by_digest=True, tier_root=str(tier_root))
    pool = ReplicaPool(factory, PoolConfig(**{**defaults, **pool_kw}))
    assert pool.wait_ready(timeout=120.0), "pool never became healthy"
    return pool


SEEDS = tuple(range(20, 26))


def test_pool_digest_affinity_repeat_traffic_all_hits(tmp_path):
    pool = tier_pool(tmp_path)
    try:
        episodes = [episode(np.random.RandomState(s)) for s in SEEDS]
        first = [pool.classify(*e) for e in episodes]
        again = [pool.classify(*e) for e in episodes]
        assert all(a["cache_hit"] for a in again), "digest affinity broke"
        assert pool.stats()["ring_nodes"] == 2
        assert pool.stats()["replica_ready_s"] is not None
    finally:
        pool.close()
    held_to_jax("maml", SEEDS, first)


def test_killed_replica_spill_adopted_by_successor(tmp_path):
    """A death under traffic: the request is answered, the ring re-forms,
    the successor adopts the dead replica's spill, and the dead replica's
    episodes keep hitting, with JAX's logits."""
    pool = tier_pool(tmp_path)
    try:
        episodes = [episode(np.random.RandomState(s)) for s in SEEDS]
        for e in episodes:
            pool.classify(*e)
        for slot in pool._slots:
            slot.replica.api.engine.cache.flush_spill()
        faultinject.activate(faultinject.FaultPlan(replica_kill_at_request=1))
        assert "logits" in pool.classify(*episodes[0])
        faultinject.deactivate()
        deadline = time.time() + 30.0
        while time.time() < deadline:
            s = pool.stats()
            if s["rehydrations_total"] >= 1 and s["ring_nodes"] == 2:
                break
            time.sleep(0.02)
        s = pool.stats()
        assert s["replica_deaths_total"] >= 1
        assert s["rehydrations_total"] >= 1, s
        assert s["ring_nodes"] == 2, s
        answers = [pool.classify(*e) for e in episodes]
        assert all(a["cache_hit"] for a in answers)
        assert pool.stats()["request_errors"] == 0
        text = pool.metrics_text()
        assert "_rehydrations_total" in text and "_replica_ready_s" in text
    finally:
        pool.close()
    held_to_jax("maml", SEEDS, answers)


def test_tier_fault_plans_match_jax_events(tmp_path):
    """The three tier faults fire at the same count with the same events
    as the JAX hooks."""
    for module in (faultinject, jfi):
        module.activate(module.FaultPlan(torn_spill_write_at=2))
    for _ in range(2):
        got, want = faultinject.torn_spill_write(b"abcdef"), jfi.torn_spill_write(b"abcdef")
        assert got == want
    assert faultinject.events == jfi.events == ["torn-spill:3"]

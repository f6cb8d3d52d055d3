"""The port's serving runtime mechanics (CPU): the per-signature dispatch
table, the adapted-params cache, the micro-batcher, the atomic hot swap
and the front door's validation, mirroring tests/test_serve_runtime.py
by name; plus the engine's one interface over the learners that take a
task axis and those that take one task a call, held to the JAX engine.

The config has 2 stages of 8 filters on 14x14 images, per-step BN over 2
inner steps, 5-way. Weights go across from JAX with ``convert.py``;
episodes come from numpy ``RandomState`` seeds.
"""

import dataclasses
import json
import sys
import tempfile
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import (
    ANILLearner as JANILLearner,
    BackboneConfig as JBackboneConfig,
    MAMLConfig as JMAMLConfig,
    ProtoNetsLearner as JProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve import ServingEngine as JServingEngine
from howtotrainyourmamlpytorch_tpu.serve import support_digest as jsupport_digest
from howtotrainyourmamlpytorch_tpu.serve.cache import routing_digest as jrouting_digest
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    inference_state_from_numpy,
    shared_state_from_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    BackboneConfig,
    GradientDescentLearner,
    MAMLConfig,
    MAMLFewShotLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    AdaptedParamsCache,
    DeadlineExceededError,
    DispatchFailedError,
    MicroBatcher,
    ServeConfig,
    ServingAPI,
    ServingEngine,
    routing_digest,
    support_digest,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.tier import ArtifactSpill
from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map
from test_torch_gradient_descent import shared_state_numpy
from test_torch_train import one_intra_op_thread, port_config  # noqa: F401

IMAGE = (1, 14, 14)
# The serve bar of tests/test_torch_serve.py.
RTOL, ATOL = 1e-4, 1e-5
FAMILIES = {
    "maml": MAMLFewShotLearner,
    "anil": ANILLearner,
    "gradient_descent": GradientDescentLearner,
    "matching_nets": MatchingNetsLearner,
    "protonets": ProtoNetsLearner,
}


TINY = dict(num_stages=2, num_filters=8, image_height=14, image_width=14,
            num_classes=5, per_step_bn_statistics=True, num_steps=2)


def tiny_cfg(**backbone) -> MAMLConfig:
    return MAMLConfig(
        backbone=BackboneConfig(**{**TINY, **backbone}),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
    )


def jax_tiny_cfg(**backbone) -> JMAMLConfig:
    return JMAMLConfig(
        backbone=JBackboneConfig(**{**TINY, **backbone}),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
    )


def fresh_state(learner, seed=0):
    return learner.init_inference_state(torch.Generator().manual_seed(seed), "cpu")


def make_engine(cls=MAMLFewShotLearner, seed=0, **serve_kw):
    learner = cls(tiny_cfg())
    return ServingEngine(learner, fresh_state(learner, seed), ServeConfig(**serve_kw),
                         device="cpu")


def make_api(cls=MAMLFewShotLearner, seed=0, **serve_kw):
    learner = cls(tiny_cfg())
    return ServingAPI(learner, fresh_state(learner, seed), ServeConfig(**serve_kw),
                      device="cpu")


def episode(rng, way=5, shot=1, query=3):
    xs = rng.rand(way * shot, *IMAGE).astype(np.float32)
    ys = np.repeat(np.arange(way), shot).astype(np.int32)
    xq = rng.rand(query, *IMAGE).astype(np.float32)
    return xs, ys, xq


def port_state_of(jlearner, learner, jstate):
    """The port's copy of a JAX learner's train state, by ``convert.py``."""
    if isinstance(learner, MAMLFewShotLearner):
        theta, lslr, bn = jax.tree.map(np.asarray, tuple(jlearner.inference_state(jstate)))
        return inference_state_from_numpy(
            (theta, lslr, {k: tuple(v) for k, v in bn.items()}), "cpu"
        )
    lr = float(jstate.opt_state.hyperparams["learning_rate"])
    return shared_state_from_numpy(shared_state_numpy(jstate), learner.state_type, lr, "cpu")


# ---------------------------------------------------------------------------
# The dispatch signature table
# ---------------------------------------------------------------------------


def test_mixed_shape_stream_compiles_once_per_bucket(rng):
    """Three passes over a stream of 5w1s, 5w5s, 3w1s at several query
    counts: one table entry per support and per query shape, each once."""
    engine = make_engine(meta_batch_size=2, max_wait_ms=0.0)
    stream = [(5, 1, 3), (5, 5, 3), (3, 1, 2), (5, 1, 15), (5, 1, 3)]
    for _ in range(3):
        for way, shot, query in stream:
            engine.dispatch([engine.prepare_episode(*episode(rng, way, shot, query))])
    assert engine.compile_table() == {
        "adapt:2x5": 1, "adapt:2x25": 1, "adapt:2x3": 1,
        "classify:2x3": 1, "classify:2x2": 1, "classify:2x15": 1,
    }


def test_traffic_level_does_not_mint_signatures(rng):
    """1, 2 and 3 episodes of one bucket all ride the padded task axis."""
    engine = make_engine(meta_batch_size=3, max_wait_ms=0.0)
    eps = [engine.prepare_episode(*episode(rng)) for _ in range(6)]
    engine.dispatch(eps[:1])
    engine.dispatch(eps[1:3])
    engine.dispatch(eps[3:6])
    assert engine.compile_table() == {"adapt:3x5": 1, "classify:3x3": 1}
    assert engine.metrics.padded_tasks.value == 3


def test_warmup_precompiles_declared_buckets(rng):
    engine = make_engine(meta_batch_size=2, max_wait_ms=0.0)
    assert not engine.ready
    engine.warmup([(5, 1, 3), (5, 5, 3)])
    assert engine.ready and len(engine.cache) == 0, "warmup takes no cache room"
    assert engine.warmed_buckets() == [(5, 1, 3), (5, 5, 3)]
    before = engine.compile_table()
    engine.dispatch([engine.prepare_episode(*episode(rng, 5, 5, 3))])
    assert engine.compile_table() == before == {
        "adapt:2x5": 1, "adapt:2x25": 1, "classify:2x3": 1,
    }
    assert engine.metrics.episodes_served.value == 1
    with pytest.raises(ValueError, match="explicit buckets"):
        engine.warmup()


# ---------------------------------------------------------------------------
# Adapted-params cache
# ---------------------------------------------------------------------------


def test_cache_lru_eviction_and_digest():
    cache = AdaptedParamsCache(capacity=2)
    keys = []
    for seed in range(3):
        xs, ys, _ = episode(np.random.RandomState(seed))
        keys.append(support_digest(xs, ys, learner="maml", state_version=0))
        assert keys[-1] == jsupport_digest(xs, ys, learner="maml", state_version=0)
    assert len(set(keys)) == 3
    cache.put(keys[0], "a")
    cache.put(keys[1], "b")
    assert cache.get(keys[0]) == "a"  # refreshes recency
    cache.put(keys[2], "c")  # evicts keys[1]
    assert keys[1] not in cache and keys[0] in cache
    assert cache.get(keys[0]) == "a" and cache.get(keys[2]) == "c"
    assert cache.evictions == 1
    cache.clear()
    assert len(cache) == 0 and keys[0] not in cache
    xs, ys, _ = episode(np.random.RandomState(0))
    assert support_digest(xs, ys, learner="maml", state_version=0) != support_digest(
        xs.astype(np.uint8), ys, learner="maml", state_version=0
    )
    mask = np.asarray([1, 1, 1, 0, 0], np.float32)
    assert support_digest(xs, ys, learner="maml", state_version=2, mask=mask) == (
        jsupport_digest(xs, ys, learner="maml", state_version=2, mask=mask)
    )
    assert routing_digest(xs, ys) == jrouting_digest(xs, ys)
    # A disk tier behind the LRU: write-through on put, a verified read
    # promoted into RAM on a miss.
    with tempfile.TemporaryDirectory() as tmp:
        spill = ArtifactSpill(tmp)
        cache.attach_spill(spill, learner="maml", state_version=0)
        cache.put(keys[0], (0, {"w": torch.arange(3.0)}))
        cache.flush_spill()
        cache.clear()
        version, artifact = cache.get(keys[0])
        assert version == 0 and torch.equal(artifact["w"], torch.arange(3.0))
        assert cache.spill_hits == 1 and spill.stats["writes"] == 1
        cache.close()


def test_cache_hit_skips_adapt_program(rng):
    engine = make_engine(meta_batch_size=2, max_wait_ms=0.0)
    xs, ys, xq = episode(rng)
    engine.dispatch([engine.prepare_episode(xs, ys, xq)])
    adapt_count = engine.metrics.adapt_latency.snapshot()["count"]
    engine.dispatch([engine.prepare_episode(xs, ys, episode(rng)[2])])
    assert engine.metrics.adapt_latency.snapshot()["count"] == adapt_count == 1
    assert engine.metrics.cache_hits.value == 1
    assert engine.metrics.cache_misses.value == 1


def test_state_swap_invalidates_cache(rng):
    learner = MAMLFewShotLearner(tiny_cfg())
    engine = ServingEngine(learner, fresh_state(learner, 0),
                           ServeConfig(meta_batch_size=2, max_wait_ms=0.0), device="cpu")
    xs, ys, xq = episode(rng)
    first = engine.dispatch([engine.prepare_episode(xs, ys, xq)])[0]
    assert len(engine.cache) == 1
    assert engine.update_state(fresh_state(learner, 1)) == 1
    assert len(engine.cache) == 0
    second = engine.dispatch([engine.prepare_episode(xs, ys, xq)])[0]
    assert engine.metrics.cache_hits.value == 0
    assert not np.array_equal(first, second), "new weights must answer"


def test_cached_artifact_is_used_only_under_its_version(rng):
    """An episode prepared before a swap, whose digest an in-flight dispatch
    cached after the swap's clear, is adapted again under the new state,
    never classified with the old fast weights."""
    learner = MAMLFewShotLearner(tiny_cfg())
    s0, s1 = fresh_state(learner, 0), fresh_state(learner, 1)
    engine = ServingEngine(learner, s0, ServeConfig(meta_batch_size=2), device="cpu")
    ep = engine.prepare_episode(*episode(rng))
    old = engine.dispatch([ep])[0]
    engine.update_state(s1)
    stale = learner.serve_adapt(s0, torch.from_numpy(ep.x_support[None]),
                                torch.from_numpy(ep.y_support[None]))
    engine.cache.put(ep.digest, (0, tree_map(lambda a: a[0], stale)))  # the late put
    again = engine.dispatch([ep])[0]
    fresh = ServingEngine(learner, s1, ServeConfig(meta_batch_size=2), device="cpu")
    np.testing.assert_array_equal(again, fresh.dispatch([fresh.prepare_episode(
        ep.x_support, ep.y_support, ep.x_query)])[0])
    assert not np.array_equal(again, old)
    assert engine.metrics.cache_hits.value == 0


def test_mn_cache_artifact_is_embeddings_not_params(rng):
    """Matching nets cache support embeddings, not parameter trees."""
    engine = make_engine(MatchingNetsLearner, meta_batch_size=2, max_wait_ms=0.0)
    ep = engine.prepare_episode(*episode(rng))
    engine.dispatch([ep])
    version, artifact = engine.cache.get(ep.digest)
    assert version == 0
    assert set(artifact) == {"support_emb", "support_labels"}
    assert artifact["support_emb"].shape == (5, 5)


# ---------------------------------------------------------------------------
# One interface over both serving forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_serves_each_family_as_its_own_serving_halves(family, rng):
    """Three episodes padded to four tasks: each episode's logits equal the
    learner's own adapt and classify of that task, bit for bit (per task
    for the one-task families, at task 0 of a one-task axis for MAML and
    ANIL)."""
    learner = FAMILIES[family](tiny_cfg())
    state = fresh_state(learner, 3)
    engine = ServingEngine(learner, state, ServeConfig(meta_batch_size=4), device="cpu")
    assert engine.family == family
    eps = [engine.prepare_episode(*episode(rng, query=4)) for _ in range(3)]
    got = engine.dispatch(eps)
    istate = learner.inference_state(state)
    t = torch.from_numpy
    for ep, logits in zip(eps, got):
        if isinstance(learner, MAMLFewShotLearner):
            pad = [np.stack([getattr(ep, k)] * 4) for k in ("x_support", "y_support", "x_query")]
            adapted = learner.serve_adapt(istate, t(pad[0]), t(pad[1]))
            want = learner.serve_classify(istate, adapted, t(pad[2]))[0]
        else:
            adapted = learner.serve_adapt(istate, t(ep.x_support), t(ep.y_support))
            want = learner.serve_classify(istate, adapted, t(ep.x_query))
        np.testing.assert_array_equal(logits, want.numpy())


@pytest.mark.parametrize(
    "family,jcls", [("anil", JANILLearner), ("protonets", JProtoNetsLearner)]
)
def test_engine_dispatch_matches_jax(family, jcls, rng):
    """The two families the HTTP parity test leaves out, through both
    engines from the same weights, padding and cache hit included."""
    jcfg = jax_tiny_cfg()
    jlearner, learner = jcls(jcfg), FAMILIES[family](port_config(jcfg))
    jstate = jlearner.init_state(jax.random.PRNGKey(4))
    jengine = JServingEngine(jlearner, jstate, JServeConfig(meta_batch_size=4))
    engine = ServingEngine(learner, port_state_of(jlearner, learner, jstate),
                           ServeConfig(meta_batch_size=4), device="cpu")
    raw = [episode(rng, query=15) for _ in range(3)]
    raw.append(raw[0])
    jeps = [jengine.prepare_episode(*e) for e in raw]
    eps = [engine.prepare_episode(*e) for e in raw]
    assert [e.digest for e in eps] == [e.digest for e in jeps]
    for got, want in zip(engine.dispatch(eps[:3]) + engine.dispatch(eps[3:]),
                         jengine.dispatch(jeps[:3]) + jengine.dispatch(jeps[3:])):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert engine.metrics.cache_hits.value == jengine.metrics.cache_hits.value == 1


# ---------------------------------------------------------------------------
# Micro-batcher
# ---------------------------------------------------------------------------


def test_batcher_collates_full_group_into_one_dispatch(rng):
    engine = make_engine(meta_batch_size=3, max_wait_ms=5000.0)
    batcher = MicroBatcher(engine)
    try:
        eps = [engine.prepare_episode(*episode(rng)) for _ in range(3)]
        logits = [f.result(timeout=30) for f in [batcher.submit(ep) for ep in eps]]
    finally:
        batcher.close()
    assert engine.metrics.batches_dispatched.value == 1
    assert engine.metrics.padded_tasks.value == 0
    assert all(lg.shape == (3, 5) for lg in logits)


def test_batcher_serves_the_bits_of_a_direct_dispatch(rng):
    """The worker thread runs the device work: its logits equal a direct
    dispatch on the caller's thread, bit for bit."""
    engine = make_engine(meta_batch_size=4, max_wait_ms=5000.0, cache_capacity=0)
    eps = [engine.prepare_episode(*episode(rng)) for _ in range(4)]
    direct = engine.dispatch(eps)
    batcher = MicroBatcher(engine)
    try:
        batched = [f.result(timeout=30) for f in [batcher.submit(ep) for ep in eps]]
    finally:
        batcher.close()
    for a, b in zip(batched, direct):
        np.testing.assert_array_equal(a, b)


def test_batcher_deadline_flushes_partial_group(rng):
    engine = make_engine(meta_batch_size=4, max_wait_ms=10.0)
    batcher = MicroBatcher(engine)
    try:
        t0 = time.perf_counter()
        logits = batcher.submit(engine.prepare_episode(*episode(rng))).result(timeout=30)
        waited_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batcher.close()
    assert logits.shape == (3, 5)
    assert waited_ms >= 10.0, "a partial group waits out its window"
    assert engine.metrics.padded_tasks.value == 3


def test_batcher_groups_by_bucket(rng):
    engine = make_engine(meta_batch_size=2, max_wait_ms=20.0)
    batcher = MicroBatcher(engine)
    try:
        futs = []
        for way, shot, query in [(5, 1, 3), (3, 1, 2), (5, 1, 3), (3, 1, 2)]:
            ep = engine.prepare_episode(*episode(rng, way, shot, query))
            futs.append((query, batcher.submit(ep)))
        for query, fut in futs:
            assert fut.result(timeout=30).shape == (query, 5)
    finally:
        batcher.close()
    assert engine.metrics.batches_dispatched.value == 2
    table = engine.metrics.bucket_table()
    assert table[(5, 1, 3)]["episodes"] == 2
    assert table[(3, 1, 2)]["episodes"] == 2


def test_batcher_propagates_dispatch_errors_typed(rng, monkeypatch):
    engine = make_engine(meta_batch_size=2, max_wait_ms=0.0)
    batcher = MicroBatcher(engine)

    def boom(eps):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(engine, "dispatch", boom)
    try:
        future = batcher.submit(engine.prepare_episode(*episode(rng)))
        with pytest.raises(DispatchFailedError, match="device fell over") as err:
            future.result(timeout=30)
        assert isinstance(err.value.__cause__, RuntimeError)
    finally:
        batcher.close()


def test_batcher_worker_survives_poisoned_episode(rng):
    """A poisoned episode (labels past the head, built around the front
    door's checks) fails its own group; the worker lives and serves the
    next one."""
    engine = make_engine(meta_batch_size=2, max_wait_ms=0.0)
    batcher = MicroBatcher(engine)
    try:
        good = engine.prepare_episode(*episode(rng))
        poisoned = dataclasses.replace(good, y_support=good.y_support + 50,
                                       digest="poisoned")
        with pytest.raises(DispatchFailedError):
            batcher.submit(poisoned).result(timeout=30)
        assert batcher._worker.is_alive(), "the worker must survive"
        ok = batcher.submit(engine.prepare_episode(*episode(rng)))
        assert ok.result(timeout=30).shape == (3, 5)
    finally:
        batcher.close()


def test_batcher_worker_survives_result_count_mismatch(rng, monkeypatch):
    engine = make_engine(meta_batch_size=2, max_wait_ms=0.0)
    batcher = MicroBatcher(engine)
    real_dispatch = engine.dispatch
    monkeypatch.setattr(engine, "dispatch", lambda eps: [])
    try:
        future = batcher.submit(engine.prepare_episode(*episode(rng)))
        with pytest.raises(DispatchFailedError, match="0 results"):
            future.result(timeout=30)
        monkeypatch.setattr(engine, "dispatch", real_dispatch)
        ok = batcher.submit(engine.prepare_episode(*episode(rng)))
        assert ok.result(timeout=30).shape == (3, 5)
    finally:
        batcher.close()


def test_expired_deadline_dropped_before_dispatch(rng):
    engine = make_engine(meta_batch_size=4, max_wait_ms=30.0)
    batcher = MicroBatcher(engine)
    try:
        ep = engine.prepare_episode(*episode(rng))
        ep.deadline = time.monotonic()  # expired on arrival
        with pytest.raises(DeadlineExceededError):
            batcher.submit(ep).result(timeout=30)
        assert engine.metrics.batches_dispatched.value == 0
        assert engine.metrics.deadline_exceeded_total.value == 1
        assert issubclass(DeadlineExceededError, TimeoutError)
    finally:
        batcher.close()


def test_tight_deadline_flushes_group_early(rng):
    engine = make_engine(meta_batch_size=4, max_wait_ms=60_000.0)
    batcher = MicroBatcher(engine)
    try:
        ep = engine.prepare_episode(*episode(rng))
        ep.deadline = time.monotonic() + 0.1
        t0 = time.perf_counter()
        logits = batcher.submit(ep).result(timeout=30)
        elapsed = time.perf_counter() - t0
    finally:
        batcher.close()
    assert logits.shape == (3, 5)
    assert elapsed < 30.0, "flushes at the deadline, not the 60 s window"


def test_batcher_close_drains_and_rejects(rng):
    engine = make_engine(meta_batch_size=4, max_wait_ms=60_000.0)
    batcher = MicroBatcher(engine)
    future = batcher.submit(engine.prepare_episode(*episode(rng)))
    batcher.close()  # flushes the pending partial group
    assert future.result(timeout=5).shape == (3, 5)
    assert not batcher._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(engine.prepare_episode(*episode(rng)))
    with pytest.raises(RuntimeError, match="closed"):
        batcher.call(lambda: None)


def test_batcher_call_runs_on_the_worker_thread(rng):
    """The API's swaps run on the worker; an exception comes back as is."""
    engine = make_engine(meta_batch_size=2)
    batcher = MicroBatcher(engine)
    try:
        assert batcher.call(threading.current_thread).result(timeout=30) is batcher._worker
        with pytest.raises(KeyError, match="nope"):
            batcher.call(lambda: {}["nope"]).result(timeout=30)
        assert batcher.submit(engine.prepare_episode(*episode(rng))).result(timeout=30).shape == (3, 5)
    finally:
        batcher.close()


def test_concurrent_submitters_all_answered():
    api = make_api(meta_batch_size=4, max_wait_ms=2.0)
    results, errors = {}, []

    def client(i):
        try:
            results[i] = api.classify(*episode(np.random.RandomState(i)))["logits"]
        except Exception as exc:  # pragma: no cover - failure detail
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        api.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 12
    assert all(v.shape == (3, 5) for v in results.values())


# ---------------------------------------------------------------------------
# Hot swap under load
# ---------------------------------------------------------------------------


def test_hot_swap_hammer_never_mixes_state_versions(rng):
    """A writer flips ``update_state`` between two states while 8 readers
    dispatch the same episode (cache off), with a short switch interval:
    every answer is bit for bit one state's, never a mixture."""
    learner = MAMLFewShotLearner(tiny_cfg())
    s0, s1 = fresh_state(learner, 0), fresh_state(learner, 1)
    engine = ServingEngine(learner, s0, ServeConfig(meta_batch_size=2, cache_capacity=0),
                           device="cpu")
    xs, ys, xq = episode(rng)
    ref0 = engine.dispatch([engine.prepare_episode(xs, ys, xq)])[0]
    engine.update_state(s1)
    ref1 = engine.dispatch([engine.prepare_episode(xs, ys, xq)])[0]
    assert not np.array_equal(ref0, ref1)
    engine.update_state(s0)

    stop = threading.Event()
    swaps = [0]

    def writer():
        while not stop.is_set():
            engine.update_state(s1 if swaps[0] % 2 == 0 else s0)
            swaps[0] += 1
            time.sleep(0.0005)

    outputs, errors, out_lock = [], [], threading.Lock()

    def reader():
        try:
            for _ in range(12):
                out = engine.dispatch([engine.prepare_episode(xs, ys, xq)])[0]
                with out_lock:
                    outputs.append(out)
        except Exception as exc:  # pragma: no cover - failure detail
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        writer_thread = threading.Thread(target=writer, daemon=True)
        readers = [threading.Thread(target=reader, daemon=True) for _ in range(8)]
        writer_thread.start()
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=120)
        stop.set()
        writer_thread.join(timeout=10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers + [writer_thread])
    assert not errors and len(outputs) == 96
    assert swaps[0] > 0, "the writer must have swapped"
    matched0 = sum(1 for o in outputs if np.array_equal(o, ref0))
    matched1 = sum(1 for o in outputs if np.array_equal(o, ref1))
    assert matched0 + matched1 == len(outputs), (
        f"{len(outputs) - matched0 - matched1} outputs match neither state"
    )


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------


def test_malformed_episodes_rejected_at_the_front_door(rng):
    engine = make_engine(meta_batch_size=2)
    xs, ys, xq = episode(rng)
    with pytest.raises(ValueError, match="support labels"):
        engine.prepare_episode(xs, ys[:-1], xq)
    with pytest.raises(ValueError, match="expects"):
        engine.prepare_episode(rng.rand(5, 1, 9, 9).astype(np.float32), ys, xq)
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        engine.prepare_episode(xs, ys + 3, xq)
    with pytest.raises(ValueError, match="no query"):
        engine.prepare_episode(xs, ys, xq[:0])
    with pytest.raises(ValueError, match="mixed buckets"):
        engine.dispatch([engine.prepare_episode(*episode(rng, 5, 1, 3)),
                         engine.prepare_episode(*episode(rng, 5, 1, 2))])
    assert ServeConfig(tier_dir="tier").tier_dir == "tier"  # the durable tier


def test_ragged_and_gapped_support_sets_rejected(rng):
    engine = make_engine(meta_batch_size=2)
    img = IMAGE
    with pytest.raises(ValueError, match="class-uniform"):
        engine.prepare_episode(rng.rand(3, *img).astype(np.float32),
                               np.asarray([0, 0, 1], np.int32),
                               rng.rand(2, *img).astype(np.float32))
    with pytest.raises(ValueError, match="class-uniform"):
        engine.prepare_episode(rng.rand(2, *img).astype(np.float32),
                               np.asarray([0, 2], np.int32),
                               rng.rand(2, *img).astype(np.float32))
    with pytest.raises(ValueError, match="no support"):
        engine.prepare_episode(rng.rand(0, *img).astype(np.float32),
                               np.asarray([], np.int32),
                               rng.rand(2, *img).astype(np.float32))


def test_classify_timeout_raises_builtin_timeouterror(rng, monkeypatch):
    api = make_api(meta_batch_size=2, max_wait_ms=0.0)
    try:
        monkeypatch.setattr(api.batcher, "submit", lambda ep: Future())
        with pytest.raises(TimeoutError, match="deadline"):
            api.classify(*episode(rng), timeout=0.05)
        assert api.metrics.request_errors.value == 1
        assert api.metrics.requests_total.value == 1
        assert api.metrics.deadline_exceeded_total.value == 1
    finally:
        api.close()


def test_failed_requests_still_counted(rng):
    api = make_api(meta_batch_size=2, max_wait_ms=0.0)
    try:
        xs, ys, xq = episode(rng)
        with pytest.raises(ValueError):
            api.classify(xs, ys[:-1], xq)
        assert api.metrics.requests_total.value == 1
        assert api.metrics.request_errors.value == 1
        assert "request_errors_total 1" in api.metrics_text()
    finally:
        api.close()


def test_gd_serving_uses_the_injected_learning_rate(rng):
    """Serving a live GDState fine-tunes at its injected learning rate: the
    served logits are ``run_validation_iter``'s, bit for bit."""
    from howtotrainyourmamlpytorch_tpu_torch.models.common import set_injected_lr

    learner = GradientDescentLearner(dataclasses.replace(
        tiny_cfg(), total_epochs=10, total_iter_per_epoch=4))
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    state = state._replace(opt_state=set_injected_lr(state.opt_state, learner._epoch_lr(7)))
    assert float(learner.inference_state(state).fine_tune_lr) == pytest.approx(
        learner._epoch_lr(7), rel=1e-6)
    xs, ys, xq = episode(rng)
    engine = ServingEngine(learner, state, ServeConfig(meta_batch_size=2), device="cpu")
    served = engine.dispatch([engine.prepare_episode(xs, ys, xq)])[0]
    _, _, ref = learner.run_validation_iter(
        state, (xs.reshape(1, 5, 1, *IMAGE), xq.reshape(1, 3, 1, *IMAGE),
                ys.reshape(1, 5, 1), np.zeros((1, 3, 1), np.int32)),
    )
    np.testing.assert_array_equal(served, ref[0].numpy())


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


def test_dispatch_and_signature_events_reach_an_installed_sink(rng, tmp_path):
    engine = make_engine(meta_batch_size=2)
    engine.dispatch([engine.prepare_episode(*episode(rng))])  # no sink: nothing
    log = events.EventLog(str(tmp_path / "serve.jsonl"))
    previous = events.install(log)
    try:
        ep = engine.prepare_episode(*episode(rng, query=4), tag="seed:7")
        engine.dispatch([ep])
        engine.dispatch([ep])
    finally:
        events.install(previous)
    assert log.flush() == 4
    lines = [json.loads(s) for s in (tmp_path / "serve.jsonl").read_text().splitlines()]
    assert [e["type"] for e in lines] == [
        "schema", "serve_compile", "serve_dispatch", "serve_dispatch"
    ]
    assert lines[1]["program"] == "classify:2x4" and lines[1]["family"] == "maml"
    first, second = lines[2], lines[3]
    assert first["trace_id"] == engine.trace_id
    assert (first["bucket"], first["tags"], first["episodes"]) == ("5x1x4", ["seed:7"], 1)
    assert (first["cache_hits"], second["cache_hits"]) == (0, 1)
    assert first["adapt_ms"] > 0 and second["adapt_ms"] is None
    assert len(first["margins"]) == 1 and first["nonfinite"] == 0

"""Episode-geometry coarsening in the port (CPU), mirroring
tests/test_geometry.py by name: the lattice order, the coarsen table, the
actionable rejection (400, not overload), the backbone refusal, the real
slice of a coarsened dispatch, the signatures of a mixed stream and the
counters; and the port against JAX: the same policy arrays, the same
seeded episodes, MAML's and ANIL's masked adapt and a coarsened dispatch
at the serve bar.

A coarsened episode's real slice is held to the port's masked dispatch at
its true geometry within ``REAL_SLICE_RTOL`` of the largest logit, not bit
for bit: on the CPU the head's matmul (``ops/linear.py``) adds in another
order when the query rows are padded from 3 to 4, which moves a logit by
up to one ulp (ROADMAP C, divergences by design). The support padding
alone is exact (``test_masked_adapt_ignores_padded_rows``).
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.data import synthesize_episode as jsynthesize_episode
from howtotrainyourmamlpytorch_tpu.models import (
    ANILLearner as JANILLearner,
    BackboneConfig as JBackboneConfig,
    MAMLConfig as JMAMLConfig,
    MAMLFewShotLearner as JMAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve import ServingAPI as JServingAPI
from howtotrainyourmamlpytorch_tpu.serve.geometry import GeometryPolicy as JGeometryPolicy
from howtotrainyourmamlpytorch_tpu_torch.data.synth_geometry import (
    geometry_mix_episodes,
    synthesize_episode,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    BackboneConfig,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    ServeConfig,
    ServingAPI,
    make_http_server,
)
from howtotrainyourmamlpytorch_tpu_torch.serve.geometry import (
    GeometryPolicy,
    GeometryRejectedError,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves
from test_torch_serve_runtime import (  # noqa: F401 (one_intra_op_thread)
    ATOL,
    FAMILIES,
    IMAGE,
    RTOL,
    TINY,
    fresh_state,
    one_intra_op_thread,
    port_config,
    port_state_of,
)

LATTICE = ((3, 1, 4), (5, 2, 8))
#: Six distinct geometries LATTICE holds: two exact fits, four coarsened.
MIX = ((2, 1, 3), (3, 1, 4), (2, 2, 5), (4, 1, 6), (5, 1, 8), (5, 2, 8))
#: A coarsened episode's real slice against its true-geometry dispatch,
#: relative to the largest logit (see the module docstring).
REAL_SLICE_RTOL = 1e-6
GEO = dict(norm_layer="layer_norm", per_step_bn_statistics=False)
GEO_TRAIN = dict(number_of_training_steps_per_iter=2,
                 number_of_evaluation_steps_per_iter=2,
                 use_multi_step_loss_optimization=False, second_order=False)


def geo_cfg() -> MAMLConfig:
    """The layer-norm backbone coarsening requires."""
    return MAMLConfig(backbone=BackboneConfig(**{**TINY, **GEO}), **GEO_TRAIN)


def jax_geo_cfg() -> JMAMLConfig:
    return JMAMLConfig(backbone=JBackboneConfig(**{**TINY, **GEO}), **GEO_TRAIN)


def serve_cfg(lattice=LATTICE, **kw):
    kw.setdefault("meta_batch_size", 2)
    kw.setdefault("max_wait_ms", 0.0)
    return ServeConfig(geometry_lattice=lattice, **kw)


def geo_api(learner, state, **kw):
    return ServingAPI(learner, state, serve_cfg(**kw), device="cpu")


def assert_real_slice_close(got, want):
    err = np.abs(got - want).max()
    assert err <= REAL_SLICE_RTOL * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


def test_lattice_sorted_by_slot_cost_then_lexicographic_and_deduped():
    policy = GeometryPolicy([(5, 2, 8), (3, 1, 4), (3, 1, 4), (2, 2, 2)])
    assert policy.lattice == ((2, 2, 2), (3, 1, 4), (5, 2, 8))
    assert policy.describe() == "2x2x2, 3x1x4, 5x2x8"


def test_equal_cost_ties_resolve_lexicographically():
    policy = GeometryPolicy([(3, 1, 3), (2, 2, 2)])
    assert policy.lattice == ((2, 2, 2), (3, 1, 3))
    assert policy.coarsen(2, 1, 2) == (2, 2, 2)
    assert policy.coarsen(3, 1, 1) == (3, 1, 3)


def test_coarsen_table():
    policy, jpolicy = GeometryPolicy(LATTICE), JGeometryPolicy(LATTICE)
    cases = {
        (2, 1, 3): (3, 1, 4), (3, 1, 4): (3, 1, 4), (2, 2, 5): (5, 2, 8),
        (4, 1, 6): (5, 2, 8), (5, 1, 8): (5, 2, 8), (5, 2, 8): (5, 2, 8),
    }
    for geometry, bucket in cases.items():
        assert policy.coarsen(*geometry) == jpolicy.coarsen(*geometry) == bucket


def test_rejection_is_actionable_and_not_overload():
    policy = GeometryPolicy(LATTICE)
    with pytest.raises(GeometryRejectedError) as exc_info:
        policy.coarsen(5, 3, 2)
    msg = str(exc_info.value)
    assert policy.describe() in msg and "not overload" in msg
    assert isinstance(exc_info.value, ValueError)


def test_bad_lattice_entries_refused():
    for bad in ([], [(5, 0, 2)], [(5, 2)]):
        with pytest.raises(ValueError):
            GeometryPolicy(bad)


def test_pad_episode_structure_matches_jax():
    policy, jpolicy = GeometryPolicy(LATTICE), JGeometryPolicy(LATTICE)
    xs, ys, xq = synthesize_episode(2, 1, 3, image_shape=IMAGE, seed=5)
    padded = policy.pad_episode(xs, ys, xq, way=2, shot=1)
    assert (padded.way, padded.shot, padded.query) == (3, 1, 4)
    assert (padded.real_way, padded.real_shot, padded.real_query) == (2, 1, 3)
    assert padded.coarsened
    np.testing.assert_array_equal(padded.x_support[:2], xs)
    np.testing.assert_array_equal(padded.x_query[:3], xq)
    np.testing.assert_array_equal(padded.x_support[2:], 0)
    np.testing.assert_array_equal(padded.y_support, [0, 1, 0])
    np.testing.assert_array_equal(padded.support_mask, [1.0, 1.0, 0.0])
    jpadded = jpolicy.pad_episode(xs, ys, xq, way=2, shot=1)
    for name in ("x_support", "y_support", "x_query", "support_mask"):
        a, b = getattr(padded, name), getattr(jpadded, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    exact = policy.pad_episode(*synthesize_episode(5, 2, 8, image_shape=IMAGE, seed=6),
                               way=5, shot=2)
    assert not exact.coarsened
    np.testing.assert_array_equal(exact.support_mask, np.ones(10, np.float32))


def test_synthesized_episodes_are_bit_identical_to_jax():
    for ours, theirs in zip(
        geometry_mix_episodes(6, MIX, image_shape=IMAGE, seed=9),
        [jsynthesize_episode(*MIX[i], image_shape=IMAGE, seed=9 + i) for i in range(6)],
    ):
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        synthesize_episode(0, 1, 1, image_shape=IMAGE)


def test_validate_backbone_refuses_batch_norm_and_narrow_heads():
    with pytest.raises(ValueError, match="row-independent"):
        GeometryPolicy(LATTICE).validate_backbone(BackboneConfig(**TINY))
    with pytest.raises(ValueError, match="only 5 classes"):
        GeometryPolicy(((7, 1, 4),)).validate_backbone(BackboneConfig(**{**TINY, **GEO}))


def test_engine_refuses_batch_norm_backbone():
    learner = MAMLFewShotLearner(MAMLConfig(backbone=BackboneConfig(**TINY), **GEO_TRAIN))
    with pytest.raises(ValueError, match="row-independent"):
        geo_api(learner, fresh_state(learner))


def test_engine_refuses_lattice_wider_than_head():
    learner = MAMLFewShotLearner(geo_cfg())
    with pytest.raises(ValueError, match="only 5 classes"):
        geo_api(learner, fresh_state(learner), lattice=((7, 1, 4),))


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def test_masked_adapt_ignores_padded_rows():
    """MAML's masked adapt of a support set with two padded rows gives the
    fast weights of the real rows alone, bit for bit, and an all-ones
    mask those of the unmasked adapt."""
    learner = MAMLFewShotLearner(geo_cfg())
    state = fresh_state(learner, 2)
    gen = torch.Generator().manual_seed(0)
    xs = torch.rand(2, 7, *IMAGE, generator=gen)
    ys = torch.randint(0, 5, (2, 7), generator=gen, dtype=torch.int32)
    mask = torch.tensor([[1.0] * 5 + [0.0] * 2] * 2)
    padded = learner.serve_adapt_masked(state, xs, ys, mask)
    real = learner.serve_adapt_masked(state, xs[:, :5].contiguous(), ys[:, :5], mask[:, :5])
    plain = learner.serve_adapt(state, xs[:, :5].contiguous(), ys[:, :5])
    for a, b, c in zip(tree_leaves(padded), tree_leaves(real), tree_leaves(plain)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), c.numpy())


@pytest.mark.parametrize("family", ["maml", "anil"])
def test_masked_adapt_matches_jax(family):
    """``serve_adapt_masked`` over a task axis against JAX's vmapped one
    from the same weights, two padded support rows per task."""
    jcls = {"maml": JMAMLFewShotLearner, "anil": JANILLearner}[family]
    jcfg = jax_geo_cfg()
    jlearner, learner = jcls(jcfg), FAMILIES[family](port_config(jcfg))
    jstate = jlearner.init_state(jax.random.PRNGKey(6))
    state = port_state_of(jlearner, learner, jstate)
    rng = np.random.RandomState(1)
    xs = rng.rand(3, 7, *IMAGE).astype(np.float32)
    ys = np.tile(np.asarray([0, 1, 2, 3, 4, 0, 0], np.int32), (3, 1))
    mask = np.tile(np.asarray([1, 1, 1, 1, 1, 0, 0], np.float32), (3, 1))
    xq = rng.rand(3, 4, *IMAGE).astype(np.float32)
    jistate = jlearner.inference_state(jstate)
    jfast = jax.vmap(jlearner.serve_adapt_masked, in_axes=(None, 0, 0, 0))(
        jistate, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask))
    jlogits = jax.vmap(jlearner.serve_classify, in_axes=(None, 0, 0))(
        jistate, jfast, jnp.asarray(xq))
    t = torch.from_numpy
    fast = learner.serve_adapt_masked(state, t(xs), t(ys), t(mask))
    logits = learner.serve_classify(state, fast, t(xq))
    for a, b in zip(tree_leaves(fast), jax.tree.leaves(jfast)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_coarsened_logits_bit_exact_real_slice(family):
    """A 2-way 1-shot 3-query episode coarsened to 3x1x4: padded query rows
    dropped, padded classes at -inf, and the real slice that of the
    masked dispatch at the true geometry (2x1x3) and of the engine without
    a lattice, within ``REAL_SLICE_RTOL``; the support padding alone
    (4x1x3 onto 5x1x3) exact."""
    learner = FAMILIES[family](geo_cfg())
    state = fresh_state(learner, 1)
    episode = synthesize_episode(2, 1, 3, image_shape=IMAGE, seed=7)
    apis = {
        "geo": geo_api(learner, state),
        "fit": geo_api(learner, state, lattice=((2, 1, 3),)),
        "plain": ServingAPI(learner, state, ServeConfig(meta_batch_size=2, max_wait_ms=0.0),
                            device="cpu"),
        "wide": geo_api(learner, state, lattice=((5, 1, 3),)),
        "wide_fit": geo_api(learner, state, lattice=((4, 1, 3),)),
    }
    try:
        out = {k: api.classify(*episode) for k, api in apis.items() if "wide" not in k}
        four = synthesize_episode(4, 1, 3, image_shape=IMAGE, seed=8)
        wide, wide_fit = (apis[k].classify(*four) for k in ("wide", "wide_fit"))
    finally:
        for api in apis.values():
            api.close()
    assert out["geo"]["coarsened"] and out["geo"]["bucket"] == "3x1x4"
    assert not out["fit"]["coarsened"] and out["fit"]["bucket"] == "2x1x3"
    assert not out["plain"]["coarsened"] and out["plain"]["bucket"] == "2x1x3"
    logits = np.asarray(out["geo"]["logits"])
    assert logits.shape == (3, 5)
    assert np.isneginf(logits[:, 2:]).all() and np.isfinite(logits[:, :2]).all()
    assert_real_slice_close(logits[:, :2], out["fit"]["logits"][:, :2])
    assert_real_slice_close(logits[:, :2], out["plain"]["logits"][:, :2])
    assert wide["coarsened"] and wide["bucket"] == "5x1x3"
    np.testing.assert_array_equal(wide["logits"][:, :4], wide_fit["logits"][:, :4])


def test_coarsened_dispatch_matches_jax():
    """The port's geometry server against JAX's on the same weights: a
    coarsened episode and an exact fit, at the serve bar."""
    jcfg = jax_geo_cfg()
    jlearner, learner = JMAMLFewShotLearner(jcfg), MAMLFewShotLearner(port_config(jcfg))
    jstate = jlearner.init_state(jax.random.PRNGKey(8))
    japi = JServingAPI(jlearner, jstate, JServeConfig(meta_batch_size=2, max_wait_ms=0.0,
                                                      geometry_lattice=LATTICE))
    api = geo_api(learner, port_state_of(jlearner, learner, jstate))
    try:
        for geometry, seed in (((2, 2, 5), 4), ((3, 1, 4), 5)):
            episode = synthesize_episode(*geometry, image_shape=IMAGE, seed=seed)
            got, want = api.classify(*episode), japi.classify(*episode)
            assert (got["bucket"], got["coarsened"]) == (want["bucket"], want["coarsened"])
            np.testing.assert_array_equal(np.isneginf(got["logits"]),
                                          np.isneginf(want["logits"]))
            real = np.isfinite(want["logits"])
            np.testing.assert_allclose(got["logits"][real], np.asarray(want["logits"])[real],
                                       rtol=RTOL, atol=ATOL)
    finally:
        api.close()
        japi.close()


# ---------------------------------------------------------------------------
# Signatures: the mix rides the lattice's
# ---------------------------------------------------------------------------


def test_mixed_stream_compiles_at_most_the_lattice():
    assert len(set(MIX)) >= 6
    learner = MAMLFewShotLearner(geo_cfg())
    api = geo_api(learner, fresh_state(learner, 2))
    try:
        api.engine.warmup()  # a geometry engine warms its whole lattice
        warmed = api.engine.compile_table()
        assert warmed == {"adapt:2x3": 1, "adapt:2x10": 1,
                          "classify:2x4": 1, "classify:2x8": 1}
        for episode in geometry_mix_episodes(12, MIX, image_shape=IMAGE, seed=100):
            out = api.classify(*episode)
            assert np.asarray(out["logits"]).shape == (episode[2].shape[0], 5)
        assert api.engine.compile_table() == warmed
        assert api.engine.warmed_buckets() == sorted(LATTICE)
    finally:
        api.close()


def test_shared_classify_program_across_equal_query_buckets():
    learner = MAMLFewShotLearner(geo_cfg())
    api = geo_api(learner, fresh_state(learner, 3), lattice=((2, 1, 6), (5, 2, 6)))
    try:
        api.engine.warmup()
        assert api.engine.compile_table() == {"adapt:2x2": 1, "adapt:2x10": 1,
                                              "classify:2x6": 1}
    finally:
        api.close()


# ---------------------------------------------------------------------------
# Observability and the front door
# ---------------------------------------------------------------------------


def test_geometry_counters_and_rejection():
    learner = MAMLFewShotLearner(geo_cfg())
    api = geo_api(learner, fresh_state(learner, 4))
    try:
        api.classify(*synthesize_episode(3, 1, 4, image_shape=IMAGE))
        assert api.metrics.snapshot()["geometry_coarsened_total"] == 0
        api.classify(*synthesize_episode(2, 1, 3, image_shape=IMAGE, seed=1))
        with pytest.raises(GeometryRejectedError):
            api.classify(*synthesize_episode(5, 3, 2, image_shape=IMAGE, seed=2))
        snap = api.metrics.snapshot()
        assert snap["geometry_coarsened_total"] == 1
        assert snap["geometry_rejected_total"] == 1
    finally:
        api.close()


@pytest.fixture
def served_geo():
    learner = MAMLFewShotLearner(geo_cfg())
    api = geo_api(learner, fresh_state(learner, 5), max_wait_ms=1.0)
    api.engine.warmup()
    server = make_http_server(api, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", api
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        api.close()
    assert not thread.is_alive()


def post_episode(base, way, shot, query, seed=0):
    xs, ys, xq = synthesize_episode(way, shot, query, image_shape=IMAGE, seed=seed)
    payload = {"support": xs.tolist(), "support_labels": ys.tolist(), "query": xq.tolist()}
    req = urllib.request.Request(f"{base}/v1/episode", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.load(resp)


def test_http_geometry_rejection_is_400_not_overload(served_geo):
    base, _ = served_geo
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        post_episode(base, 5, 3, 2)
    err = exc_info.value
    assert err.code == 400
    body = json.load(err)
    assert body["geometry_rejected"] is True
    assert "3x1x4" in body["error"] and "not overload" in body["error"]
    assert "shed" not in body and err.headers.get("Retry-After") is None


def test_http_coarsened_roundtrip_and_metrics_scrape(served_geo):
    base, _ = served_geo
    status, body = post_episode(base, 2, 1, 3, seed=3)
    assert status == 200 and body["coarsened"] is True and body["bucket"] == "3x1x4"
    assert np.asarray(body["logits"]).shape == (3, 5)
    assert max(body["predictions"]) < 2  # -inf pad columns never win
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    assert "maml_serve_geometry_coarsened_total 1" in text
    assert "maml_serve_geometry_rejected_total 0" in text

"""The port's MAML++ serve slice against the JAX package's, from the same
weights and episodes (CPU, float32).

JAX runs with ``use_pallas_fused_norm=True`` (Pallas kernels in interpret
mode) and serves tasks by ``jax.vmap``; the port takes the task axis
itself and runs its fused norm's plain version on the CPU. The config is
tests/test_pallas_fused_norm.py's ``_make_maml`` at 8 filters: 2 stages,
8x8 images, per-step BN over 2 steps, LSLR.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import (
    BackboneConfig as JBackboneConfig,
    MAMLConfig as JMAMLConfig,
    MAMLFewShotLearner as JLearner,
)
from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve.engine import ServingEngine as JEngine
from howtotrainyourmamlpytorch_tpu.utils import parser_utils as j_parser
from howtotrainyourmamlpytorch_tpu_torch.convert import (
    inference_state_from_numpy,
    inference_state_to_numpy,
    tree_to_numpy,
)
from howtotrainyourmamlpytorch_tpu_torch.models import (
    BackboneConfig,
    MAMLConfig,
    MAMLFewShotLearner,
)
from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine
from howtotrainyourmamlpytorch_tpu_torch.serve.cache import AdaptedParamsCache
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(
    REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json"
)
MINI_IMAGENET = os.path.join(
    REPO, "experiment_config",
    "mini-imagenet_maml++-mini-imagenet_5_2_0.01_48_5_0.json",
)


def _port_config(jcfg) -> MAMLConfig:
    shared = {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(MAMLConfig) if f.name != "backbone"
    }
    return MAMLConfig(
        backbone=BackboneConfig(**dataclasses.asdict(jcfg.backbone)), **shared
    )


def _jax_istate_numpy(istate):
    theta, lslr, bn = jax.tree.map(np.asarray, tuple(istate))
    return theta, lslr, {k: tuple(v) for k, v in bn.items()}


@pytest.fixture(scope="module")
def learners():
    jcfg = JMAMLConfig(
        backbone=JBackboneConfig(
            num_stages=2, num_filters=8, per_step_bn_statistics=True,
            num_steps=2, num_classes=5, image_height=8, image_width=8,
            use_pallas_fused_norm=True,
        ),
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2,
    )
    jlearner = JLearner(jcfg)
    jstate = jlearner.init_inference_state(jax.random.PRNGKey(5))
    # Non-uniform LSLR rates, so a wrong step index shows.
    jstate = jstate._replace(lslr=jax.tree.map(
        lambda a: a * jnp.asarray([1.0, 0.5, 2.0], a.dtype), jstate.lslr
    ))
    learner = MAMLFewShotLearner(_port_config(jcfg))
    state = inference_state_from_numpy(_jax_istate_numpy(jstate), "cpu")
    return jlearner, jstate, learner, state


def _episodes(rng, tasks, query=6):
    xs = (rng.rand(tasks, 5, 1, 8, 8) > 0.5).astype(np.float32)
    ys = np.tile(np.arange(5, dtype=np.int32), (tasks, 1))
    xq = (rng.rand(tasks, query, 1, 8, 8) > 0.5).astype(np.float32)
    return xs, ys, xq


def _assert_tree_close(ours, theirs):
    """Matched by key; ``None`` must sit at the same positions."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _assert_tree_close(ours[k], theirs[k])
    elif theirs is None:
        assert ours is None
    else:
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=RTOL, atol=ATOL)


def test_serve_adapt_and_classify_match_jax_vmap(learners, rng):
    jlearner, jstate, learner, state = learners
    xs, ys, xq = _episodes(rng, 3)
    jfast = jax.vmap(jlearner.serve_adapt, in_axes=(None, 0, 0))(
        jstate, jnp.asarray(xs), jnp.asarray(ys)
    )
    jlogits = jax.vmap(jlearner.serve_classify, in_axes=(None, 0, 0))(
        jstate, jfast, jnp.asarray(xq)
    )
    with torch.no_grad():  # adapt turns autograd on for itself
        fast = learner.serve_adapt(state, torch.from_numpy(xs), torch.from_numpy(ys))
    logits = learner.serve_classify(state, fast, torch.from_numpy(xq))
    assert fast["conv0"]["norm"] == {"gamma": None, "beta": None}
    _assert_tree_close(tree_to_numpy(fast), jfast)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL
    )


def test_engine_dispatch_matches_jax_with_padding_and_cache_hit(learners, rng):
    jlearner, jstate, learner, state = learners
    jengine = JEngine(jlearner, jstate, JServeConfig(meta_batch_size=4))
    engine = ServingEngine(learner, state, ServeConfig(meta_batch_size=4),
                           device="cpu")
    xs, ys, xq = _episodes(rng, 3)
    jeps = [jengine.prepare_episode(*a) for a in zip(xs, ys, xq)]
    eps = [engine.prepare_episode(*a) for a in zip(xs, ys, xq)]
    assert [e.digest for e in eps] == [e.digest for e in jeps]
    assert {e.bucket for e in eps} == {(5, 1, 6)}
    want = jengine.dispatch(jeps)
    got = engine.dispatch(eps)  # 3 episodes padded to 4 tasks
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    again = engine.dispatch(eps[:1])  # adapted weights from the cache
    np.testing.assert_array_equal(again[0], got[0])
    stats = engine.stats
    assert (stats.cache_misses, stats.cache_hits) == (3, 1)
    assert (stats.padded_tasks, stats.episodes_served) == (4, 4)
    assert len(stats.adapt_ms) == 1 and len(stats.classify_ms) == 2
    assert len(engine.cache) == 3
    assert stats.nonfinite_episodes == 0 and len(stats.margins) == 4
    # Padding is invisible: each episode alone gives the same logits.
    alone = ServingEngine(learner, state, ServeConfig(meta_batch_size=1),
                          device="cpu")
    for ep, logits in zip(eps, got):
        np.testing.assert_allclose(
            alone.dispatch([ep])[0], logits, rtol=RTOL, atol=ATOL
        )
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.deterministic


@pytest.mark.parametrize(
    "config,overrides",
    [
        (FLAGSHIP, {"use_pallas_fused_norm": True}),
        (FLAGSHIP, {"transfer_dtype": "uint8"}),
        (MINI_IMAGENET, {"transfer_dtype": "uint8"}),
    ],
    ids=["flagship-fused", "flagship-uint8", "mini-imagenet-uint8"],
)
def test_json_config_gives_jax_config(config, overrides):
    args = vars(j_parser.get_parser().parse_args([]))
    args = j_parser.extract_args_from_json(config, args)
    args.update(overrides)
    for key, value in args.items():
        if str(value).lower() in ("true", "false"):
            args[key] = str(value).lower() == "true"
    jcfg = j_parser.args_to_maml_config(j_parser.Bunch(args))
    cfg = load_maml_config(config, **overrides)
    port_fields = {f.name for f in dataclasses.fields(cfg)}
    jax_only = {f.name for f in dataclasses.fields(jcfg)} - port_fields
    assert jax_only == {
        "remat_inner_steps", "task_chunk", "collective_fusion", "device_augment"
    }
    for name in port_fields - {"backbone", "wire_codec"}:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert tuple(cfg.wire_codec or ()) == tuple(jcfg.wire_codec or ())
    assert dataclasses.asdict(cfg.backbone) == dataclasses.asdict(jcfg.backbone)


def test_inference_state_round_trip(learners):
    jlearner, jstate, learner, state = learners
    tree = _jax_istate_numpy(jstate)
    back = inference_state_to_numpy(inference_state_from_numpy(tree, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert isinstance(back[2]["conv0"], tuple)
    assert learner.init_inference_state(
        torch.Generator().manual_seed(0), device="cpu"
    ).lslr["conv0"]["norm"] == {"gamma": None, "beta": None}


def test_cache_is_a_bounded_lru():
    cache = AdaptedParamsCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1  # refreshes "a": "b" is now the oldest
    cache.put("c", 3)
    assert (cache.get("b"), cache.get("a"), cache.get("c")) == (None, 1, 3)
    assert len(cache) == 2 and cache.evictions == 1
    off = AdaptedParamsCache(capacity=0)
    off.put("a", 1)
    assert off.get("a") is None

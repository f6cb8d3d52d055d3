"""The port's HTTP front door and its ``serve_maml`` command line (CPU),
mirroring tests/test_serve_http.py by name: the round trip, the cache hit,
the error surface, ``/healthz`` 503 before warmup, the shed 503 with
``Retry-After``, promote and its 409s, and the command line's learner
build and warmup parsing. The logits a port server answers over HTTP are
held to the JAX ``ServingAPI.classify`` of the same flagship-shaped
episode (5-way 1-shot, 15 queries) on the same weights at the serve bar,
for the three learners the command line serves; the port learner runs its
fused norm (the plain versions on the CPU), JAX its XLA norm.

Narrow widths: the experiment JSON below has 2 stages of 8 filters on
14x14 images.
"""

import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.data import synthesize_episode as jsynthesize_episode
from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve import ServingAPI as JServingAPI
from howtotrainyourmamlpytorch_tpu_torch import serve_maml
from howtotrainyourmamlpytorch_tpu_torch.data.synth_geometry import synthesize_episode
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.serve import (
    OverloadedError,
    ServeConfig,
    ServingAPI,
    make_http_server,
)
from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config
from howtotrainyourmamlpytorch_tpu_torch.utils import locksan

import chip_smoke
from test_torch_zoo_launches import counted  # noqa: F401 (fixture)
from test_torch_serve_runtime import (  # noqa: F401 (one_intra_op_thread)
    ATOL,
    IMAGE,
    RTOL,
    fresh_state,
    one_intra_op_thread,
    port_state_of,
    tiny_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The JAX server's program-ledger rows that the port leaves out of
#: /metrics: XLA's analysis of a compiled program gives them, and the port
#: compiles none. (``maml_serve_program_hbm_peak_bytes`` is the caching
#: allocator's peak, on a card only.)
LEDGER_ROWS = {
    "maml_serve_program_bytes_accessed",
    "maml_serve_program_arithmetic_intensity",
    "maml_serve_program_temp_bytes",
}
CPU_LEDGER_ROWS = LEDGER_ROWS | {"maml_serve_program_hbm_peak_bytes"}

#: The experiment JSON of the command-line tests: the flagship's keys at
#: narrow widths.
CLI_CONFIG = {
    "num_stages": 2,
    "cnn_num_filters": 8,
    "num_classes_per_set": 5,
    "image_height": 14,
    "image_width": 14,
    "image_channels": 1,
    "max_pooling": True,
    "per_step_bn_statistics": True,
    "learnable_per_layer_per_step_inner_loop_learning_rate": True,
    "number_of_training_steps_per_iter": 2,
    "number_of_evaluation_steps_per_iter": 2,
    "dataset_name": "omniglot_dataset",
}


@pytest.fixture(autouse=True)
def _lock_sanitizer():
    """Every test of this suite runs under the port's lock sanitizer: no
    cycle in the observed acquisition order, and every lock created under
    ``howtotrainyourmamlpytorch_tpu_torch/serve`` held under 2.0 s."""
    with locksan.sanitized() as san:
        yield san


def run_server(api):
    """Starts ``make_http_server(api)`` on an ephemeral port; returns
    ``(server, thread, base_url)``."""
    server = make_http_server(api, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def stop_server(server, thread, api):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    api.close()
    assert not thread.is_alive(), "the server thread must exit on shutdown"


@pytest.fixture
def served():
    """A warmed tiny MAML server; yields ``(base_url, api)``."""
    learner = MAMLFewShotLearner(tiny_cfg())
    api = ServingAPI(learner, fresh_state(learner),
                     ServeConfig(meta_batch_size=2, max_wait_ms=1.0), device="cpu")
    api.warmup([(5, 1, 2)])  # on the batcher's worker thread
    server, thread, base = run_server(api)
    try:
        yield base, api
    finally:
        stop_server(server, thread, api)


def get_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, json.load(resp)


def post_json(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.load(resp)


def post_episode(base, payload):
    return post_json(f"{base}/v1/episode", payload)


def episode_payload(rng, way=5, shot=1, query=2):
    return {
        "support": rng.rand(way * shot, *IMAGE).tolist(),
        "support_labels": np.repeat(np.arange(way), shot).tolist(),
        "query": rng.rand(query, *IMAGE).tolist(),
    }


def metric_families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def test_http_roundtrip_and_metrics_scrape(served, rng):
    base, api = served
    status, health = get_json(f"{base}/healthz")
    assert status == 200
    assert health["status"] == "ok" and health["family"] == "maml"
    assert health["ready"] is True and health["degraded"] is False
    assert health["queue_depth"] == 0 and "last_dispatch_age_s" in health
    assert health["warmed_buckets"] == ["5x1x2"]

    status, body = post_episode(base, episode_payload(rng))
    assert status == 200
    logits = np.asarray(body["logits"], np.float32)
    assert logits.shape == (2, 5)
    assert body["bucket"] == "5x1x2" and body["cache_hit"] is False
    assert body["predictions"] == np.argmax(logits, axis=-1).tolist()

    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
        assert resp.status == 200
        text = resp.read().decode()
    assert "maml_serve_requests_total 1" in text
    assert 'maml_serve_adapt_latency_ms{quantile="0.5"}' in text
    assert 'maml_serve_adapt_latency_ms{quantile="0.99"}' in text
    assert "maml_serve_cache_hit_rate" in text
    assert "maml_serve_queue_depth" in text
    assert 'maml_serve_bucket_episodes_total{bucket="5x1x2"} 1' in text
    assert 'maml_serve_program_compiles{program="adapt:2x5"} 1' in text
    assert api.stats()["compiles"] == {"adapt:2x5": 1, "classify:2x2": 1}


def test_http_cache_hit_on_repeat_support(served, rng):
    base, _ = served
    payload = episode_payload(rng)
    _, first = post_episode(base, payload)
    _, second = post_episode(base, payload)
    assert first["cache_hit"] is False and second["cache_hit"] is True
    assert second["logits"] == first["logits"]


def test_http_error_surface(served, rng):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as err:
        get_json(f"{base}/nope")
    assert err.value.code == 404
    bad = episode_payload(rng)
    bad["support_labels"] = bad["support_labels"][:-1]
    with pytest.raises(urllib.error.HTTPError) as err:
        post_episode(base, bad)
    assert err.value.code == 400
    assert "support labels" in json.load(err.value)["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        post_episode(base, {"support": []})
    assert err.value.code == 400


def test_healthz_503_until_first_warmup(rng):
    learner = MAMLFewShotLearner(tiny_cfg())
    api = ServingAPI(learner, fresh_state(learner),
                     ServeConfig(meta_batch_size=2, max_wait_ms=1.0), device="cpu")
    server, thread, base = run_server(api)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            get_json(f"{base}/healthz")
        assert err.value.code == 503
        body = json.load(err.value)
        assert body["ready"] is False and body["status"] == "unready"
        post_episode(base, episode_payload(rng))
        status, health = get_json(f"{base}/healthz")
        assert status == 200 and health["ready"] is True
    finally:
        stop_server(server, thread, api)


def test_shed_returns_503_with_retry_after(rng):
    learner = MAMLFewShotLearner(tiny_cfg())
    api = ServingAPI(
        learner, fresh_state(learner),
        ServeConfig(meta_batch_size=4, max_wait_ms=60_000.0, max_queue_depth=1,
                    retry_after_s=2.5),
        device="cpu",
    )
    api.engine.warmup([(5, 1, 2)])
    server, thread, base = run_server(api)
    blocked = threading.Thread(target=lambda: post_episode(base, episode_payload(rng)),
                               daemon=True)
    try:
        blocked.start()
        deadline = time.monotonic() + 5
        while api.batcher.queue_depth() < 1:
            assert time.monotonic() < deadline, "queue never filled"
            time.sleep(0.005)
        with pytest.raises(urllib.error.HTTPError) as err:
            post_episode(base, episode_payload(rng))
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "2.5"
        body = json.load(err.value)
        assert body["shed"] is True and "shed" in body["error"]
        status, health = get_json(f"{base}/healthz")
        assert status == 200 and health["shed_total"] >= 1
        assert "maml_serve_shed_total 1" in api.metrics_text()
    finally:
        stop_server(server, thread, api)  # close() drains the parked episode
        blocked.join(timeout=10)
    assert not blocked.is_alive()


def episode_args(rng):
    p = episode_payload(rng)
    return p["support"], p["support_labels"], p["query"]


def test_degraded_tier_sheds_cache_misses_first(rng, monkeypatch):
    """Past the soft limit a cache miss is shed and a cache hit served."""
    learner = MAMLFewShotLearner(tiny_cfg())
    api = ServingAPI(learner, fresh_state(learner),
                     ServeConfig(meta_batch_size=2, max_wait_ms=1.0, degrade_queue_depth=1),
                     device="cpu")
    try:
        args = episode_args(rng)
        api.classify(*args)
        monkeypatch.setattr(api.batcher, "queue_depth", lambda: 1)
        assert api.classify(*args)["cache_hit"]
        with pytest.raises(OverloadedError, match="cold-adapt"):
            api.classify(*episode_args(rng))
        assert api.metrics.shed_total.value == 1 and api.metrics.degraded.value == 1.0
        assert api.healthz()["status"] == "degraded"
    finally:
        api.close()


def test_admin_promote_roundtrip_and_rejection(served, rng, tmp_path):
    """A checkpoint the port saved swaps in (200, new version); a corrupt
    one, one of another architecture and one with NaN weights are refused
    with 409, and the promoted state keeps serving bit for bit."""
    base, api = served
    payload = episode_payload(rng)
    _, before = post_episode(base, payload)
    assert before["state_version"] == 0

    learner = MAMLFewShotLearner(tiny_cfg())
    state = learner.init_state(torch.Generator().manual_seed(7), "cpu")
    ckpt = str(tmp_path / "promote_me")
    learner.save_model(ckpt, state, {"current_iter": 0})
    status, body = post_json(f"{base}/admin/promote", {"checkpoint": ckpt})
    assert status == 200 and body["state_version"] == 1
    assert body["buckets_canaried"] >= 1 and body["source"] == ckpt
    _, after = post_episode(base, payload)
    assert after["state_version"] == 1 and after["cache_hit"] is False
    assert after["logits"] != before["logits"], "new weights must answer"
    assert get_json(f"{base}/healthz")[1]["checkpoint_digest"] is not None

    wide = MAMLFewShotLearner(tiny_cfg(num_filters=16))
    other = str(tmp_path / "other_arch")
    wide.save_model(other, wide.init_state(torch.Generator().manual_seed(0), "cpu"),
                    {"current_iter": 0})
    poisoned = str(tmp_path / "nan_weights")
    nan_theta = dict(state.theta, linear={"weight": state.theta["linear"]["weight"] * np.nan,
                                          "bias": state.theta["linear"]["bias"]})
    learner.save_model(poisoned, state._replace(theta=nan_theta), {"current_iter": 0})
    with open(ckpt, "r+b") as f:
        f.truncate(128)
    for path, reason in ((ckpt, "corrupt_checkpoint"), (other, "incompatible_checkpoint"),
                         (poisoned, "nonfinite_logits")):
        with pytest.raises(urllib.error.HTTPError) as err:
            post_json(f"{base}/admin/promote", {"checkpoint": path})
        assert err.value.code == 409
        assert json.load(err.value)["reason"] == reason
    _, still = post_episode(base, payload)
    assert still["state_version"] == 1 and still["logits"] == after["logits"]
    assert api.metrics.swap_rejected_total.value == 3
    assert api.metrics.swaps_total.value == 1


def test_kernel_record_is_served_only_on_debug_kernels(served, monkeypatch):
    """``/healthz`` carries no kernel record; ``GET /debug/kernels`` is 404
    unless the server was built with ``debug_kernels`` (``serve_maml
    --debug_kernels``), and then answers ``fused_norm.launch_record()``."""
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as tfn
    from howtotrainyourmamlpytorch_tpu_torch.serve.resilience.replica import (
        serve_maml_argv,
    )

    base, api = served
    assert "kernels" not in get_json(f"{base}/healthz")[1]
    with pytest.raises(urllib.error.HTTPError) as err:
        get_json(f"{base}/debug/kernels")
    assert err.value.code == 404

    monkeypatch.setitem(tfn.launch_counts, "bn_stats_act", 24)
    monkeypatch.setitem(tfn.launch_shapes, "bn_stats_act",
                        {((5, 64, 28, 28), 0.01), ((5, 64, 14, 14), 0.01, "bfloat16")})
    server = make_http_server(api, port=0, debug_kernels=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, record = get_json(
            f"http://127.0.0.1:{server.server_address[1]}/debug/kernels")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200 and record == json.loads(json.dumps(tfn.launch_record()))
    assert record["launches"]["bn_stats_act"] == 24
    assert record["shapes"]["bn_stats_act"] == [
        [[5, 64, 14, 14], 0.01, "bfloat16"], [[5, 64, 28, 28], 0.01]]
    assert set(record["launches"]) == set(record["shapes"]) == set(tfn.KERNELS)

    argv = serve_maml_argv("c.json", port_file="p", debug_kernels=True)
    assert "--debug_kernels" in argv
    assert "--debug_kernels" not in serve_maml_argv("c.json", port_file="p")
    assert serve_maml.get_parser().parse_args(
        ["--config", "c.json", "--debug_kernels"]).debug_kernels is True


def test_admin_scale_is_409_on_one_engine(served):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as err:
        post_json(f"{base}/admin/scale", {"pool_size": 2})
    assert err.value.code == 409
    assert "replica pool" in json.load(err.value)["error"]


# ---------------------------------------------------------------------------
# The port's server against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture
def cli_config(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    path = tmp_path / "serve_cfg.json"
    path.write_text(json.dumps(CLI_CONFIG))
    return str(path)


@pytest.mark.parametrize("name", serve_maml.LEARNERS)
def test_http_logits_match_jax_serving_api(name, cli_config):
    """Both command lines' learner builds from one JSON, the JAX weights
    copied by ``convert.py``: the port's HTTP answer to a flagship-shaped
    episode (and to its repeat, from the cache) against JAX
    ``ServingAPI.classify``, and ``/metrics`` with the JAX server's metric
    families less the program ledger's rows the port cannot measure (the
    port records its rows at warmup, as the JAX server does at its
    dispatches' first sight of a bucket)."""
    from tools.serve_maml import build_learner as jbuild_learner

    jlearner = jbuild_learner(name, cli_config)
    learner, device = serve_maml.build_learner(
        name, cli_config, ["--use_pallas_fused_norm", "True"], device="cpu")
    assert device == torch.device("cpu")
    assert learner.cfg.backbone.use_pallas_fused_norm
    assert not jlearner.cfg.backbone.use_pallas_fused_norm
    jstate = jlearner.init_state(jax.random.PRNGKey(11))
    japi = JServingAPI(jlearner, jstate, JServeConfig(meta_batch_size=4, max_wait_ms=1.0))
    api = ServingAPI(learner, port_state_of(jlearner, learner, jstate),
                     ServeConfig(meta_batch_size=4, max_wait_ms=1.0), device="cpu")
    api.engine.warmup([(5, 1, 15)])
    server, thread, base = run_server(api)
    try:
        xs, ys, xq = synthesize_episode(5, 1, 15, image_shape=IMAGE, seed=3)
        for a, b in zip((xs, ys, xq), jsynthesize_episode(5, 1, 15, image_shape=IMAGE, seed=3)):
            np.testing.assert_array_equal(a, b)
        for repeat in (False, True):
            want = japi.classify(xs, ys, xq)
            _, body = post_episode(base, {"support": xs.tolist(),
                                          "support_labels": ys.tolist(),
                                          "query": xq.tolist()})
            assert body["cache_hit"] is repeat is bool(want["cache_hit"])
            assert body["bucket"] == want["bucket"] == "5x1x15"
            np.testing.assert_allclose(np.asarray(body["logits"], np.float32),
                                       np.asarray(want["logits"]), rtol=RTOL, atol=ATOL)
        jtext, text = japi.metrics_text(), api.metrics_text()
        assert metric_families(text) == metric_families(jtext) - CPU_LEDGER_ROWS
        assert api.stats()["compiles"].keys() == japi.stats()["compiles"].keys()
    finally:
        stop_server(server, thread, api)
        japi.close()


# ---------------------------------------------------------------------------
# serve_maml command line
# ---------------------------------------------------------------------------


def test_cli_builds_learner_from_experiment_config(cli_config):
    learner, _ = serve_maml.build_learner("maml", cli_config, device="cpu")
    assert isinstance(learner, MAMLFewShotLearner)
    assert learner.cfg.backbone.num_filters == 8
    assert learner.cfg.backbone.num_classes == 5
    assert learner.cfg.number_of_training_steps_per_iter == 2
    assert not learner.cfg.backbone.use_pallas_fused_norm


def test_cli_warmup_spec_parsing():
    assert serve_maml.parse_warmup("5x1x15,20x1x5") == [(5, 1, 15), (20, 1, 5)]
    assert serve_maml.parse_warmup("") == []
    with pytest.raises(ValueError, match="WAYxSHOTxQUERY"):
        serve_maml.parse_warmup("5x1")


def test_cli_pool_mode_raises_naming_a11(cli_config, capsys):
    """``--replicas`` runs a supervised pool (tests/test_torch_serve_pool.py)
    and refuses to start without ``--warmup``: a worker that never warms
    would never become routable. The control-plane daemons run beside it,
    over its front door (tests/test_torch_promotion.py)."""
    with pytest.raises(SystemExit) as exit_info:
        serve_maml.main(["--config", cli_config, "--init_from_scratch",
                         "--replicas", "2"], device="cpu")
    assert exit_info.value.code == 2
    assert "--replicas requires --warmup" in capsys.readouterr().err


def test_cli_requires_a_checkpoint(cli_config, capsys):
    with pytest.raises(SystemExit) as exit_info:
        serve_maml.main(["--config", cli_config], device="cpu")
    assert exit_info.value.code == 2
    assert "--checkpoint" in capsys.readouterr().err


def test_cli_refuses_to_run_without_a_card(cli_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_maml.main(["--config", cli_config, "--init_from_scratch", "--port", "0"])


def test_cli_serves_until_sigterm(cli_config, tmp_path, rng):
    """``main`` on the CPU: warmed, it names its port, answers /healthz and
    an episode, writes telemetry, and returns 0 on SIGTERM."""
    port_file = tmp_path / "serve.port"
    telemetry = tmp_path / "logs" / "serve.jsonl"
    answers = {}

    def client():
        deadline = time.monotonic() + 120
        while not port_file.exists():
            if time.monotonic() > deadline:
                return
            time.sleep(0.02)
        base = f"http://127.0.0.1:{port_file.read_text()}"
        try:
            answers["health"] = get_json(f"{base}/healthz")
            answers["episode"] = post_episode(base, episode_payload(rng, query=15))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    handler = signal.getsignal(signal.SIGTERM)
    code = serve_maml.main([
        "--config", cli_config, "--init_from_scratch", "--port", "0",
        "--port_file", str(port_file), "--warmup", "5x1x15",
        "--telemetry", str(telemetry), "--use_pallas_fused_norm", "True",
    ], device="cpu")
    thread.join(timeout=30)
    assert code == 0 and not thread.is_alive()
    assert answers["health"][0] == 200 and answers["health"][1]["ready"]
    status, body = answers["episode"]
    assert status == 200 and np.asarray(body["logits"]).shape == (15, 5)
    kinds = [json.loads(line)["type"] for line in telemetry.read_text().splitlines()]
    assert kinds[0] == "schema" and kinds.count("serve_compile") == 2
    assert kinds.count("serve_dispatch") == 1
    assert signal.getsignal(signal.SIGTERM) is handler


# ---------------------------------------------------------------------------
# What chip_smoke.py holds the card to
# ---------------------------------------------------------------------------

FLAGSHIP = os.path.join(REPO, "experiment_config",
                        "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json")
NORTH_STAR = os.path.join(REPO, "experiment_config",
                          "mini-imagenet_maml++-mini-imagenet_5_2_0.01_48_5_0.json")
SERVE_BUCKETS = {FLAGSHIP: (5, 1, 15), NORTH_STAR: (5, 5, 15)}


@pytest.mark.parametrize("config", [FLAGSHIP, NORTH_STAR], ids=["flagship", "north_star"])
def test_api_launches_are_what_chip_smoke_holds(counted, config):  # noqa: F811
    """Through ``ServingAPI`` with ``use_pallas_fused_norm`` (8 filters:
    the counts follow the stage layout, not the width): a dispatch that
    adapts a cache miss launches ``SERVE_LAUNCHES``, one that only
    classifies ``SERVE_HIT_LAUNCHES``."""
    learner = MAMLFewShotLearner(load_maml_config(config, use_pallas_fused_norm=True,
                                                  cnn_num_filters=8))
    api = ServingAPI(learner, fresh_state(learner), ServeConfig(), device="cpu")
    bb = learner.cfg.backbone
    way, shot, query = SERVE_BUCKETS[config]
    episode = synthesize_episode(way, shot, query, seed=1, image_shape=(
        bb.image_channels, bb.image_height, bb.image_width))
    try:
        for hit, want in ((False, chip_smoke.SERVE_LAUNCHES),
                          (True, chip_smoke.SERVE_HIT_LAUNCHES)):
            for name in counted:
                counted[name] = 0
            assert api.classify(*episode)["cache_hit"] is hit
            assert counted == want
    finally:
        api.close()


def test_serve_shapes_are_checked_in_chip_smoke():
    """Each fused site's input shape in a serve dispatch at meta-batch 4
    of both JSONs at full width (support and query rows, the tasks'
    filters folded into channels, at each stage's size) is among the
    shapes chip_smoke.py holds the kernels to their plain versions at."""
    for config, (way, shot, query) in SERVE_BUCKETS.items():
        bb = load_maml_config(config, use_pallas_fused_norm=True).backbone
        hw, shapes = bb.image_height, set()
        for _ in range(bb.num_stages):
            shapes |= {(n, 4 * bb.num_filters, hw, hw) for n in (way * shot, query)}
            hw //= 2
        assert shapes <= set(chip_smoke.KERNEL_SHAPES), shapes - set(chip_smoke.KERNEL_SHAPES)

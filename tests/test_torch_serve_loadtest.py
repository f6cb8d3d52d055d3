"""The port's open-loop load test (CPU), mirroring the loadtest cases of
tests/test_serve_resilience.py: the in-process smoke, sheds counted into a
failing verdict, and the command line over a ``LocalReplica`` pool with a
kill, a durable tier and the JSON verdict line, and over ``--url``. The
seeded ramp schedules and the synthetic episodes are
the JAX harness's (``tools/serve_loadtest.py``) exactly.

The config has 2 stages of 8 filters on 14x14 images, per-step BN over 2
inner steps, 5-way.
"""

import json
import time

import pytest

import tools.serve_loadtest as jloadtest
from howtotrainyourmamlpytorch_tpu_torch import serve_loadtest
from howtotrainyourmamlpytorch_tpu_torch.serve_loadtest import run_loadtest, synth_episodes
from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject
from test_torch_serve_http import CLI_CONFIG, run_server, stop_server
from test_torch_serve_pool import make_api
from test_torch_serve_runtime import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.deactivate()
    yield
    faultinject.deactivate()


@pytest.fixture
def cli_config(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    path = tmp_path / "serve_cfg.json"
    path.write_text(json.dumps(CLI_CONFIG))
    return str(path)


def test_loadtest_smoke_in_process():
    api = make_api(meta_batch_size=4, max_wait_ms=2.0, max_queue_depth=128,
                   degrade_queue_depth=0)
    api.warmup([(5, 1, 3)])
    try:
        result = run_loadtest(
            api, synth_episodes(4, way=5, shot=1, query=3, image_shape=(1, 14, 14)),
            rate_qps=20.0, duration_s=0.8, p99_budget_ms=30_000.0, error_slo=0.01,
            seed=0,
        )
    finally:
        api.close()
    assert result["offered"] > 0
    assert result["completed_ok"] == result["offered"]
    assert result["serve_error_rate"] == 0.0
    assert result["slo_pass"] is True
    assert result["serve_slo_p99_ms"] == 30_000.0
    assert result["serve_loadtest_p99_ms"] > 0
    assert result["serve_recovery_s"] == 0.0
    for key in ("serve_loadtest_qps", "serve_error_rate", "serve_recovery_s",
                "serve_slo_p99_ms", "slo_pass", "shed", "deadline_exceeded"):
        assert key in result
    json.dumps(result)
    assert serve_loadtest.verdict_line(result).startswith("[PASS] offered")


def test_loadtest_counts_sheds_and_fails_verdict():
    """An overloaded target cannot pass: sheds count into the error rate."""
    api = make_api(meta_batch_size=8, max_wait_ms=60_000.0, max_queue_depth=1,
                   degrade_queue_depth=0)
    api.warmup([(5, 1, 3)])
    try:
        result = run_loadtest(
            api, synth_episodes(4, way=5, shot=1, query=3, image_shape=(1, 14, 14)),
            rate_qps=30.0, duration_s=0.7, p99_budget_ms=30_000.0, error_slo=0.01,
            timeout_s=1.0, seed=1,
        )
    finally:
        api.close()
    assert result["shed"] + result["deadline_exceeded"] > 0
    assert result["serve_error_rate"] > 0.01
    assert result["slo_pass"] is False
    assert serve_loadtest.verdict_line(result).startswith("[FAIL]")


@pytest.mark.parametrize("spec", ["2:20:1.5", "0:8:0.5,1:4:1"])
def test_ramp_arrivals_are_the_jax_harness(spec):
    segments = serve_loadtest.parse_ramp(spec)
    assert segments == jloadtest.parse_ramp(spec)
    assert serve_loadtest.ramp_arrivals(segments, seed=3) == jloadtest.ramp_arrivals(
        segments, seed=3)
    rate, total, peak = serve_loadtest.ramp_rate_fn(segments)
    jrate, jtotal, jpeak = jloadtest.ramp_rate_fn(segments)
    assert (total, peak) == (jtotal, jpeak)
    assert [rate(t / 10) for t in range(40)] == [jrate(t / 10) for t in range(40)]
    for bad in ("1:2", "3:1:5", "1:2:0"):
        with pytest.raises(ValueError):
            serve_loadtest.parse_ramp(bad)


def test_synthetic_episodes_are_the_jax_harness():
    got = synth_episodes(3, way=5, shot=2, query=4, image_shape=(1, 14, 14), seed=9)
    want = jloadtest.synth_episodes(3, way=5, shot=2, query=4, image_shape=(1, 14, 14),
                                    seed=9)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_loadtest_cli_pool_with_a_kill_and_a_tier(cli_config, tmp_path, capsys):
    """``--replicas 2 --kill-replica-at 3 --tier-dir``: every request is
    answered through the death, the verdict passes (exit 0) and the JSON
    line has the recovery and the respawn's ready time."""
    code = serve_loadtest.main([
        "--config", cli_config, "--device", "cpu", "--replicas", "2",
        "--kill-replica-at", "3", "--tier-dir", str(tmp_path / "tier"),
        "--rate", "15", "--duration-s", "1.5", "--episodes", "6", "--query", "3",
        "--p99-budget-ms", "30000", "--json", "--use_pallas_fused_norm", "True",
    ])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0, result
    assert result["target"] == "in-process pool x2"
    assert result["errors"] == result["shed"] == 0 and result["serve_error_rate"] == 0.0
    assert result["completed_ok"] == result["offered"] > 3
    assert result["serve_recovery_s"] is not None and result["serve_recovery_s"] > 0
    assert faultinject.current_plan() is None


def test_loadtest_cli_url_target_and_failing_exit_code(cli_config, capsys):
    """``--url`` against a running port server; a budget nothing can meet
    fails the verdict with exit code 2."""
    api = make_api(meta_batch_size=4, max_wait_ms=1.0)
    api.warmup([(5, 1, 3)])
    server, thread, base = run_server(api)
    try:
        code = serve_loadtest.main([
            "--url", base, "--image-shape", "1x14x14", "--rate", "10",
            "--duration-s", "0.6", "--query", "3", "--episodes", "2",
            "--p99-budget-ms", "0.001",
        ])
    finally:
        stop_server(server, thread, api)
    out = capsys.readouterr().out
    assert code == 2 and out.startswith("[FAIL]"), out
    assert api.metrics.episodes_served.value > 0
    with pytest.raises(SystemExit):
        serve_loadtest.main(["--rate", "1"])  # no target


def test_health_sampler_measures_the_longest_degraded_window():
    class Target:
        def __init__(self):
            self.states = iter([True, False, False, True, False, True] + [True] * 100)

        def healthz(self):
            return {"ready": next(self.states)}

    sampler = serve_loadtest._HealthSampler(Target(), interval_s=0.01)
    with sampler:
        time.sleep(0.2)
    assert 0.0 < sampler.longest_degraded_window_s() < 1.0


# ---------------------------------------------------------------------------
# The geometry stream (--geometry-mix / --geometry-lattice)
# ---------------------------------------------------------------------------


@pytest.fixture
def built_apis(monkeypatch):
    """Every ``ServingAPI`` the load test's in-process targets build."""
    from howtotrainyourmamlpytorch_tpu_torch import serve_maml

    apis, build = [], serve_maml.build_api

    def recording(*args, **kwargs):
        api, line = build(*args, **kwargs)
        apis.append(api)
        return api, line

    monkeypatch.setattr(serve_maml, "build_api", recording)
    return apis


@pytest.mark.parametrize("lattice", [None, "5x1x15,3x2x8"], ids=["max_of_mix", "explicit"])
@pytest.mark.parametrize("replicas", [0, 2], ids=["one_engine", "pool"])
def test_geometry_mix_stream_is_answered_within_the_lattice(cli_config, capsys, built_apis,
                                                            lattice, replicas):
    """A ``5x1x15,3x2x8`` stream: every request answered, each engine built
    on the lattice (the mix's elementwise maximum 5x2x15, or the given one),
    with layer norm, warmed at every lattice bucket, and minting at most an
    adapt and a classify program per bucket."""
    argv = ["--config", cli_config, "--device", "cpu", "--geometry-mix", "5x1x15,3x2x8",
            "--rate", "12", "--duration-s", "1.0", "--episodes", "6",
            "--p99-budget-ms", "30000", "--json", "--replicas", str(replicas)]
    if lattice:
        argv += ["--geometry-lattice", lattice]
    code = serve_loadtest.main(argv)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0, result
    assert result["completed_ok"] == result["offered"] > 3 and result["errors"] == 0
    want = serve_loadtest.parse_geometries(lattice) if lattice else [(5, 2, 15)]
    assert built_apis and len(built_apis) >= max(replicas, 1)
    for api in built_apis:
        engine = api.engine
        assert engine.config.geometry_lattice == tuple(want)
        assert engine.learner.cfg.backbone.norm_layer == "layer_norm"
        assert engine.warmed_buckets() == sorted(want)
        assert 0 < len(engine.compile_table()) <= 2 * len(want)


@pytest.mark.parametrize("spec", ["5x1x15,3x2x8", " 5x1x15 , ", "1x1x1"])
def test_parse_geometries_is_the_jax_harness(spec):
    from tools.serve_bench import parse_geometries

    assert serve_loadtest.parse_geometries(spec) == parse_geometries(spec)


@pytest.mark.parametrize("spec", ["5x1", "5x1x15,3x2", ",", "5x1x15x2"])
def test_malformed_geometry_raises_the_jax_message(spec, cli_config):
    from tools.serve_bench import parse_geometries

    with pytest.raises(ValueError) as theirs:
        parse_geometries(spec)
    with pytest.raises(ValueError) as ours:
        serve_loadtest.parse_geometries(spec)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="must be WxSxQ|no geometries"):
        serve_loadtest.main(["--config", cli_config, "--device", "cpu",
                             "--geometry-mix", spec, "--duration-s", "0.1"])

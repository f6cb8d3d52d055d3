"""The port stands alone: importing all of it loads no JAX, no port file
imports the JAX package, and chip_smoke.py refuses to run without a card."""

import os
import pkgutil
import re
import subprocess
import sys

import howtotrainyourmamlpytorch_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
JAX_PACKAGE_IMPORT = re.compile(
    r"(import|from)\s+howtotrainyourmamlpytorch_tpu(\.|\s|$)"
)


def _port_modules():
    return [
        m.name for m in pkgutil.walk_packages([PORT_DIR], port.__name__ + ".")
    ]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_importing_every_port_module_loads_no_jax():
    modules = _port_modules()
    assert len(modules) >= 15
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'optax')\n"
        "                or m.split('.')[0] == 'howtotrainyourmamlpytorch_tpu')\n"
        "print('LEAKED', leaked)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout


def test_train_slice_modules_are_in_the_import_check():
    """The modules of the train slice are among those the import check
    walks, and the entry points it adds exist."""
    from howtotrainyourmamlpytorch_tpu_torch.models import TrainState
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm

    modules = _port_modules()
    for name in ("models.maml", "models.common", "ops.fused_norm", "convert",
                 "inner_loop"):
        assert f"{port.__name__}.{name}" in modules
    assert {"fused_bn_leaky_relu_ho", "fused_bn_leaky_relu_pool",
            "bn_act_pool_apply", "plain_pool_apply"} <= set(dir(fused_norm))
    assert TrainState._fields[-1] == "iteration"


def test_cli_slice_modules_are_in_the_import_check():
    """The modules of the training CLI are among those the import check
    walks."""
    modules = _port_modules()
    for name in ("train_maml_system", "experiment_builder", "data.dataset",
                 "data.loader", "data.augment", "data.fast_synth",
                 "native.build", "utils.checkpoint", "utils.storage",
                 "utils.dataset_tools", "utils.parser_utils"):
        assert f"{port.__name__}.{name}" in modules


def test_dispatch_slice_modules_are_in_the_import_check():
    """The modules of the multi-iteration dispatch are among those the
    import check walks, and the entry points they add exist."""
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner

    modules = _port_modules()
    for name in ("models.step_graph", "data.device_prefetch"):
        assert f"{port.__name__}.{name}" in modules
    assert callable(MAMLFewShotLearner.run_train_iters)


def test_no_port_source_imports_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tools", f)
        for f in os.listdir(os.path.join(REPO, "tools"))
        if f.startswith("port_") and f.endswith(".py")
    ]
    for root, _, files in os.walk(PORT_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if JAX_PACKAGE_IMPORT.search(line):
                    offenders.append(f"{path}:{lineno}: {line.strip()}")
    assert not offenders, offenders


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, cwd=REPO, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_serving_slice_modules_are_in_the_import_check():
    """The modules of the serving runtime's front door are among those the
    import check walks, and its public names exist."""
    from howtotrainyourmamlpytorch_tpu_torch import serve

    modules = _port_modules()
    for name in ("serve.api", "serve.batcher", "serve.cache", "serve.engine",
                 "serve.errors", "serve.geometry", "serve.metrics",
                 "serve.resilience.admission", "serve.resilience.swap",
                 "telemetry.events", "telemetry.registry", "data.synth_geometry",
                 "serve_maml"):
        assert f"{port.__name__}.{name}" in modules
    assert {"ServingAPI", "make_http_server", "MicroBatcher", "ServeMetrics",
            "ServeConfig", "EpisodeRequest", "ServingEngine", "SwapRejectedError",
            "DeadlineExceededError", "OverloadedError"} <= set(serve.__all__)


def test_compute_options_slice_modules_are_in_the_import_check():
    """The modules of the compute options (lane padding, the port's own
    Threefry) are among those the import check walks, and the on-device
    augmentation's entry points exist."""
    from howtotrainyourmamlpytorch_tpu_torch.models import common

    modules = _port_modules()
    for name in ("ops.layout", "utils.threefry"):
        assert f"{port.__name__}.{name}" in modules
    assert {"DeviceAugment", "rot90_by_gather", "crop_flip_by_key",
            "decode_augment_images", "decode_train_batch"} <= set(dir(common))
    assert not hasattr(common, "refuse_unported")


def test_operations_plane_modules_are_in_the_import_check():
    """The training CLI's operations plane (fault injection, the watchdog,
    the sanitizers, the trainer telemetry, the dispatcher and the chaos
    harness) is among the modules the import check walks."""
    modules = _port_modules()
    for name in ("utils.faultinject", "utils.watchdog", "utils.sanitize",
                 "telemetry.runtime", "telemetry.device", "telemetry.heartbeat",
                 "telemetry.anomaly", "telemetry.profiling", "telemetry.events",
                 "train_maml_system_dispatch", "chaos_train"):
        assert f"{port.__name__}.{name}" in modules


def test_replica_pool_and_tier_modules_are_in_the_import_check():
    """The supervised replica pool, the replica flavours, the durable tier
    and the load test are among the modules the import check walks (no
    JAX, nothing of the JAX package), with the JAX package's public names."""
    from howtotrainyourmamlpytorch_tpu.serve import tier as jtier
    from howtotrainyourmamlpytorch_tpu_torch import serve
    from howtotrainyourmamlpytorch_tpu_torch.serve import resilience, tier

    modules = _port_modules()
    for name in ("serve.pool", "serve.resilience.replica", "serve.tier",
                 "serve.tier.atomic", "serve.tier.ring", "serve.tier.spill",
                 "serve.tier.execcache", "serve_loadtest"):
        assert f"{port.__name__}.{name}" in modules
    assert set(tier.__all__) == set(jtier.__all__)
    assert {"PoolConfig", "ReplicaPool", "NoHealthyReplicaError",
            "ReplicaDeadError"} <= set(serve.__all__)
    assert {"Replica", "LocalReplica", "HttpReplica",
            "SubprocessReplica"} <= set(resilience.__all__)


def test_control_plane_modules_are_in_the_import_check_and_stay_off_the_card():
    """The promotion daemon, the autoscaler and their command lines are
    among the modules the import check walks (no JAX, nothing of the JAX
    package), with the JAX package's public names; importing them and
    building a daemon imports no torch (the serve package loads its
    submodules on first use), so no CUDA is initialised."""
    from howtotrainyourmamlpytorch_tpu.serve.resilience import promotion as jpromo
    from howtotrainyourmamlpytorch_tpu_torch.serve import resilience
    from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import (
        autoscaler,
        promotion,
    )

    modules = _port_modules()
    for name in ("serve.resilience.promotion", "serve.resilience.autoscaler",
                 "promotion_daemon", "autoscaler_daemon"):
        assert f"{port.__name__}.{name}" in modules
    assert {"PromotionConfig", "PromotionDaemon", "PromotionJournal", "SloWatch",
            "AutoscalerDaemon", "AutoscalerPolicy", "decide"} <= set(resilience.__all__)
    for name in ("PHASE_START", "PHASE_VERIFIED", "PHASE_PROMOTED", "PHASE_SLO_OK",
                 "PHASE_REJECTED", "PHASE_ROLLBACK_START", "PHASE_ROLLED_BACK",
                 "PHASE_DEDUPED", "PHASE_RESUMED", "PHASE_RETIRED", "TERMINAL_PHASES",
                 "KILL_PRE_VERIFY", "KILL_PRE_PUBLISH", "KILL_POST_PUBLISH",
                 "KILL_PRE_RESOLVE", "KILL_MID_GC"):
        assert getattr(promotion, name) == getattr(jpromo, name), name
    assert autoscaler.TERMINAL_PHASES == ("settled", "aborted")
    code = (
        "import sys\n"
        "from howtotrainyourmamlpytorch_tpu_torch import promotion_daemon, autoscaler_daemon\n"
        "d = promotion_daemon.build_daemon(promotion_daemon.get_parser().parse_args(\n"
        "    ['--watch', sys.argv[1] + '/saved_models', '--target', 'http://127.0.0.1:9']))\n"
        "a = autoscaler_daemon.build_daemon(autoscaler_daemon.get_parser().parse_args(\n"
        "    ['--target', 'http://127.0.0.1:9', '--journal', sys.argv[1] + '/a.jsonl']))\n"
        "print('TORCH', 'torch' in sys.modules)\n"
        "import torch\n"
        "print('CUDA', torch.cuda.is_initialized())\n"
        "print('JAX', sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "      ('jax', 'jaxlib', 'howtotrainyourmamlpytorch_tpu')))\n"
    )
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-c", code, tmp], capture_output=True, text=True,
            env=_env(), cwd=REPO, timeout=120,
        )
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout, proc.stdout
    assert "CUDA False" in proc.stdout and "JAX []" in proc.stdout, proc.stdout


def test_feedback_and_toolkit_modules_are_in_the_import_check_and_host_only():
    """The episode miner, the knob space, the lock sanitizer and its
    algorithm, and the telemetry report are among the modules the import
    check walks; the miner, the space, the sanitizer, the algorithm and the
    report's report and fleet modes import no torch (a command line run
    beside a trainer holds no CUDA context)."""
    modules = _port_modules()
    for name in ("episode_miner", "tune", "tune.space", "utils.algo", "utils.locksan",
                 "telemetry_report"):
        assert f"{port.__name__}.{name}" in modules
    code = (
        "import json, sys, tempfile, os\n"
        "from howtotrainyourmamlpytorch_tpu_torch import episode_miner, telemetry_report\n"
        "from howtotrainyourmamlpytorch_tpu_torch.tune import space\n"
        "from howtotrainyourmamlpytorch_tpu_torch.utils import algo, locksan\n"
        "d = tempfile.mkdtemp()\n"
        "p = os.path.join(d, 'telemetry.jsonl')\n"
        "open(p, 'w').write(json.dumps({'t': 1.0, 'type': 'serve_dispatch',\n"
        "    'tags': ['seed:3'], 'margins': [0.1], 'entropies': [1.0]}) + '\\n')\n"
        "assert episode_miner.main(['--telemetry', p, '--out', p + '.m', '--json']) == 0\n"
        "assert telemetry_report.main([p, '--json']) == 0\n"
        "assert telemetry_report.main(['--fleet', p]) == 0\n"
        "space.fingerprint_from_args(object())\n"
        "with locksan.sanitized():\n"
        "    pass\n"
        "print('TORCH', 'torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout, proc.stdout


def test_parallel_modules_are_in_the_import_check():
    """The data-parallel layer (bring-up, the dp layout, the bucketed
    collectives, the fences and gathers) is among the modules the import
    check walks (no JAX, nothing of the JAX package), with the names JAX's
    ``parallel/`` exports for its dp half."""
    from howtotrainyourmamlpytorch_tpu import parallel as jparallel
    from howtotrainyourmamlpytorch_tpu_torch import parallel

    modules = _port_modules()
    for name in ("parallel", "parallel.distributed", "parallel.mesh",
                 "parallel.collectives", "parallel.multihost"):
        assert f"{port.__name__}.{name}" in modules
    dp_half = {"make_mesh", "default_mesh_from_args", "degraded_dp_extent",
               "degraded_process_count", "host_batch_bounds", "DistributedInitError",
               "initialize_distributed", "initialize_distributed_from_argv",
               "DEFAULT_DATA_AXIS", "DEFAULT_MODEL_AXIS"}
    assert dp_half <= set(jparallel.__all__) and dp_half <= set(parallel.__all__)
    assert {"fused_psum", "per_leaf_psum", "flatten_buckets", "unflatten_buckets",
            "BucketSpec", "guard_task_chunk", "barrier", "gather_global",
            "allgather_host", "is_multiprocess"} <= set(parallel.__all__)


def test_autotuner_modules_are_in_the_import_check_and_host_only():
    """The autotuner (the sentinel, the gate judge, the loop and its command
    line) is among the modules the import check walks (no JAX, nothing of
    the JAX package), with the names JAX's ``tune/autotuner.py`` exports;
    the sentinel's trainer scan, the judge and the ranking import no
    torch."""
    from howtotrainyourmamlpytorch_tpu.tune import autotuner as jautotuner
    from howtotrainyourmamlpytorch_tpu_torch.tune import autotuner

    modules = _port_modules()
    for name in ("tune.sentinel", "tune.judge", "tune.autotuner", "autotune"):
        assert f"{port.__name__}.{name}" in modules
    shared = {"PROBE_KEY", "BASELINE_KEY", "HBM_BW_BY_KIND", "ProbeSpec", "classify_regime",
              "rank_candidates", "PROBE_APPLIERS", "_probe_batch", "_probe_config",
              "default_measure", "_measure_clean", "autotune_run", "append_gate"}
    assert shared <= set(dir(jautotuner)) and shared <= set(dir(autotuner))
    code = (
        "import sys\n"
        "from howtotrainyourmamlpytorch_tpu_torch import autotune\n"
        "from howtotrainyourmamlpytorch_tpu_torch.tune import autotuner, judge, sentinel\n"
        "from howtotrainyourmamlpytorch_tpu_torch.tune.space import TuneContext\n"
        "autotuner.rank_candidates('memory', TuneContext())\n"
        "autotuner.classify_regime(0.5, 'NVIDIA H100 80GB HBM3', 67e12)\n"
        "judge.eval_gate('this > 1', {'this': 2})\n"
        "sentinel.live_trainer_pids()\n"
        "autotune.get_parser().parse_args([])\n"
        "print('TORCH', 'torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout, proc.stdout

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

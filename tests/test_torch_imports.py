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


def test_no_port_source_imports_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
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

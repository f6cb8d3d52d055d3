"""The serving engine's per-bucket program ledger in the port
(``serve/engine.py``, ``serve/metrics.py``) against the JAX engine's, on
the CPU: ``warmup`` records one row per bucket's adapt and classify
programs (FLOPs under ``FlopCounterMode``), emitted as ``program_profile``
and served as ``maml_serve_program_flops`` on ``/metrics``; a live
dispatch records nothing and runs under no counter; the adapt program's
FLOPs are within a factor of 2 of the JAX engine's XLA count for the same
bucket (the ratio is printed). On the CPU there is no allocator peak, so
no ``maml_serve_program_hbm_peak_bytes`` row."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JMAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu.serve import ServeConfig as JServeConfig
from howtotrainyourmamlpytorch_tpu.serve import ServingEngine as JServingEngine
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine
from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
from howtotrainyourmamlpytorch_tpu_torch.utils import locksan
from test_torch_serve_runtime import (  # noqa: F401 (one_intra_op_thread)
    episode,
    jax_tiny_cfg,
    make_api,
    one_intra_op_thread,
    port_state_of,
    tiny_cfg,
)

#: The JAX adapt program's FLOPs over the port's must lie in [1/2, 2].
FLOPS_FACTOR = 2.0
BUCKETS = [(5, 1, 3), (5, 2, 4)]


@pytest.fixture(autouse=True)
def _lock_sanitizer():
    with locksan.sanitized() as san:
        yield san


@pytest.fixture
def engines():
    jlearner, learner = JMAMLFewShotLearner(jax_tiny_cfg()), MAMLFewShotLearner(tiny_cfg())
    jstate = jlearner.init_state(jax.random.PRNGKey(5))
    jengine = JServingEngine(jlearner, jstate, JServeConfig(meta_batch_size=2))
    engine = ServingEngine(learner, port_state_of(jlearner, learner, jstate),
                           ServeConfig(meta_batch_size=2), device="cpu")
    return jengine, engine


def _rows(ledger):
    return {row["name"]: row for row in ledger.table()}


@pytest.mark.parametrize("bucket", BUCKETS)
def test_warmup_records_each_program_once_within_a_factor_of_jax(engines, bucket, tmp_path):
    jengine, engine = engines
    log = events.EventLog(str(tmp_path / "events.jsonl"))
    previous = events.install(log)
    try:
        engine.warmup([bucket])
        jengine.warmup([bucket])
        engine.warmup([bucket])  # a second warmup records nothing new
    finally:
        events.install(previous)
    log.flush()
    way, shot, query = bucket
    adapt, classify = f"adapt:2x{way * shot}", f"classify:2x{query}"
    rows, jrows = _rows(engine.ledger), _rows(jengine.ledger)
    assert set(rows) == {adapt, classify}
    for name, role in ((adapt, "serve_adapt"), (classify, "serve_classify")):
        row = rows[name]
        assert row["role"] == role and row["bucket"] == "x".join(map(str, bucket))
        assert row["k"] == 1 and row["flops"] > 0 and row["hbm_peak_bytes"] is None
    profiles = [e for e in events.read_events(log.path) if e["type"] == "program_profile"]
    assert sorted(e["name"] for e in profiles) == sorted([adapt, classify])
    jflops = jrows[adapt]["flops"]
    ratio = jflops / rows[adapt]["flops"]
    print(f"adapt {bucket}: JAX {jflops:.4g} FLOPs, port {rows[adapt]['flops']:.4g} "
          f"FLOPs, ratio {ratio:.3f}")
    assert 1.0 / FLOPS_FACTOR <= ratio <= FLOPS_FACTOR


def test_live_dispatches_record_nothing_and_metrics_serve_the_rows():
    api = make_api(meta_batch_size=2, max_wait_ms=0.0)
    try:
        rng = np.random.RandomState(0)
        api.classify(*episode(rng))  # a live dispatch before any warmup
        assert api.engine.ledger.table() == []
        assert "maml_serve_program_flops" not in api.metrics_text()
        api.warmup([(5, 1, 3)])
        text = api.metrics_text()
        rows = [line for line in text.splitlines()
                if line.startswith("maml_serve_program_flops{")]
        assert sorted(rows) == sorted(
            f'maml_serve_program_flops{{program="{r["name"]}",bucket="5x1x3"}} {r["flops"]:g}'
            for r in api.engine.ledger.table())
        assert all(float(line.split()[-1]) > 0 for line in rows)
        assert "maml_serve_program_hbm_peak_bytes" not in text
        assert "maml_serve_program_bytes_accessed" not in text
        assert len(api.stats()["programs"]) == 2
        before = api.engine.ledger.table()
        for _ in range(3):
            api.classify(*episode(rng))
        assert api.engine.ledger.table() == before
    finally:
        api.close()


def test_warmup_through_a_wrapped_probe_still_records(engines):
    """A monitor that wraps ``engine._probe(istate, ep)`` (as the smoke
    script's control-plane monitor does, to count warmups and canaries)
    sees each warmup probe, and the ledger still records the bucket."""
    _, engine = engines
    calls = []
    probe = engine._probe

    def counted(istate, ep):
        calls.append(ep.bucket)
        return probe(istate, ep)

    engine._probe = counted
    engine.warmup([(5, 1, 3)])
    assert calls == [(5, 1, 3)]
    assert sorted(_rows(engine.ledger)) == ["adapt:2x5", "classify:2x3"]
    engine.canary_probe(engine._published.istate)
    assert len(calls) == 2 and len(engine.ledger.table()) == 2


def test_flop_counter_counts_as_flop_counter_mode_without_importing_dynamo():
    """The ledgers' counter counts what ``FlopCounterMode`` counts, and a
    process that counts imports no ``torch._dynamo`` (its first import is
    seconds of a worker's boot)."""
    code = (
        "import sys, torch\n"
        "from torch.utils.flop_counter import FlopCounterMode\n"
        "from howtotrainyourmamlpytorch_tpu_torch.telemetry.device import flop_counter\n"
        "x, w = torch.ones(4, 8, requires_grad=True), torch.ones(8, 3)\n"
        "def work():\n"
        "    y = torch.nn.functional.conv2d(torch.ones(2, 3, 8, 8), torch.ones(5, 3, 3, 3))\n"
        "    (x @ w).sum().backward()\n"
        "    return y\n"
        "ours = flop_counter()\n"
        "with ours:\n"
        "    work()\n"
        "print('DYNAMO', 'torch._dynamo' in sys.modules)\n"
        "theirs = FlopCounterMode(display=False)\n"
        "with theirs:\n"
        "    work()\n"
        "print('FLOPS', ours.get_total_flops(), theirs.get_total_flops())\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=repo, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "DYNAMO False" in proc.stdout, proc.stdout
    flops = proc.stdout.split("FLOPS")[1].split()
    assert flops[0] == flops[1] and int(flops[0]) > 0

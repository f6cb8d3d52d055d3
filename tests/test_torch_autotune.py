"""The port's autotuner (``tune/autotuner.py``, ``tune/sentinel.py``, the
``autotune`` command line and the program ledger's byte count) against the
JAX package's ``tune/autotuner.py`` and the JAX repo's ``bench.py`` on the
CPU.

* The decision machinery, driven by the injected measure and sentinel
  tables of tests/test_tune.py, returns the same document in both
  packages; the regime, the ranking, the gates-file append and the probe
  batch are the same.
* The probe learner, the JAX weights carried across by ``convert.py``:
  its first ``run_train_iters`` losses at K=1 and K=2, at the baseline,
  under ``task_chunk`` 4 and under lane padding, within rtol 1e-5 of the
  JAX probe's (its fused norm runs its plain body on the CPU, JAX's probe
  has none); theta and the LSLR rates after it at the port's grad bar
  (rtol 1e-3, atol 1e-5), the conv biases, which sit before batch norm
  and take Adam steps on rounding noise, within 2 K meta learning rates
  (tests/test_torch_train_iter.py).
* The probe's fused-norm launches per iteration, counted on the CPU, are
  those ``chip_smoke.py``'s ``[autotune]`` holds its captured graphs to.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.telemetry.device import (
    ProgramLedger as JProgramLedger,
    record_train_program,
)
from howtotrainyourmamlpytorch_tpu.tune import autotuner as jautotuner
from howtotrainyourmamlpytorch_tpu.tune.space import TuneContext as JTuneContext
from howtotrainyourmamlpytorch_tpu_torch import autotune as cli
from howtotrainyourmamlpytorch_tpu_torch.convert import train_state_from_numpy, tree_to_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
from howtotrainyourmamlpytorch_tpu_torch.telemetry import device as ledger_device
from howtotrainyourmamlpytorch_tpu_torch.tune import autotuner, sentinel
from howtotrainyourmamlpytorch_tpu_torch.tune.space import (
    TuneContext,
    config_fingerprint,
    resolve,
)

from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_ATOL,
    assert_tree_close,
    jax_train_state_numpy,
    one_intra_op_thread,
)
from test_torch_train_iter import _split_conv_biases
from test_torch_zoo_launches import counted  # noqa: F401

PROBE_LOSS_RTOL = 1e-5
H100 = "NVIDIA H100 80GB HBM3"

# ---------------------------------------------------------------------------
# Regime and ranking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("intensity, kind, peak", [
    (None, "cpu", None),
    (0.8, "cpu", None),
    (10.0, "cpu", 1e12),
    (10.0, "NVIDIA A100-SXM4-80GB", 19.5e12),
    (None, H100, 67e12),
    (5.0, H100, None),
    (5.0, "", 67e12),
])
def test_classify_regime_matches_jax_for_kinds_jax_does_not_know(intensity, kind, peak):
    assert autotuner.classify_regime(intensity, kind, peak) == jautotuner.classify_regime(
        intensity, kind, peak)


def test_the_h100_ridge_is_20_flop_per_byte():
    assert autotuner.hbm_bandwidth(H100) == 3.35e12
    assert autotuner.hbm_bandwidth("nvidia h100 80gb hbm3") == 3.35e12
    assert autotuner.hbm_bandwidth("NVIDIA A100-SXM4-80GB") is None
    assert all("TPU" not in kind for kind in autotuner.HBM_BW_BY_KIND)
    regime, reason = autotuner.classify_regime(19.9, H100, 67e12)
    assert regime == "memory" and "ridge 20.0" in reason and "19.9 FLOP/B" in reason
    regime, reason = autotuner.classify_regime(20.1, H100, 67e12)
    assert regime == "compute" and "ridge 20.0" in reason


CONTEXTS = [dict(), dict(global_batch=6), dict(global_batch=12, n_devices=4, dp=2),
            dict(global_batch=4), dict(global_batch=16, n_devices=8, dp=8)]


@pytest.mark.parametrize("regime", ["dispatch", "memory", "compute", "latency"])
@pytest.mark.parametrize("ctx", range(len(CONTEXTS)))
def test_rank_candidates_match_jax(regime, ctx):
    for cap in (1, 2, 6, 99):
        assert autotuner.rank_candidates(regime, TuneContext(**CONTEXTS[ctx]), cap) == \
            jautotuner.rank_candidates(regime, JTuneContext(**CONTEXTS[ctx]), cap)
    assert set(autotuner.PROBE_APPLIERS) == set(jautotuner.PROBE_APPLIERS)
    assert (autotuner.PROBE_KEY, autotuner.BASELINE_KEY) == (
        jautotuner.PROBE_KEY, jautotuner.BASELINE_KEY)


# ---------------------------------------------------------------------------
# The loop, with the injected tables of tests/test_tune.py
# ---------------------------------------------------------------------------

QUIET = {"contended": False, "sentinel_ms": 1.0}
NOISY = {"contended": True, "sentinel_ms": 99.0}


def _measure_table(baseline, table, default=9.0):
    def measure(overrides, spec):  # noqa: ARG001
        if not overrides:
            return baseline
        for (knob, value), measured in table.items():
            if overrides.get(knob) == value:
                return measured
        return default

    return measure


def _constant(value):
    def measure(overrides, spec):  # noqa: ARG001
        return value

    return measure


def _sequence(*readings):
    def make():
        it = iter(readings)
        return lambda: dict(next(it, QUIET))

    return make


LOOPS = {
    "keeps_a_winner": (dict(run_id="t01", contention_retries=0),
                       lambda: _measure_table(10.0, {("iters_per_dispatch", 5): 13.0}),
                       _sequence()),
    "below_min_gain": (dict(run_id="t02", contention_retries=0, min_gain=0.05),
                       lambda: _measure_table(10.0, {("iters_per_dispatch", 5): 10.2}),
                       _sequence()),
    "contended_baseline": (dict(run_id="t03", contention_retries=1),
                           lambda: _constant(10.0),
                           lambda: (lambda: dict(NOISY))),
    "discarded_probes": (dict(run_id="t04", contention_retries=1, max_candidates=3),
                         lambda: _measure_table(10.0, {("iters_per_dispatch", 25): 14.0}),
                         _sequence(QUIET, QUIET, NOISY, NOISY, NOISY, NOISY)),
}


@pytest.mark.parametrize("case", list(LOOPS))
def test_autotune_run_returns_the_jax_document(case):
    kwargs, measure, sentinels = LOOPS[case]
    kwargs = dict(kwargs)
    retries = kwargs.pop("contention_retries")
    ours = autotuner.autotune_run(
        spec=autotuner.ProbeSpec(contention_retries=retries),
        measure_fn=measure(), sentinel_fn=sentinels(), **kwargs)
    theirs = jautotuner.autotune_run(
        spec=jautotuner.ProbeSpec(contention_retries=retries),
        measure_fn=measure(), sentinel_fn=sentinels(), **kwargs)
    assert ours == theirs


def test_a_memory_bound_h100_runs_the_jax_memory_regime_loop():
    """The port on the H100 under its ridge against JAX on a TPU v4 under
    its own: the same memory-regime loop (task_chunk first), the documents
    equal but for the card's name in the reason and the gate's note."""
    measure = _measure_table(10.0, {("task_chunk", 8): 12.0})
    kwargs = dict(run_id="t05", arithmetic_intensity=0.8, measure_fn=measure,
                  sentinel_fn=lambda: dict(QUIET))
    ours = autotuner.autotune_run(spec=autotuner.ProbeSpec(contention_retries=0),
                                  device_kind=H100, peak_flops=67e12, **kwargs)
    theirs = jautotuner.autotune_run(spec=jautotuner.ProbeSpec(contention_retries=0),
                                     device_kind="TPU v4", peak_flops=275e12, **kwargs)
    assert ours["regime"] == theirs["regime"] == "memory"
    assert ours["ranked_candidates"][0] == {"knob": "task_chunk", "value": 2}
    for doc in (ours, theirs):
        doc.pop("regime_reason")
        doc["winner"]["gate_entry"].pop("note")
    assert ours == theirs and ours["winner"]["lever"] == "--task_chunk=8"


def test_the_sentinel_log_holds_every_attempt():
    log = []
    result = autotuner.autotune_run(
        run_id="t06", spec=autotuner.ProbeSpec(contention_retries=1), max_candidates=3,
        measure_fn=_measure_table(10.0, {("iters_per_dispatch", 25): 14.0}),
        sentinel_fn=_sequence(QUIET, QUIET, NOISY, NOISY, NOISY, NOISY)(), sentinel_log=log)
    assert [e["overrides"] for e in log] == [{}] + [
        {p["knob"]: p["value"]} for p in result["probes"]]
    assert [e["measured"] for e in log[1:]] == [p["measured"] for p in result["probes"]]
    assert [len(e["attempts"]) for e in log] == [1, 2, 1, 1]
    assert all(set(a) == {"before", "after", "flagged"} for e in log for a in e["attempts"])


def test_append_gate_writes_the_jax_bytes(tmp_path):
    seed = {"schema": 1, "gates": {"existing": {"direction": "higher", "gate": "this > 0"}},
            "ungated_ok": ["contended"]}
    entry = {"direction": "higher", "gate": "this > 1.05 * base", "source": "autotune:t05"}
    paths = []
    for name, module in (("ours", autotuner), ("theirs", jautotuner)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(seed))
        module.append_gate(str(path), autotuner.PROBE_KEY, entry,
                           ungated_extra=(autotuner.BASELINE_KEY, "contended"))
        module.append_gate(str(path), autotuner.PROBE_KEY, dict(entry, source="autotune:t06"),
                           ungated_extra=(autotuner.BASELINE_KEY, "autotune_knob"))
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert json.loads(paths[0].read_text())["ungated_ok"] == [
        "contended", autotuner.BASELINE_KEY, "autotune_knob"]


@pytest.mark.parametrize("spec", [{}, dict(num_stages=4, num_filters=64, inner_steps=5,
                                           window_iters=20), dict(batch_size=3, shots=2)],
                         ids=["probe", "flagship", "odd"])
def test_probe_batch_is_bit_identical(spec):
    ours = autotuner._probe_batch(autotuner.ProbeSpec(**spec), np.random.RandomState(1))
    theirs = jautotuner._probe_batch(jautotuner.ProbeSpec(**spec), np.random.RandomState(1))
    assert dataclasses_equal(autotuner.ProbeSpec(**spec), jautotuner.ProbeSpec(**spec))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# The probe learner against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("overrides", [{}, {"task_chunk": 4}, {"lane_pad_channels": True}],
                         ids=["baseline", "task_chunk4", "lane_pad"])
def test_probe_learner_matches_jax(overrides, k):
    jspec, spec = jautotuner.ProbeSpec(), autotuner.ProbeSpec()
    jlearner = JLearner(jautotuner._probe_config(overrides, jspec))
    jstate = jlearner.init_state(jax.random.PRNGKey(0))
    cfg = autotuner._probe_config(overrides, spec)
    assert cfg.backbone.fused_norm_train and cfg.backbone.fused_norm_pool
    learner = MAMLFewShotLearner(cfg)
    state = train_state_from_numpy(jax_train_state_numpy(jstate), cfg.meta_learning_rate, "cpu")
    rng = np.random.RandomState(1)
    batches = [autotuner._probe_batch(spec, rng) for _ in range(k)]
    jstate, jlosses = jlearner.run_train_iters(jstate, batches, 0)
    state, losses = learner.run_train_iters(state, batches, 0)
    np.testing.assert_allclose(losses["loss"].numpy(), np.asarray(jlosses["loss"]),
                               rtol=PROBE_LOSS_RTOL, atol=LOSS_ATOL)
    biases, rest = _split_conv_biases(tree_to_numpy(state.theta))
    jbiases, jrest = _split_conv_biases(jax.tree.map(np.asarray, jstate.theta))
    assert_tree_close(rest, jrest, GRAD_RTOL, GRAD_ATOL)
    assert_tree_close(biases, jbiases, 0, 2 * k * cfg.meta_learning_rate)
    assert_tree_close(tree_to_numpy(state.lslr), jax.tree.map(np.asarray, jstate.lslr),
                      GRAD_RTOL, GRAD_ATOL)


def test_default_measure_on_the_cpu_gives_a_rate():
    spec = autotuner.ProbeSpec(window_iters=2, windows=2)
    for overrides in ({}, {"iters_per_dispatch": 5}):
        rate = autotuner.default_measure(overrides, spec, device="cpu")
        assert math.isfinite(rate) and rate > 0


def test_the_probe_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotuner.default_measure({}, autotuner.ProbeSpec(window_iters=1, windows=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dry-run", "--window-iters", "1"])


@pytest.mark.parametrize("spec, want", [
    ({}, chip_smoke.AUTOTUNE_PROBE_LAUNCHES),
    ({"num_stages": 4, "num_filters": 8, "inner_steps": 5}, chip_smoke.AUTOTUNE_FLAGSHIP_LAUNCHES),
], ids=["probe", "flagship_stages"])
def test_probe_launches_are_what_chip_smoke_holds(counted, spec, want):  # noqa: F811
    """The launches of one probe iteration at the baseline: 2 (flagship 4)
    stages, 2 (5) inner steps, first order, final-only, remat on. The
    counts depend on the stages, the steps and remat, not on the width;
    task chunks multiply them by their number."""
    for overrides, chunks in (({}, 1), ({"task_chunk": 2}, 4), ({"lane_pad_channels": True}, 1)):
        learner, state, batches = autotuner.probe_learner(
            overrides, autotuner.ProbeSpec(**spec), "cpu")
        for name in counted:
            counted[name] = 0
        learner.run_train_iters(state, batches, 0)
        assert dict(counted) == {k: chunks * v for k, v in want.items()}, overrides


# ---------------------------------------------------------------------------
# The contention sentinel
# ---------------------------------------------------------------------------

TRAINER_ARGVS = [
    (["python3", "/x/train_maml_system.py", "--a"], True),
    (["python", "train_gradient_descent_system.py"], True),
    (["python", "/r/train_matching_nets_system_fake.py"], True),
    (["python", "train_maml_system_dispatch.py", "cfg"], True),
    (["grep", "train_maml_system"], False),
    (["tail", "-f", "train_maml_system.log"], False),
    (["sh", "-c", "python train_maml_system.py --x"], False),
    (["python", "train_anil_system.py"], False),
    (["python", "bench.py"], False),
]
PORT_FORMS = [
    (["python3", "-u", "-m", "howtotrainyourmamlpytorch_tpu_torch.train_maml_system"], True),
    (["python3", "-m", "howtotrainyourmamlpytorch_tpu_torch.train_maml_system_dispatch",
      "cfg.json"], True),
    (["python3", "-m", "howtotrainyourmamlpytorch_tpu_torch.train_matching_nets_system"], True),
    (["python3", "-m", "howtotrainyourmamlpytorch_tpu_torch.serve_maml"], False),
    (["python3", "-m", "howtotrainyourmamlpytorch_tpu_torch.autotune"], False),
    (["python3", "-m", "other_package.train_maml_system"], False),
    (["grep", "-m", "1", "train_maml_system"], False),
    (["python3", "-m"], False),
    ([b"python3", b"-m", b"howtotrainyourmamlpytorch_tpu_torch.train_maml_system", b""], True),
]


@pytest.mark.parametrize("argv, want", TRAINER_ARGVS + PORT_FORMS)
def test_is_trainer_argv(argv, want):
    assert sentinel.is_trainer_argv(argv) is want


def test_live_trainer_scan_matches_bench_on_live_processes(tmp_path):
    """Each argv above as a live process (``python -c <sleep> <argv...>``:
    the scan reads every token): the port's scan flags what bench's does,
    and the ``-m`` form, which bench does not know, too."""
    sleeper = "import time; time.sleep(60)"
    procs = []
    try:
        for argv, _ in TRAINER_ARGVS + PORT_FORMS[:-1]:
            procs.append(subprocess.Popen([sys.executable, "-c", sleeper, *argv]))
        ours, theirs = set(sentinel.live_trainer_pids()), set(bench._live_trainer_pids())
        for proc, (argv, want) in zip(procs, TRAINER_ARGVS + PORT_FORMS[:-1]):
            assert (proc.pid in ours) is want, argv
            if "-m" not in argv:
                assert (proc.pid in theirs) is want, argv
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()


def test_live_trainer_pids_reads_a_proc_tree(tmp_path):
    for pid, argv in ((11, [b"python3", b"-m",
                            b"howtotrainyourmamlpytorch_tpu_torch.train_maml_system"]),
                      (12, [b"grep", b"train_maml_system"]), (13, None)):
        (tmp_path / str(pid)).mkdir()
        if argv is not None:
            (tmp_path / str(pid) / "cmdline").write_bytes(b"\x00".join(argv) + b"\x00")
    (tmp_path / "self").mkdir()
    assert sentinel.live_trainer_pids(str(tmp_path)) == [11]
    assert sentinel.live_trainer_pids(str(tmp_path / "missing")) == []


def test_sentinel_ms_and_the_run_local_floor(monkeypatch):
    assert sentinel.SENTINEL_CONTENTION_FACTOR == bench.SENTINEL_CONTENTION_FACTOR == 5.0
    ms = sentinel.sentinel_ms(repeats=3, device="cpu")
    assert math.isfinite(ms) and ms > 0
    monkeypatch.setattr(sentinel, "live_trainer_pids", lambda: [])
    monkeypatch.setenv(sentinel.QUIET_SENTINEL_ENV, "not a number")
    readings = iter([2.0, 1.0, 3.0, 4.0, 6.0])
    monkeypatch.setattr(sentinel, "sentinel_ms", lambda repeats, device: next(readings))
    sentinel_fn = autotuner.ContentionSentinel("cpu")
    first = sentinel_fn()
    assert first["floor_ms"] == 1.0 and first["sentinel_ms"] == 4.0
    assert first["contended"] is False
    assert sentinel_fn()["contended"] is True  # 6.0 > 5 x 1.0
    monkeypatch.setenv(sentinel.QUIET_SENTINEL_ENV, "10")
    monkeypatch.setattr(sentinel, "sentinel_ms", lambda repeats, device: 30.0)
    monkeypatch.setattr(sentinel, "live_trainer_pids", lambda: [4242])
    reading = autotuner.ContentionSentinel("cpu")()
    assert reading["floor_ms"] == 10.0 and reading["live_trainers"] == [4242]
    assert reading["contended"] is True  # a live trainer, though 30 < 50


# ---------------------------------------------------------------------------
# The roofline inputs
# ---------------------------------------------------------------------------


def test_the_byte_counter_counts_what_moves():
    x = torch.ones((4, 4))
    with ledger_device.byte_counter() as moved:
        y = x + 1  # 64 read, 64 written
        x.view(16).expand(2, 16).t()  # aliases only
        torch.empty(100)  # allocates only
        y.reshape(2, 8)  # a view of a contiguous tensor
    assert moved.bytes == 128
    with ledger_device.byte_counter() as moved:
        torch.mm(x, x)  # 64 + 64 read, 64 written
    assert moved.bytes == 192


def test_the_warmup_hook_counts_bytes_and_intensity():
    """The probe program's row (``probe_program``: the ledger's warm-up
    hook around the CPU's eager step), and the ratio of its count before
    fusion to the JAX probe's XLA ``bytes accessed`` after fusion on the
    CPU, printed (a divergence, not a bar)."""
    entry = autotuner.probe_program(autotuner.ProbeSpec(), "cpu")
    assert entry.name == "train_step[first_order,final_only]"
    assert entry.flops > 0 and entry.bytes_accessed > 0
    assert entry.arithmetic_intensity == entry.flops / entry.bytes_accessed
    jspec = jautotuner.ProbeSpec()
    jlearner = JLearner(jautotuner._probe_config({}, jspec))
    jentry = record_train_program(
        JProgramLedger(emit_events=False), jlearner, jlearner.init_state(jax.random.PRNGKey(0)),
        [jautotuner._probe_batch(jspec, np.random.RandomState(1))], 0)
    print(f"probe program on the CPU: port bytes {entry.bytes_accessed:.6g} (before fusion), "
          f"JAX bytes {jentry.bytes_accessed:.6g} (XLA, after fusion), ratio "
          f"{entry.bytes_accessed / jentry.bytes_accessed:.4f}; FLOPs {entry.flops:.6g} / "
          f"{jentry.flops:.6g}; intensity {entry.arithmetic_intensity:.4f} / "
          f"{jentry.arithmetic_intensity:.4f} FLOP/B")
    assert jentry.bytes_accessed > 0


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


@pytest.fixture
def seed_gates(tmp_path):
    path = tmp_path / "gates.json"
    with open(cli.DEFAULT_GATES) as f:
        path.write_text(f.read())
    return path


def _patch_probe(monkeypatch, table):
    monkeypatch.setattr(autotuner, "default_measure",
                        lambda overrides, spec, device=None: table(overrides, spec))
    monkeypatch.setattr(autotuner, "ContentionSentinel",
                        lambda device=None: (lambda: dict(QUIET)))


def test_cli_dry_run_leaves_the_gates_alone(monkeypatch, seed_gates, tmp_path, capsys):
    _patch_probe(monkeypatch, _measure_table(10.0, {("iters_per_dispatch", 5): 13.0}))
    before = seed_gates.read_bytes()
    out = tmp_path / "out"
    code = cli.main(["--device", "cpu", "--dry-run", "--json", "--out", str(out),
                     "--gates", str(seed_gates)])
    doc = json.loads(capsys.readouterr().out)
    assert code == 0 and doc["winner"]["lever"] == "--iters_per_dispatch=5"
    assert doc["gates_appended"] is False and seed_gates.read_bytes() == before
    assert not out.exists()
    assert doc["regime"] == "dispatch" and doc["machine"]["device_kind"] == "cpu"
    assert doc["machine"]["arithmetic_intensity"] > 0 and doc["machine"]["ridge"] is None
    assert len(doc["sentinel_log"]) == 1 + len(doc["probes"])


@pytest.mark.parametrize("gain, code", [(13.0, 0), (10.2, 2)], ids=["keep", "revert"])
def test_cli_appends_if_and_only_if_it_exits_0(monkeypatch, seed_gates, tmp_path, capsys,
                                               gain, code):
    _patch_probe(monkeypatch, _measure_table(10.0, {("iters_per_dispatch", 5): gain}))
    monkeypatch.setattr(autotuner, "probe_program", lambda spec, device=None: None)
    before = seed_gates.read_bytes()
    out = tmp_path / "out"
    assert cli.main(["--device", "cpu", "--out", str(out), "--gates", str(seed_gates)]) == code
    text = capsys.readouterr().out
    receipts = sorted(os.listdir(out)) if out.exists() else []
    if code == 0:
        assert "WINNER --iters_per_dispatch=5" in text and "gate appended" in text
        assert receipts == ["AUTOTUNE_r01_r01.json", "AUTOTUNE_r01_r02.json"]
        gates = json.loads(seed_gates.read_text())
        assert gates["gates"][autotuner.PROBE_KEY]["source"] == "autotune:r01"
        ctx = TuneContext(n_devices=1, global_batch=8)
        r02 = json.loads((out / "AUTOTUNE_r01_r02.json").read_text())
        assert r02["parsed"]["config_fingerprint"] == config_fingerprint(
            resolve({"iters_per_dispatch": 5}, ctx))
        assert cli._next_run_id(str(out)) == "r02"
    else:
        assert "no candidate beat the gate" in text
        assert receipts == [] and seed_gates.read_bytes() == before

"""The port's gate judge (``tune/judge.py``) against the JAX repo's
``tools/bench_judge.py`` on the CPU.

The port has no ``bench.py`` whose ``EMITTED_KEYS`` it could read and no
program registry, so it judges as the JAX judge does when
``bench_emitted_keys()`` and ``program_registry_names()`` return None:
on the JAX side both are patched so. With that, both judges return the
same document for the gate documents and trajectories of
tests/test_bench_judge.py, for the checked-in ``BENCH_r01..r03`` under
``tools/bench_gates.json`` (with and without a degraded fourth run) and
for the autotuner's own emissions; the gate grammar gives the same values
and the same errors.
"""

import json
import os

import pytest

from howtotrainyourmamlpytorch_tpu_torch.tune import autotuner, judge
from tools import bench_judge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_judge(monkeypatch):
    """The JAX judge with no bench declaration and no program registry."""
    monkeypatch.setattr(bench_judge, "bench_emitted_keys", lambda *a: None)
    monkeypatch.setattr(bench_judge, "program_registry_names", lambda *a: None)
    return bench_judge.judge


def _gates(gates, ungated_ok=(), default_tolerance=0.08):
    return {"schema": 1, "default_tolerance": default_tolerance,
            "ungated_ok": list(ungated_ok), "gates": gates}


def _runs(tmp_path, payloads):
    paths = []
    for i, parsed in enumerate(payloads):
        path = tmp_path / f"BENCH_t{i + 1:02d}.json"
        path.write_text(json.dumps({"n": i + 1, "parsed": parsed}))
        paths.append(str(path))
    return bench_judge.load_trajectory(paths)


# The gate documents and trajectories of tests/test_bench_judge.py.
CASES = {
    "keep_revert_pending": (
        _gates({
            "rate": {"gate": None, "direction": "higher"},
            "lever_rate": {"gate": "this >= 1.1 * rate", "direction": "higher"},
            "bad_lever_rate": {"gate": "this >= 2.0 * rate", "direction": "higher"},
            "unmeasured": {"gate": "this >= 0.5", "direction": "higher"},
            "future_gate": {"gate": "this >= 1.0", "direction": "higher",
                            "gate_from_run": 9},
        }),
        [{"rate": 100.0, "lever_rate": 130.0, "bad_lever_rate": 120.0,
          "future_gate": 5.0}],
    ),
    "regress": (
        _gates({"rate": {"gate": "this >= 1.0", "direction": "higher",
                         "tolerance": 0.1}}),
        [{"rate": 100.0}, {"rate": 50.0}],
    ),
    "tolerance_and_lower": (
        _gates({
            "rate": {"gate": None, "direction": "higher", "tolerance": 0.1},
            "latency_ms": {"gate": None, "direction": "lower", "tolerance": 0.1},
            "overhead_pct": {"gate": None, "direction": "lower",
                             "tolerance": 0.5, "abs_slack": 1.0},
        }),
        [{"rate": 100.0, "latency_ms": 10.0, "overhead_pct": -0.2},
         {"rate": 95.0, "latency_ms": 10.5, "overhead_pct": 0.3}],
    ),
    "lower_regresses": (
        _gates({"latency_ms": {"gate": None, "direction": "lower", "tolerance": 0.1}}),
        [{"latency_ms": 10.0}, {"latency_ms": 20.0}],
    ),
    "contended_skipped": (
        _gates({"rate": {"gate": None, "direction": "higher", "tolerance": 0.1}}),
        [{"rate": 100.0}, {"rate": 500.0, "contended": True}, {"rate": 101.0},
         {"rate": 10.0, "contended": True}],
    ),
    "null_valued_runs": (
        _gates({"rate": {"gate": None, "direction": "higher", "tolerance": 0.1}}),
        [{"rate": 100.0}, {"rate": None}, {"rate": 80.0}],
    ),
    "stale_keys": (
        _gates({"rate": {"gate": None},
                "ghost_key": {"gate": None, "source": "bench.py"}},
               ungated_ok=["meta"]),
        [{"rate": 1.0, "meta": "x", "surprise_key": 2.0}],
    ),
    "program_sourced": (
        _gates({
            "comm_bytes_per_iter": {"gate": None, "source": "programs:maml/train_multi"},
            "mfu_pct": {"gate": None, "source": "programs:ghost/name"},
        }),
        [{"comm_bytes_per_iter": 1428, "mfu_pct": 3.8}],
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_judge_matches_jax_on_the_jax_tests_trajectories(case, tmp_path, jax_judge):
    gates, payloads = CASES[case]
    runs = _runs(tmp_path, payloads)
    got = judge.judge(gates, runs)
    assert got == jax_judge(gates, runs)
    assert got["stale"]["stale_gates"] == []


def test_all_contended_raises_the_jax_error(tmp_path, jax_judge):
    gates = _gates({"rate": {"gate": None}})
    runs = _runs(tmp_path, [{"rate": 1.0, "contended": True}])
    with pytest.raises(ValueError) as ours:
        judge.judge(gates, runs)
    with pytest.raises(ValueError) as theirs:
        jax_judge(gates, runs)
    assert str(ours.value) == str(theirs.value)


def _checked_in(tmp_path, degrade: bool):
    paths = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in (1, 2, 3)]
    if degrade:
        with open(paths[-1]) as f:
            doc = json.load(f)
        doc["n"] = 4
        doc["parsed"] = dict(doc["parsed"], value=doc["parsed"]["value"] / 2.0,
                             contended=False)
        r04 = tmp_path / "BENCH_r04.json"
        r04.write_text(json.dumps(doc))
        paths.append(str(r04))
    return paths


@pytest.mark.parametrize("degrade", [False, True], ids=["head", "degraded_r04"])
def test_judge_matches_jax_on_the_checked_in_trajectory(degrade, tmp_path, jax_judge):
    """The repo's own gates file over BENCH_r01..r03 (and a halved r04, which
    regresses the headline key) under both judges."""
    gates_path = os.path.join(REPO, "tools", "bench_gates.json")
    gates = judge.load_gates(gates_path)
    assert gates == bench_judge.load_gates(gates_path)
    runs = bench_judge.load_trajectory(_checked_in(tmp_path, degrade))
    got = judge.judge(gates, runs)
    assert got == jax_judge(gates, runs)
    assert ("value" in got["regressions"]) == degrade


@pytest.mark.parametrize("gain", [13.0, 10.2], ids=["keep", "revert"])
def test_judge_matches_jax_on_the_autotuner_emissions(gain, jax_judge):
    """The gates document and receipts an autotune run hands its judge."""
    seen = []

    def recording(gates_doc, runs):
        seen.append((gates_doc, runs))
        return judge.judge(gates_doc, runs)

    def measure(overrides, spec):  # noqa: ARG001
        return gain if overrides == {"iters_per_dispatch": 5} else (10.0 if not overrides else 9.0)

    result = autotuner.autotune_run(
        run_id="j01", spec=autotuner.ProbeSpec(contention_retries=0),
        measure_fn=measure, sentinel_fn=lambda: {"contended": False}, judge_fn=recording,
    )
    ((gates_doc, runs),) = seen
    assert judge.judge(gates_doc, runs) == jax_judge(gates_doc, runs)
    assert result["judge"]["verdict"] == ("keep" if gain > 10.5 else "revert")


GATE_VALUES = [
    ("this >= 0.5 * rate", {"this": 60.0, "rate": 100.0}),
    ("this >= 0.75 and this <= 1.0", {"this": 0.8}),
    ("this >= 1", {"this": True}),
    ("this >= rate", {"this": 1.0}),
    ("this >= rate", {"this": 1.0, "rate": None}),
    ("this > 1.05 * autotune_baseline_meta_iters_per_s",
     {"this": 13.0, "autotune_baseline_meta_iters_per_s": 10.0}),
    ("-this < 2 or this == 3", {"this": float("nan")}),
    ("this != 2 and +this - 1 / 4 > 0", {"this": 3}),
]
BAD_GATES = ["__import__('os')", "this.x > 1", "f(this)", "this >= 'a'", "this[0] > 1",
             "this ** 2 > 1"]


@pytest.mark.parametrize("expr, env", GATE_VALUES)
def test_eval_gate_values_match_jax(expr, env):
    assert judge.eval_gate(expr, env) is bench_judge.eval_gate(expr, env)


@pytest.mark.parametrize("expr", BAD_GATES)
def test_eval_gate_refuses_what_jax_refuses(expr):
    with pytest.raises(ValueError) as ours:
        judge.eval_gate(expr, {"this": 1.0})
    with pytest.raises(ValueError) as theirs:
        bench_judge.eval_gate(expr, {"this": 1.0})
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("doc", [{"schema": 2, "gates": {}}, {"schema": 1}],
                         ids=["newer_schema", "no_gates"])
def test_load_gates_refuses_what_jax_refuses(doc, tmp_path):
    path = tmp_path / "gates.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError) as ours:
        judge.load_gates(str(path))
    with pytest.raises(ValueError) as theirs:
        bench_judge.load_gates(str(path))
    assert str(ours.value) == str(theirs.value)


def test_the_seed_gates_file_loads_empty():
    doc = judge.load_gates(os.path.join(REPO, "howtotrainyourmamlpytorch_tpu_torch", "tune",
                                        "gates.json"))
    assert doc == {"schema": 1, "gates": {}, "ungated_ok": []}

"""The port's knob space (``tune/space.py``) and its event reader
(``telemetry/events.EventReader``) against the JAX package's, on the CPU:
the same registry (names, flags, planes, regimes, defaults, candidates,
``moves``, guards), the same ``resolve`` results and refusals, the same
legal candidates, and the same 12-hex fingerprint for the same
namespace; the reader's events, offsets and torn-line counts equal to
JAX's on torn and appended files. The trainer's stamped fingerprint is in
``tests/test_torch_telemetry_train.py``."""

import itertools
import json
import types

import pytest

from howtotrainyourmamlpytorch_tpu.telemetry import events as jevents
from howtotrainyourmamlpytorch_tpu.tune import space as jspace
from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
from howtotrainyourmamlpytorch_tpu_torch.tune import space

# ---------------------------------------------------------------------------
# The knob space
# ---------------------------------------------------------------------------

#: Knob fields that must agree; ``description`` says what the knob does in
#: each package, and the guards are compared by their verdicts.
KNOB_FIELDS = ("name", "flag", "plane", "regime", "default", "candidates", "moves")

CONTEXTS = [
    dict(),
    dict(global_batch=6),
    dict(global_batch=12),
    dict(n_devices=8, dp=4, global_batch=8),
    dict(n_devices=2, global_batch=8),
    dict(n_devices=4, global_batch=6),
    dict(n_devices=8, dp=2, mp=2, global_batch=16),
]

OVERRIDES = [
    {},
    {"task_chunk": 8},
    {"task_chunk": 2},
    {"task_chunk": 4},
    {"mesh_shape": (4, 1)},
    {"mesh_shape": (2, 2)},
    {"iters_per_dispatch": 25, "device_prefetch": 0},
    {"iters_per_dispatch": 7},
    {"task_chnuk": 4},
    {"serve_max_wait_ms": 10.0, "serve_queue_margin": (32, 128)},
    {"lane_pad_channels": True, "serve_max_batch": 16},
]


def _outcome(package, overrides, ctx):
    """The resolved set, or the refusal up to its parenthesis (the port's
    explanations in parentheses say what the step does in the port)."""
    try:
        return "ok", package.resolve(overrides, package.TuneContext(**ctx))
    except ValueError as exc:
        return "refused", str(exc).split(" (")[0]


@pytest.mark.parametrize("name", sorted(jspace.SPACE))
def test_registry_equals_jax(name):
    assert sorted(space.SPACE) == sorted(jspace.SPACE)
    knob, jknob = space.SPACE[name], jspace.SPACE[name]
    for field in KNOB_FIELDS:
        assert getattr(knob, field) == getattr(jknob, field), field
    assert (knob.guard is None) == (jknob.guard is None)
    assert knob.description


@pytest.mark.parametrize("case", range(len(OVERRIDES)))
def test_resolve_equals_jax_in_every_context(case):
    for ctx in CONTEXTS:
        assert _outcome(space, OVERRIDES[case], ctx) == \
            _outcome(jspace, OVERRIDES[case], ctx), ctx


@pytest.mark.parametrize("ctx", range(len(CONTEXTS)))
def test_legal_candidates_equal_jax(ctx):
    for name in jspace.SPACE:
        assert space.SPACE[name].legal_candidates(space.TuneContext(**CONTEXTS[ctx])) == \
            jspace.SPACE[name].legal_candidates(jspace.TuneContext(**CONTEXTS[ctx]))


#: The overrides that resolve at the default context.
RESOLVABLE = [o for o in OVERRIDES if _outcome(jspace, o, {})[0] == "ok"]


@pytest.mark.parametrize("case", range(len(RESOLVABLE)))
def test_config_fingerprint_equals_jax(case):
    resolved = jspace.resolve(RESOLVABLE[case])
    fp = space.config_fingerprint(resolved)
    assert fp == jspace.config_fingerprint(resolved)
    assert len(fp) == 12 and int(fp, 16) >= 0
    # A JSON round trip (tuples become lists) keeps the value hash.
    assert space.config_fingerprint(json.loads(json.dumps(resolved))) == fp


#: Namespaces as the CLI leaves them (strings), processed, partial and
#: empty; every combination of these attribute values is hashed.
ARG_VALUES = {
    "iters_per_dispatch": [None, 1, "5", 25],
    "task_chunk": [None, 0, "2"],
    "lane_pad_channels": [None, False, "True", "false", True],
    "device_prefetch": [None, -1, "0", 8],
    "data_parallel_devices": [None, 0, 1, "2"],
    "model_parallel_devices": [None, 1, 2],
}
NAMESPACES = [
    dict(zip(ARG_VALUES, values)) for values in itertools.product(*ARG_VALUES.values())
]


@pytest.mark.parametrize("shard", range(8))
def test_fingerprint_from_args_equals_jax_over_a_grid(shard):
    for values in NAMESPACES[shard::8]:
        args = types.SimpleNamespace(
            **{k: v for k, v in values.items() if v is not None})
        assert space.fingerprint_from_args(args) == jspace.fingerprint_from_args(args), values


def test_fingerprint_from_args_coerces_cli_strings_and_defaults():
    cli = types.SimpleNamespace(iters_per_dispatch="5", task_chunk=0,
                                lane_pad_channels="False", device_prefetch=-1,
                                data_parallel_devices=1, model_parallel_devices=1)
    processed = types.SimpleNamespace(iters_per_dispatch=5, task_chunk=0,
                                      lane_pad_channels=False, device_prefetch=-1,
                                      data_parallel_devices=1, model_parallel_devices=1)
    assert space.fingerprint_from_args(cli) == space.fingerprint_from_args(processed)
    assert space.fingerprint_from_args(types.SimpleNamespace()) == \
        space.config_fingerprint(space.resolve({}))


# ---------------------------------------------------------------------------
# EventReader
# ---------------------------------------------------------------------------


def _line(t, kind, **fields):
    return json.dumps({"t": t, "type": kind, **fields})


#: (initial bytes, appends between reads, since): each scenario is read by
#: one reader per package, once, then after each append.
SCENARIOS = {
    "streamed": (_line(100.0, "schema", version=1) + "\n" + _line(100.0, "a", iter=1) + "\n",
                 [_line(101.0, "b", iter=2) + "\n", ""], None),
    "since": (_line(100.0, "schema", version=1) + "\n" + _line(100.0, "a") + "\n"
              + _line(102.0, "b") + "\n", [], 101.0),
    "torn_and_tail": (_line(1.0, "a") + "\n" + '{"t": 2.0, "type": "torn"}garbage\n'
                      + _line(3.0, "b") + "\n" + '{"t": 4.0, "type": "tail',
                      ['_event"}\n', _line(5.0, "c") + "\n"], None),
    "unterminated_complete": (_line(1.0, "a") + "\n" + _line(2.0, "hang"), ["\n"], None),
    "blank_lines": ("\n" + _line(1.0, "a") + "\n\n\n" + _line(2.0, "b") + "\n",
                    ["\n", _line(3.0, "c")], None),
}


@pytest.mark.parametrize("include_tail", [False, True])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_event_reader_equals_jax_on_torn_and_appended_files(tmp_path, name,
                                                            include_tail):
    initial, appends, since = SCENARIOS[name]
    path = tmp_path / "telemetry.jsonl"
    path.write_text(initial)
    port, jax_ = events.EventReader(str(path)), jevents.EventReader(str(path))
    for append in [None, *appends]:
        if append is not None:
            with open(path, "a") as f:
                f.write(append)
        got = port.read(since=since, include_tail=include_tail)
        want = jax_.read(since=since, include_tail=include_tail)
        assert got == want
        assert (port.offset, port.torn_lines) == (jax_.offset, jax_.torn_lines)
    assert events.read_events(str(path), since=since) == \
        jevents.read_events(str(path), since=since)


def test_event_reader_resumes_from_an_offset_and_refuses_a_newer_schema(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    path.write_text(_line(1.0, "a") + "\n" + _line(2.0, "b") + "\n")
    first = events.EventReader(str(path))
    assert [e["type"] for e in first.read()] == ["a", "b"]
    later = events.EventReader(str(path), offset=len(_line(1.0, "a")) + 1)
    assert [e["type"] for e in later.read()] == ["b"]
    assert later.offset == first.offset
    newer = tmp_path / "newer.jsonl"
    newer.write_text(_line(0.0, "schema", version=99) + "\n")
    with pytest.raises(ValueError, match="schema 99"):
        events.read_events(str(newer))
    with pytest.raises(ValueError, match="schema 99"):
        jevents.read_events(str(newer))
    # The port's one-shot form reads a missing file as no events, as its
    # callers (the chaos harness, the smoke script) expect.
    assert events.read_events(str(tmp_path / "missing.jsonl")) == []

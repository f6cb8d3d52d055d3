"""The port's hard-episode miner (``episode_miner.py``) against the JAX
package's ``tools/episode_miner.py``, on the CPU: the per-(family, bucket)
stats, the per-seed stats and the selection equal on the same event
streams, the manifest's bytes equal, and the command lines agree (the
summary line, the manifest, exit 0, and exit 3 with no manifest when
nothing is mined); the manifest loads in both loaders. (Mirrors JAX
``tests/test_promotion.py:895-1000``.)"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.data.loader import (
    load_replay_manifest as jload_replay_manifest,
)
from howtotrainyourmamlpytorch_tpu_torch import episode_miner
from howtotrainyourmamlpytorch_tpu_torch.data.loader import load_replay_manifest
from tools import episode_miner as jminer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAND_WRITTEN = [
    {"type": "serve_dispatch", "tags": ["seed:5", "seed:6"],
     "margins": [0.05, 0.9], "entropies": [1.5, 0.1], "family": "maml",
     "bucket": "5x1x15", "episodes": 2},
    {"type": "serve_dispatch", "tags": ["seed:5", None],
     "margins": [0.2, 0.01], "entropies": [1.0, 2.0], "bucket": "5x1x15",
     "episodes": 2, "coarsened": 1},
    {"type": "serve_dispatch", "tags": ["untagged", "seed:x"],
     "margins": [0.0, 0.1], "entropies": [2.0, 1.0], "family": "anil",
     "bucket": "5x5x15", "episodes": 2},
    {"type": "serve_dispatch", "tags": ["seed:7"],
     "margins": [None], "entropies": [None], "family": "maml",
     "bucket": "5x1x15", "episodes": 1},
    {"type": "serve_dispatch", "tags": ["seed:8", "seed:9"], "margins": [0.3],
     "entropies": [], "family": "protonets", "bucket": "5x1x15", "episodes": 2},
    {"type": "step"},
]


def _random_stream(seed, n=60):
    """A stream of dispatches as the engine emits them: tagged and untagged
    episodes, repeated seeds, NaN answers, three families and buckets."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = int(rng.randint(1, 5))
        tags = [f"seed:{int(rng.randint(0, 20))}" if rng.rand() < 0.8 else None
                for _ in range(k)]
        margins = [None if rng.rand() < 0.05 else float(rng.rand()) for _ in range(k)]
        entropies = [float(rng.rand() * 1.6) for _ in range(k)]
        out.append({"type": "serve_dispatch", "tags": tags, "margins": margins,
                    "entropies": entropies,
                    "family": ["maml", "anil", "protonets"][int(rng.randint(0, 3))],
                    "bucket": ["5x1x15", "5x5x15"][int(rng.randint(0, 2))],
                    "episodes": k, "coarsened": int(rng.randint(0, 2))})
        if rng.rand() < 0.2:
            out.append({"type": "step", "iter": len(out)})
    return out


STREAMS = {"hand_written": HAND_WRITTEN,
           **{f"random_{s}": _random_stream(s) for s in range(4)}}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stats_and_selection_equal_jax(name):
    events = STREAMS[name]
    assert episode_miner.family_bucket_stats(events) == jminer.family_bucket_stats(events)
    stats = episode_miner.mine_events(events)
    assert stats == jminer.mine_events(events)
    for max_margin, top, min_count in ((0.5, 64, 1), (1.0, 5, 1), (0.3, 64, 2), (0.0, 3, 1)):
        assert episode_miner.select_hard_episodes(
            stats, max_margin=max_margin, top=top, min_count=min_count
        ) == jminer.select_hard_episodes(
            stats, max_margin=max_margin, top=top, min_count=min_count)


def test_hand_written_stream_mines_the_hardest_first(tmp_path):
    stats = episode_miner.mine_events(HAND_WRITTEN)
    assert set(stats) == {5, 6, 7, 8, 9}
    assert stats[5]["count"] == 2 and stats[5]["margin"] == 0.05
    assert stats[7]["margin"] == 0.0  # a non-finite answer is maximally hard
    hard = episode_miner.select_hard_episodes(stats, max_margin=0.5, top=10)
    assert [row["seed"] for row in hard] == [7, 9, 5, 8]
    out = tmp_path / "port.json"
    episode_miner.write_manifest(str(out), hard, source="test", learner="maml")
    jminer.write_manifest(str(tmp_path / "jax.json"), hard, source="test", learner="maml")
    assert out.read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert not (tmp_path / "port.json.tmp").exists()
    assert load_replay_manifest(str(out)) == jload_replay_manifest(str(out)) == (7, 9, 5, 8)


def _cli(module_argv, telemetry, out, *flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, *module_argv, "--telemetry", str(telemetry), "--out", str(out),
         *flags], capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    return proc


@pytest.mark.parametrize("flags, code", [
    (("--json",), 0),
    (("--max-margin", "1.0", "--top", "3", "--json"), 0),
    (("--min-count", "2", "--json"), 0),
    ((), 0),
    (("--max-margin", "-1", "--json"), 3),
])
def test_cli_round_trip_equals_jax(tmp_path, flags, code):
    telemetry = tmp_path / "telemetry.jsonl"
    telemetry.write_text("".join(json.dumps({"t": float(i), **e}) + "\n"
                                 for i, e in enumerate(_random_stream(7))))
    port = _cli(["-m", "howtotrainyourmamlpytorch_tpu_torch.episode_miner"], telemetry,
                tmp_path / "port.json", *flags)
    jax_ = _cli([os.path.join(REPO, "tools", "episode_miner.py")], telemetry,
                tmp_path / "jax.json", *flags)
    assert port.returncode == jax_.returncode == code, port.stderr + jax_.stderr
    if "--json" in flags:
        got, want = json.loads(port.stdout), json.loads(jax_.stdout)
        assert got.pop("out") == (str(tmp_path / "port.json") if code == 0 else None)
        want.pop("out")
        assert got == want
    else:
        assert port.stdout.replace("port.json", "jax.json") == jax_.stdout
    if code == 0:
        assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
        assert load_replay_manifest(str(tmp_path / "port.json"))
    else:
        assert not (tmp_path / "port.json").exists()

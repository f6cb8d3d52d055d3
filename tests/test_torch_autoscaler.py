"""The port's autoscaler (``serve/resilience/autoscaler.py``) against the
JAX package's, on the CPU.

* ``decide`` gives JAX's verdict, target and reason string, on a seeded
  grid of observations and policies; ``observe`` fuses the same health,
  metrics and heartbeat watermarks; ``replay_scale_journal`` folds the
  same rows into the same state. Exact equality throughout.
* The daemon journals, then acts: decided, applied, settled, with the
  target size (never a delta); a confirm streak rides out one-sample
  blips; a cooldown separates decisions; a kill at each journal boundary
  (aborted at the ``autoscaler_phase`` hook, a fresh daemon over the same
  journal, as ``tests/test_autoscaler.py`` stands in for a SIGKILL)
  resumes by issuing the same target once more and settles exactly once;
  a refused resize is ``aborted``. Each script runs against both daemons
  over their own stub fleets, and the journals' (phase, decision, target)
  rows must be equal.
"""

import json

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.serve.resilience import autoscaler as jasc
from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import autoscaler as asc


class StubScaleTarget:
    """A front door as the autoscaler sees one (``tests/test_autoscaler.py``):
    health, metrics, and an idempotent ``resize`` that records each call."""

    def __init__(self, size=1, queue=0.0, p99=10.0, degraded=False, text=None):
        self.size, self.queue, self.p99, self.degraded = size, queue, p99, degraded
        self.text = text
        self.resize_calls: list[int] = []
        self.refuse = None

    def healthz(self):
        return {"pool_size": self.size, "healthy_replicas": self.size,
                "degraded": self.degraded, "ready": self.size > 0}

    def metrics_text(self):
        if self.text is not None:
            return self.text
        return "\n".join([
            f"maml_serve_pool_degraded {1.0 if self.degraded else 0.0}",
            f'maml_serve_pool_request_latency_ms{{quantile="0.99"}} {self.p99}',
            f"maml_serve_queue_depth {self.queue}",
        ])

    def resize(self, n):
        if self.refuse is not None:
            raise self.refuse("fleet unreachable")
        self.resize_calls.append(int(n))
        self.size = int(n)
        return {"pool_size": self.size}


def observations(rng, n):
    return [dict(pool_size=int(rng.randint(0, 10)), healthy_replicas=int(rng.randint(0, 10)),
                 degraded=bool(rng.rand() < 0.3), queue_depth=float(rng.rand() * 60),
                 p99_ms=float(rng.choice([rng.rand() * 40, rng.rand() * 400, 900.0])),
                 memory_frac=[None, float(rng.rand())][rng.randint(2)])
            for _ in range(n)]


def policies(rng, n):
    out = [{}]
    for _ in range(n):
        lo = int(rng.randint(1, 4))
        out.append(dict(min_replicas=lo, max_replicas=lo + int(rng.randint(0, 6)),
                        up_queue_per_replica=float(rng.choice([1.0, 4.0])),
                        up_p99_ms=float(rng.choice([100.0, 250.0])),
                        down_queue_per_replica=float(rng.choice([0.1, 0.5])),
                        down_p99_ms=float(rng.choice([20.0, 50.0])),
                        step_up=int(rng.randint(1, 4)), step_down=int(rng.randint(1, 3)),
                        memory_veto_frac=float(rng.choice([0.5, 0.9]))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_decide_equals_jax_on_a_grid(seed):
    rng = np.random.RandomState(seed)
    decided = 0
    for policy in policies(rng, 8):
        mine, theirs = asc.AutoscalerPolicy(**policy), jasc.AutoscalerPolicy(**policy)
        for obs in observations(rng, 50):
            got = asc.decide(asc.Observation(**obs), mine)
            assert got == jasc.decide(jasc.Observation(**obs), theirs), (policy, obs)
            decided += got is not None
    assert decided > 20  # the grid reaches both verdicts, not only holds


@pytest.mark.parametrize("bad", [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                                 dict(step_up=0), dict(step_down=0)])
def test_policy_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as want:
        jasc.AutoscalerPolicy(**bad)
    with pytest.raises(ValueError) as got:
        asc.AutoscalerPolicy(**bad)
    assert str(got.value) == str(want.value)


HEARTBEATS = [
    None,
    "not json",
    {"memory": "none"},
    {"memory": [{"bytes_in_use": 5, "bytes_limit": 0}]},
    {"memory": [{"bytes_in_use": 5, "bytes_limit": 10},
                {"bytes_in_use": 9, "bytes_limit": 10}, "x"]},
]


@pytest.mark.parametrize("index", range(len(HEARTBEATS)))
def test_observe_equals_jax(index, tmp_path):
    """Health, metrics (the pool's p99, the engine's as the fallback, no
    queue as 0) and the heartbeat's largest memory share."""
    path = None
    if HEARTBEATS[index] is not None:
        path = tmp_path / "status.json"
        body = HEARTBEATS[index]
        path.write_text(body if isinstance(body, str) else json.dumps(body))
        path = str(path)
    texts = [None, 'maml_serve_request_latency_ms{quantile="0.99"} 77.0',
             'maml_serve_pool_request_latency_ms{quantile="0.99"} 50\nmaml_serve_pool_degraded 1']
    for text in texts:
        target = StubScaleTarget(size=3, queue=6.0, p99=123.0, text=text)
        got = asc.observe(target, path).__dict__
        want = jasc.observe(target, path).__dict__
        got.pop("t"), want.pop("t")
        assert got == want


def scale_rows(rng, n):
    ids = [f"scale-{i:04d}" for i in range(1, 4)] + [None]
    phases = ["decided", "applied", "settled", "aborted", "resumed"]
    rows = []
    for i in range(n):
        row = {"t": float(i), "phase": phases[rng.randint(len(phases))],
               "decision_id": ids[rng.randint(len(ids))]}
        for key in ("from_size", "to_size", "reason"):
            if rng.rand() < 0.5:
                row[key] = f"r{rng.randint(3)}" if key == "reason" else int(rng.randint(1, 5))
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(5))
def test_replay_scale_journal_equals_jax(seed):
    rows = scale_rows(np.random.RandomState(seed), 30)
    assert asc.replay_scale_journal(rows) == jasc.replay_scale_journal(rows)
    assert asc.replay_scale_journal(rows[:0]) == jasc.replay_scale_journal(rows[:0])


# ---------------------------------------------------------------------------
# The daemon, scripted against both packages
# ---------------------------------------------------------------------------


class _Killed(BaseException):
    """The stand-in for a SIGKILL at a journal boundary."""


class Fleet:
    """One package's daemon factory over its own stub fleet."""

    def __init__(self, module, root, monkeypatch):
        self.asc, self.root, self.monkeypatch = module, root, monkeypatch
        self.target = StubScaleTarget(size=1, p99=900.0)

    def daemon(self, **policy):
        defaults = dict(max_replicas=4, cooldown_s=0.0, confirm_samples=1,
                        settle_timeout_s=2.0)
        return self.asc.AutoscalerDaemon(
            self.target,
            self.asc.AutoscalerConfig(journal_path=str(self.root / "autoscale.jsonl"),
                                      poll_interval_s=0.01),
            self.asc.AutoscalerPolicy(**{**defaults, **policy}))

    def kill_at(self, phase):
        def hook(p):
            if p == phase:
                raise _Killed(f"phase {p}")

        self.monkeypatch.setattr(self.asc.faultinject, "autoscaler_phase", hook)

    def disarm(self):
        self.monkeypatch.setattr(self.asc.faultinject, "autoscaler_phase", lambda p: None)

    def killed(self, daemon):
        with pytest.raises(_Killed):
            daemon.run_once()

    def rows(self):
        from howtotrainyourmamlpytorch_tpu_torch.serve.resilience.promotion import (
            PromotionJournal,
        )

        return [(r["phase"], r.get("decision_id"), r.get("to_size"), r.get("resumed"))
                for r in PromotionJournal.load(str(self.root / "autoscale.jsonl"))]


def s_journal_then_act(f):
    row = f.daemon().run_once()
    assert row["phase"] == "settled" and row["healthy"] is True and f.target.size == 3
    assert [r[0] for r in f.rows()] == ["decided", "applied", "settled"]
    return [row["decision_id"]]


def s_confirm_streak(f):
    d = f.daemon(confirm_samples=2)
    out = [d.run_once()]
    f.target.p99 = 100.0  # the blip is over: the streak resets
    out.append(d.run_once())
    f.target.p99 = 900.0
    out.append(d.run_once())
    out.append(d.run_once()["phase"])
    assert out == [None, None, None, "settled"] and f.target.size == 3
    return out


def s_cooldown(f):
    d = f.daemon(cooldown_s=60.0)
    out = [d.run_once()["phase"], d.run_once()]
    assert out == ["settled", None] and f.target.size == 3
    return out


def make_kill(phase):
    def scenario(f):
        f.kill_at(phase)
        f.killed(f.daemon())
        before = list(f.target.resize_calls)
        f.disarm()
        d2 = f.daemon()
        row = d2.run_once()
        assert row["phase"] == "settled" and row["resumed"] is True and f.target.size == 3
        assert set(f.target.resize_calls) == {3}
        f.target.p99 = 100.0  # held between the thresholds: nothing more
        assert d2.run_once() is None
        return [before, f.target.resize_calls]
    return scenario


def s_double_crash(f):
    f.kill_at(asc.KILL_PRE_APPLY)
    f.killed(f.daemon())
    f.kill_at(asc.KILL_POST_APPLY)
    f.killed(f.daemon())
    f.disarm()
    row = f.daemon().run_once()
    rows = f.rows()
    assert row["phase"] == "settled"
    assert [r[0] for r in rows].count("settled") == 1
    assert [r[0] for r in rows].count("resumed") == 2
    return f.target.resize_calls


def s_fresh_ids(f):
    assert f.daemon().run_once()["decision_id"] == "scale-0001"
    f.target.p99 = 10.0  # idle: the next decision scales down
    row = f.daemon().run_once()
    assert row["decision_id"] == "scale-0002" and f.target.size == 2
    return [row["decision_id"]]


def s_refused(f):
    f.target.refuse = f.asc.PromotionTransportError
    row = f.daemon().run_once()
    assert row["phase"] == "aborted"
    return [row["error"]]


def s_memory_veto(f):
    status = f.root / "status.json"
    status.write_text(json.dumps({"memory": [{"bytes_in_use": 95, "bytes_limit": 100}]}))
    d = f.asc.AutoscalerDaemon(
        f.target, f.asc.AutoscalerConfig(journal_path=str(f.root / "autoscale.jsonl"),
                                         heartbeat_path=str(status)),
        f.asc.AutoscalerPolicy(confirm_samples=1, cooldown_s=0.0))
    out = [d.run_once(), f.target.size]
    status.write_text(json.dumps({"memory": [{"bytes_in_use": 5, "bytes_limit": 100}]}))
    out.append(d.run_once()["to_size"])
    assert out == [None, 1, 3]
    return out


SCENARIOS = {
    "journal_then_act": s_journal_then_act, "confirm_streak": s_confirm_streak,
    "cooldown": s_cooldown,
    **{f"kill_at_phase_{p}": make_kill(p) for p in (1, 2, 3)},
    "double_crash": s_double_crash, "fresh_ids_after_restart": s_fresh_ids,
    "refused_resize_aborts": s_refused, "memory_veto": s_memory_veto,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_daemon_scenarios_journal_as_jax(name, tmp_path, monkeypatch):
    results, rows = [], []
    for tag, module in (("jax", jasc), ("port", asc)):
        (tmp_path / tag).mkdir()
        fleet = Fleet(module, tmp_path / tag, monkeypatch)
        results.append(SCENARIOS[name](fleet))
        rows.append(fleet.rows())
    assert results[0] == results[1]
    assert rows[0] == rows[1] and rows[1]

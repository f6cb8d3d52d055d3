"""The port's promotion daemon (``serve/resilience/promotion.py``) against
the JAX package's, on the CPU.

* The pure parts equal JAX's exactly, on the same inputs made from a numpy
  seed: ``replay_journal``, ``parse_prometheus``, ``slo_counters``,
  ``SloWatch.verdict`` and ``extract_val_stat``.
* The two daemons, each over its own scripted stub fleet and a copy of the
  same candidate files, write the same journal: the sequence of (phase,
  digest, reason), times aside, in each scenario of
  ``tests/test_promotion.py`` (epoch order, dedupe, the validation gate, a
  corrupt candidate, transient fleet failures, a kill at each phase
  boundary, a double crash, a torn final line, staging GC and its mid-GC
  kill, the rollback to the last-known-good and a regression with none).
  A kill is the JAX tests' stand-in: the pipeline aborted at the
  ``daemon_phase`` boundary and a fresh daemon over the same journal.
* Markers and digests agree across the packages both ways; a checkpoint
  the JAX ``AsyncCheckpointWriter`` published is staged, verified and
  promoted by the port's daemon into a CPU ``LocalReplica`` pool, which
  then answers within the serve bar (rtol 1e-4, atol 1e-5) of the JAX
  ``ServingAPI`` on the same state.
* ``regress_after_promote`` fires at the publish of the pool's and the
  ``ServingAPI``'s promote: the next K answers are NaN, counted at the
  front door, the canaries before it untouched.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.serve.resilience import promotion as jpromo
from howtotrainyourmamlpytorch_tpu.utils import checkpoint as jckpt
from howtotrainyourmamlpytorch_tpu.utils import faultinject as jfi
from howtotrainyourmamlpytorch_tpu_torch.serve import PoolConfig, ReplicaPool
from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import LocalReplica
from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import promotion as promo
from howtotrainyourmamlpytorch_tpu_torch.utils import checkpoint, faultinject
from howtotrainyourmamlpytorch_tpu_torch.utils import locksan
from test_torch_serve_http import CLI_CONFIG
from test_torch_serve_pool import LEARNER, jax_reference, local_pool, make_api
from test_torch_serve_runtime import ATOL, RTOL, episode

#: The two packages: (promotion module, checkpoint module, faultinject).
JAX, PORT = (jpromo, jckpt, jfi), (promo, checkpoint, faultinject)
PHASES = ["start", "verified", "promoted", "slo_ok", "rejected", "rollback_start",
          "rolled_back", "deduped", "resumed", "retired"]


@pytest.fixture(autouse=True)
def _lock_sanitizer():
    """Every test of this suite runs under the port's lock sanitizer: no
    cycle in the observed acquisition order, and every lock created under
    ``howtotrainyourmamlpytorch_tpu_torch/serve`` held under 2.0 s."""
    with locksan.sanitized() as san:
        yield san


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.deactivate()
    jfi.deactivate()
    yield
    faultinject.deactivate()
    jfi.deactivate()


# ---------------------------------------------------------------------------
# The pure parts, exactly as JAX's
# ---------------------------------------------------------------------------


def random_rows(rng, n):
    """Journal rows over 4 digests with the fields the daemon writes, some
    absent or ``None``, and rows without a digest."""
    digests = [f"{i:064x}" for i in range(4)] + [None]
    rows = []
    for i in range(n):
        row = {"t": float(i), "phase": PHASES[rng.randint(len(PHASES))],
               "digest": digests[rng.randint(len(digests))]}
        for key in ("path", "staged", "epoch", "val_stat"):
            draw = rng.rand()
            if draw < 0.4:
                row[key] = f"{key}_{rng.randint(5)}" if key in ("path", "staged") else (
                    int(rng.randint(5)) if key == "epoch" else float(rng.rand()))
            elif draw < 0.5:
                row[key] = None
        rows.append(row)
    return rows


SCRIPTED_ROWS = [
    [],
    [{"t": 1.0, "phase": "start", "digest": "d1", "path": "p", "staged": "s", "epoch": 0},
     {"t": 2.0, "phase": "verified", "digest": "d1", "val_stat": 0.5},
     {"t": 3.0, "phase": "resumed", "digest": "d1", "from_phase": "verified"}],
    [{"t": 1.0, "phase": "start", "digest": "d1", "path": "p", "staged": "/stage/s1",
      "epoch": 0},
     {"t": 2.0, "phase": "verified", "digest": "d1", "val_stat": 0.5},
     {"t": 3.0, "phase": "promoted", "digest": "d1", "state_version": 1},
     {"t": 4.0, "phase": "slo_ok", "digest": "d1"},
     {"t": 5.0, "phase": "retired", "digest": "d1", "staged": "s1"},
     {"t": 6.0, "phase": "retired", "digest": None, "staged": "zz"},
     {"t": 7.0, "phase": "deduped", "digest": "d1", "path": "q"}],
]


@pytest.mark.parametrize("case", range(len(SCRIPTED_ROWS) + 6))
def test_replay_journal_equals_jax(case):
    rows = (SCRIPTED_ROWS[case] if case < len(SCRIPTED_ROWS)
            else random_rows(np.random.RandomState(case), 40))
    assert promo.replay_journal(rows) == jpromo.replay_journal(rows)


def test_journal_load_equals_jax_on_a_torn_final_line(tmp_path):
    path = tmp_path / "promotions.jsonl"
    path.write_text(
        json.dumps({"t": 1.0, "phase": "start", "digest": "d1", "path": "p",
                    "staged": "s", "epoch": 0}) + "\n\n[1, 2]\n"
        + json.dumps({"t": 1.5, "no_phase": 1}) + "\n"
        + '{"t": 2.0, "phase": "promo')
    rows = promo.PromotionJournal.load(str(path))
    assert rows == jpromo.PromotionJournal.load(str(path)) and len(rows) == 1
    assert promo.replay_journal(rows) == jpromo.replay_journal(rows)
    assert promo.PromotionJournal.load(str(tmp_path / "absent")) == []


def prometheus_texts():
    """A pool's and an engine's real ``/metrics`` and seeded random
    exposition lines (labels, comments, blanks, garbage)."""
    from howtotrainyourmamlpytorch_tpu_torch.serve.metrics import ServeMetrics

    pool = ReplicaPool(lambda i: None, PoolConfig(n_replicas=1, health_interval_s=60.0))
    try:
        pool_text = pool.metrics_text()
    finally:
        pool.close()
    metrics = ServeMetrics()
    metrics.request_latency.observe(12.5)
    texts = [pool_text, metrics.render_prometheus(queue_depth=3, compile_table={}), ""]
    rng = np.random.RandomState(3)
    names = ["maml_serve_pool_requests_total", "maml_serve_requests_total",
             "maml_serve_pool_request_errors_total", "maml_serve_nonfinite_logits_total",
             'maml_serve_pool_request_latency_ms{quantile="0.99"}',
             'maml_serve_request_latency_ms{quantile="0.99"}', "other_metric"]
    for _ in range(6):
        lines = []
        for _ in range(12):
            kind = rng.randint(5)
            if kind == 0:
                lines.append("# TYPE x counter")
            elif kind == 1:
                lines.append("  garbage line without value  ")
            elif kind == 2:
                lines.append("")
            else:
                value = rng.choice(["1", "2.5", "-3e2", "nan", "inf", "x"])
                lines.append(f"{names[rng.randint(len(names))]} {value}")
        texts.append("\n".join(lines))
    return texts


@pytest.mark.parametrize("index", range(9))
def test_parse_prometheus_and_slo_counters_equal_jax(index):
    text = prometheus_texts()[index]
    got, want = promo.parse_prometheus(text), jpromo.parse_prometheus(text)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert json.dumps(promo.slo_counters(got), sort_keys=True) == json.dumps(
        jpromo.slo_counters(want), sort_keys=True)


class TextTarget:
    """A front door whose ``/metrics`` is whatever ``text`` holds."""

    text = ""

    def metrics_text(self):
        if self.text is None:
            raise ConnectionError("scrape failed")
        return self.text


def counters_text(prefix, c):
    return (f"{prefix}_requests_total {c[0]}\n{prefix}_request_errors_total {c[1]}\n"
            f"{prefix}_nonfinite_logits_total {c[2]}\n"
            f'{prefix}_request_latency_ms{{quantile="0.99"}} {c[3]}\n')


@pytest.mark.parametrize("seed", range(4))
def test_slo_watch_verdict_equals_jax(seed):
    """Seeded configs and (baseline, later samples) pairs: the same verdict
    string, or ``None``, from both watches."""
    rng = np.random.RandomState(seed)
    for _ in range(60):
        cfg = dict(watch_dir=".", journal_path="j", staging_dir=".",
                   max_error_rate=float(rng.choice([0.0, 0.05, 0.5])),
                   max_new_nonfinite=int(rng.randint(3)),
                   min_requests=int(rng.choice([1, 5, 50])),
                   p99_budget_ms=float(rng.choice([10.0, 100.0, 30_000.0])))
        base = [float(rng.randint(100)), float(rng.randint(5)), float(rng.randint(3)),
                float(rng.rand() * 200)]
        later = [base[0] + rng.randint(60), base[1] + rng.randint(8),
                 base[2] + rng.randint(4), float(rng.rand() * 400)]
        prefix = ["maml_serve_pool", "maml_serve"][rng.randint(2)]
        verdicts = []
        for module in (promo, jpromo):
            target = TextTarget()
            watch = module.SloWatch(target, module.PromotionConfig(**cfg))
            assert watch.verdict(None) is None
            target.text = counters_text(prefix, base)
            baseline = watch.sample_now()
            target.text = None
            assert watch.sample_now() is None  # a failed scrape is skipped
            target.text = counters_text(prefix, later)
            watch.sample_now()
            verdicts.append((baseline, watch.verdict(baseline)))
        assert verdicts[0] == verdicts[1]


EXPERIMENT_STATES = [
    {},
    {"best_val_acc": 0.4},
    {"best_val_acc": "0.25"},
    {"best_val_acc": None},
    {"best_val_acc": float("nan")},
    {"per_epoch_statistics": {"val_accuracy_mean": [0.1, 0.3]}, "best_val_acc": 0.9},
    {"per_epoch_statistics": {"val_accuracy_mean": []}, "best_val_acc": 0.7},
    {"per_epoch_statistics": {"val_accuracy_mean": [float("inf")]}},
    {"per_epoch_statistics": {"val_loss_mean": [1.5]}, "best_val_acc": [1]},
    {"per_epoch_statistics": None, "best_val_acc": "x"},
]


@pytest.mark.parametrize("key", ["val_accuracy_mean", "val_loss_mean"])
def test_extract_val_stat_equals_jax(key):
    for state in EXPERIMENT_STATES:
        assert promo.extract_val_stat(state, key) == jpromo.extract_val_stat(state, key)


# ---------------------------------------------------------------------------
# Markers and digests across the packages
# ---------------------------------------------------------------------------


def test_markers_and_digests_agree_across_packages(tmp_path):
    """A marker the port published reads the same through the JAX reader,
    and the reverse; torn, digestless and newer-schema markers read as
    ``None`` in both."""
    port_path = str(tmp_path / "train_model_0")
    checkpoint.save_checkpoint(port_path, [("a", torch.arange(6.0))], {"current_iter": 1},
                               backoff_s=0.0)
    checkpoint.publish_done_marker(port_path, backoff_s=0.0)
    jax_path = str(tmp_path / "train_model_1")
    jckpt.save_checkpoint(jax_path, {"w": np.arange(6, dtype=np.float32)},
                          {"current_iter": 1})
    jckpt.publish_done_marker(jax_path, backoff_s=0.0)
    for path in (port_path, jax_path):
        got, want = checkpoint.read_done_marker(path), jckpt.read_done_marker(path)
        assert got == want and got["digest"] == checkpoint.checkpoint_digest(path) == \
            jckpt.checkpoint_digest(path)
    for body in ("{", "[]", '{"schema": 1}', '{"schema": 99, "digest": "x"}',
                 '{"schema": 1, "digest": ""}'):
        (tmp_path / "train_model_0.ready").write_text(body)
        assert checkpoint.read_done_marker(port_path) is None
        assert jckpt.read_done_marker(port_path) is None
    assert checkpoint.read_done_marker(str(tmp_path / "absent")) is None


# ---------------------------------------------------------------------------
# The two daemons' journals on scripted scenarios
# ---------------------------------------------------------------------------


class StubTarget:
    """``tests/test_promotion.py``'s stub fleet: promote, healthz and a
    ``/metrics`` whose counters move on each scrape."""

    def __init__(self):
        self.promoted: list[str] = []
        self.promoted_digests: list[str] = []
        self.digest = None
        self.fail_promotes = 0
        self.nonfinite_after_promotes: set[int] = set()
        self._nonfinite_delay = None
        self.metrics_down = False
        self.health_down = False
        self.counters = {"requests": 100.0, "errors": 0.0, "nonfinite": 0.0, "p99": 5.0}

    def promote(self, path):
        if self.fail_promotes > 0:
            self.fail_promotes -= 1
            raise ConnectionError("fleet transiently unreachable")
        self.promoted.append(path)
        self.digest = checkpoint.checkpoint_digest(path)
        self.promoted_digests.append(self.digest)
        if len(self.promoted) in self.nonfinite_after_promotes:
            self._nonfinite_delay = 1
        return {"state_version": len(self.promoted)}

    def healthz(self):
        if self.health_down:
            raise ConnectionError("down")
        return {"ready": True, "last_promoted_digest": self.digest}

    def metrics_text(self):
        if self.metrics_down:
            raise ConnectionError("front door saturated")
        c = self.counters
        if self._nonfinite_delay is not None:
            if self._nonfinite_delay <= 0:
                c["nonfinite"] += 3
                self._nonfinite_delay = None
            else:
                self._nonfinite_delay -= 1
        c["requests"] += 1
        return counters_text("maml_serve_pool", [c["requests"], c["errors"],
                                                 c["nonfinite"], c["p99"]])


class _Killed(BaseException):
    """The stand-in for a SIGKILL at a journal boundary."""


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """Candidate files, each written once (by the port) and copied into
    both daemons' watch directories, so that both see the same digests."""
    root = tmp_path_factory.mktemp("bank")
    made = {}

    def candidate(epoch, seed=None, val_acc=0.5, with_stats=True):
        key = (epoch, seed, val_acc, with_stats)
        if key not in made:
            state = {"current_iter": epoch * 2}
            if with_stats:
                state["per_epoch_statistics"] = {
                    "val_accuracy_mean": [val_acc - 0.01, val_acc][: epoch + 1] or [val_acc]}
                state["best_val_acc"] = val_acc
            rng = np.random.RandomState(epoch if seed is None else seed)
            path = str(root / f"c{len(made)}")
            checkpoint.save_checkpoint(
                path, [("w", torch.from_numpy(rng.rand(4, 3).astype(np.float32))),
                       ("b", torch.from_numpy(rng.rand(3).astype(np.float32)))],
                state, backoff_s=0.0)
            checkpoint.publish_done_marker(path, backoff_s=0.0)
            made[key] = path
        return made[key]

    return candidate


class World:
    """One package's daemon over its own stub fleet and watch directory."""

    def __init__(self, mods, root, bank, monkeypatch):
        self.promo, self.ckpt, self.fi = mods
        self.root, self.bank, self.monkeypatch = root, bank, monkeypatch
        self.watch = root / "saved_models"
        self.watch.mkdir(parents=True)
        self.target = StubTarget()
        self.journal_path = str(root / "logs" / "promotions.jsonl")

    def write(self, epoch, **kw):
        src = self.bank(epoch, **kw)
        dst = str(self.watch / f"train_model_{epoch}")
        shutil.copyfile(src, dst)
        shutil.copyfile(src + ".ready", dst + ".ready")
        return dst

    def daemon(self, **overrides):
        cfg = dict(watch_dir=str(self.watch), journal_path=self.journal_path,
                   staging_dir=str(self.root / "promotion_staging"), poll_interval_s=0.05,
                   slo_watch_s=0.1, slo_poll_s=0.02, promote_retries=3,
                   promote_backoff_s=0.01)
        cfg.update(overrides)
        return self.promo.PromotionDaemon(self.target, self.promo.PromotionConfig(**cfg))

    def kill_at(self, phase):
        def hook(p):
            if p == phase:
                raise _Killed(f"phase {p}")

        self.monkeypatch.setattr(self.promo.faultinject, "daemon_phase", hook)

    def disarm(self):
        self.monkeypatch.setattr(self.promo.faultinject, "daemon_phase", lambda p: None)

    def run_killed(self, daemon):
        with pytest.raises(_Killed):
            daemon.run_once()
        self.disarm()

    def rows(self):
        return [(r["phase"], r.get("digest"), r.get("reason"))
                for r in self.promo.PromotionJournal.load(self.journal_path)]


def s_epoch_order(w):
    w.write(1, val_acc=0.6)
    w.write(0, val_acc=0.5)
    w.daemon().run_once()


def s_dedupe(w):
    path0 = w.write(0)
    d = w.daemon()
    d.run_once()
    dup = str(w.watch / "train_model_7")
    shutil.copyfile(path0, dup)
    shutil.copyfile(path0 + ".ready", dup + ".ready")
    d.run_once()
    d.run_once()


def s_val_gate(w):
    w.write(0, with_stats=False)
    w.write(1, val_acc=0.7)
    w.write(2, val_acc=0.4)
    w.daemon(val_min_delta=0.0).run_once()


def s_corrupt(w):
    w.write(0)
    w.write(1, val_acc=0.6)
    w.fi.activate(w.fi.FaultPlan(corrupt_candidate_at=64))
    w.daemon().run_once()


def s_transient(w):
    w.write(0)
    w.target.fail_promotes = 2
    w.daemon().run_once()


def s_transient_exhausted(w):
    w.write(0)
    w.target.fail_promotes = 3
    d = w.daemon(promote_retries=2)
    with pytest.raises(w.promo.PromotionTransportError):
        d.run_once()
    d.run_once()  # the fleet is back: resumed from ``verified``


def make_kill(phase):
    def scenario(w):
        w.write(0)
        w.kill_at(phase)
        w.run_killed(w.daemon())
        d = w.daemon()
        d.run_once()
        d.run_once()
    return scenario


def s_double_crash(w):
    w.write(0)
    w.kill_at(3)
    w.run_killed(w.daemon())
    d2 = w.daemon()
    real = d2.journal.append

    def append_then_die(phase, **fields):
        row = real(phase, **fields)
        if phase == "resumed":
            raise _Killed("mid-resume")
        return row

    d2.journal.append = append_then_die
    with pytest.raises(_Killed):
        d2.run_once()
    w.daemon().run_once()


def s_torn_final_line(w):
    w.write(0)
    w.kill_at(1)
    w.run_killed(w.daemon())
    with open(w.journal_path, "a") as f:
        f.write('{"t": 2.0, "phase": "verif')
    w.daemon().run_once()


def s_unscrapeable(w):
    w.write(0)
    w.target.metrics_down = True
    d = w.daemon()
    d.run_once()
    w.target.metrics_down = False
    d.run_once()


def s_unreachable_resume(w):
    w.write(0)
    w.kill_at(3)
    w.run_killed(w.daemon())
    d = w.daemon()
    w.target.health_down = True
    d.run_once()
    w.target.health_down = False
    d.run_once()


def s_staging_gc(w):
    for epoch in range(5):
        w.write(epoch, val_acc=0.5 + 0.05 * epoch)
    w.daemon(retain_staged=1).run_once()
    w.daemon(retain_staged=1).run_once()


def s_mid_gc_kill(w):
    for epoch in range(4):
        w.write(epoch, val_acc=0.5 + 0.05 * epoch)
    w.kill_at(5)
    w.run_killed(w.daemon(retain_staged=0))
    w.daemon(retain_staged=0).run_once()


def s_rollback(w):
    good = w.write(0, val_acc=0.5)
    d = w.daemon()
    d.run_once()
    os.remove(good)
    os.remove(good + ".ready")
    w.write(1, val_acc=0.9, seed=11)
    w.target.nonfinite_after_promotes = {2}
    d.run_once()


def s_no_lkg(w):
    w.write(0)
    w.target.nonfinite_after_promotes = {1}
    w.daemon().run_once()


SCENARIOS = {
    "epoch_order": s_epoch_order, "dedupe": s_dedupe, "val_gate": s_val_gate,
    "corrupt_candidate": s_corrupt, "transient_failure": s_transient,
    "transient_exhausted": s_transient_exhausted,
    **{f"kill_at_phase_{p}": make_kill(p) for p in (1, 2, 3, 4)},
    "double_crash": s_double_crash, "torn_final_line": s_torn_final_line,
    "unscrapeable_window": s_unscrapeable, "unreachable_resume": s_unreachable_resume,
    "staging_gc": s_staging_gc, "mid_gc_kill": s_mid_gc_kill,
    "rollback_to_lkg": s_rollback, "regression_without_lkg": s_no_lkg,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_daemon_journals_equal_jax(name, tmp_path, bank, monkeypatch):
    """The same script against both daemons: the same (phase, digest,
    reason) rows and the same publishes, by digest, on each fleet."""
    worlds = {}
    for tag, mods in (("jax", JAX), ("port", PORT)):
        world = World(mods, tmp_path / tag, bank, monkeypatch)
        SCENARIOS[name](world)
        mods[2].deactivate()
        worlds[tag] = world
    jax_rows, port_rows = worlds["jax"].rows(), worlds["port"].rows()
    assert port_rows == jax_rows
    assert len(port_rows) >= 3
    assert (worlds["port"].target.promoted_digests
            == worlds["jax"].target.promoted_digests)


# ---------------------------------------------------------------------------
# A JAX-published checkpoint through the port's daemon into a CPU pool
# ---------------------------------------------------------------------------


def test_jax_published_checkpoint_promoted_by_the_port_daemon(tmp_path):
    from howtotrainyourmamlpytorch_tpu_torch import serve_maml
    from tools.serve_maml import build_learner as jbuild_learner

    config = tmp_path / "serve_cfg.json"
    config.write_text(json.dumps(CLI_CONFIG))
    os.environ.setdefault("DATASET_DIR", str(tmp_path))
    jlearner = jbuild_learner("maml", str(config))
    jstate = jlearner.init_state(jax.random.PRNGKey(13))
    watch = tmp_path / "saved_models"
    watch.mkdir()
    ckpt = str(watch / "train_model_0")
    writer = jckpt.AsyncCheckpointWriter()
    writer.submit(ckpt, jckpt.snapshot_for_save(jstate, {
        "current_iter": 2, "best_val_acc": 0.6,
        "per_epoch_statistics": {"val_accuracy_mean": [0.6]}}),
        alias_dst=str(watch / "train_model_latest"), publish_marker=True)
    writer.drain()
    writer.close()
    assert checkpoint.read_done_marker(ckpt) == jckpt.read_done_marker(ckpt)

    opts, flags = serve_maml.get_parser().parse_known_args([
        "--config", str(config), "--init_from_scratch", "--max_batch", "4",
        "--warmup", "5x1x15", "--use_pallas_fused_norm", "True"])

    def factory(index):
        return LocalReplica(serve_maml.build_api(opts, flags, "cpu")[0], f"local-{index}")

    pool = ReplicaPool(factory, PoolConfig(n_replicas=2, health_interval_s=0.02,
                                           min_uptime_s=0.0))
    raw = [episode(np.random.RandomState(60 + i), query=15) for i in range(4)]
    try:
        assert pool.wait_ready(timeout=120)
        daemon = promo.PromotionDaemon(pool, promo.PromotionConfig(
            watch_dir=str(watch), journal_path=str(tmp_path / "logs" / "promotions.jsonl"),
            staging_dir=str(tmp_path / "staging"), slo_watch_s=0.1, slo_poll_s=0.02))
        daemon.run_once()
        rows = promo.PromotionJournal.load(daemon.config.journal_path)
        assert [r["phase"] for r in rows] == ["start", "verified", "promoted", "slo_ok"]
        staged = rows[0]["staged"]
        assert not os.path.samefile(staged, ckpt)  # a real copy
        assert os.stat(staged).st_ino != os.stat(ckpt).st_ino
        digest = jckpt.checkpoint_digest(ckpt)
        assert rows[0]["digest"] == digest == pool.healthz()["last_promoted_digest"]
        assert rows[1]["val_stat"] == 0.6
        got = [pool.classify(*e)["logits"] for e in raw]
    finally:
        pool.close()
    for g, want in zip(got, jax_reference(jlearner, jstate, raw)):
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# regress_after_promote at the promote verbs
# ---------------------------------------------------------------------------


def promote_checkpoint_file(tmp_path):
    path = str(tmp_path / "train_model_3")
    LEARNER.save_model(path, LEARNER.init_state(torch.Generator().manual_seed(5), "cpu"),
                       {"current_iter": 0})
    return path


def test_regress_after_promote_turns_the_pools_next_answers_nan(tmp_path):
    """Armed, the pool's promote passes both canaries, then the next K
    answers are NaN and the front door counts them; the one after is
    finite. One-shot: a second promote arms nothing."""
    ckpt = promote_checkpoint_file(tmp_path)
    rng = np.random.RandomState(8)
    pool = local_pool(n=2)
    try:
        faultinject.activate(faultinject.FaultPlan(regress_after_promote=2))
        assert pool.promote(ckpt)["promoted_replicas"] == 2
        assert faultinject.events == ["regress-after-promote:2"]
        answers = [pool.classify(*episode(rng)) for _ in range(3)]
        assert [bool(np.isnan(a["logits"]).all()) for a in answers] == [True, True, False]
        assert pool.metrics.nonfinite_logits_total.value == 2
        pool.promote(ckpt)
        assert np.isfinite(pool.classify(*episode(rng))["logits"]).all()
        assert faultinject.current_plan().nan_next_logits == 0
    finally:
        pool.close()


def test_regress_after_promote_fires_at_the_serving_api_promote(tmp_path):
    ckpt = promote_checkpoint_file(tmp_path)
    rng = np.random.RandomState(9)
    api = make_api()
    try:
        api.warmup([(5, 1, 3)])
        faultinject.activate(faultinject.FaultPlan(regress_after_promote=1))
        assert api.promote(ckpt)["state_version"] == 1
        assert np.isnan(api.classify(*episode(rng))["logits"]).all()
        assert np.isfinite(api.classify(*episode(rng))["logits"]).all()
        assert api.metrics.nonfinite_logits_total.value == 1
    finally:
        api.close()


def test_daemon_threads_start_and_join(tmp_path):
    daemon = promo.PromotionDaemon(StubTarget(), promo.PromotionConfig(
        watch_dir=str(tmp_path / "w"), journal_path=str(tmp_path / "j.jsonl"),
        staging_dir=str(tmp_path / "s"), poll_interval_s=0.02, slo_poll_s=0.02))
    daemon.start()
    assert daemon._thread.is_alive() and daemon.slo._thread.is_alive()
    daemon.close()
    assert not daemon._thread.is_alive() and not daemon.slo._thread.is_alive()

"""The continuous train-to-serve promotion daemon
(``howtotrainyourmamlpytorch_tpu/serve/resilience/promotion.py``).

The trainer publishes an epoch checkpoint and then its ``.ready`` marker
(``utils/checkpoint.publish_done_marker``); the fleet has a safe promote
verb (verify, canary replica 0, roll to the rest: ``serve/pool.py``,
``serve/resilience/swap.py``). This daemon joins them, unattended, and so
is built around three contracts:

* **candidate gating** - an epoch checkpoint is a candidate only once its
  marker exists and names the file's digest. The candidate is then staged
  as a real copy into the daemon's retention directory (never a hardlink:
  no staged file shares an inode with the trainer's, and the trainer's
  pruning of old epochs cannot strand a rollback target), verified
  (``verify_checkpoint``, numpy only) and gated on the validation
  statistic the experiment recorded, before any replica is touched.
* **crash-safe idempotency** - every phase is journaled to an append-only,
  fsync'd JSONL before or after the action it brackets. SIGKILLed at any
  boundary and restarted, the daemon replays the journal and resumes
  exactly once: a candidate journaled ``verified`` but not ``promoted`` is
  checked against the digest the fleet serves (``/healthz``
  ``last_promoted_digest`` or ``checkpoint_digest``), and recorded as
  ``promoted`` with ``resumed`` set when the publish already landed.
  A digest with a terminal row is never driven again; a candidate that
  resurfaces under another name dedupes by digest.
* **automatic rollback** - after a publish the daemon watches windowed
  error rate, p99 and non-finite answers scraped from the front door's
  ``/metrics``, and re-promotes the retained last-known-good staged copy
  when live traffic regresses: the case a pre-publish canary cannot see
  (``regress_after_promote`` in ``utils/faultinject.py`` produces it).

The daemon owns two threads, the watcher and the SLO sampler, both joined
by ``close()``. It is plain Python over files and HTTP and imports no
torch: nothing here touches a tensor or the card. The command line is
``python3 -m howtotrainyourmamlpytorch_tpu_torch.promotion_daemon``; the
chaos loop is ``chaos_train --schedule promote``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque

from ...telemetry import events as telemetry_events
from ...utils import faultinject
from ...utils.checkpoint import (
    CheckpointError,
    checkpoint_digest,
    read_done_marker,
    verify_checkpoint,
)
from ..errors import NoHealthyReplicaError, ReplicaDeadError, SwapRejectedError

#: Journal phases (one JSONL row each). Terminal phases end a digest's
#: lifecycle; the others resume after a crash.
PHASE_START = "start"
PHASE_VERIFIED = "verified"
PHASE_PROMOTED = "promoted"
PHASE_SLO_OK = "slo_ok"
PHASE_REJECTED = "rejected"
PHASE_ROLLBACK_START = "rollback_start"
PHASE_ROLLED_BACK = "rolled_back"
PHASE_DEDUPED = "deduped"
PHASE_RESUMED = "resumed"
#: Audit row of the staging GC: the named staged copy is (about to be)
#: removed. Journaled before the removal; replay treats it as audit only.
PHASE_RETIRED = "retired"

TERMINAL_PHASES = (PHASE_REJECTED, PHASE_SLO_OK, PHASE_ROLLED_BACK)

#: ``daemon_kill_at_phase`` boundaries (``utils/faultinject.py``).
KILL_PRE_VERIFY = 1  # ``start`` journaled, candidate not verified
KILL_PRE_PUBLISH = 2  # ``verified`` journaled, fleet untouched
KILL_POST_PUBLISH = 3  # fleet promoted, ``promoted`` row not written
KILL_PRE_RESOLVE = 4  # ``promoted`` journaled, SLO watch unresolved
KILL_MID_GC = 5  # ``retired`` journaled, staged copy not yet removed


class PromotionTransportError(Exception):
    """The fleet could not be reached or answered abnormally: transient by
    assumption, so the daemon retries with backoff and leaves the
    candidate in flight (resumable), never rejected."""


@dataclasses.dataclass(frozen=True)
class PromotionConfig:
    """The daemon's knobs (the command line: ``promotion_daemon``)."""

    #: The trainer's ``saved_models`` directory.
    watch_dir: str
    #: The append-only journal (``logs/promotions.jsonl``).
    journal_path: str
    #: Where staged copies are kept (rollback targets outlive the
    #: trainer's ``max_models_to_save`` pruning).
    staging_dir: str
    poll_interval_s: float = 2.0
    #: The experiment statistic the validation gate reads (the last value
    #: of its series, else ``best_val_acc``).
    val_stat_key: str = "val_accuracy_mean"
    #: Reject a candidate with no finite recorded statistic.
    require_val_stat: bool = True
    #: When set, a candidate must beat the last-known-good's statistic by
    #: this much (may be negative); ``None`` gates on presence only.
    val_min_delta: float | None = None
    #: Retries of a publish that failed in transport.
    promote_retries: int = 3
    promote_backoff_s: float = 0.5
    #: The post-publish SLO watch: window, sample cadence, thresholds over
    #: the window's ``/metrics`` deltas.
    slo_watch_s: float = 10.0
    slo_poll_s: float = 0.5
    p99_budget_ms: float = 30_000.0
    max_error_rate: float = 0.05
    max_new_nonfinite: int = 0
    #: Answered requests a window needs before error rate and p99 decide.
    min_requests: int = 1
    #: Staged copies kept besides the last-known-good and the in-flight
    #: one: the N newest; older ones are removed with ``retired`` rows.
    retain_staged: int = 2


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------


class PromotionJournal:
    """Append-only fsync'd JSONL. Each ``append`` is one flushed line;
    ``load`` skips a torn final line (a SIGKILL mid-append loses at most
    the row being written, which resume re-derives from the fleet)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def append(self, phase: str, **fields) -> dict:
        row = {"t": time.time(), "phase": str(phase), **fields}
        line = json.dumps(row)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        return row

    @staticmethod
    def load(path: str) -> list[dict]:
        rows: list[dict] = []
        try:
            with open(path) as f:
                raw = f.read()
        except OSError:
            return rows
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # torn final line of a killed writer
            if isinstance(row, dict) and row.get("phase"):
                rows.append(row)
        return rows


def replay_journal(rows: list[dict]) -> dict:
    """Journal rows folded into resume state: per-digest info (path,
    staged, epoch, val_stat), each digest's last phase, the terminal set,
    the last-known-good (newest ``slo_ok``) and the in-flight candidate
    (the newest digest whose last phase is not terminal)."""
    info: dict[str, dict] = {}
    last_phase: dict[str, str] = {}
    lkg: dict | None = None
    seen_pairs: set[tuple[str, str]] = set()
    order: list[str] = []
    for row in rows:
        digest = row.get("digest")
        if not digest:
            continue
        if row["phase"] == PHASE_RETIRED:
            # Audit only: the digest keeps its verdict, and the row's
            # ``staged`` is a basename that must not replace the full path.
            continue
        entry = info.setdefault(digest, {"digest": digest})
        for key in ("path", "staged", "epoch", "val_stat"):
            if row.get(key) is not None:
                entry[key] = row[key]
        phase = row["phase"]
        if phase == PHASE_DEDUPED:
            seen_pairs.add((digest, str(row.get("path"))))
            continue
        if digest not in order:
            order.append(digest)
        if phase == PHASE_RESUMED:
            # Audit only: as a last phase it would make a crash after a
            # resume replay the candidate from scratch.
            continue
        last_phase[digest] = phase
        if phase == PHASE_SLO_OK:
            lkg = dict(entry)
    terminal = {d for d, p in last_phase.items() if p in TERMINAL_PHASES}
    inflight = None
    for digest in reversed(order):
        if digest not in terminal:
            inflight = dict(info[digest])
            inflight["last_phase"] = last_phase[digest]
            break
    return {
        "info": info,
        "last_phase": last_phase,
        "terminal": terminal,
        "lkg": lkg,
        "inflight": inflight,
        "seen_pairs": seen_pairs,
    }


# ---------------------------------------------------------------------------
# The fleet's front door
# ---------------------------------------------------------------------------


class HttpTarget:
    """The daemon's client of a front door: POST ``/admin/promote``, GET
    ``/healthz`` (a 503 body is health data) and GET ``/metrics``.
    Transport failures become :class:`PromotionTransportError`. An
    in-process ``ReplicaPool`` or ``ServingAPI`` serves as a target
    directly."""

    def __init__(self, base_url: str, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _fetch(self, path: str, payload: dict | None = None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            headers={"Content-Type": "application/json"} if data else {},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def promote(self, checkpoint_path: str) -> dict:
        try:
            return json.loads(
                self._fetch("/admin/promote", {"checkpoint": checkpoint_path})
            )
        except urllib.error.HTTPError as exc:
            body = {}
            try:
                body = json.load(exc)
            except Exception:  # noqa: BLE001 - the body is best-effort detail
                pass
            if exc.code == 409:
                raise SwapRejectedError(
                    body.get("error", str(exc)),
                    reason=body.get("reason", "canary"),
                ) from None
            raise PromotionTransportError(
                f"promote answered {exc.code}: {body.get('error', exc)}"
            ) from None
        except (urllib.error.URLError, ConnectionError, OSError, TimeoutError) as exc:
            raise PromotionTransportError(f"promote failed: {exc}") from exc

    def healthz(self) -> dict:
        try:
            return json.loads(self._fetch("/healthz"))
        except urllib.error.HTTPError as exc:
            try:
                return json.load(exc)  # a 503 carries the health body
            except Exception:  # noqa: BLE001
                raise PromotionTransportError(
                    f"healthz answered {exc.code}"
                ) from None
        except (urllib.error.URLError, ConnectionError, OSError, TimeoutError) as exc:
            raise PromotionTransportError(f"healthz failed: {exc}") from exc

    def metrics_text(self) -> str:
        try:
            return self._fetch("/metrics").decode()
        except (urllib.error.URLError, ConnectionError, OSError, TimeoutError) as exc:
            raise PromotionTransportError(f"metrics failed: {exc}") from exc


def parse_prometheus(text: str) -> dict[str, float]:
    """Exposition text as ``{name_with_labels: value}`` (comments and
    unparsable lines skipped)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name.strip()] = float(value)
        except ValueError:
            continue
    return out


#: The metrics the SLO watch reads, under the pool's prefix first (a pool
#: front door renders only pool metrics), then the single engine's.
_SLO_PREFIXES = ("maml_serve_pool", "maml_serve")
_SLO_SUFFIXES = {
    "requests": "_requests_total",
    "errors": "_request_errors_total",
    "nonfinite": "_nonfinite_logits_total",
    "p99_ms": '_request_latency_ms{quantile="0.99"}',
}


def slo_counters(metrics: dict[str, float]) -> dict[str, float] | None:
    for prefix in _SLO_PREFIXES:
        if prefix + "_requests_total" in metrics:
            return {
                key: float(metrics.get(prefix + suffix, 0.0))
                for key, suffix in _SLO_SUFFIXES.items()
            }
    return None


# ---------------------------------------------------------------------------
# SLO watch
# ---------------------------------------------------------------------------


class SloWatch:
    """A ``/metrics`` sampler with post-publish verdicts over a window.

    A background thread keeps samples in a bounded deque; after a publish
    the daemon takes a baseline and asks for a verdict over the deltas
    since. A failed scrape is skipped (a missed sample never decides a
    rollback). Error rate and p99 decide only once ``min_requests`` were
    answered in the window; new non-finite answers beyond
    ``max_new_nonfinite`` decide at once."""

    def __init__(self, target, config: PromotionConfig):
        self.target = target
        self.config = config
        self._samples: deque[tuple[float, dict]] = deque(maxlen=4096)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="promotion-slo-sampler", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sample_now()
            self._stop.wait(self.config.slo_poll_s)

    def sample_now(self) -> dict | None:
        """One scrape: the counters (also kept in the window), or ``None``
        when it failed."""
        try:
            counters = slo_counters(parse_prometheus(self.target.metrics_text()))
        except Exception:  # noqa: BLE001 - a failed scrape is a skipped sample
            counters = None
        if counters is not None:
            self._samples.append((time.monotonic(), counters))
        return counters

    def verdict(self, baseline: dict | None) -> str | None:
        """The regression since ``baseline`` (a ``sample_now`` result), or
        ``None`` while the window looks healthy."""
        if baseline is None or not self._samples:
            return None
        _, now = self._samples[-1]
        d_requests = now["requests"] - baseline["requests"]
        d_errors = now["errors"] - baseline["errors"]
        d_nonfinite = now["nonfinite"] - baseline["nonfinite"]
        if d_nonfinite > self.config.max_new_nonfinite:
            return (
                f"nonfinite logits on live traffic: +{int(d_nonfinite)} "
                f"(max {self.config.max_new_nonfinite})"
            )
        if d_requests >= self.config.min_requests:
            error_rate = d_errors / d_requests
            if error_rate > self.config.max_error_rate:
                return (
                    f"error rate {error_rate:.3f} over {int(d_requests)} "
                    f"requests (max {self.config.max_error_rate})"
                )
            # The scrape's p99 is the fleet's recent ring, not a pure
            # post-publish window: over budget AND grown since the baseline,
            # so a spike from before the publish condemns nothing.
            if (
                now["p99_ms"] > self.config.p99_budget_ms
                and now["p99_ms"] > 1.2 * baseline["p99_ms"]
            ):
                return (
                    f"p99 {now['p99_ms']:.0f} ms over budget "
                    f"{self.config.p99_budget_ms:.0f} ms (baseline "
                    f"{baseline['p99_ms']:.0f} ms)"
                )
        return None


# ---------------------------------------------------------------------------
# Daemon
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Candidate:
    epoch: int
    path: str
    digest: str


class PromotionDaemon:
    """Scan, stage, verify and gate, promote (with retries), journal, watch
    the SLOs, resolve (``slo_ok`` or a rollback). One watcher thread and
    the SLO sampler; see the module docstring for the three contracts."""

    def __init__(self, target, config: PromotionConfig):
        self.target = target
        self.config = config
        self.journal = PromotionJournal(config.journal_path)
        self.slo = SloWatch(target, config)
        os.makedirs(config.staging_dir, exist_ok=True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        state = replay_journal(PromotionJournal.load(config.journal_path))
        self._info: dict[str, dict] = state["info"]
        self._terminal: set[str] = set(state["terminal"])
        self._seen_pairs: set[tuple[str, str]] = set(state["seen_pairs"])
        self._lkg: dict | None = state["lkg"]
        self._inflight: dict | None = state["inflight"]
        #: Publishes this daemon resolved (``slo_ok`` or a rollback): the
        #: ``--max_promotions`` exit condition.
        self.resolved_promotions = 0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self.slo.start()
        self._thread = threading.Thread(
            target=self._run, name="promotion-watcher", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=30.0)
        self.slo.close()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as exc:  # noqa: BLE001 - the loop must survive
                detail = f"{type(exc).__name__}: {exc}"[:300]
                telemetry_events.emit("promotion_error", error=detail)
                print(
                    f"promotion daemon: pass failed ({detail}); retrying "
                    f"in {self.config.poll_interval_s}s",
                    file=sys.stderr,
                )
            self._flush_telemetry()
            self._stop.wait(self.config.poll_interval_s)

    @staticmethod
    def _flush_telemetry() -> None:
        sink = telemetry_events.active()
        if sink is not None:
            sink.flush()

    # -- scan -----------------------------------------------------------

    def scan_candidates(self) -> list[Candidate]:
        """Published, not yet terminal epoch candidates in epoch order. A
        checkpoint is visible only once its marker exists and names its
        digest; a terminal digest at a new path is journaled ``deduped``
        once and skipped."""
        try:
            names = os.listdir(self.config.watch_dir)
        except OSError:
            return []
        epochs = []
        for name in names:
            suffix = name[len("train_model_"):]
            if name.startswith("train_model_") and suffix.isdigit():
                epochs.append(int(suffix))
        out: list[Candidate] = []
        for epoch in sorted(epochs):
            path = os.path.join(self.config.watch_dir, f"train_model_{epoch}")
            marker = read_done_marker(path)
            if marker is None:
                continue  # not published yet (or torn): wait
            digest = str(marker["digest"])
            if digest in self._terminal or (
                self._inflight and self._inflight.get("digest") == digest
            ):
                pair = (digest, path)
                if digest in self._terminal and pair not in self._seen_pairs:
                    known = self._info.get(digest, {})
                    if known.get("path") != path:
                        self._seen_pairs.add(pair)
                        self.journal.append(
                            PHASE_DEDUPED, digest=digest, path=path
                        )
                continue
            if digest in self._info and self._info[digest].get("resolved"):
                continue
            out.append(Candidate(epoch=epoch, path=path, digest=digest))
        return out

    # -- one pass -------------------------------------------------------

    def run_once(self) -> None:
        """One watcher pass: resume a journaled in-flight candidate, then
        take the new ones in epoch order."""
        if self._inflight is not None:
            self._resume_inflight()
        for cand in self.scan_candidates():
            if self._stop.is_set():
                return
            self._process(cand)

    # -- the candidate pipeline ----------------------------------------

    def _note_phase(self, phase: str, **fields) -> None:
        """Keeps the in-memory in-flight record in step with the journal,
        so a transient failure retried in this process resumes from the
        right phase (a restart rebuilds it by replay)."""
        if self._inflight is not None:
            self._inflight["last_phase"] = phase
            self._inflight.update(
                {k: v for k, v in fields.items() if v is not None}
            )

    def _staged_path(self, cand: Candidate) -> str:
        return os.path.join(
            self.config.staging_dir,
            f"{cand.digest[:16]}_{os.path.basename(cand.path)}",
        )

    def _stage(self, cand: Candidate) -> str:
        staged = self._staged_path(cand)
        if not os.path.exists(staged):
            _copy_atomic(cand.path, staged)
        return staged

    def _verify(self, cand: Candidate, staged: str):
        """Integrity and the validation gate on the staged copy:
        ``(val_stat, None)`` on acceptance, ``(None, (reason, detail))``
        on rejection."""
        faultinject.candidate_checkpoint_loading(staged)
        try:
            if checkpoint_digest(staged) != cand.digest:
                return None, (
                    "digest_mismatch",
                    "staged bytes disagree with the publish marker digest",
                )
            summary = verify_checkpoint(staged)
        except CheckpointError as exc:
            return None, ("corrupt", str(exc))
        val_stat = extract_val_stat(
            summary.get("experiment_state") or {}, self.config.val_stat_key
        )
        if val_stat is None and self.config.require_val_stat:
            return None, (
                "val_gate",
                f"no finite {self.config.val_stat_key!r} recorded in the "
                "candidate's experiment state",
            )
        if (
            self.config.val_min_delta is not None
            and val_stat is not None
            and self._lkg is not None
            and self._lkg.get("val_stat") is not None
            and val_stat < float(self._lkg["val_stat"]) + self.config.val_min_delta
        ):
            return None, (
                "val_gate",
                f"{self.config.val_stat_key}={val_stat:.4f} does not beat "
                f"last-known-good {float(self._lkg['val_stat']):.4f} "
                f"by {self.config.val_min_delta}",
            )
        return val_stat, None

    def _reject(self, digest: str, path: str, reason: str, detail: str) -> None:
        self._terminal.add(digest)
        self._inflight = None
        self.journal.append(
            PHASE_REJECTED, digest=digest, path=path,
            reason=reason, detail=detail[:300],
        )
        telemetry_events.emit(
            "promotion_rejected", digest=digest[:16], source=path,
            reason=reason, detail=detail[:300],
        )

    def _drive_promote(self, staged: str) -> int | None:
        """``target.promote`` with retries and backoff on transport errors;
        the fleet's new state version. ``SwapRejectedError`` propagates (a
        terminal rejection); spent retries raise
        :class:`PromotionTransportError` (the candidate stays in flight)."""
        last: Exception | None = None
        for attempt in range(max(int(self.config.promote_retries), 1)):
            if attempt:
                if self._stop.wait(
                    self.config.promote_backoff_s * (2 ** (attempt - 1))
                ):
                    break
            try:
                result = self.target.promote(staged)
                return (result or {}).get("state_version")
            except SwapRejectedError:
                raise
            except (
                PromotionTransportError, ReplicaDeadError,
                NoHealthyReplicaError, ConnectionError, TimeoutError, OSError,
            ) as exc:
                last = exc
        raise PromotionTransportError(
            f"fleet unreachable after {self.config.promote_retries} "
            f"attempt(s): {last}"
        )

    def _process(self, cand: Candidate) -> None:
        staged = self._stage(cand)
        info = {
            "digest": cand.digest, "path": cand.path,
            "staged": staged, "epoch": cand.epoch,
        }
        self._info[cand.digest] = dict(info)
        self._inflight = dict(info, last_phase=PHASE_START)
        self.journal.append(PHASE_START, **info)
        faultinject.daemon_phase(KILL_PRE_VERIFY)
        val_stat, rejection = self._verify(cand, staged)
        if rejection is not None:
            self._reject(cand.digest, cand.path, *rejection)
            return
        self._info[cand.digest]["val_stat"] = val_stat
        self.journal.append(
            PHASE_VERIFIED, digest=cand.digest, val_stat=val_stat
        )
        self._note_phase(PHASE_VERIFIED, val_stat=val_stat)
        faultinject.daemon_phase(KILL_PRE_PUBLISH)
        self._publish_and_resolve(cand.digest, staged, val_stat)

    def _publish_and_resolve(
        self, digest: str, staged: str, val_stat, resumed: bool = False
    ) -> None:
        try:
            version = self._drive_promote(staged)
        except SwapRejectedError as exc:
            self._reject(digest, staged, exc.reason, str(exc))
            return
        faultinject.daemon_phase(KILL_POST_PUBLISH)
        self.journal.append(
            PHASE_PROMOTED, digest=digest, state_version=version,
            resumed=resumed,
        )
        self._note_phase(PHASE_PROMOTED)
        telemetry_events.emit(
            "promotion_promoted", digest=digest[:16], source=staged,
            state_version=version, resumed=resumed,
        )
        faultinject.daemon_phase(KILL_PRE_RESOLVE)
        self._watch_and_resolve(digest, staged, val_stat)

    # -- SLO watch and rollback ----------------------------------------

    def _watch_and_resolve(self, digest: str, staged: str, val_stat) -> None:
        baseline = self.slo.sample_now()
        deadline = time.monotonic() + self.config.slo_watch_s
        reason: str | None = None
        while time.monotonic() < deadline and not self._stop.is_set():
            self._stop.wait(self.config.slo_poll_s)
            if baseline is None:
                # The post-publish baseline scrape failed: keep trying; a
                # missing baseline never blesses the window.
                baseline = self.slo.sample_now()
                continue
            # Sample here too: the watch must not depend on the background
            # sampler (``run_once`` and ``--once`` drive it directly).
            self.slo.sample_now()
            reason = self.slo.verdict(baseline)
            if reason is not None:
                break
        if baseline is None:
            # The whole window was unscrapeable: the candidate stays
            # ``promoted`` (in flight) and the next pass judges a window.
            return
        if reason is None:
            if self._stop.is_set():
                # Shutdown cut the watch short: the next run judges a full
                # window instead of blessing a partial one.
                return
            self.slo.sample_now()
            reason = self.slo.verdict(baseline)
        if reason is None:
            self._terminal.add(digest)
            self._inflight = None
            self._info[digest]["resolved"] = True
            self.journal.append(PHASE_SLO_OK, digest=digest)
            self._lkg = {
                "digest": digest, "staged": staged, "val_stat": val_stat,
            }
            self.resolved_promotions += 1
            self._gc_staging()
            return
        telemetry_events.emit(
            "slo_regression", digest=digest[:16], reason=reason
        )
        rollback_to = self._lkg if (
            self._lkg and self._lkg.get("digest") != digest
        ) else None
        self.journal.append(
            PHASE_ROLLBACK_START, digest=digest, reason=reason,
            to=(rollback_to or {}).get("digest"),
        )
        self._note_phase(PHASE_ROLLBACK_START)
        self._finish_rollback(digest, rollback_to, reason)

    def _finish_rollback(self, digest: str, rollback_to, reason: str) -> None:
        """Drives the rollback promote and resolves the condemned digest.
        With no other last-known-good (a first promotion regressed) there is
        nothing to roll back to: the row records ``no_lkg`` and a loud
        ``slo_rollback_unavailable`` event fires; the fleet still serves
        the condemned state and no rollback is claimed."""
        if rollback_to is not None:
            self._drive_promote(rollback_to["staged"])
        self._terminal.add(digest)
        self._inflight = None
        self._info.setdefault(digest, {})["resolved"] = True
        self.journal.append(
            PHASE_ROLLED_BACK, digest=digest,
            to=(rollback_to or {}).get("digest"),
            no_lkg=rollback_to is None,
        )
        if rollback_to is None:
            telemetry_events.emit(
                "slo_rollback_unavailable", digest=digest[:16], reason=reason
            )
            print(
                f"promotion daemon: digest {digest[:16]} regressed but no "
                "last-known-good is retained: the fleet still serves the "
                "condemned state; an operator must intervene",
                file=sys.stderr,
            )
        else:
            telemetry_events.emit(
                "slo_rollback", digest=digest[:16],
                to=(rollback_to.get("digest") or "")[:16] or None,
                reason=reason,
            )
        self.resolved_promotions += 1
        self._gc_staging()

    def _gc_staging(self) -> None:
        """Bounded staging: the last-known-good and any in-flight copy are
        kept, and the ``retain_staged`` newest others; each older copy is
        journaled ``retired`` first, then removed. A SIGKILL between the
        two (``KILL_MID_GC``) leaves a retired copy that the next pass
        retires again; replay never changes a verdict for it."""
        keep = set()
        if self._lkg:
            keep.add(os.path.basename(str(self._lkg.get("staged"))))
        if self._inflight:
            keep.add(os.path.basename(str(self._inflight.get("staged"))))
        try:
            names = os.listdir(self.config.staging_dir)
        except OSError:
            return
        staged_digest = {
            os.path.basename(str(entry.get("staged"))): digest
            for digest, entry in self._info.items()
            if entry.get("staged")
        }
        aged: list[tuple[float, str]] = []
        for name in names:
            if name in keep:
                continue
            try:
                mtime = os.path.getmtime(
                    os.path.join(self.config.staging_dir, name)
                )
            except OSError:
                continue  # another remover got there first
            aged.append((mtime, name))
        aged.sort(reverse=True)  # newest first; the head is retained
        for _mtime, name in aged[max(0, self.config.retain_staged):]:
            self.journal.append(
                PHASE_RETIRED,
                digest=staged_digest.get(name),
                staged=name,
            )
            faultinject.daemon_phase(KILL_MID_GC)
            try:
                os.remove(os.path.join(self.config.staging_dir, name))
            except OSError:
                pass

    # -- crash resume ---------------------------------------------------

    def _fleet_digest(self) -> str | None:
        """The digest the fleet serves: ``None`` when it is unreachable
        (decide nothing on it), ``""`` when nothing was promoted yet."""
        try:
            health = self.target.healthz()
        except Exception:  # noqa: BLE001 - unreachable: decide later
            return None
        return (
            health.get("last_promoted_digest")
            or health.get("checkpoint_digest")
            or ""
        )

    def _resume_inflight(self) -> None:
        """Exactly once at every kill boundary: ``start`` re-verifies the
        staged copy; ``verified`` asks the fleet whether the publish landed
        and records it as resumed or drives it now; ``promoted`` judges a
        fresh SLO window; ``rollback_start`` finishes the rollback."""
        inflight = self._inflight
        if inflight is None:
            return
        digest = inflight["digest"]
        phase = inflight.get("last_phase", PHASE_START)
        staged = inflight.get("staged") or self._staged_path(
            Candidate(
                epoch=int(inflight.get("epoch", 0)),
                path=str(inflight.get("path")), digest=digest,
            )
        )
        if not os.path.exists(staged):
            source = str(inflight.get("path") or "")
            if source and os.path.exists(source):
                _copy_atomic(source, staged)
            else:
                self._reject(
                    digest, source, "staged_lost",
                    "daemon restarted with neither the staged copy nor the "
                    "source checkpoint on disk",
                )
                return
        self.journal.append(PHASE_RESUMED, digest=digest, from_phase=phase)
        telemetry_events.emit(
            "promotion_resumed", digest=digest[:16], from_phase=phase
        )
        val_stat = inflight.get("val_stat")
        if phase == PHASE_START:
            cand = Candidate(
                epoch=int(inflight.get("epoch", 0)),
                path=str(inflight.get("path")), digest=digest,
            )
            val_stat, rejection = self._verify(cand, staged)
            if rejection is not None:
                self._reject(digest, cand.path, *rejection)
                return
            self._info.setdefault(cand.digest, {})["val_stat"] = val_stat
            self.journal.append(
                PHASE_VERIFIED, digest=digest, val_stat=val_stat
            )
            self._publish_and_resolve(digest, staged, val_stat)
        elif phase == PHASE_VERIFIED:
            fleet = self._fleet_digest()
            if fleet is None:
                # Unreachable: whether the publish landed is unknown, and a
                # blind decision risks a double drive. Ask again next pass.
                return
            if fleet == digest:
                # Published before the crash: record it, never drive twice.
                self.journal.append(
                    PHASE_PROMOTED, digest=digest, state_version=None,
                    resumed=True,
                )
                telemetry_events.emit(
                    "promotion_promoted", digest=digest[:16], source=staged,
                    state_version=None, resumed=True,
                )
                self._watch_and_resolve(digest, staged, val_stat)
            else:
                self._publish_and_resolve(
                    digest, staged, val_stat, resumed=True
                )
        elif phase == PHASE_PROMOTED:
            self._watch_and_resolve(digest, staged, val_stat)
        elif phase == PHASE_ROLLBACK_START:
            # The regression is journaled: never re-watch (a one-shot
            # regression may have passed and a new window could bless the
            # condemned digest); finish the rollback.
            rollback_to = self._lkg if (
                self._lkg and self._lkg.get("digest") != digest
            ) else None
            self._finish_rollback(digest, rollback_to, "resumed")
        else:  # a phase this build does not know: left to the operator
            self._inflight = None


def _copy_atomic(src: str, dst: str) -> None:
    """Stages by a real copy (temp file, rename), never a hardlink: the
    staged file shares no inode with the trainer's, so a corruption on the
    daemon's side (``corrupt_candidate_at``) or its retention never
    reaches the training run's checkpoints."""
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def extract_val_stat(experiment_state: dict, key: str) -> float | None:
    """The candidate's recorded validation statistic: the last entry of
    ``per_epoch_statistics[key]``, else ``best_val_acc``; ``None`` when
    absent or not finite."""
    stats = experiment_state.get("per_epoch_statistics") or {}
    values = stats.get(key) or []
    value = values[-1] if values else experiment_state.get("best_val_acc")
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if math.isfinite(value) else None

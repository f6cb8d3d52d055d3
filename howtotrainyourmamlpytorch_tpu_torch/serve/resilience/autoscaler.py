"""The journal-backed fleet autoscaler: a replica count that follows load
(``howtotrainyourmamlpytorch_tpu/serve/resilience/autoscaler.py``).

A sibling of the promotion daemon (``promotion.py``), built from its parts
(the fsync'd :class:`~.promotion.PromotionJournal`, ``parse_prometheus``,
the HTTP client) because the problem has the same shape: an unattended
daemon that changes a live fleet must survive a SIGKILL at any instant
without driving the change twice. Three contracts:

* **declared policy, pure decision** - the policy is data
  (:class:`AutoscalerPolicy`) and the decision a pure function
  (:func:`decide`) of one :class:`Observation` (queue depth, p99, the
  ``degraded`` gauge and the healthy count from ``/healthz`` and
  ``/metrics``, device-memory watermarks from a heartbeat
  ``status.json``): the same observation always gives the same verdict.
* **journal, then act; resume by target** - a decision is journaled
  (``decided``: its id, from and to size, the reason) before the fleet is
  touched, applied through ``ReplicaPool.resize`` (or POST
  ``/admin/scale``), journaled ``applied``, and ``settled`` once the fleet
  reports that many healthy replicas. The journaled fact is the target
  size, and ``resize`` is idempotent on it, so a daemon killed between the
  row and the resize (or between the resize and the ``applied`` row)
  resumes by issuing the same target again: no replica spawned twice.
  ``resumed`` rows are audit only.
* **bounded and vetoed** - the size stays in ``[min_replicas,
  max_replicas]``, decisions are a cooldown apart, and a scale-up is vetoed
  while the heartbeat's device memory is past ``memory_veto_frac`` of its
  limit (growing a fleet that is out of memory trades latency for an OOM).

A new replica warms its buckets before its first health probe passes, so
a scale-up is ``settled`` only once the new replicas answer warmed.

Kill points (``utils/faultinject.autoscaler_phase``): ``KILL_PRE_APPLY``
1, ``KILL_POST_APPLY`` 2, ``KILL_PRE_SETTLE`` 3. Plain Python over HTTP,
no torch: nothing here touches a tensor or the card. The command line is
``python3 -m howtotrainyourmamlpytorch_tpu_torch.autoscaler_daemon``; the
chaos loop is ``chaos_train --schedule autoscale``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque

from ...telemetry import events as telemetry_events
from ...utils import faultinject
from .promotion import (
    HttpTarget,
    PromotionJournal,
    PromotionTransportError,
    parse_prometheus,
)

#: Journal phases. ``settled`` and ``aborted`` end a decision;
#: ``resumed`` is an audit row.
PHASE_DECIDED = "decided"
PHASE_APPLIED = "applied"
PHASE_SETTLED = "settled"
PHASE_ABORTED = "aborted"
PHASE_RESUMED = "resumed"

TERMINAL_PHASES = (PHASE_SETTLED, PHASE_ABORTED)

#: ``autoscaler_kill_at_phase`` boundaries.
KILL_PRE_APPLY = 1  # ``decided`` journaled, resize not issued
KILL_POST_APPLY = 2  # resize issued, ``applied`` not written
KILL_PRE_SETTLE = 3  # ``applied`` journaled, settle unconfirmed


@dataclasses.dataclass(frozen=True)
class AutoscalerPolicy:
    """The declared scaling policy."""

    min_replicas: int = 1
    max_replicas: int = 8
    #: Scale up when the queue per healthy replica exceeds this, or the
    #: front door's p99 exceeds the budget.
    up_queue_per_replica: float = 4.0
    up_p99_ms: float = 250.0
    #: Scale down only when both are well below (hysteresis: the fleet
    #: does not flap on a steady load).
    down_queue_per_replica: float = 0.5
    down_p99_ms: float = 50.0
    #: Grow fast, shrink slowly.
    step_up: int = 2
    step_down: int = 1
    #: Seconds between decisions.
    cooldown_s: float = 5.0
    #: How long a decision waits for the fleet to report healthy at the
    #: target size before it is journaled ``settled`` with
    #: ``healthy=false`` (the next observation decides again).
    settle_timeout_s: float = 30.0
    #: Scale-up veto: heartbeat device memory beyond this share of its
    #: limit.
    memory_veto_frac: float = 0.9
    #: Observations in a row a threshold must hold before acting.
    confirm_samples: int = 2

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}"
            )
        if self.step_up < 1 or self.step_down < 1:
            raise ValueError("scale steps must be >= 1")


@dataclasses.dataclass(frozen=True)
class Observation:
    """One sample of the fleet's load."""

    pool_size: int
    healthy_replicas: int
    degraded: bool
    queue_depth: float
    p99_ms: float
    memory_frac: float | None = None  # max bytes_in_use / bytes_limit
    t: float = 0.0


def observe(target, heartbeat_path: str | None = None) -> Observation:
    """``/healthz`` and ``/metrics`` (and a heartbeat ``status.json`` when
    named) as one :class:`Observation`. Transport failures propagate as
    ``PromotionTransportError``."""
    health = target.healthz()
    metrics = parse_prometheus(target.metrics_text())
    # The queue is the single engine's metric; a pool front door does not
    # render it, and absent means 0, which errs towards scaling down.
    queue_depth = metrics.get("maml_serve_queue_depth", 0.0)
    p99 = metrics.get(
        'maml_serve_pool_request_latency_ms{quantile="0.99"}',
        metrics.get('maml_serve_request_latency_ms{quantile="0.99"}', 0.0),
    )
    degraded = bool(
        metrics.get("maml_serve_pool_degraded", 0.0)
        or health.get("degraded", False)
    )
    memory_frac = _heartbeat_memory_frac(heartbeat_path)
    return Observation(
        pool_size=int(health.get("pool_size", 0) or 0),
        healthy_replicas=int(health.get("healthy_replicas", 0) or 0),
        degraded=degraded,
        queue_depth=float(queue_depth),
        p99_ms=float(p99),
        memory_frac=memory_frac,
        t=time.time(),
    )


def _heartbeat_memory_frac(path: str | None) -> float | None:
    """The largest ``bytes_in_use / bytes_limit`` over the heartbeat's
    ``memory`` watermarks (``telemetry/device.sample_memory_stats``);
    ``None`` when the file, the key or the limits are absent (an unknown
    watermark never vetoes)."""
    if not path:
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    watermarks = payload.get("memory")
    if not isinstance(watermarks, list):
        return None
    fracs = [
        w["bytes_in_use"] / w["bytes_limit"]
        for w in watermarks
        if isinstance(w, dict) and w.get("bytes_limit")
    ]
    return max(fracs) if fracs else None


def decide(
    obs: Observation, policy: AutoscalerPolicy
) -> tuple[int, str] | None:
    """The pure policy: ``(target_size, reason)``, or ``None`` to hold.
    Cooldown, confirmation and the journal are the caller's."""
    size = max(obs.pool_size, 1)
    per_replica = obs.queue_depth / max(obs.healthy_replicas, 1)
    if (
        per_replica > policy.up_queue_per_replica
        or obs.p99_ms > policy.up_p99_ms
    ):
        if obs.memory_frac is not None and (
            obs.memory_frac >= policy.memory_veto_frac
        ):
            return None
        target = min(size + policy.step_up, policy.max_replicas)
        if target > size:
            why = (
                f"queue/replica {per_replica:.2f} > "
                f"{policy.up_queue_per_replica:g}"
                if per_replica > policy.up_queue_per_replica
                else f"p99 {obs.p99_ms:.1f}ms > {policy.up_p99_ms:g}ms"
            )
            return target, f"scale_up: {why}"
    if (
        per_replica < policy.down_queue_per_replica
        and obs.p99_ms < policy.down_p99_ms
        and not obs.degraded
    ):
        target = max(size - policy.step_down, policy.min_replicas)
        if target < size:
            return target, (
                f"scale_down: idle (queue/replica {per_replica:.2f}, "
                f"p99 {obs.p99_ms:.1f}ms)"
            )
    return None


def replay_scale_journal(rows: list[dict]) -> dict:
    """Journal rows folded into resume state: each decision's info and last
    phase, the terminal set, and the in-flight decision (the newest whose
    last phase is not terminal). ``resumed`` rows are audit only."""
    info: dict[str, dict] = {}
    last_phase: dict[str, str] = {}
    order: list[str] = []
    for row in rows:
        did = row.get("decision_id")
        if not did:
            continue
        if row["phase"] == PHASE_RESUMED:
            continue
        entry = info.setdefault(did, {"decision_id": did})
        for key in ("from_size", "to_size", "reason"):
            if row.get(key) is not None:
                entry[key] = row[key]
        if did not in order:
            order.append(did)
        last_phase[did] = row["phase"]
    terminal = {d for d, p in last_phase.items() if p in TERMINAL_PHASES}
    inflight = None
    for did in reversed(order):
        if did not in terminal:
            inflight = dict(info[did])
            inflight["last_phase"] = last_phase[did]
            break
    return {
        "info": info,
        "last_phase": last_phase,
        "terminal": terminal,
        "inflight": inflight,
    }


class HttpScaleTarget(HttpTarget):
    """The front-door client with the scale verb, POST ``/admin/scale``. An
    in-process ``ReplicaPool`` serves as a target directly."""

    def resize(self, n: int) -> dict:
        try:
            return json.loads(
                self._fetch("/admin/scale", {"pool_size": int(n)})
            )
        except PromotionTransportError:
            raise
        except Exception as exc:  # noqa: BLE001 - one transport error class
            raise PromotionTransportError(f"scale failed: {exc}") from exc


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """The daemon's wiring (the policy is :class:`AutoscalerPolicy`)."""

    journal_path: str
    poll_interval_s: float = 1.0
    heartbeat_path: str | None = None


class AutoscalerDaemon:
    """One thread's observe, decide, journal, apply, settle loop over one
    target. It owns no thread: ``run`` is the loop and the caller owns the
    process; ``run_once`` is the unit the tests and the chaos loop drive."""

    def __init__(
        self,
        target,
        config: AutoscalerConfig,
        policy: AutoscalerPolicy | None = None,
    ):
        self.target = target
        self.config = config
        self.policy = policy or AutoscalerPolicy()
        self.journal = PromotionJournal(config.journal_path)
        self._decisions = 0
        self._last_decision_t = 0.0
        self._streak: deque[int] = deque(
            maxlen=max(1, self.policy.confirm_samples)
        )
        self._resume_pending = True

    # -- resume -------------------------------------------------------

    def _resume_inflight(self) -> dict | None:
        """Replays the journal and drives the newest unfinished decision by
        issuing its target size again (idempotent), then settles it.
        Returns the ``settled`` row, or ``None``."""
        state = replay_scale_journal(PromotionJournal.load(self.journal.path))
        # New decision ids must not collide with journaled ones.
        self._decisions = len(state["info"])
        inflight = state["inflight"]
        if inflight is None:
            return None
        to_size = int(inflight["to_size"])
        try:
            health = self.target.healthz()
            observed = int(health.get("pool_size", 0) or 0)
        except PromotionTransportError:
            return None  # unreachable: try again on the next pass
        self.journal.append(
            PHASE_RESUMED,
            decision_id=inflight["decision_id"],
            from_phase=inflight["last_phase"],
            observed_pool_size=observed,
        )
        return self._apply_and_settle(
            inflight["decision_id"], to_size, resumed=True,
            already_applied=inflight["last_phase"] == PHASE_APPLIED,
        )

    # -- the loop's unit ------------------------------------------------

    def run_once(self) -> dict | None:
        """One observation, at most one journaled decision. Returns the
        terminal row of a decision it drove (new or resumed), else None."""
        if self._resume_pending:
            self._resume_pending = False
            resumed = self._resume_inflight()
            if resumed is not None:
                self._last_decision_t = time.monotonic()
                return resumed
        try:
            obs = observe(self.target, self.config.heartbeat_path)
        except PromotionTransportError:
            return None
        verdict = decide(obs, self.policy)
        if verdict is None:
            self._streak.clear()
            return None
        target_size, reason = verdict
        self._streak.append(target_size)
        if (
            len(self._streak) < self.policy.confirm_samples
            or len(set(self._streak)) != 1
        ):
            return None  # not confirmed yet
        if (
            time.monotonic() - self._last_decision_t
            < self.policy.cooldown_s
        ):
            return None
        self._streak.clear()
        self._decisions += 1
        decision_id = f"scale-{self._decisions:04d}"
        self.journal.append(
            PHASE_DECIDED,
            decision_id=decision_id,
            from_size=obs.pool_size,
            to_size=target_size,
            reason=reason,
            queue_depth=obs.queue_depth,
            p99_ms=obs.p99_ms,
        )
        telemetry_events.emit(
            "autoscale_decided",
            decision_id=decision_id,
            from_size=obs.pool_size,
            to_size=target_size,
            reason=reason,
        )
        self._last_decision_t = time.monotonic()
        return self._apply_and_settle(decision_id, target_size)

    def _apply_and_settle(
        self,
        decision_id: str,
        to_size: int,
        *,
        resumed: bool = False,
        already_applied: bool = False,
    ) -> dict:
        """decided, applied, settled, with a kill point at each boundary.
        ``already_applied`` skips only the ``applied`` row: the resize is
        always issued again (idempotent), since a journaled ``applied``
        does not prove the pool still holds that size."""
        faultinject.autoscaler_phase(KILL_PRE_APPLY)
        try:
            self.target.resize(to_size)
        except (PromotionTransportError, RuntimeError, ValueError) as exc:
            row = self.journal.append(
                PHASE_ABORTED,
                decision_id=decision_id,
                to_size=to_size,
                error=str(exc),
                resumed=resumed,
            )
            telemetry_events.emit(
                "autoscale_aborted", decision_id=decision_id, error=str(exc)
            )
            return row
        faultinject.autoscaler_phase(KILL_POST_APPLY)
        if not already_applied:
            self.journal.append(
                PHASE_APPLIED,
                decision_id=decision_id,
                to_size=to_size,
                resumed=resumed,
            )
        faultinject.autoscaler_phase(KILL_PRE_SETTLE)
        healthy = self._await_settle(to_size)
        row = self.journal.append(
            PHASE_SETTLED,
            decision_id=decision_id,
            to_size=to_size,
            healthy=healthy,
            resumed=resumed,
        )
        telemetry_events.emit(
            "autoscale_settled",
            decision_id=decision_id,
            to_size=to_size,
            healthy=healthy,
            resumed=resumed,
        )
        return row

    def _await_settle(self, to_size: int) -> bool:
        """Polls ``/healthz`` until ``healthy_replicas >= to_size`` (a
        replica's probe passes only once it answers warmed) or the settle
        budget runs out."""
        deadline = time.monotonic() + self.policy.settle_timeout_s
        while time.monotonic() < deadline:
            try:
                health = self.target.healthz()
            except PromotionTransportError:
                time.sleep(self.config.poll_interval_s)
                continue
            if int(health.get("healthy_replicas", 0) or 0) >= to_size:
                return True
            time.sleep(min(0.1, self.config.poll_interval_s))
        return False

    def run(self, stop) -> None:
        """``run_once`` every ``poll_interval_s`` until ``stop`` (a
        ``threading.Event``) is set."""
        while not stop.is_set():
            self.run_once()
            stop.wait(self.config.poll_interval_s)

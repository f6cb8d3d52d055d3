"""Replica pool: N serving engines behind one front door, supervised
(``howtotrainyourmamlpytorch_tpu/serve/pool.py``).

One serving process is one point of failure: a crash strands every queued
request. The pool runs ``n_replicas`` workers (``serve/resilience/
replica.py``: worker processes in production, in-process replicas in the
tests), each with its own engine and so its own kernels, and has three
jobs:

* **dispatch with re-dispatch** - requests go round-robin (or by digest on
  a consistent-hash ring) over healthy replicas; a ``ReplicaDeadError``
  (crashed process, dropped connection, wedged worker) retires that
  replica and sends the request to another, up to
  ``max_dispatch_retries`` times. Serving is a pure function of (state,
  episode), so the caller gets one answer and no failed request.
* **supervision** - a thread probes every replica's ``/healthz`` each
  ``health_interval_s`` with a timeout, so a wedged replica that still
  holds its port is found, not just a dead one. ``unhealthy_after``
  failures in a row retire it; a retired slot restarts with exponential
  backoff, and a slot that keeps dying young trips the circuit breaker
  (``circuit_breaker_after``) and is parked. A starting replica is probed
  as STARTING until its warmup answers: it is not retired for booting.
* **the front door** - the pool has ``ServingAPI``'s surface (classify,
  healthz, stats, metrics_text, promote, close, and ``resize``), so
  ``serve/api.make_http_server`` serves it unchanged, and ``/healthz``
  sums the replicas with an honest ``degraded`` flag.

Promotion is canary-first: the checkpoint is verified once at the front
door (``utils/checkpoint.verify_checkpoint``: a corrupt file costs no
replica), replica 0 canaries it (``serve/resilience/swap.py``), and only
then does it roll to the rest. With no healthy replica the pool raises
``NoHealthyReplicaError`` (a 503); it never falls back to another engine.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

from ..telemetry import events as telemetry_events
from ..utils import faultinject
from ..utils.checkpoint import (
    CheckpointError,
    checkpoint_digest,
    verify_checkpoint,
)
from .errors import (
    NoHealthyReplicaError,
    ReplicaDeadError,
    SwapRejectedError,
)
from .cache import routing_digest
from .metrics import Counter, LatencyStat
from .resilience.replica import Replica
from .tier import HashRing

#: Slot lifecycle: STARTING -(ready healthz)-> HEALTHY -(strikes/death)->
#: RETIRED -(backoff)-> STARTING ... -(crash loop)-> CIRCUIT_OPEN.
STARTING = "starting"
HEALTHY = "healthy"
RETIRED = "retired"
CIRCUIT_OPEN = "circuit_open"


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Supervision and re-dispatch knobs (the command line: ``serve_maml``)."""

    n_replicas: int = 2
    #: Supervisor cadence and per-probe budget. A wedged replica is detected
    #: within ``unhealthy_after * health_interval_s + health_timeout_s``.
    health_interval_s: float = 0.25
    health_timeout_s: float = 2.0
    unhealthy_after: int = 2
    #: Restart backoff: ``restart_backoff_s * 2**consecutive_failures``,
    #: capped. A replica must stay healthy ``min_uptime_s`` to reset the
    #: failure streak (instant-death restarts must not reset the clock).
    restart_backoff_s: float = 0.2
    restart_backoff_max_s: float = 30.0
    min_uptime_s: float = 5.0
    #: Consecutive young deaths that park the slot (crash-loop breaker).
    circuit_breaker_after: int = 5
    #: Re-dispatch budget after a replica dies mid-request.
    max_dispatch_retries: int = 2
    #: Per-attempt replica call budget (bounds how long a silently-wedged
    #: replica can hold a caller before the retry fires). A worker's first
    #: cache-miss dispatch on a card takes seconds; keep this above it.
    dispatch_timeout_s: float = 30.0
    #: Route episodes to replicas by consistent hash of the support-set
    #: routing digest (serve/tier/ring.py) instead of round-robin, so
    #: each replica's hot set (RAM LRU + disk spill) is DISJOINT and the
    #: fleet's aggregate cache capacity scales with replica count. Ring
    #: membership follows health: a retired replica's arc moves to its
    #: successor; re-dispatch after a mid-request death re-routes there.
    route_by_digest: bool = False
    #: Fleet durable-tier root: replica ``i``'s tier lives at
    #: ``<tier_root>/replica-<i>`` (the factory wires each replica's
    #: ``ServeConfig.tier_dir`` to match). When set, a retirement also
    #: asks the ring successor to rehydrate the dead replica's spill
    #: directory — the inherited arc arrives with its history.
    tier_root: str | None = None
    #: Virtual nodes per replica on the routing ring.
    ring_vnodes: int = 64

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n_replicas}")
        if self.unhealthy_after < 1:
            raise ValueError(
                f"unhealthy_after must be >= 1, got {self.unhealthy_after}"
            )


class _Slot:
    """One supervised replica position."""

    __slots__ = (
        "index", "replica", "state", "strikes", "consecutive_failures",
        "restarts", "next_restart_at", "healthy_since", "start_began",
        "last_ready_s",
    )

    def __init__(self, index: int):
        self.index = index
        self.replica: Replica | None = None
        self.state = RETIRED
        self.strikes = 0
        self.consecutive_failures = 0
        self.restarts = 0
        self.next_restart_at = 0.0
        self.healthy_since: float | None = None
        #: When the current start attempt began (monotonic) — the birth
        #: timestamp the ready-time measurement is taken against.
        self.start_began: float | None = None
        #: Last observed start→healthy latency (the ``serve_replica_ready_s``
        #: bench key: warm durable tier makes this collapse).
        self.last_ready_s: float | None = None

    def describe(self) -> dict:
        return {
            "index": self.index,
            "id": self.replica.replica_id if self.replica else None,
            "state": self.state,
            "strikes": self.strikes,
            "restarts": self.restarts,
            "consecutive_failures": self.consecutive_failures,
        }


class PoolMetrics:
    """Pool-level counters (replica engines keep their own
    ``ServeMetrics``; these count what only the pool can see)."""

    PREFIX = "maml_serve_pool"

    def __init__(self):
        self.requests_total = Counter("requests_total")
        self.request_errors = Counter("request_errors")
        self.retry_total = Counter("retry_total")
        self.shed_total = Counter("shed_total")
        self.replica_deaths_total = Counter("replica_deaths_total")
        self.replica_restarts_total = Counter("replica_restarts_total")
        self.circuit_open_total = Counter("circuit_open_total")
        # Answered requests whose logits carried any non-finite value —
        # counted at the front door (works for subprocess replicas too,
        # whose engine-level counters the pool cannot scrape), so the
        # promotion daemon's post-publish SLO watch sees live numeric
        # regressions on ONE /metrics surface.
        self.nonfinite_logits_total = Counter("nonfinite_logits_total")
        # Dead-replica spill directories adopted by a ring successor.
        self.rehydrations_total = Counter("rehydrations_total")
        self.request_latency = LatencyStat("request")


class ReplicaPool:
    """Supervised replica fleet with a ``ServingAPI``-shaped front door."""

    #: The HTTP front door checks this: the kill and wedge faults belong
    #: to the replicas, never to the pool's front door (serve/api.py).
    is_replica_pool = True

    def __init__(self, factory, config: PoolConfig | None = None):
        """``factory(slot_index) -> Replica`` builds (and starts) one
        replica; it is called from the supervisor thread on every restart,
        so it must be safe to call repeatedly."""
        self.factory = factory
        self.config = config or PoolConfig()
        self.metrics = PoolMetrics()
        self.started_at = time.time()
        self._lock = threading.Condition()
        self._slots = [_Slot(i) for i in range(self.config.n_replicas)]
        self._rr = 0  # round-robin cursor
        self._graveyard: list[Replica] = []  # terminated by the supervisor
        self._closed = False
        #: Provenance of the last fleet-wide promotion (content digest +
        #: source path) — /healthz surfaces it so a crashed promotion
        #: daemon can resume idempotently (was my in-flight candidate
        #: already published?).
        self._last_promoted: dict | None = None
        # Digest-affine routing (serve/tier/ring.py): membership follows
        # health, mutated and consulted only under the pool lock. The
        # rehydration queue carries (dead_index, successor_index) pairs
        # out of _retire_locked; the supervisor drains it OUTSIDE the
        # lock — a disk-bound rehydrate must not park the dispatchers.
        self._ring = HashRing(self.config.ring_vnodes)
        self._rehydrate_q: list[tuple[int, int]] = []
        self._last_ready_s: float | None = None
        for slot in self._slots:
            self._try_start(slot)
        self._supervisor = threading.Thread(
            target=self._supervise, name="replica-pool-supervisor", daemon=True
        )
        self._supervisor.start()

    # ------------------------------------------------------------------
    # Dispatch (front door)
    # ------------------------------------------------------------------

    def _pick(
        self, routing_key: str | None = None
    ) -> tuple[_Slot, Replica] | None:
        """Healthy (slot, replica) pair for a request; ``None`` when the
        fleet is out. With a routing key and a populated ring, the owner
        of the key's arc is chosen (digest-affine: the same support set
        always lands on the replica holding its cached artifact);
        otherwise round-robin. The replica is captured under the lock so
        a concurrent retirement can never hand the caller a ``None``."""
        with self._lock:
            if routing_key is not None and len(self._ring):
                owner = self._ring.route(routing_key)
                if owner is not None:
                    slot = self._slots[owner]
                    if slot.state == HEALTHY and slot.replica is not None:
                        return slot, slot.replica
                    # Health flipped between ring update and here — fall
                    # through to round-robin over whoever is left.
            healthy = [
                s for s in self._slots
                if s.state == HEALTHY and s.replica is not None
            ]
            if not healthy:
                return None
            slot = healthy[self._rr % len(healthy)]
            self._rr += 1
            return slot, slot.replica

    def classify(
        self, x_support, y_support, x_query, *,
        timeout: float | None = 30.0, tag: str | None = None,
    ) -> dict:
        """Dispatches one episode to a healthy replica, re-dispatching on
        replica death (bounded by ``max_dispatch_retries``). Raises
        ``NoHealthyReplicaError`` (a 503) when the fleet cannot answer;
        replica-level sheds (``OverloadedError``) and validation errors
        propagate unchanged — retrying them elsewhere would amplify
        overload / re-reject the same episode."""
        self.metrics.requests_total.inc()
        t0 = time.perf_counter()
        budget = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        attempts = self.config.max_dispatch_retries + 1
        last_death: ReplicaDeadError | None = None
        routing_key = None
        if self.config.route_by_digest:
            # Version/learner-independent support hash, computed ONCE at
            # the front door. Re-dispatch after a death re-routes with
            # the same key — the ring has already moved the arc to the
            # successor, which (tier_root set) rehydrates the dead
            # replica's spill. Geometry-coarsening replicas stay
            # ring-consistent for free: the raw support bytes hash here,
            # and every replica coarsens them onto the same lattice entry
            # (serve/geometry.py orders the lattice deterministically),
            # so one episode always lands in one coarsened bucket on one
            # replica.
            try:
                routing_key = routing_digest(
                    np.asarray(x_support), np.asarray(y_support)
                )
            except Exception:
                routing_key = None  # malformed input fails in prepare, not here
        try:
            for attempt in range(attempts):
                picked = self._pick(routing_key)
                if picked is None:
                    raise NoHealthyReplicaError(
                        "no healthy replica available "
                        f"({self._state_counts()})"
                    )
                slot, replica = picked
                per_attempt = self.config.dispatch_timeout_s
                if budget is not None:
                    remaining = budget - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "pool dispatch exceeded the caller deadline"
                        )
                    per_attempt = min(per_attempt, remaining)
                try:
                    result = replica.classify(
                        x_support, y_support, x_query, timeout=per_attempt,
                        tag=tag,
                    )
                    self._note_logits(result)
                    return result
                except ReplicaDeadError as exc:
                    last_death = exc
                    self._report_death(slot, replica)
                    if attempt < attempts - 1:
                        self.metrics.retry_total.inc()
            raise NoHealthyReplicaError(
                f"request re-dispatched {attempts} times, every replica "
                f"died under it (last: {last_death})"
            )
        except NoHealthyReplicaError:
            self.metrics.shed_total.inc()
            self.metrics.request_errors.inc()
            raise
        except Exception:
            self.metrics.request_errors.inc()
            raise
        finally:
            self.metrics.request_latency.observe(
                (time.perf_counter() - t0) * 1e3
            )

    def _note_logits(self, result: dict) -> None:
        """Front-door nonfinite accounting (the SLO-watch scrape works
        for subprocess replicas too, whose engine counters the pool
        cannot see). Strictly best-effort: a malformed logits field must
        never fail a response that the replica answered."""
        logits = result.get("logits") if isinstance(result, dict) else None
        if logits is None:
            return
        try:
            finite = np.isfinite(np.asarray(logits, np.float64)).all()
        except (TypeError, ValueError):
            return
        if not finite:
            self.metrics.nonfinite_logits_total.inc()

    def _report_death(self, slot: _Slot, replica: Replica) -> None:
        """Fast-path retirement from the dispatch side: a dropped
        connection is stronger evidence than a missed health probe."""
        with self._lock:
            if slot.replica is not replica or slot.state in (
                RETIRED, CIRCUIT_OPEN,
            ):
                return  # supervisor already handled it
            self._retire_locked(slot, why="dispatch failure")
            self._lock.notify()

    # ------------------------------------------------------------------
    # Supervision
    # ------------------------------------------------------------------

    def _retire_locked(self, slot: _Slot, why: str) -> None:
        replica = slot.replica
        if replica is not None:
            self._graveyard.append(replica)
        # Ring rebalance: the dead replica's arc moves to its successor,
        # and (durable tier configured) the successor is queued to adopt
        # the dead spill directory — drained by the supervisor outside
        # this lock, because rehydration is real disk + verify work.
        if slot.index in self._ring:
            self._ring.remove(slot.index)
            successor = self._ring.successor(slot.index)
            if successor is not None and self.config.tier_root:
                self._rehydrate_q.append((slot.index, int(successor)))
        # Young death (never healthy, or healthy for less than min_uptime)
        # extends the crash streak; a replica that proved itself by serving
        # a while resets it. One that NEVER became healthy (factory failure,
        # died while starting) always extends — that's the crash loop the
        # breaker exists for.
        now = time.monotonic()
        if (
            slot.healthy_since is not None
            and now - slot.healthy_since >= self.config.min_uptime_s
        ):
            slot.consecutive_failures = 0
        slot.consecutive_failures += 1
        slot.replica = None
        slot.healthy_since = None
        slot.strikes = 0
        self.metrics.replica_deaths_total.inc()
        telemetry_events.emit(
            "replica_dead",
            slot=slot.index,
            why=why,
            consecutive_failures=slot.consecutive_failures,
        )
        if slot.consecutive_failures >= self.config.circuit_breaker_after:
            slot.state = CIRCUIT_OPEN
            self.metrics.circuit_open_total.inc()
            telemetry_events.emit("replica_circuit_open", slot=slot.index)
            return
        slot.state = RETIRED
        backoff = min(
            self.config.restart_backoff_s
            * (2 ** (slot.consecutive_failures - 1)),
            self.config.restart_backoff_max_s,
        )
        slot.next_restart_at = now + backoff

    def _try_start(self, slot: _Slot) -> None:
        """Builds a replica for ``slot`` (factory may block; called at
        construction and from the supervisor thread)."""
        slot.start_began = time.monotonic()
        try:
            replica = self.factory(slot.index)
        except Exception as exc:
            with self._lock:
                slot.replica = None
                self._retire_locked(slot, why=f"factory failed: {exc}")
            return
        with self._lock:
            adopted = not self._closed
            if adopted:
                slot.replica = replica
                slot.state = STARTING
                slot.strikes = 0
                slot.restarts += 1
                is_restart = slot.restarts > 1
        if not adopted:
            # Shutdown raced the start: nobody will supervise it — stop it
            # here instead of leaking a live replica.
            try:
                replica.terminate()
            except Exception:
                pass
            return
        if is_restart:  # the initial boot of a slot is not a "restart"
            self.metrics.replica_restarts_total.inc()
            telemetry_events.emit(
                "replica_restart", slot=slot.index, restarts=slot.restarts - 1
            )

    def _probe(self, slot: _Slot) -> None:
        replica = slot.replica
        if replica is None:
            return
        try:
            health = replica.healthz(timeout=self.config.health_timeout_s)
        except Exception as exc:  # dead, wedged (timeout), or transport
            with self._lock:
                if slot.replica is not replica:
                    return
                slot.strikes += 1
                if slot.strikes >= self.config.unhealthy_after:
                    self._retire_locked(slot, why=f"health: {exc}")
            return
        with self._lock:
            if slot.replica is not replica:
                return
            slot.strikes = 0
            if health.get("ready", True):
                if slot.state != HEALTHY:
                    slot.state = HEALTHY
                    slot.healthy_since = time.monotonic()
                    if slot.start_began is not None:
                        slot.last_ready_s = (
                            slot.healthy_since - slot.start_began
                        )
                        self._last_ready_s = slot.last_ready_s
                    self._ring.add(slot.index)
                    telemetry_events.emit(
                        "replica_healthy", slot=slot.index,
                        restarts=slot.restarts,
                        ready_s=slot.last_ready_s,
                    )
            else:
                slot.state = STARTING  # alive, still warming

    def _supervise(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
                graveyard, self._graveyard = self._graveyard, []
                rehydrations, self._rehydrate_q = self._rehydrate_q, []
                due = [
                    s for s in self._slots
                    if s.state == RETIRED
                    and time.monotonic() >= s.next_restart_at
                ]
                probes = [
                    s for s in self._slots
                    if s.state in (STARTING, HEALTHY) and s.replica is not None
                ]
            for replica in graveyard:
                try:
                    replica.terminate()
                except Exception:
                    pass  # already gone — termination is best-effort
            for dead_index, succ_index in rehydrations:
                self._rehydrate_one(dead_index, succ_index)
            for slot in due:
                self._try_start(slot)
            for slot in probes:
                self._probe(slot)
            with self._lock:
                if self._closed:
                    return
                self._lock.wait(self.config.health_interval_s)

    def _rehydrate_one(self, dead_index: int, succ_index: int) -> None:
        """Ask the ring successor to adopt a dead replica's spill dir.

        Best-effort by contract: the successor may itself have died, the
        replica flavor may not support rehydration (HTTP replicas), or
        the spill may verify down to nothing — every failure mode leaves
        the successor serving correctly, just colder."""
        assert self.config.tier_root is not None
        with self._lock:
            # A resize may have shrunk the fleet between the retirement
            # that queued this pair and now — a vanished successor just
            # means the arc's history is lost, never an IndexError.
            if succ_index >= len(self._slots):
                return
            slot = self._slots[succ_index]
            replica = (
                slot.replica if slot.state == HEALTHY else None
            )
        if replica is None:
            return
        spill_dir = os.path.join(
            self.config.tier_root, f"replica-{dead_index}"
        )
        try:
            adopted = replica.rehydrate_spill(spill_dir)
        except Exception:
            return
        self.metrics.rehydrations_total.inc()
        telemetry_events.emit(
            "spill_rehydrated",
            dead_slot=dead_index,
            successor=succ_index,
            entries=adopted,
        )

    # ------------------------------------------------------------------
    # Elastic fleet size (/admin/scale)
    # ------------------------------------------------------------------

    def resize(self, n: int) -> dict:
        """Grows or shrinks the fleet to ``n`` supervised slots.

        Idempotent by construction — ``resize(pool_size)`` is a no-op —
        so the autoscaler (``/admin/scale``, ``serve/resilience/autoscaler.py``)
        resumes a decision by re-issuing it: the target size, not a delta.

        Grow appends fresh RETIRED slots due immediately; the supervisor
        starts them on its next round (the factory runs on the supervisor
        thread, never under this lock) and they join the ring when their
        first health probe passes — with a durable tier a worker loads the
        kernel library from its executable cache and runs no nvcc build.

        Shrink retires the HIGHEST-index slots: low indices keep their
        identity, so ring arcs, ``replica-<i>`` tier directories, and the
        canary (slot 0) are never reshuffled by a scale-down. Each
        removed replica's arc moves to its ring successor (with spill
        rehydration when a durable tier is configured — the same path a
        death takes), and the replica itself drains through the
        graveyard, terminated by the supervisor outside the lock."""
        n = int(n)
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        with self._lock:
            if self._closed:
                raise RuntimeError("cannot resize a closed pool")
            before = len(self._slots)
            if n == before:
                return {"pool_size": before, "added": 0, "removed": 0}
            if n > before:
                now = time.monotonic()
                for i in range(before, n):
                    slot = _Slot(i)
                    slot.next_restart_at = now  # due immediately
                    self._slots.append(slot)
            else:
                for slot in self._slots[n:]:
                    if slot.replica is not None:
                        self._graveyard.append(slot.replica)
                        slot.replica = None
                    if slot.index in self._ring:
                        self._ring.remove(slot.index)
                        successor = self._ring.successor(slot.index)
                        if successor is not None and self.config.tier_root:
                            self._rehydrate_q.append(
                                (slot.index, int(successor))
                            )
                    slot.state = RETIRED
                del self._slots[n:]
            after = len(self._slots)
            self._lock.notify()  # wake the supervisor: starts / graveyard
        telemetry_events.emit(
            "pool_resized", before=before, after=after,
        )
        return {
            "pool_size": after,
            "added": max(0, after - before),
            "removed": max(0, before - after),
        }

    # ------------------------------------------------------------------
    # Operational surface (ServingAPI-shaped)
    # ------------------------------------------------------------------

    def _state_counts(self) -> dict:
        with self._lock:
            counts: dict[str, int] = {}
            for slot in self._slots:
                counts[slot.state] = counts.get(slot.state, 0) + 1
            return counts

    def healthz(self) -> dict:
        with self._lock:
            replicas = [slot.describe() for slot in self._slots]
            last_promoted = dict(self._last_promoted or {}) or None
        healthy = sum(1 for r in replicas if r["state"] == HEALTHY)
        size = len(replicas)
        degraded = healthy < size
        ready = healthy > 0
        return {
            "last_promoted_digest": (
                last_promoted["digest"] if last_promoted else None
            ),
            "status": (
                "ok" if not degraded else ("degraded" if ready else "unready")
            ),
            "ready": ready,
            "degraded": degraded,
            "replicas": replicas,
            "healthy_replicas": healthy,
            "pool_size": size,
            "uptime_s": time.time() - self.started_at,
        }

    def wait_ready(
        self, timeout: float = 120.0, *, healthy: int | None = None
    ) -> bool:
        """Blocks until ``healthy`` replicas (default: all) pass health
        checks; returns False on timeout."""
        want = len(self._slots) if healthy is None else healthy
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.healthz()["healthy_replicas"] >= want:
                return True
            time.sleep(0.05)
        return False

    def promote(self, checkpoint_path: str) -> dict:
        """Rolls a checkpoint across the fleet, canary-first: manifest
        verification happens ONCE at the front door (a corrupt file costs
        zero replicas), then replica 0 must accept (canary episodes against
        the candidate state) before the rest are touched. Raises
        ``SwapRejectedError`` on the front-door verify or the first replica
        rejection; the message counts replicas already promoted so a
        mid-roll divergence is visible to the operator."""
        try:
            verify_checkpoint(checkpoint_path)
        except CheckpointError as exc:
            telemetry_events.emit(
                "swap_rejected",
                source=checkpoint_path,
                reason="corrupt_checkpoint",
                detail=str(exc),
            )
            raise SwapRejectedError(
                f"checkpoint failed front-door verification: {exc}",
                reason="corrupt_checkpoint",
            ) from exc
        with self._lock:
            targets = [
                s.replica for s in self._slots
                if s.state == HEALTHY and s.replica is not None
            ]
        if not targets:
            raise NoHealthyReplicaError("no healthy replica to promote onto")
        promoted = 0
        for replica in targets:
            try:
                result = replica.promote(checkpoint_path)
            except SwapRejectedError as exc:
                raise SwapRejectedError(
                    f"replica {replica.replica_id} rejected the swap after "
                    f"{promoted}/{len(targets)} replicas promoted: {exc}",
                    reason=exc.reason,
                ) from exc
            promoted += 1
        # Hash OUTSIDE the lock: the first digest of a multi-MB archive is
        # real file I/O, and holding the pool Condition across it would
        # park every dispatcher/_pick caller behind the hash
        # (blocking-under-lock; the memo makes repeats cheap, not the
        # first read).
        digest = checkpoint_digest(checkpoint_path)
        with self._lock:
            self._last_promoted = {
                "digest": digest,
                "path": checkpoint_path,
                "t": time.time(),
            }
        telemetry_events.emit(
            "pool_swap_promoted", source=checkpoint_path, replicas=promoted,
        )
        # The publish landed: an injected live regression starts with the
        # very next answer (``regress_after_promote``).
        faultinject.promotion_applied()
        return {
            "promoted_replicas": promoted,
            "state_version": result.get("state_version"),
        }

    def stats(self) -> dict:
        m = self.metrics
        return {
            "requests_total": m.requests_total.value,
            "request_errors": m.request_errors.value,
            "retry_total": m.retry_total.value,
            "shed_total": m.shed_total.value,
            "replica_deaths_total": m.replica_deaths_total.value,
            "replica_restarts_total": m.replica_restarts_total.value,
            "circuit_open_total": m.circuit_open_total.value,
            "nonfinite_logits_total": m.nonfinite_logits_total.value,
            "rehydrations_total": m.rehydrations_total.value,
            "replica_ready_s": self._last_ready_s,
            "ring_nodes": len(self._ring),
            "latency_ms": {"request": m.request_latency.snapshot()},
            "replicas": self.healthz()["replicas"],
        }

    def metrics_text(self) -> str:
        p = self.metrics.PREFIX
        m = self.metrics
        health = self.healthz()
        lines = [
            f"# TYPE {p}_requests_total counter",
            f"{p}_requests_total {m.requests_total.value}",
            f"# TYPE {p}_request_errors_total counter",
            f"{p}_request_errors_total {m.request_errors.value}",
            f"# TYPE {p}_retry_total counter",
            f"{p}_retry_total {m.retry_total.value}",
            f"# TYPE {p}_shed_total counter",
            f"{p}_shed_total {m.shed_total.value}",
            f"# TYPE {p}_replica_deaths_total counter",
            f"{p}_replica_deaths_total {m.replica_deaths_total.value}",
            f"# TYPE {p}_replica_restarts_total counter",
            f"{p}_replica_restarts_total {m.replica_restarts_total.value}",
            f"# TYPE {p}_circuit_open_total counter",
            f"{p}_circuit_open_total {m.circuit_open_total.value}",
            f"# TYPE {p}_nonfinite_logits_total counter",
            f"{p}_nonfinite_logits_total {m.nonfinite_logits_total.value}",
            f"# TYPE {p}_rehydrations_total counter",
            f"{p}_rehydrations_total {m.rehydrations_total.value}",
            f"# TYPE {p}_replica_ready_s gauge",
            f"{p}_replica_ready_s {self._last_ready_s or 0.0:.6f}",
            f"# TYPE {p}_pool_size gauge",
            f"{p}_pool_size {health['pool_size']}",
            f"# TYPE {p}_healthy_replicas gauge",
            f"{p}_healthy_replicas {health['healthy_replicas']}",
            f"# TYPE {p}_degraded gauge",
            f"{p}_degraded {int(health['degraded'])}",
        ]
        snap = m.request_latency.snapshot()
        lines += [
            f"# TYPE {p}_request_latency_ms summary",
            f'{p}_request_latency_ms{{quantile="0.5"}} {snap["p50_ms"]:.6f}',
            f'{p}_request_latency_ms{{quantile="0.99"}} {snap["p99_ms"]:.6f}',
            f"{p}_request_latency_ms_count {snap['count']}",
            f"{p}_request_latency_ms_sum {snap['sum_ms']:.6f}",
        ]
        for slot in health["replicas"]:
            lines.append(
                f'{p}_replica_up{{slot="{slot["index"]}"}} '
                f"{int(slot['state'] == HEALTHY)}"
            )
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            replicas = [s.replica for s in self._slots if s.replica]
            replicas += self._graveyard
            self._graveyard = []
            for slot in self._slots:
                slot.replica = None
                slot.state = RETIRED
            self._lock.notify_all()
        self._supervisor.join(timeout=10)
        for replica in replicas:
            try:
                replica.terminate()
            except Exception:
                pass  # best-effort shutdown

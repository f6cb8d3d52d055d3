"""Deterministic fault injection for the training and serving runtimes
(``howtotrainyourmamlpytorch_tpu/utils/faultinject.py``: its training,
serve and durable-tier faults).

Every recovery path of the builder, the checkpoint writer and the stager
is driven by one of these one-shot failure points:

* ``truncate_checkpoint_at`` - truncate the next published checkpoint file
  at byte N (a torn or rotted file that passed the atomic rename);
* ``fail_next_writes`` - raise ``OSError`` (``ENOSPC``) on the next K
  checkpoint write attempts;
* ``nan_at_iter`` / ``overflow_at_iter`` - fill the target images of the
  batch iteration I consumes with NaN / 3e38 before staging, so the
  meta-loss goes non-finite through the real step. Float wire only: the
  ``uint8`` wire codec's ``prepare_batch`` clips and casts the images, so
  NaN becomes 0 and 3e38 becomes 255 there and the batch stays finite;
* ``sigterm_at_iter`` / ``sigkill_at_iter`` - signal this process right
  after the dispatch that reaches iteration I (a preemption; a worker's
  death, with no handler and no emergency checkpoint);
* ``hang_at_iter`` - park the dispatch thread inside the watchdog's armed
  window at the dispatch that covers iteration I;
* ``producer_fail_at_iter`` - raise a transient ``OSError`` in the
  prefetch stager as it pulls the group planned for iteration I;
* ``oom_at_iter`` - a ``torch.OutOfMemoryError`` at the dispatch that
  covers iteration I: on a card a real one, from an allocation larger than
  ``torch.cuda.mem_get_info`` reports free, so it takes the path a failed
  allocation of the step takes; on the CPU the same class, raised;
* ``kill_trainer_mid_publish`` - SIGKILL between an epoch archive (and its
  alias) landing and its ``.ready`` marker.

Serve-path faults (``serve/pool.py``, ``serve/resilience``):

* ``replica_kill_at_request`` - the replica serving the Kth classify
  request (counted in this process from activation, 1-based) dies: a
  ``LocalReplica`` turns dead and raises ``ReplicaDeadError``, a worker
  process's HTTP handler leaves with ``os._exit(86)``;
* ``wedge_replica_at_request`` - the same trigger, but the replica wedges:
  it answers neither requests nor health probes and does not die;
* ``corrupt_swap_at`` - truncate the checkpoint at byte N the next time a
  promotion loads it;
* ``nan_next_logits`` - the next K classify outputs (canaries included)
  are all NaN at the engine's logits boundary.

Control-plane faults (``serve/resilience/{promotion,autoscaler}.py``):

* ``corrupt_candidate_at`` - truncate the promotion daemon's staged copy
  of the next candidate at byte N, right before it is verified (the
  trainer's own file is untouched);
* ``daemon_kill_at_phase`` - SIGKILL the promotion daemon at journal
  boundary N (``promotion.KILL_*``);
* ``autoscaler_kill_at_phase`` - the same for the autoscaler
  (``autoscaler.KILL_*``);
* ``regress_after_promote`` - the moment a promotion publishes (the pool's
  or ``ServingAPI``'s), arm ``nan_next_logits=K``: the promoted state
  answers NaN on the very next K answers.

Durable-tier faults (``serve/tier/``):

* ``torn_spill_write_at`` - the Kth durable publish lands torn (half its
  payload renamed into place);
* ``corrupt_cache_entry_at`` - the Kth spill read first finds four bytes
  flipped in the middle of its entry;
* ``stale_exec_cache_at`` - the Kth executable-cache load sees its stored
  fence drifted.

The plan comes from ``activate(FaultPlan(...))`` or from the environment,
``MAML_FAULTS="nan_at_iter=40,sigterm_at_iter=120"`` (comma or semicolon
separated ``key=int``), read once on first use, so each fault is armed in
the process that fires it. Every ``FaultPlan`` field of the JAX package
parses and fires. Fired faults are appended to ``events``. With no plan
each hook is one ``None`` check.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import re
import signal
import time

import numpy as np

ENV_VAR = "MAML_FAULTS"

#: Fired faults (``"write-fail:..."``, ``"nan:3"``, ...), cleared by
#: ``activate``, ``deactivate`` and ``reset``.
events: list[str] = []


@dataclasses.dataclass
class FaultPlan:
    """One-shot failure points; ``None``/``0`` is inactive. The fields are
    the JAX package's, serve and control-plane ones included."""

    truncate_checkpoint_at: int | None = None
    fail_next_writes: int = 0
    nan_at_iter: int | None = None
    overflow_at_iter: int | None = None
    sigterm_at_iter: int | None = None
    sigkill_at_iter: int | None = None
    hang_at_iter: int | None = None
    producer_fail_at_iter: int | None = None
    oom_at_iter: int | None = None
    replica_kill_at_request: int | None = None
    wedge_replica_at_request: int | None = None
    corrupt_swap_at: int | None = None
    nan_next_logits: int = 0
    corrupt_candidate_at: int | None = None
    kill_trainer_mid_publish: int = 0
    daemon_kill_at_phase: int | None = None
    autoscaler_kill_at_phase: int | None = None
    regress_after_promote: int = 0
    torn_spill_write_at: int | None = None
    corrupt_cache_entry_at: int | None = None
    stale_exec_cache_at: int | None = None


#: Faults of the serving pool and the durable tier.
SERVE_KEYS = (
    "replica_kill_at_request", "wedge_replica_at_request", "corrupt_swap_at",
    "nan_next_logits", "torn_spill_write_at", "corrupt_cache_entry_at",
    "stale_exec_cache_at",
)

#: Faults of the promotion and autoscaler daemons.
CONTROL_PLANE_KEYS = (
    "corrupt_candidate_at", "daemon_kill_at_phase", "autoscaler_kill_at_phase",
    "regress_after_promote",
)

_UNSET = object()  # the environment not yet read
_plan: FaultPlan | None | object = _UNSET
_serve_requests = 0  # classify requests since activation (serve faults)
_tier_writes = 0  # durable-tier publishes since activation
_tier_reads = 0  # spill-entry reads since activation
_exec_loads = 0  # executable-cache loads since activation


def parse_plan(spec: str) -> FaultPlan | None:
    """The plan a ``MAML_FAULTS`` string names (None for an empty one);
    ``ValueError`` for an unknown key, as the JAX parser raises."""
    spec = spec.strip()
    if not spec:
        return None
    plan = FaultPlan()
    fields = {f.name for f in dataclasses.fields(FaultPlan)}
    for part in re.split(r"[;,]", spec):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        key = key.strip()
        if not sep or key not in fields:
            raise ValueError(
                f"{ENV_VAR}: unknown fault {part!r}; expected key=int with "
                f"key in {sorted(fields)}"
            )
        setattr(plan, key, int(value))
    return plan


def _active() -> FaultPlan | None:
    global _plan
    if _plan is _UNSET:
        _plan = parse_plan(os.environ.get(ENV_VAR, ""))
    return _plan  # type: ignore[return-value]


def current_plan() -> FaultPlan | None:
    """The active plan (read from the environment on the first call)."""
    return _active()


def activate(plan: FaultPlan) -> FaultPlan:
    """Installs ``plan`` over any environment plan, clears ``events`` and
    restarts the request and tier counters (a serve fault fires at "the
    Kth request after activation")."""
    global _plan
    _plan = plan
    _reset_counters()
    events.clear()
    return plan


def deactivate() -> None:
    """No plan; the environment is not read again (``reset`` does that)."""
    global _plan
    _plan = None
    _reset_counters()
    events.clear()


def reset() -> None:
    """The next hook reads ``MAML_FAULTS`` again."""
    global _plan
    _plan = _UNSET
    _reset_counters()
    events.clear()


def _reset_counters() -> None:
    global _serve_requests, _tier_writes, _tier_reads, _exec_loads
    _serve_requests = _tier_writes = _tier_reads = _exec_loads = 0


# ---------------------------------------------------------------------------
# Failure points
# ---------------------------------------------------------------------------


def checkpoint_write_attempt(filepath: str) -> None:
    """Before each checkpoint write attempt: the injected ``ENOSPC`` while
    ``fail_next_writes`` > 0."""
    plan = _active()
    if plan is None or plan.fail_next_writes <= 0:
        return
    plan.fail_next_writes -= 1
    events.append(f"write-fail:{os.path.basename(filepath)}")
    raise OSError(
        errno.ENOSPC, "faultinject: injected checkpoint write failure", filepath
    )


def checkpoint_written(filepath: str) -> None:
    """After a checkpoint file is published (write or alias): the one-shot
    ``truncate_checkpoint_at``."""
    plan = _active()
    if plan is None or plan.truncate_checkpoint_at is None:
        return
    n = plan.truncate_checkpoint_at
    plan.truncate_checkpoint_at = None
    with open(filepath, "r+b") as f:
        f.truncate(n)
    events.append(f"truncate:{os.path.basename(filepath)}@{n}")


def poison_batch(sample, current_iter: int):
    """``sample`` with its target images all NaN (``nan_at_iter``) or 3e38
    (``overflow_at_iter``) when ``current_iter`` (the 0-based iteration
    that consumes it) is planned; else ``sample`` itself. A sample is
    ``(xs, xt, ys, yt, seed[, aug])``."""
    plan = _active()
    if plan is None:
        return sample
    fill = None
    if plan.nan_at_iter is not None and current_iter == plan.nan_at_iter:
        plan.nan_at_iter = None
        events.append(f"nan:{current_iter}")
        fill = np.nan
    elif plan.overflow_at_iter is not None and current_iter == plan.overflow_at_iter:
        plan.overflow_at_iter = None
        events.append(f"overflow:{current_iter}")
        fill = 3.0e38
    if fill is None:
        return sample
    xs, xt, *rest = sample
    xt = np.full_like(np.asarray(xt, dtype=np.float32), fill)
    return (xs, xt, *rest)


def poison_batches(samples, first_iter: int):
    """Element j of ``samples`` feeds iteration ``first_iter + j``."""
    if _active() is None:
        return samples
    return [poison_batch(s, first_iter + j) for j, s in enumerate(samples)]


def sigterm_due(iters_done: int) -> None:
    """SIGKILL, then SIGTERM, to this process once ``iters_done`` reaches
    the planned count."""
    plan = _active()
    if plan is None:
        return
    if plan.sigkill_at_iter is not None and iters_done >= plan.sigkill_at_iter:
        plan.sigkill_at_iter = None
        events.append(f"sigkill:{iters_done}")
        os.kill(os.getpid(), signal.SIGKILL)
    if plan.sigterm_at_iter is not None and iters_done >= plan.sigterm_at_iter:
        plan.sigterm_at_iter = None
        events.append(f"sigterm:{iters_done}")
        os.kill(os.getpid(), signal.SIGTERM)


#: Cap on the injected stall; the watchdog ends the process long before.
HANG_STALL_CAP_S = 3600.0


def hang_due(current_iter: int) -> None:
    """Parks the calling thread once ``current_iter`` (a dispatch group's
    first iteration) reaches ``hang_at_iter``, until the watchdog ends the
    process or the cap passes."""
    plan = _active()
    if plan is None or plan.hang_at_iter is None or current_iter < plan.hang_at_iter:
        return
    plan.hang_at_iter = None
    events.append(f"hang:{current_iter}")
    deadline = time.monotonic() + HANG_STALL_CAP_S
    while time.monotonic() < deadline:
        time.sleep(0.05)


def _out_of_memory(device) -> None:
    """Raises ``torch.OutOfMemoryError``: on a CUDA device from an
    allocation of twice the free memory (nothing is allocated), elsewhere
    directly."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        torch.empty(2 * free + (1 << 30), dtype=torch.uint8, device=device)
    raise torch.OutOfMemoryError(
        "faultinject: injected out of memory (no CUDA device to exhaust)"
    )


def oom_due(current_iter: int, device=None) -> None:
    """The injected out-of-memory at the dispatch that covers
    ``oom_at_iter`` (``current_iter`` is the group's first iteration)."""
    plan = _active()
    if plan is None or plan.oom_at_iter is None or current_iter < plan.oom_at_iter:
        return
    plan.oom_at_iter = None
    events.append(f"oom:{current_iter}")
    _out_of_memory(device)


def producer_pull(current_iter: int) -> None:
    """Before the stager pulls the group planned for ``current_iter``: the
    injected transient loader error (one-shot)."""
    plan = _active()
    if (plan is None or plan.producer_fail_at_iter is None
            or current_iter < plan.producer_fail_at_iter):
        return
    plan.producer_fail_at_iter = None
    events.append(f"producer-fail:{current_iter}")
    raise OSError(errno.EIO, "faultinject: injected transient episode-producer failure")


def trainer_publish_marker(filepath: str) -> None:
    """Right before the ``.ready`` marker of ``filepath`` is written:
    SIGKILL under ``kill_trainer_mid_publish`` (one-shot)."""
    plan = _active()
    if plan is None or plan.kill_trainer_mid_publish <= 0:
        return
    plan.kill_trainer_mid_publish = 0
    events.append(f"kill-mid-publish:{os.path.basename(filepath)}")
    os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# Serve-path failure points (serve/pool.py, serve/resilience, serve/tier)
# ---------------------------------------------------------------------------


def serve_request_fault() -> str | None:
    """Once per classify request a replica answers: ``"kill"`` or
    ``"wedge"`` when this is the planned Kth request (counted from
    activation, 1-based), else ``None``. The replica decides what death
    and wedging mean for it."""
    global _serve_requests
    plan = _active()
    if plan is None or (plan.replica_kill_at_request is None
                        and plan.wedge_replica_at_request is None):
        return None
    _serve_requests += 1
    if plan.replica_kill_at_request == _serve_requests:
        plan.replica_kill_at_request = None
        events.append(f"replica-kill:{_serve_requests}")
        return "kill"
    if plan.wedge_replica_at_request == _serve_requests:
        plan.wedge_replica_at_request = None
        events.append(f"replica-wedge:{_serve_requests}")
        return "wedge"
    return None


def swap_checkpoint_loading(filepath: str) -> None:
    """Right before a promotion reads its checkpoint: the one-shot
    ``corrupt_swap_at`` truncation."""
    plan = _active()
    if plan is None or plan.corrupt_swap_at is None:
        return
    n = plan.corrupt_swap_at
    plan.corrupt_swap_at = None
    with open(filepath, "r+b") as f:
        f.truncate(n)
    events.append(f"corrupt-swap:{os.path.basename(filepath)}@{n}")


def poison_logits(logits: np.ndarray) -> np.ndarray:
    """``logits`` (host, after the fetch) all NaN while ``nan_next_logits``
    > 0, else ``logits`` itself; the engine consults it on every classify
    output, canaries included."""
    plan = _active()
    if plan is None or plan.nan_next_logits <= 0:
        return logits
    plan.nan_next_logits -= 1
    events.append(f"nan-logits:{plan.nan_next_logits}")
    return np.full_like(np.asarray(logits, dtype=np.float32), np.nan)


# ---------------------------------------------------------------------------
# Control-plane failure points (serve/resilience/promotion.py, autoscaler.py)
# ---------------------------------------------------------------------------


def candidate_checkpoint_loading(filepath: str) -> None:
    """Right before the promotion daemon verifies a staged candidate copy:
    the one-shot ``corrupt_candidate_at`` truncation of that copy."""
    plan = _active()
    if plan is None or plan.corrupt_candidate_at is None:
        return
    n = plan.corrupt_candidate_at
    plan.corrupt_candidate_at = None
    with open(filepath, "r+b") as f:
        f.truncate(n)
    events.append(f"corrupt-candidate:{os.path.basename(filepath)}@{n}")


def daemon_phase(phase: int) -> None:
    """At each journal boundary of the promotion daemon: SIGKILL when
    ``daemon_kill_at_phase`` names ``phase`` (one-shot)."""
    plan = _active()
    if plan is None or plan.daemon_kill_at_phase is None:
        return
    if int(plan.daemon_kill_at_phase) != int(phase):
        return
    plan.daemon_kill_at_phase = None
    events.append(f"daemon-kill:phase{phase}")
    os.kill(os.getpid(), signal.SIGKILL)


def autoscaler_phase(phase: int) -> None:
    """At each journal boundary of the autoscaler: SIGKILL when
    ``autoscaler_kill_at_phase`` names ``phase`` (one-shot)."""
    plan = _active()
    if plan is None or plan.autoscaler_kill_at_phase is None:
        return
    if int(plan.autoscaler_kill_at_phase) != int(phase):
        return
    plan.autoscaler_kill_at_phase = None
    events.append(f"autoscaler-kill:phase{phase}")
    os.kill(os.getpid(), signal.SIGKILL)


def promotion_applied() -> None:
    """The moment a promotion publishes (the pool's or ``ServingAPI``'s):
    an armed ``regress_after_promote=K`` becomes ``nan_next_logits=K``
    (one-shot), so the promoted state regresses the very next answers, the
    class a pre-publish canary cannot see."""
    plan = _active()
    if plan is None or plan.regress_after_promote <= 0:
        return
    k = plan.regress_after_promote
    plan.regress_after_promote = 0
    plan.nan_next_logits = k
    events.append(f"regress-after-promote:{k}")


def torn_spill_write(data: bytes) -> bytes:
    """On every durable publish (``serve/tier/atomic.atomic_write_bytes``):
    the ``torn_spill_write_at``-th returns the first half of ``data``, so
    the rename lands a torn file."""
    global _tier_writes
    plan = _active()
    if plan is None or plan.torn_spill_write_at is None:
        return data
    _tier_writes += 1
    if plan.torn_spill_write_at != _tier_writes:
        return data
    plan.torn_spill_write_at = None
    cut = max(1, len(data) // 2)
    events.append(f"torn-spill:{cut}")
    return data[:cut]


def corrupt_cache_entry(path: str) -> None:
    """Before each spill read: the ``corrupt_cache_entry_at``-th first
    writes four bytes into the middle of the entry on disk."""
    global _tier_reads
    plan = _active()
    if plan is None or plan.corrupt_cache_entry_at is None:
        return
    _tier_reads += 1
    if plan.corrupt_cache_entry_at != _tier_reads:
        return
    plan.corrupt_cache_entry_at = None
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(max(0, size // 2))
            f.write(b"\xde\xad\xbe\xef")
    except OSError:
        pass
    events.append(f"corrupt-entry:{os.path.basename(path)}")


def stale_exec_cache(fence: dict) -> dict:
    """On each executable-cache load, with the stored fence: the
    ``stale_exec_cache_at``-th sees its toolchain field drifted (the JAX
    package drifts ``jaxlib``; the port's fence has ``torch`` there)."""
    global _exec_loads
    plan = _active()
    if plan is None or plan.stale_exec_cache_at is None:
        return fence
    _exec_loads += 1
    if plan.stale_exec_cache_at != _exec_loads:
        return fence
    plan.stale_exec_cache_at = None
    events.append("stale-exec-fence")
    return {**fence, "torch": "0.0.0-faulted"}

"""Deterministic fault injection for the training runtime
(``howtotrainyourmamlpytorch_tpu/utils/faultinject.py``, its training
faults).

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

The plan comes from ``activate(FaultPlan(...))`` or from the environment,
``MAML_FAULTS="nan_at_iter=40,sigterm_at_iter=120"`` (comma or semicolon
separated ``key=int``), read once on first use. Every ``FaultPlan`` field
of the JAX package parses; a serve or control-plane fault set to anything
but its idle value raises ``NotImplementedError`` (ROADMAP A11). Fired
faults are appended to ``events``. With no plan each hook is one ``None``
check.
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


#: Faults of the serving pool, the promotion and autoscaler daemons and the
#: durable tier: ROADMAP A11 in the port.
NOT_PORTED = (
    "replica_kill_at_request", "wedge_replica_at_request", "corrupt_swap_at",
    "nan_next_logits", "corrupt_candidate_at", "daemon_kill_at_phase",
    "autoscaler_kill_at_phase", "regress_after_promote", "torn_spill_write_at",
    "corrupt_cache_entry_at", "stale_exec_cache_at",
)

_UNSET = object()  # the environment not yet read
_plan: FaultPlan | None | object = _UNSET


def _refuse_unported(plan: FaultPlan) -> FaultPlan:
    idle = FaultPlan()
    set_ = [name for name in NOT_PORTED
            if getattr(plan, name) != getattr(idle, name)]
    if set_:
        raise NotImplementedError(
            f"serve and control-plane faults {set_} are ROADMAP item A11"
        )
    return plan


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
    return _refuse_unported(plan)


def _active() -> FaultPlan | None:
    global _plan
    if _plan is _UNSET:
        _plan = parse_plan(os.environ.get(ENV_VAR, ""))
    return _plan  # type: ignore[return-value]


def current_plan() -> FaultPlan | None:
    """The active plan (read from the environment on the first call)."""
    return _active()


def activate(plan: FaultPlan) -> FaultPlan:
    """Installs ``plan`` over any environment plan and clears ``events``."""
    global _plan
    _plan = _refuse_unported(plan)
    events.clear()
    return plan


def deactivate() -> None:
    """No plan; the environment is not read again (``reset`` does that)."""
    global _plan
    _plan = None
    events.clear()


def reset() -> None:
    """The next hook reads ``MAML_FAULTS`` again."""
    global _plan
    _plan = _UNSET
    events.clear()


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

"""The contention sentinel (the JAX repo's ``bench.py``: the sentinel
program, the live-trainer scan and the contention factor).

An A/B probe is only judged when nothing else competed for the card or the
host while it ran. Two signals say so:

* the direct one, :func:`live_trainer_pids`: another training process is
  alive on this host. A trainer poisons a measurement even while its work
  is on the host (episode synthesis) and the card looks idle;
* the device one, :func:`sentinel_ms`: the median time of one fixed
  program, a 256x256 float32 product and its sum, synchronised. The
  program never changes, so its time moves only with contention; a reading
  beyond :data:`SENTINEL_CONTENTION_FACTOR` times the quiet floor is
  contended.

The quiet floor is the caller's (the autotuner's run-local floor);
``BENCH_QUIET_SENTINEL_MS`` overrides it (:func:`quiet_floor_override`).
The sentinel is a yardstick, not a ported kernel: a library product is the
point of it.
"""

from __future__ import annotations

import os
import statistics
import time

#: A reading beyond this multiple of the quiet floor is contended.
SENTINEL_CONTENTION_FACTOR = 5.0

#: Environment override of the quiet floor, ms.
QUIET_SENTINEL_ENV = "BENCH_QUIET_SENTINEL_MS"

#: Script and module names of the training entry points whose live
#: processes mark a measurement contended.
TRAINER_MARKERS = (
    "train_maml_system",
    "train_gradient_descent_system",
    "train_matching_nets_system",
)

#: The package whose ``python -m <package>.train_*`` processes are trainers.
PACKAGE = __name__.split(".")[0]


def quiet_floor_override() -> float | None:
    """``BENCH_QUIET_SENTINEL_MS`` as a float; None when unset or not a
    number."""
    env = os.environ.get(QUIET_SENTINEL_ENV)
    if not env:
        return None
    try:
        return float(env)
    except ValueError:
        return None


def is_trainer_argv(argv) -> bool:
    """Whether a process's argv (``/proc/<pid>/cmdline`` split at NULs)
    starts a trainer: a script token whose basename is ``<marker>*.py``
    (``python train_maml_system.py``), or ``-m <package>.<marker>*``, the
    form this package's dispatcher, fleet ranks and chaos loops use. A
    substring match would also flag ``grep train_maml_system``, ``tail -f
    train_maml_system.log`` or a wrapper shell whose one argument quotes
    the command, so only whole tokens count."""
    tokens = [t.decode(errors="replace") if isinstance(t, bytes) else str(t)
              for t in argv]
    for index, token in enumerate(tokens):
        base = os.path.basename(token)
        if base.endswith(".py") and base.startswith(TRAINER_MARKERS):
            return True
        if token == "-m" and index + 1 < len(tokens):
            package, _, module = tokens[index + 1].rpartition(".")
            if package == PACKAGE and module.startswith(TRAINER_MARKERS):
                return True
    return False


def live_trainer_pids(proc: str = "/proc") -> list[int]:
    """PIDs of the other live trainer processes on this host
    (:func:`is_trainer_argv` over every ``<proc>/<pid>/cmdline``)."""
    pids = []
    me = os.getpid()
    try:
        entries = os.listdir(proc)
    except OSError:
        return pids
    for entry in entries:
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(os.path.join(proc, entry, "cmdline"), "rb") as f:
                argv = f.read().split(b"\x00")
        except OSError:
            continue
        if is_trainer_argv(argv):
            pids.append(int(entry))
    return pids


def sentinel_ms(repeats: int = 30, device=None) -> float:
    """Median wall ms of the fixed program on ``device`` (the card by
    default): a 256x256 float32 product and its sum, each call ended by a
    synchronisation; one call first, untimed."""
    import torch

    from ..utils.platform import resolve_device

    device = resolve_device(device)
    x = torch.ones((256, 256), dtype=torch.float32, device=device)

    def once():
        torch.matmul(x, x).sum()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    once()
    times = []
    for _ in range(int(repeats)):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)

"""Multi-process bring-up: a fail-fast ``torch.distributed`` process group
(``howtotrainyourmamlpytorch_tpu/parallel/distributed.py``).

A rank is a process. Bring-up is one call, before anything touches CUDA
and before the entry point picks its device (``utils/parser_utils.get_args``
picks ``cuda:<local rank mod device count>``):

* ranks other than 0 preflight a TCP probe of the coordinator (rank 0
  hosts the group's store there), retried until the bring-up timeout, and
  raise a typed :class:`DistributedInitError` naming the address instead of
  parking inside the handshake;
* the handshake (``init_process_group`` over a ``tcp://`` init method) runs
  under the same timeout, and a failure there is re-raised as the same
  typed error, before any training state exists. The group keeps that
  timeout for its collectives: a gloo collective whose peer stalls longer
  raises rather than waiting for the hang watchdog.

The backend is ``nccl`` when every rank of the host has a card of its own
and ``gloo`` when ranks share a card or run on the CPU: NCCL refuses two
ranks on one device, and gloo reduces CUDA tensors through the host
(``parallel/mesh.choose_backend``).

Opt-in by explicit signal only, as in the JAX package: the arguments, or
the launcher's standard variables (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) where JAX reads ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``. Without one the call is a no-op.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import sys
import time

#: Wall budget of the whole bring-up (preflight and handshake).
DEFAULT_INIT_TIMEOUT_S = 120.0

#: The four bring-up keys, read from flags and from the config JSON.
BRINGUP_KEYS = (
    "coordinator_address",
    "num_processes",
    "process_id",
    "distributed_init_timeout_s",
)


def find_free_port(host: str = "127.0.0.1") -> int:
    """A currently free loopback port for a coordinator."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class DistributedInitError(RuntimeError):
    """Bring-up failed (coordinator unreachable, handshake timeout, or the
    backend refused the topology). Raised before any training state
    exists."""


def _group_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    try:
        if _group_ready():
            import torch.distributed as dist

            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - identity must never crash telemetry
        pass
    return 0


def process_count() -> int:
    """The process group's size (1 without one)."""
    try:
        if _group_ready():
            import torch.distributed as dist

            return int(dist.get_world_size())
    except Exception:  # noqa: BLE001 - identity must never crash telemetry
        pass
    return 1


def local_rank() -> int:
    """This process's rank among the ranks of its host: the launcher's
    ``LOCAL_RANK`` where it sets one, else the global rank (one host)."""
    value = os.environ.get("LOCAL_RANK")
    return int(value) if value not in (None, "") else process_index()


def _await_coordinator(address: str, deadline_s: float) -> None:
    """Polls a TCP connect to ``address`` until it accepts or the deadline
    passes, then raises :class:`DistributedInitError`."""
    host, _, port = address.rpartition(":")
    try:
        port_no = int(port)
    except ValueError as exc:
        raise DistributedInitError(
            f"malformed coordinator address {address!r} (expected host:port)"
        ) from exc
    deadline = time.monotonic() + deadline_s
    last_error: Exception | None = None
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host or "127.0.0.1", port_no),
                                          timeout=2.0):
                return
        except OSError as exc:
            last_error = exc
            time.sleep(0.25)
    raise DistributedInitError(
        f"coordinator unreachable at {address} after {deadline_s:.0f}s "
        f"(last error: {last_error}); check --coordinator_address / "
        "MASTER_ADDR:MASTER_PORT and that process 0 is running"
    )


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    distributed_init_timeout_s: float | None = None,
    cpu: bool = False,
) -> bool:
    """Joins this process to the process group when a multi-process run is
    signalled; returns whether it did. The backend is
    ``mesh.choose_backend``'s (``cpu``: the ranks run on the CPU); the
    bring-up's budget ``DEFAULT_INIT_TIMEOUT_S`` unless given."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if distributed_init_timeout_s is None:
        distributed_init_timeout_s = DEFAULT_INIT_TIMEOUT_S
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    )
    if not explicit:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise DistributedInitError(
            "a multi-process run needs --coordinator_address, --num_processes "
            f"and --process_id (got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}); nothing detects them here"
        )
    if not 0 <= process_id < num_processes:
        raise DistributedInitError(
            f"--process_id {process_id} out of range for {num_processes} processes"
        )
    import torch
    import torch.distributed as dist

    from .mesh import choose_backend

    # Counting the cards initialises no CUDA context.
    backend = choose_backend(num_processes, torch.cuda.device_count(), cpu)
    if process_id != 0:
        # Rank 0 hosts the store; every other rank proves it can reach it
        # before committing to the handshake.
        _await_coordinator(coordinator_address, distributed_init_timeout_s)
    try:
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=max(distributed_init_timeout_s, 1.0)),
        )
    except Exception as exc:  # noqa: BLE001 - the typed bring-up surface
        raise DistributedInitError(
            f"init_process_group failed for coordinator {coordinator_address!r} "
            f"(num_processes={num_processes}, process_id={process_id}, "
            f"backend={backend}): {exc}"
        ) from exc
    return True


def shutdown_distributed() -> None:
    """Leaves the process group, if this process joined one."""
    if _group_ready():
        import torch.distributed as dist

        dist.destroy_process_group()


def _flag(argv: list, name: str):
    token = f"--{name}"
    if token in argv:
        i = argv.index(token)
        if i + 1 < len(argv):
            return argv[i + 1]
    for item in argv:
        if item.startswith(token + "="):
            return item.split("=", 1)[1]
    return None


def distributed_config_from_argv(argv=None) -> dict:
    """The bring-up keys of a command line, without the full parser (which
    picks the device, and must run after bring-up): the four flags, over
    the same keys of the ``--name_of_args_json_file`` config. Flags are
    strings, config values as the JSON has them."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config: dict = {}
    cfg_path = _flag(argv, "name_of_args_json_file")
    if cfg_path and cfg_path != "None" and os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                cfg_json = json.load(f)
        except (OSError, ValueError):
            cfg_json = {}
        for key in BRINGUP_KEYS:
            if cfg_json.get(key) is not None:
                config[key] = cfg_json[key]
    for key in BRINGUP_KEYS:
        value = _flag(argv, key)
        if value is not None:
            config[key] = value
    return config


def initialize_distributed_from_argv(argv=None) -> bool:
    """Entry-point bring-up from the command line (and its config's keys);
    ``--device cpu`` puts the ranks on the CPU. Runs before ``get_args``.
    Returns whether the process joined a group."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config = distributed_config_from_argv(argv)
    address = config.get("coordinator_address")
    nprocs = config.get("num_processes")
    pid = config.get("process_id")
    timeout = config.get("distributed_init_timeout_s")
    device = _flag(argv, "device")
    return initialize_distributed(
        coordinator_address=str(address) if address else None,
        # 0 is the parser's default: no fleet asked for.
        num_processes=int(nprocs) if nprocs is not None and int(nprocs) > 0 else None,
        # -1 is the parser's unset default.
        process_id=int(pid) if pid is not None and int(pid) >= 0 else None,
        distributed_init_timeout_s=float(timeout) if timeout is not None else None,
        cpu=str(device or "").startswith("cpu"),
    )

"""Replica flavours the pool supervises, one serving engine each
(``howtotrainyourmamlpytorch_tpu/serve/resilience/replica.py``).

The pool (``serve/pool.py``) talks to the small ``Replica`` surface
(classify, health, promote, rehydrate, terminate), so supervision,
re-dispatch and the circuit breaker are written once, proven on the
in-process flavour and run unchanged on the worker processes:

* ``LocalReplica`` - a whole ``ServingAPI`` in this process; the kill and
  wedge faults (``utils/faultinject.py``) become state changes (dead:
  ``ReplicaDeadError``; wedged: health probes time out), so every recovery
  path is testable without a subprocess;
* ``HttpReplica`` - a client of a replica behind a URL: refused or reset
  connections and timeouts are ``ReplicaDeadError``, so a dropped TCP
  connection is a death to the pool;
* ``SubprocessReplica`` - the production shape: the port's ``serve_maml``
  as a worker process (one engine, its own CUDA context, crash
  isolation), started by fork-and-exec (``subprocess.Popen``, never a
  ``multiprocessing`` fork of a process with CUDA initialised), found
  through a port file and spoken to through ``HttpReplica``.

``serve_adapt``/``serve_classify`` are pure functions of (state, episode),
so a request that died with its replica can be sent to another and get
the same answer; re-dispatch needs no dedup.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

from ...utils import faultinject
from ..errors import OverloadedError, ReplicaDeadError, SwapRejectedError
from .swap import promote_checkpoint

#: The directory that holds the port package: a worker's working
#: directory, so ``python3 -m`` finds it.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


class Replica:
    """The surface the pool supervises. Subclasses raise
    ``ReplicaDeadError`` from any method once the replica is gone."""

    replica_id: str = "?"

    def classify(self, x_support, y_support, x_query, *, timeout: float,
                 tag: str | None = None) -> dict:
        raise NotImplementedError

    def healthz(self, *, timeout: float) -> dict:
        raise NotImplementedError

    def promote(self, checkpoint_path: str) -> dict:
        raise NotImplementedError

    def rehydrate_spill(self, tier_dir: str) -> int:
        """Adopts a dead peer's spill directory (the ring rebalance of
        ``serve/pool.py``); returns the artifacts adopted. The default
        flavour has no durable tier and adopts nothing."""
        return 0

    def terminate(self) -> None:
        raise NotImplementedError


class LocalReplica(Replica):
    """A replica in this process: its own ``ServingAPI`` on this process's
    device."""

    def __init__(self, api, replica_id: str = "local"):
        # ``api`` is a ServingAPI, duck-typed (serve/api.py imports this
        # package).
        self.api = api
        self.replica_id = replica_id
        self._dead = False
        self._wedged = False

    def _consult_faults(self) -> None:
        fault = faultinject.serve_request_fault()
        if fault == "kill":
            self._dead = True
        elif fault == "wedge":
            self._wedged = True

    def classify(self, x_support, y_support, x_query, *, timeout: float,
                 tag: str | None = None) -> dict:
        if self._dead:
            raise ReplicaDeadError(f"replica {self.replica_id} is dead")
        if self._wedged:
            # What the pool would see from a wedged process, without
            # spending ``timeout`` of wall time.
            raise ReplicaDeadError(
                f"replica {self.replica_id} did not answer within {timeout} s")
        self._consult_faults()
        if self._dead:
            raise ReplicaDeadError(
                f"replica {self.replica_id} crashed serving this request")
        # A wedge armed now takes effect after this request: the health
        # probes must find it, as with a process that goes quiet.
        return self.api.classify(x_support, y_support, x_query, timeout=timeout, tag=tag)

    def healthz(self, *, timeout: float) -> dict:
        if self._dead:
            raise ReplicaDeadError(f"replica {self.replica_id} is dead")
        if self._wedged:
            raise TimeoutError(
                f"replica {self.replica_id} health check timed out ({timeout} s)")
        return self.api.healthz()

    def promote(self, checkpoint_path: str) -> dict:
        if self._dead or self._wedged:
            raise ReplicaDeadError(f"replica {self.replica_id} cannot take a promotion")
        result = self.api.batcher.call(
            lambda: promote_checkpoint(self.api.engine, checkpoint_path)).result()
        return {"state_version": result.version,
                "buckets_canaried": len(result.buckets_canaried)}

    def rehydrate_spill(self, tier_dir: str) -> int:
        if self._dead or self._wedged:
            raise ReplicaDeadError(f"replica {self.replica_id} cannot rehydrate")
        return self.api.engine.rehydrate_spill(tier_dir)

    def terminate(self) -> None:
        self._dead = True
        self.api.close()


class HttpReplica(Replica):
    """Client of a replica behind a URL. A refused or reset connection, a
    timeout or a hang-up mid-answer all mean one thing to the pool: this
    replica cannot answer (``ReplicaDeadError``)."""

    def __init__(self, base_url: str, replica_id: str = "http"):
        self.base_url = base_url.rstrip("/")
        self.replica_id = replica_id

    def _request(self, path: str, payload: dict | None, timeout: float) -> dict:
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as exc:
            body = {}
            try:
                body = json.load(exc)
            except Exception:
                pass
            detail = body.get("error", str(exc))
            if exc.code == 503:
                raise OverloadedError(
                    f"replica {self.replica_id}: {detail}",
                    retry_after_s=float(exc.headers.get("Retry-After", 1.0)),
                ) from None
            if exc.code == 409:
                raise SwapRejectedError(f"replica {self.replica_id}: {detail}",
                                        reason=body.get("reason", "canary")) from None
            if 400 <= exc.code < 500:
                raise ValueError(f"replica {self.replica_id}: {detail}") from None
            raise ReplicaDeadError(
                f"replica {self.replica_id} answered {exc.code}: {detail}") from None
        except (urllib.error.URLError, ConnectionError, OSError) as exc:
            raise ReplicaDeadError(f"replica {self.replica_id} unreachable: {exc}") from exc

    def classify(self, x_support, y_support, x_query, *, timeout: float,
                 tag: str | None = None) -> dict:
        payload = {
            "support": np.asarray(x_support).tolist(),
            "support_labels": np.asarray(y_support).tolist(),
            "query": np.asarray(x_query).tolist(),
        }
        if tag is not None:
            payload["tag"] = str(tag)
        return self._request("/v1/episode", payload, timeout)

    def healthz(self, *, timeout: float) -> dict:
        try:
            return self._request("/healthz", None, timeout)
        except OverloadedError as exc:
            # 503 from /healthz: alive, still warming; health data, not
            # a death.
            return {"status": "unready", "ready": False, "detail": str(exc)}

    def promote(self, checkpoint_path: str) -> dict:
        return self._request("/admin/promote", {"checkpoint": checkpoint_path},
                             timeout=600.0)

    def terminate(self) -> None:  # nothing owned: the URL outlives the client
        pass


class SubprocessReplica(Replica):
    """A worker process running the port's ``serve_maml`` (in the directory
    that holds the package), announced through a port file and driven
    through :class:`HttpReplica`; its output goes to ``log_path``.
    ``terminate`` ends it: SIGTERM, then SIGKILL after ``TERMINATE_GRACE_S``
    (a wedged worker must not keep its CUDA context)."""

    TERMINATE_GRACE_S = 10.0

    def __init__(self, argv: list[str], *, replica_id: str = "proc",
                 env: dict | None = None, startup_timeout_s: float = 120.0,
                 port_file: str, log_path: str | None = None):
        self.replica_id = replica_id
        self._port_file = port_file
        log = open(log_path, "ab") if log_path else subprocess.DEVNULL
        try:
            self._proc = subprocess.Popen(argv, env=env, cwd=_REPO_ROOT,
                                          stdout=log, stderr=subprocess.STDOUT)
        finally:
            if log_path:
                log.close()
        self._http: HttpReplica | None = None
        self._startup_deadline = time.monotonic() + startup_timeout_s

    @property
    def pid(self) -> int:
        return self._proc.pid

    @property
    def returncode(self) -> int | None:
        return self._proc.poll()

    def _endpoint(self, timeout: float) -> HttpReplica:
        """The worker's client, once its port file names a port (blocking
        until then, or until the startup budget runs out)."""
        if self._http is not None:
            return self._http
        deadline = min(self._startup_deadline, time.monotonic() + timeout)
        while True:
            if self._proc.poll() is not None:
                raise ReplicaDeadError(
                    f"replica {self.replica_id} exited rc={self._proc.returncode} "
                    "before binding a port")
            try:
                with open(self._port_file) as f:
                    port = int(f.read().strip())
                self._http = HttpReplica(f"http://127.0.0.1:{port}",
                                         replica_id=self.replica_id)
                return self._http
            except (OSError, ValueError):
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.05)
        raise ReplicaDeadError(
            f"replica {self.replica_id} did not announce a port within its startup budget")

    def _check_process(self) -> None:
        if self._proc.poll() is not None:
            raise ReplicaDeadError(
                f"replica {self.replica_id} process exited rc={self._proc.returncode}")

    def classify(self, x_support, y_support, x_query, *, timeout: float,
                 tag: str | None = None) -> dict:
        self._check_process()
        return self._endpoint(timeout).classify(x_support, y_support, x_query,
                                                timeout=timeout, tag=tag)

    def healthz(self, *, timeout: float) -> dict:
        self._check_process()
        try:
            # No wait for the port file: the probes run one after another,
            # and a booting worker must not hold up the others'.
            endpoint = self._endpoint(0.0)
        except ReplicaDeadError:
            if self._proc.poll() is None and time.monotonic() < self._startup_deadline:
                # Alive and still starting (imports, the card, warmup):
                # not ready, not dead.
                return {"status": "starting", "ready": False}
            raise
        return endpoint.healthz(timeout=timeout)

    def promote(self, checkpoint_path: str) -> dict:
        self._check_process()
        return self._endpoint(60.0).promote(checkpoint_path)

    def terminate(self) -> None:
        if self._proc.poll() is None:
            self._proc.send_signal(signal.SIGTERM)
            try:
                self._proc.wait(timeout=self.TERMINATE_GRACE_S)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=30)
        try:
            os.remove(self._port_file)
        except OSError:
            pass


def serve_maml_argv(config_path: str, *, port_file: str, checkpoint: str | None = None,
                    learner: str = "maml", warmup: str = "", telemetry: str | None = None,
                    max_batch: int = 4, max_wait_ms: float = 2.0,
                    cache_capacity: int | None = None, max_queue_depth: int | None = None,
                    degrade_queue_depth: int | None = None,
                    max_queue_age_ms: float | None = None,
                    retry_after_s: float | None = None, tier_dir: str | None = None,
                    device: str | None = None, debug_kernels: bool = False,
                    train_flags=()) -> list[str]:
    """The argv of one worker: ``python3 -m
    howtotrainyourmamlpytorch_tpu_torch.serve_maml`` on an ephemeral port
    named in ``port_file``. The cache and admission limits are passed when
    given (``None`` keeps the worker's default), so a pool never drops the
    operator's limits; ``device`` is passed only when named (the CPU
    tests), so on a card the worker takes the card; ``debug_kernels``
    serves ``GET /debug/kernels``; ``train_flags`` go to the training
    parser (``--use_pallas_fused_norm True``)."""
    argv = [
        sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve_maml",
        "--config", os.path.abspath(config_path),
        "--port", "0",
        "--port_file", os.path.abspath(port_file),
        "--learner", learner,
        "--max_batch", str(max_batch),
        "--max_wait_ms", str(max_wait_ms),
    ]
    for flag, value in (
        ("--cache_capacity", cache_capacity),
        ("--max_queue_depth", max_queue_depth),
        ("--degrade_queue_depth", degrade_queue_depth),
        ("--max_queue_age_ms", max_queue_age_ms),
        ("--retry_after_s", retry_after_s),
    ):
        if value is not None:
            argv += [flag, str(value)]
    if warmup:
        argv += ["--warmup", warmup]
    if telemetry:
        argv += ["--telemetry", os.path.abspath(telemetry)]
    if tier_dir:
        argv += ["--tier_dir", os.path.abspath(tier_dir)]
    if device:
        argv += ["--device", str(device)]
    if debug_kernels:
        argv += ["--debug_kernels"]
    if checkpoint:
        argv += ["--checkpoint", os.path.abspath(checkpoint)]
    else:
        argv += ["--init_from_scratch"]
    return argv + list(train_flags)

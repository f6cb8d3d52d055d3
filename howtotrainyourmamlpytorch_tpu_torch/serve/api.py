"""Serving front doors: the in-process ``ServingAPI`` and the stdlib HTTP
server over it (``howtotrainyourmamlpytorch_tpu/serve/api.py``).

``ServingAPI`` puts the engine, the micro-batcher, the cache, admission
control and the metrics behind one synchronous ``classify``. The HTTP
front door is a minimal ``http.server`` over it or over a
``serve/pool.ReplicaPool``, which has the same surface::

    POST /v1/episode     {"support": [...], "support_labels": [...],
                          "query": [...], "tag": optional}
                         -> 200 {"logits", "predictions", "cache_hit",
                                 "bucket", "coarsened", "state_version"}
                         -> 503 + Retry-After when shed, 503 on a deadline,
                            400 on a malformed episode (with
                            "geometry_rejected" when no bucket holds it)
    POST /admin/promote  {"checkpoint": "<path>"}: verify, canary, publish;
                         409 on rejection, the old state still serving
    POST /admin/scale    {"pool_size": n}: ``ReplicaPool.resize(n)``; 409 on
                         a single engine
    GET  /healthz        200 once warmed or once an episode was answered,
                         503 with "ready": false before
    GET  /metrics        Prometheus text (serve/metrics.py)
    GET  /debug/kernels  the fused-norm kernels' launch counts and shapes
                         (``ops/fused_norm.launch_record``), served only by
                         a server built with ``debug_kernels=True``

Handler threads touch no tensor: every dispatch, promotion and raw swap
runs on the batcher's worker thread. A server over one engine is a
replica: it consults the serve faults on each episode, leaving the
process with ``os._exit(REPLICA_KILL_EXIT)`` under
``replica_kill_at_request`` and stalling every handler under
``wedge_replica_at_request``; a pool's front door passes them to its
replicas.
"""

from __future__ import annotations

import json
import os
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..ops import fused_norm
from ..telemetry import events as telemetry_events
from ..utils import faultinject
from .batcher import MicroBatcher
from .engine import ServeConfig, ServingEngine
from .errors import DeadlineExceededError, OverloadedError, SwapRejectedError
from .geometry import GeometryRejectedError
from .metrics import ServeMetrics
from .resilience.admission import AdmissionController
from .resilience.swap import promote_checkpoint, promote_state

#: Cap on a request body (64 MB of JSON is about 200 84x84x3 images).
MAX_BODY_BYTES = 64 * 1024 * 1024

#: Exit code of a worker killed by the ``replica_kill_at_request`` fault,
#: told apart from a real crash in the pool's logs.
REPLICA_KILL_EXIT = 86

#: How long a wedged handler stalls: every client and supervisor timeout
#: fires first.
_WEDGE_STALL_S = 3600.0


class ServingAPI:
    """In-process few-shot serving against one loaded state, behind
    admission control; on the card unless ``device`` says otherwise."""

    def __init__(self, learner, state, config: ServeConfig | None = None,
                 device=None):
        self.metrics = ServeMetrics()
        self.engine = ServingEngine(
            learner, state, config=config, metrics=self.metrics, device=device
        )
        self.batcher = MicroBatcher(self.engine)
        self.admission = AdmissionController(self.engine.config, self.metrics)
        self.started_at = time.time()
        self._closed = False

    def classify(self, x_support, y_support, x_query, *,
                 timeout: float | None = 30.0, tag: str | None = None) -> dict:
        """Adapts to the support set and classifies the queries: ``logits``
        ``(Q, num_classes)`` float32, ``predictions``, ``cache_hit``,
        ``bucket``, ``coarsened`` and ``state_version``. Raises
        ``ValueError`` on a malformed episode, ``OverloadedError`` when
        shed and ``DeadlineExceededError`` (a ``TimeoutError``) when
        ``timeout`` runs out; the budget rides the episode as a deadline,
        so an expired request is dropped from the queue."""
        t0 = time.perf_counter()
        # Counted when offered: a server failing every request must not
        # look idle.
        self.metrics.requests_total.inc()
        try:
            episode = self.engine.prepare_episode(x_support, y_support, x_query, tag=tag)
            cache_hit = episode.digest in self.engine.cache
            self.admission.admit(
                queue_depth=self.batcher.queue_depth(),
                oldest_age_s=self.batcher.oldest_pending_age_s(),
                cache_hit=cache_hit,
            )
            if timeout is not None:
                episode.deadline = time.monotonic() + float(timeout)
            future = self.batcher.submit(episode)
            try:
                logits = future.result(timeout=timeout)
            except DeadlineExceededError:
                raise  # failed and counted by the batcher
            except futures.TimeoutError:
                future.cancel()
                self.metrics.deadline_exceeded_total.inc()
                raise DeadlineExceededError(
                    f"dispatch exceeded the {timeout} s deadline"
                ) from None
        except Exception:
            self.metrics.request_errors.inc()
            raise
        self.metrics.request_latency.observe((time.perf_counter() - t0) * 1e3)
        return {
            "logits": logits,
            "predictions": np.argmax(logits, axis=-1),
            "cache_hit": cache_hit,
            "bucket": "x".join(str(d) for d in episode.bucket),
            "coarsened": episode.coarsened,
            "state_version": self.engine.state_version,
        }

    def warmup(self, buckets=None) -> None:
        """``ServingEngine.warmup`` on the worker thread, which then holds
        the cuDNN and cuBLAS handles the first request would otherwise
        create."""
        self.batcher.call(lambda: self.engine.warmup(buckets)).result()

    def update_state(self, state) -> int:
        """Raw hot swap (no canary), on the worker thread; ``promote`` is
        the safe path."""
        return self.batcher.call(lambda: self.engine.update_state(state)).result()

    def promote(self, checkpoint_path=None, *, state=None, buckets=None) -> dict:
        """Safe hot swap (``serve/resilience/swap.py``) of a checkpoint
        file or an in-memory state, on the worker thread. Raises
        ``SwapRejectedError`` with the old state still serving."""
        if (checkpoint_path is None) == (state is None):
            raise ValueError("promote takes exactly one of checkpoint_path or state")
        if checkpoint_path is not None:
            work = lambda: promote_checkpoint(  # noqa: E731
                self.engine, checkpoint_path, buckets=buckets)
        else:
            work = lambda: promote_state(  # noqa: E731
                self.engine, state, buckets=buckets)
        result = self.batcher.call(work).result()
        return {
            "state_version": result.version,
            "buckets_canaried": len(result.buckets_canaried),
            "source": result.source,
        }

    def healthz(self) -> dict:
        """Readiness, degradation, queue depth and age, last-dispatch age,
        this process's fused-norm launches and their shapes, and the
        durable tier's counters when there is one."""
        queue_depth = self.batcher.queue_depth()
        oldest_age_s = self.batcher.oldest_pending_age_s()
        ready = self.engine.ready
        degraded = self.admission.degraded(queue_depth, oldest_age_s)
        status = "unready" if not ready else "degraded" if degraded else "ok"
        tier = self.engine.tier_stats()
        return {
            "status": status,
            "ready": ready,
            "degraded": degraded,
            "family": self.engine.family,
            "state_version": self.engine.state_version,
            "checkpoint_digest": self.engine.published_digest,
            "uptime_s": time.time() - self.started_at,
            "episodes_served": self.metrics.episodes_served.value,
            "queue_depth": queue_depth,
            "oldest_pending_age_s": round(oldest_age_s, 4),
            "last_dispatch_age_s": round(self.batcher.last_dispatch_age_s(), 4),
            "shed_total": self.metrics.shed_total.value,
            "warmed_buckets": [
                "x".join(str(d) for d in b) for b in self.engine.warmed_buckets()
            ],
            **({} if tier is None else {"tier": tier}),
        }

    def stats(self) -> dict:
        return self.metrics.snapshot(
            queue_depth=self.batcher.queue_depth(),
            compile_table=self.engine.compile_table(),
        )

    def metrics_text(self) -> str:
        return self.metrics.render_prometheus(
            queue_depth=self.batcher.queue_depth(),
            compile_table=self.engine.compile_table(),
        )

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.batcher.close()
            self.engine.close()


class _Handler(BaseHTTPRequestHandler):
    """Routes requests onto the bound ``ServingAPI`` or ``ReplicaPool``."""

    api: ServingAPI
    #: True when this server is a replica (one engine): the kill and wedge
    #: faults fire here, never at a pool's front door.
    consult_faults = True
    #: True when ``GET /debug/kernels`` is served.
    debug_kernels = False
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        pass

    def _stalled(self) -> bool:
        """The wedge: a live worker that answers nothing, as a process
        stuck in the GIL or on the device looks to its clients."""
        if getattr(self.server, "wedged", False):
            time.sleep(_WEDGE_STALL_S)
            return True
        return False

    def _send(self, code: int, body: bytes, content_type: str,
              extra_headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict,
                   extra_headers: dict | None = None) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json",
                   extra_headers)

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        if self._stalled():
            return
        if self.path == "/healthz":
            payload = self.api.healthz()
            self._send_json(200 if payload.get("ready") else 503, payload)
        elif self.path == "/metrics":
            self._send(200, self.api.metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/debug/kernels" and self.debug_kernels:
            self._send_json(200, fused_norm.launch_record())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _read_body(self) -> dict | None:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > MAX_BODY_BYTES:
            self._send_json(413 if length > MAX_BODY_BYTES else 400,
                            {"error": f"bad Content-Length {length}"})
            return None
        return json.loads(self.rfile.read(length))

    def do_POST(self) -> None:  # noqa: N802 (stdlib casing)
        if self._stalled():
            return
        routes = {"/v1/episode": self._post_episode,
                  "/admin/promote": self._post_promote,
                  "/admin/scale": self._post_scale}
        route = routes.get(self.path)
        if route is None:
            self._send_json(404, {"error": f"no route {self.path}"})
        else:
            route()

    def _post_episode(self) -> None:
        if self.consult_faults:
            fault = faultinject.serve_request_fault()
            if fault is not None:
                telemetry_events.emit("serve_fault", fault=fault)
            if fault == "kill":
                # A crash: no answer, no clean-up; the pool sees the
                # connection drop.
                os._exit(REPLICA_KILL_EXIT)
            if fault == "wedge":
                self.server.wedged = True
                if self._stalled():
                    return
        try:
            payload = self._read_body()
            if payload is None:
                return
            result = self.api.classify(
                payload["support"], payload["support_labels"], payload["query"],
                tag=payload.get("tag"),
            )
        except OverloadedError as exc:
            self._send_json(503, {"error": str(exc), "shed": True},
                            {"Retry-After": f"{exc.retry_after_s:g}"})
            return
        except GeometryRejectedError as exc:
            # A shape no bucket holds: a client error, not overload (no
            # Retry-After, no shed flag).
            self._send_json(400, {"error": str(exc), "geometry_rejected": True})
            return
        except (KeyError, ValueError, TypeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except TimeoutError as exc:
            self._send_json(503, {"error": f"dispatch timed out: {exc}"})
            return
        except Exception as exc:  # a failed dispatch: visible, not a hang
            self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._send_json(200, {
            "logits": np.asarray(result["logits"]).tolist(),
            "predictions": np.asarray(result["predictions"]).tolist(),
            "cache_hit": bool(result["cache_hit"]),
            "bucket": result["bucket"],
            "coarsened": bool(result["coarsened"]),
            "state_version": result["state_version"],
        })

    def _post_promote(self) -> None:
        try:
            payload = self._read_body()
            if payload is None:
                return
            result = self.api.promote(payload["checkpoint"])
        except SwapRejectedError as exc:
            self._send_json(409, {"error": str(exc), "reason": exc.reason})
            return
        except (KeyError, ValueError, TypeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except Exception as exc:
            self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._send_json(200, result)

    def _post_scale(self) -> None:
        """``{"pool_size": n}`` -> ``ReplicaPool.resize(n)``; 409 on a single
        engine, so an autoscaler pointed at one fails loudly."""
        try:
            payload = self._read_body()
            if payload is None:
                return
            if not getattr(self.api, "is_replica_pool", False):
                self._send_json(409, {"error": "serving tier is not a replica "
                                               "pool; /admin/scale needs one"})
                return
            result = self.api.resize(int(payload["pool_size"]))
        except (KeyError, ValueError, TypeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except Exception as exc:
            self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._send_json(200, result)


def make_http_server(api, host: str = "127.0.0.1", port: int = 0,
                     debug_kernels: bool = False) -> ThreadingHTTPServer:
    """Builds (does not start) the HTTP server over a ``ServingAPI`` or a
    ``ReplicaPool``; ``port=0`` binds an ephemeral port
    (``server.server_address``). Run it with ``serve_forever()``.
    ``debug_kernels`` adds ``GET /debug/kernels``."""
    handler = type("BoundServeHandler", (_Handler,), {
        "api": api,
        "consult_faults": not getattr(api, "is_replica_pool", False),
        "debug_kernels": debug_kernels,
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.wedged = False
    return server

"""Serving front doors: the in-process ``ServingAPI`` and the stdlib HTTP
server over it (``howtotrainyourmamlpytorch_tpu/serve/api.py``).

``ServingAPI`` puts the engine, the micro-batcher, the cache, admission
control and the metrics behind one synchronous ``classify``. The HTTP
front door is a minimal ``http.server`` over the same object::

    POST /v1/episode     {"support": [...], "support_labels": [...],
                          "query": [...], "tag": optional}
                         -> 200 {"logits", "predictions", "cache_hit",
                                 "bucket", "coarsened", "state_version"}
                         -> 503 + Retry-After when shed, 503 on a deadline,
                            400 on a malformed episode (with
                            "geometry_rejected" when no bucket holds it)
    POST /admin/promote  {"checkpoint": "<path>"}: verify, canary, publish;
                         409 on rejection, the old state still serving
    POST /admin/scale    409: a single engine, not a replica pool (the pool
                         is ROADMAP A11)
    GET  /healthz        200 once warmed or once an episode was answered,
                         503 with "ready": false before
    GET  /metrics        Prometheus text (serve/metrics.py)

Handler threads touch no tensor: every dispatch, promotion and raw swap
runs on the batcher's worker thread.
"""

from __future__ import annotations

import json
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import MicroBatcher
from .engine import ServeConfig, ServingEngine
from .errors import DeadlineExceededError, OverloadedError, SwapRejectedError
from .geometry import GeometryRejectedError
from .metrics import ServeMetrics
from .resilience.admission import AdmissionController
from .resilience.swap import promote_checkpoint, promote_state

#: Cap on a request body (64 MB of JSON is about 200 84x84x3 images).
MAX_BODY_BYTES = 64 * 1024 * 1024


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
        """Readiness, degradation, queue depth and age, last-dispatch age."""
        queue_depth = self.batcher.queue_depth()
        oldest_age_s = self.batcher.oldest_pending_age_s()
        ready = self.engine.ready
        degraded = self.admission.degraded(queue_depth, oldest_age_s)
        status = "unready" if not ready else "degraded" if degraded else "ok"
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


class _Handler(BaseHTTPRequestHandler):
    """Routes requests onto the bound ``ServingAPI``."""

    api: ServingAPI
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        pass

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
        if self.path == "/healthz":
            payload = self.api.healthz()
            self._send_json(200 if payload.get("ready") else 503, payload)
        elif self.path == "/metrics":
            self._send(200, self.api.metrics_text().encode(),
                       "text/plain; version=0.0.4")
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
        routes = {"/v1/episode": self._post_episode,
                  "/admin/promote": self._post_promote,
                  "/admin/scale": self._post_scale}
        route = routes.get(self.path)
        if route is None:
            self._send_json(404, {"error": f"no route {self.path}"})
        else:
            route()

    def _post_episode(self) -> None:
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
        """409: only a replica pool scales (ROADMAP A11), so an autoscaler
        pointed at one engine fails loudly."""
        try:
            if self._read_body() is None:
                return
        except (ValueError, TypeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        self._send_json(409, {"error": "serving tier is not a replica pool; "
                                       "/admin/scale needs one"})


def make_http_server(api: ServingAPI, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Builds (does not start) the HTTP server over ``api``; ``port=0``
    binds an ephemeral port (``server.server_address``). Run it with
    ``serve_forever()``."""
    handler = type("BoundServeHandler", (_Handler,), {"api": api})
    return ThreadingHTTPServer((host, port), handler)

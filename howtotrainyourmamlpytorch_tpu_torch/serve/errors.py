"""Typed serving failures (``howtotrainyourmamlpytorch_tpu/serve/errors.py``).

Callers branch on the type, never on the message: the HTTP front door
maps ``OverloadedError`` to 503 with ``Retry-After``,
``DeadlineExceededError`` to 503 and ``SwapRejectedError`` to 409.
``DeadlineExceededError`` is also a builtin ``TimeoutError``, so code that
catches ``TimeoutError`` keeps working.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class of the serving runtime's typed failures."""


class OverloadedError(ServeError):
    """Admission control shed the request (queue depth or age past its
    limits). Clients back off ``retry_after_s``."""

    def __init__(self, message: str, *, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class NoHealthyReplicaError(OverloadedError):
    """No healthy replica to dispatch to. Raised by the replica pool,
    which is ROADMAP A11; kept so that callers can name the type."""


class DeadlineExceededError(ServeError, TimeoutError):
    """The request's deadline ran out, in the caller's wait or in the
    batcher's queue before dispatch (the work is dropped, not run)."""


class DispatchFailedError(ServeError):
    """The batcher's engine dispatch failed for this request's group. The
    worker thread lives on and keeps serving; the engine's exception is
    the ``__cause__``."""


class ReplicaDeadError(ServeError):
    """A pool replica crashed or refused the dispatch (the pool is ROADMAP
    A11)."""


class SwapRejectedError(ServeError):
    """A promotion failed verification (corrupt or incompatible checkpoint,
    non-finite canary logits). The previous state is still serving."""

    def __init__(self, message: str, *, reason: str = "canary"):
        super().__init__(message)
        self.reason = reason

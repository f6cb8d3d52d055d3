"""Safe hot swap: verify, canary, then publish
(``howtotrainyourmamlpytorch_tpu/serve/resilience/swap.py``).

``ServingEngine.update_state`` publishes whatever it is given. A
promotion puts every candidate through three gates before the version
moves:

1. the checkpoint's integrity (manifest, per-leaf CRCs) and its fit to
   the served architecture, both checked by ``utils/checkpoint``'s
   ``load_for_inference`` under the learner's ``load_inference_state``;
2. one synthetic canary episode per warmed bucket against the candidate
   state, every logit finite;
3. the atomic publish.

A rejection leaves the old state serving, bit for bit: the only traces are
``swap_rejected_total`` and a ``swap_rejected`` event. Callers get
``SwapRejectedError`` (409 at the HTTP front door). The ``corrupt_swap_at``
fault truncates the checkpoint right before gate 1 reads it, and
``nan_next_logits`` poisons the canary's logits before gate 2.
"""

from __future__ import annotations

import dataclasses

from ...telemetry import events as telemetry_events
from ...utils import faultinject
from ...utils.checkpoint import CheckpointError, checkpoint_digest
from ..engine import ServingEngine
from ..errors import SwapRejectedError


@dataclasses.dataclass(frozen=True)
class SwapResult:
    """An accepted promotion."""

    version: int
    buckets_canaried: tuple[tuple[int, int, int], ...]
    source: str


def _reject(engine: ServingEngine, source: str, reason: str, detail: str) -> None:
    engine.metrics.swap_rejected_total.inc()
    telemetry_events.emit("swap_rejected", source=source, reason=reason,
                          detail=detail, state_version=engine.state_version)


def promote_state(engine: ServingEngine, state, *, buckets=None,
                  source: str = "<in-memory>") -> SwapResult:
    """Canaries ``state`` on the engine's device and publishes it; raises
    ``SwapRejectedError`` with the old state still serving."""
    candidate = engine.device_istate(state)
    try:
        probed = engine.canary_probe(candidate, buckets)
    except SwapRejectedError as exc:
        _reject(engine, source, exc.reason, str(exc))
        raise
    version = engine.update_state(candidate)
    engine.metrics.swaps_total.inc()
    telemetry_events.emit("swap_promoted", source=source, state_version=version,
                          buckets=["x".join(str(d) for d in b) for b in probed])
    return SwapResult(version=version, buckets_canaried=tuple(probed), source=source)


def promote_checkpoint(engine: ServingEngine, checkpoint_path: str, *,
                       buckets=None) -> SwapResult:
    """Verifies and loads ``checkpoint_path``, then :func:`promote_state`.
    Every rejection is a ``SwapRejectedError`` (``corrupt_checkpoint``,
    ``incompatible_checkpoint`` or the canary's reason) with the typed
    checkpoint error as its ``__cause__``."""
    faultinject.swap_checkpoint_loading(checkpoint_path)
    try:
        state, _ = engine.learner.load_inference_state(
            checkpoint_path, device=engine.device
        )
    except CheckpointError as exc:
        _reject(engine, checkpoint_path, "corrupt_checkpoint", str(exc))
        raise SwapRejectedError(
            f"checkpoint failed integrity verification: {exc}",
            reason="corrupt_checkpoint",
        ) from exc
    except ValueError as exc:
        _reject(engine, checkpoint_path, "incompatible_checkpoint", str(exc))
        raise SwapRejectedError(
            f"checkpoint does not match the served architecture: {exc}",
            reason="incompatible_checkpoint",
        ) from exc
    result = promote_state(engine, state, buckets=buckets, source=checkpoint_path)
    engine.published_digest = checkpoint_digest(checkpoint_path)
    engine.published_source = checkpoint_path
    return result

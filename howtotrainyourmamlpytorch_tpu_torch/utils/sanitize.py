"""Runtime sanitizers: the capture guard and ``--debug_nans``
(``howtotrainyourmamlpytorch_tpu/utils/sanitize.py``).

The JAX package's ``compile_guard`` counts XLA compiles. The port's train
step does not compile; it is captured as a CUDA graph per
``(second_order, final_only)`` branch and batch shape and dtype
(``models/step_graph.py``). :func:`capture_guard` counts those captures by
class, and a steady loop must capture each class exactly once::

    with capture_guard() as guard:
        for _ in range(5):
            state, _ = learner.run_train_iters(state, batches, epoch=0)
    guard.assert_captures_once()

``--debug_nans`` (``set_debug_nans``, from ``utils/parser_utils.get_args``)
is the port's ``jax_debug_nans``: the train step then runs eagerly, with no
graph, and :func:`nan_checks` (which the experiment builder enters around a
run) raises ``FloatingPointError`` at the first operation, forward or
backward, whose output holds a NaN, naming it; the backward also runs under
``torch.autograd.detect_anomaly(check_nan=True)``, which adds the forward
trace of the failing backward operation. It reads every output on the host
and is for finding a NaN, not for training.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves


class RecaptureError(AssertionError):
    """A graph class was captured more often than its budget."""


@dataclass
class CaptureGuard:
    """The captures seen while active; a class is ``(second_order,
    final_only, ((shape, dtype), ...))``."""

    events: list = field(default_factory=list)

    def count(self, second_order=None, final_only=None) -> int:
        """Captures of the branch (either field None: any)."""
        return sum(1 for key in self.events
                   if (second_order is None or key[0] == second_order)
                   and (final_only is None or key[1] == final_only))

    def classes(self) -> Counter:
        return Counter(self.events)

    def assert_captures(self, exactly: int, second_order=None, final_only=None) -> None:
        found = self.count(second_order, final_only)
        if found != exactly:
            raise RecaptureError(
                f"expected exactly {exactly} capture(s) of branch "
                f"(second_order={second_order}, final_only={final_only}), "
                f"observed {found}: {self.events}"
            )

    def assert_captures_once(self) -> None:
        """No class captured twice."""
        twice = {key: n for key, n in self.classes().items() if n > 1}
        if twice:
            raise RecaptureError(f"graph classes captured more than once: {twice}")


@contextlib.contextmanager
def capture_guard():
    """Yields a :class:`CaptureGuard` recording every step-graph capture in
    the block."""
    from ..models import step_graph

    guard = CaptureGuard()

    def record(key, steps):
        guard.events.append(key)
        return contextlib.nullcontext()

    step_graph.warmup_hooks.append(record)
    try:
        yield guard
    finally:
        step_graph.warmup_hooks.remove(record)


# ---------------------------------------------------------------------------
# --debug_nans
# ---------------------------------------------------------------------------

_debug_nans = False


def set_debug_nans(enabled: bool) -> None:
    global _debug_nans
    _debug_nans = bool(enabled)


def debug_nans_enabled() -> bool:
    return _debug_nans


class _NanCheckMode(TorchDispatchMode):
    """Raises at the first operation whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for value in _pytree_leaves(out):
            if (isinstance(value, torch.Tensor) and value.is_floating_point()
                    and value.numel() and bool(torch.isnan(value).any())):
                raise FloatingPointError(
                    f"debug_nans: {func} produced a NaN (output shape "
                    f"{tuple(value.shape)})"
                )
        return out


@contextlib.contextmanager
def nan_checks(enabled: bool | None = None):
    """The NaN checks of ``--debug_nans`` on this thread for the block
    (``enabled`` None: as ``set_debug_nans`` left it); nothing otherwise."""
    if not (debug_nans_enabled() if enabled is None else enabled):
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True), _NanCheckMode():
        yield

"""``models.step_graph.collector_paused``, the guard around every capture,
on the CPU: no automatic collection runs inside it, however much the block
allocates, and the collector's state is restored on the way out."""

import gc
import weakref

import pytest

from howtotrainyourmamlpytorch_tpu_torch.models.step_graph import collector_paused


class _Node:
    pass


def _cycle():
    """A weak reference to an object only a reference cycle holds."""
    node = _Node()
    node.self = node
    return weakref.ref(node)


def test_no_collection_runs_inside_and_the_garbage_goes_after():
    thresholds = gc.get_threshold()
    gc.set_threshold(10)
    try:
        with collector_paused():
            assert not gc.isenabled()
            gone = _cycle()
            churn = [[i] for i in range(10_000)]  # far past the threshold
            assert gone() is not None
        del churn
        assert gc.isenabled()
        gc.collect()
        assert gone() is None
    finally:
        gc.set_threshold(*thresholds)


def test_the_collector_is_restored_when_the_block_raises():
    with pytest.raises(RuntimeError):
        with collector_paused():
            raise RuntimeError("capture failed")
    assert gc.isenabled()


def test_a_paused_collector_stays_paused():
    gc.disable()
    try:
        with collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()

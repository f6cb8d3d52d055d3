"""The port's hang watchdog and anomaly detectors against the JAX
package's (``utils/watchdog.py``, ``telemetry/anomaly.py``), on one
seeded stream of window lengths read through a fake clock: the deadline
after every window, and every anomaly event, are equal. The port also
leaves out of the deadline statistics every window in which the learner
captured a CUDA graph (``capture_count``), which JAX, with one compile,
does only for the first; that is its own case. A firing dumps the stacks,
emits the ``hang`` event with the JAX fields and exits with 76."""

import threading
import time

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.telemetry import anomaly as janomaly
from howtotrainyourmamlpytorch_tpu.utils import watchdog as jwatchdog
from howtotrainyourmamlpytorch_tpu_torch.telemetry import anomaly, events
from howtotrainyourmamlpytorch_tpu_torch.utils import watchdog


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _windows(seed=0, n=300):
    """Window lengths: a long first one, steady steps with jitter, a few
    stragglers."""
    rng = np.random.RandomState(seed)
    steps = 0.04 + 0.005 * rng.rand(n)
    steps[0] = 30.0
    steps[rng.choice(np.arange(1, n), 6, replace=False)] *= 40
    return steps


def _deadlines(module, windows, captured=(), factor=20.0, **kw):
    clock = FakeClock()
    count = [0]
    if module is watchdog:
        kw["capture_count"] = lambda: count[0]
    wd = module.DispatchWatchdog(min_deadline_s=1e9, factor=factor, clock=clock,
                                 exit_fn=lambda code: None, **kw)
    out = []
    try:
        for i, length in enumerate(windows):
            with wd.armed(i):
                clock.t += length
                if i in captured:
                    count[0] += 1
            wd.min_deadline_s = 0.01  # read the factor x p95 part
            out.append(wd.deadline_s())
            wd.min_deadline_s = 1e9
    finally:
        wd.close()
    return out


def test_deadlines_follow_the_jax_watchdog():
    windows = _windows()
    assert _deadlines(watchdog, windows) == _deadlines(jwatchdog, windows)


def test_windows_that_captured_stay_out_of_the_deadline():
    """Captures at windows 0 (the first dispatch), 40 (the MSL horizon's
    final-only branch) and 41: the port's deadlines are JAX's over the
    stream without those windows, and no sample of a capture moves them."""
    windows = _windows(seed=1)
    windows[40], windows[41] = 3.35, 0.65  # the captures' seconds (PERF.md)
    got = _deadlines(watchdog, windows, captured={0, 40, 41})
    keep = [w for i, w in enumerate(windows) if i not in (40, 41)]
    want = _deadlines(jwatchdog, keep)
    assert got[:40] == want[:40] and got[42:] == want[40:]
    assert got[40] == got[41] == got[39]


def test_anomaly_events_follow_the_jax_detector():
    rng = np.random.RandomState(2)
    port, jax_ = anomaly.RollingAnomalyDetector(), janomaly.RollingAnomalyDetector()
    for i, value in enumerate(_windows(seed=2, n=400)):
        kind = ("step_time", "data_wait", "stage_wait")[i % 3]
        assert port.observe(kind, value) == jax_.observe(kind, value), i
    assert port.reports == jax_.reports > 0
    mem, jmem = anomaly.MemoryGrowthDetector(), janomaly.MemoryGrowthDetector()
    level = 1 << 30
    for _ in range(60):
        level += int(rng.choice([0, 1, 40]) << 20)
        assert mem.observe(level) == jmem.observe(level)
    assert mem.reports == jmem.reports > 0


def test_a_hang_dumps_stacks_emits_the_event_and_exits_76(tmp_path):
    log = events.EventLog(str(tmp_path / "events.jsonl"))
    previous = events.install(log)
    exited, unwound = threading.Event(), []
    codes = []

    def exit_fn(code):
        codes.append(code)
        exited.set()

    wd = watchdog.DispatchWatchdog(min_deadline_s=0.2, logs_dir=str(tmp_path),
                                   on_hang=unwound.append, exit_fn=exit_fn,
                                   identity={"process_index": 0, "process_count": 1})
    try:
        with wd.armed(7):
            assert exited.wait(10.0)
    finally:
        wd.close()
        events.install(previous)
    log.flush()
    assert codes == [watchdog.HANG_EXIT_CODE] == [jwatchdog.HANG_EXIT_CODE]
    assert wd.fired and unwound and unwound[0]["iter"] == 7
    text = (tmp_path / "hang_stacks.txt").read_text()
    assert "dispatch hang at iteration 7" in text and "MainThread" in text
    (hang,) = [e for e in events.read_events(str(tmp_path / "events.jsonl"))
               if e["type"] == "hang"]
    assert set(hang) >= {"iter", "dispatch_id", "deadline_s", "elapsed_s",
                         "stack_path", "stacks", "exit_code", "process_index",
                         "process_count"}
    assert hang["exit_code"] == 76 and hang["iter"] == 7


def test_a_clean_window_never_fires():
    wd = watchdog.DispatchWatchdog(min_deadline_s=5.0, exit_fn=lambda c: pytest.fail(c))
    try:
        for i in range(3):
            with wd.armed(i):
                time.sleep(0.01)
        assert not wd.fired and wd.state()["armed"] is False
    finally:
        wd.close()

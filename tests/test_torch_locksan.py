"""The port's runtime lock-order sanitizer (``utils/locksan.py``) and its
``tarjan_scc`` (``utils/algo.py``), on the CPU: the JAX package's twelve
``tests/test_locksan.py`` cases on the port's sanitizer (the instrumented
lock's API, cycle detection without a deadlock, same-site peers, condition
waits not counted as holds, the hold budget, reentrancy, queue attribution,
locks made before activation, nesting, cross-thread release, and a replica
killed mid-stream in the port's pool, sanitized), the same graph and
verdicts as the JAX sanitizer on one scripted run, and ``tarjan_scc``
against the JAX one and a reachability oracle on random graphs."""

import queue
import threading
import time

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.utils import algo as jalgo
from howtotrainyourmamlpytorch_tpu.utils import locksan as jlocksan
from howtotrainyourmamlpytorch_tpu_torch.utils import algo, faultinject, locksan
from howtotrainyourmamlpytorch_tpu_torch.utils.locksan import LockSanitizer


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.deactivate()
    yield
    faultinject.deactivate()


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------


def test_instrumented_lock_api_parity():
    with LockSanitizer():
        lock = threading.Lock()
        assert lock.acquire()
        assert lock.locked()
        assert not lock.acquire(blocking=False)
        lock.release()
        assert not lock.locked()
        with lock:
            assert lock.locked()
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as pool:
            assert pool.submit(lambda: 7).result(timeout=10) == 7
    assert threading.Lock is not lock.__class__


def test_deactivate_restores_native_factories():
    native = threading.Lock
    with LockSanitizer():
        assert threading.Lock is not native
    assert threading.Lock is native
    assert threading.RLock().__class__.__name__ == "RLock"


def test_cycle_detected_without_an_actual_deadlock():
    """Both halves of an AB/BA inversion record their edge even when the
    threads never overlap."""
    with LockSanitizer() as san:
        a = threading.Lock()
        b = threading.Lock()

        def forward():
            with a:
                with b:
                    pass

        def backward():
            with b:
                with a:
                    pass

        for target in (forward, backward):
            t = threading.Thread(target=target)
            t.start()
            t.join()
    assert len(san.cycles()) == 1
    with pytest.raises(AssertionError, match="cyclic lock-acquisition"):
        san.assert_clean()
    with pytest.raises(AssertionError, match="cyclic"):
        with locksan.sanitized():
            c = threading.Lock()
            d = threading.Lock()
            with c, d:
                pass
            with d, c:
                pass


def test_same_site_peer_instances_are_not_a_cycle():
    with LockSanitizer() as san:

        def make():
            return threading.Lock()

        x, y = make(), make()
        with x:
            with y:
                pass
        with y:
            with x:
                pass
    assert san.cycles() == []


def test_condition_wait_not_counted_as_hold():
    with LockSanitizer() as san:
        cond = threading.Condition()
        woke = []

        def waiter():
            with cond:
                cond.wait(timeout=10.0)
                woke.append(True)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.25)
        with cond:
            cond.notify()
        t.join(timeout=10)
    assert woke == [True]
    assert all(hold < 0.2 for hold in san.max_hold_s.values()), san.max_hold_s


def test_hold_budget_verdict_fires():
    with LockSanitizer() as san:
        lock = threading.Lock()
        with lock:
            time.sleep(0.06)
    over = san.over_budget(0.05)
    assert len(over) == 1
    with pytest.raises(AssertionError, match="hold time over"):
        san.assert_clean(hold_budget_s=0.05)
    san.assert_clean(hold_budget_s=0.05, match="no/such/path")
    site, hold = locksan.longest_hold(san)
    assert site == lock.site and hold >= 0.06
    assert locksan.longest_hold(san, match="no/such/path") == (None, 0.0)


def test_rlock_reentrancy_single_hold_no_self_edges():
    with LockSanitizer() as san:
        r = threading.RLock()
        with r:
            with r:
                with r:
                    pass
    assert san.edges == {}
    assert sum(san.acquisitions.values()) == 1


def test_queue_locks_are_attributed_to_the_queue_owner():
    with LockSanitizer() as san:
        q = queue.Queue()
        q.put(1)
        assert q.get(timeout=5) == 1
    assert any("test_torch_locksan.py" in site for site in san.acquisitions)


def test_locks_created_before_activation_stay_native():
    pre = threading.Lock()
    with LockSanitizer() as san:
        with pre:
            pass
    assert san.acquisitions == {}


def test_nested_sanitizers_restore_the_outer_one():
    native = threading.Lock
    with LockSanitizer() as outer:
        with LockSanitizer() as inner:
            inner_lock = threading.Lock()
            with inner_lock:
                pass
        assert threading.Lock is not native
        outer_lock = threading.Lock()
        with outer_lock:
            pass
    assert threading.Lock is native
    assert inner.acquisitions and outer.acquisitions


def test_cross_thread_lock_release_does_not_fabricate_edges():
    with LockSanitizer() as san:
        signal_lock = threading.Lock()
        other = threading.Lock()
        signal_lock.acquire()
        releaser = threading.Thread(target=signal_lock.release)
        releaser.start()
        releaser.join()
        with other:
            pass
    assert (signal_lock.site, other.site) not in san.edges, san.edges
    assert san.cycles() == []


# ---------------------------------------------------------------------------
# The port's pool: a replica killed mid-stream, sanitized
# ---------------------------------------------------------------------------


def test_pool_kill_mid_stream_under_locksan():
    """A replica of the port's pool dies under live traffic from three
    clients; the pool re-dispatches and restarts it, and the observed
    acquisition-order graph of the whole episode (the pool's supervisor,
    the batcher's worker, the engine, the cache, the metrics) is acyclic
    with every serve hold inside 2.0 s."""
    from test_torch_serve_pool import local_pool
    from test_torch_serve_runtime import episode

    rng = np.random.RandomState(0)
    with LockSanitizer() as san:
        pool = local_pool(n=2)
        try:
            faultinject.activate(faultinject.FaultPlan(replica_kill_at_request=5))
            answered = []
            lock = threading.Lock()

            def client(n):
                for _ in range(n):
                    with lock:
                        ep = episode(rng)
                    out = pool.classify(*ep, timeout=60.0)
                    with lock:
                        answered.append(out)

            threads = [threading.Thread(target=client, args=(4,)) for _ in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert len(answered) == 12  # no failed request
            assert pool.metrics.replica_deaths_total.value >= 1
        finally:
            faultinject.deactivate()
            pool.close()
    assert sum(san.acquisitions.values()) > 100
    assert any(locksan.SERVE_MATCH in site for site in san.acquisitions)
    san.assert_clean(hold_budget_s=locksan.SERVE_HOLD_BUDGET_S, match=locksan.SERVE_MATCH)


# ---------------------------------------------------------------------------
# Against the JAX sanitizer, and tarjan_scc
# ---------------------------------------------------------------------------


def _scripted_run(sanitizer_cls):
    """Three locks from three lines, nested in a fixed order on two
    threads, one inversion among them; returns the sanitizer's verdicts
    with sites reduced to their line offsets."""
    with sanitizer_cls() as san:
        a = threading.Lock()
        b = threading.RLock()
        c = threading.Lock()

        def one():
            with a:
                with b:
                    with b:
                        pass
                with c:
                    pass

        def two():
            with c:
                with a:
                    pass

        for target in (one, two):
            t = threading.Thread(target=target)
            t.start()
            t.join()
    base = int(a.site.rsplit(":", 1)[1])

    def line(site):
        return int(site.rsplit(":", 1)[1]) - base

    return ({(line(s), line(d)): n for (s, d), n in san.edges.items()},
            sorted(sorted(line(s) for s in comp) for comp in san.cycles()),
            {line(s): n for s, n in san.acquisitions.items()})


def test_scripted_run_gives_the_jax_sanitizers_graph():
    assert _scripted_run(LockSanitizer) == _scripted_run(jlocksan.LockSanitizer)
    edges, cycles, _ = _scripted_run(LockSanitizer)
    assert cycles == [[0, 2]] and edges[(0, 1)] == 1


def _oracle(adj):
    """Components of size >= 2 by mutual reachability."""
    nodes = sorted(set(adj) | {d for v in adj.values() for d in v})
    reach = {}
    for n in nodes:
        seen, stack = set(), [n]
        while stack:
            for d in adj.get(stack.pop(), ()):
                if d not in seen:
                    seen.add(d)
                    stack.append(d)
        reach[n] = seen
    comps = {tuple(sorted(m for m in nodes if m == n or (m in reach[n] and n in reach[m])))
             for n in nodes}
    return sorted(list(c) for c in comps if len(c) >= 2)


@pytest.mark.parametrize("seed", range(6))
def test_tarjan_scc_on_random_graphs(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        n = int(rng.randint(1, 30))
        density = rng.rand() * 0.2
        adj = {}
        for src in range(n):
            for dst in range(n):
                if src != dst and rng.rand() < density:
                    adj.setdefault(f"n{src:02d}", set()).add(f"n{dst:02d}")
        got = algo.tarjan_scc({k: set(v) for k, v in adj.items()})
        assert got == jalgo.tarjan_scc({k: set(v) for k, v in adj.items()})
        assert sorted(got) == _oracle(adj)
    # A long chain closed into one cycle: no recursion limit.
    chain = {f"v{i:05d}": {f"v{i + 1:05d}"} for i in range(5000)}
    chain["v05000"] = {"v00000"}
    assert [len(c) for c in algo.tarjan_scc(chain)] == [5001]

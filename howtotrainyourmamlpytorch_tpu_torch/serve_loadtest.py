"""Open-loop serving load test of the port: Poisson arrivals, the SLO
verdict, recovery (``tools/serve_loadtest.py``).

    python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_loadtest \\
        --config <experiment JSON> [--checkpoint <file>] [--device cpu] \\
        [--rate 4] [--duration-s 5] [--ramp LO:HI:DUR[,...]] \\
        [--p99-budget-ms 2000] [--error-slo 0.01] [--timeout-s 10] \\
        [--replicas N] [--kill-replica-at K] [--tier-dir DIR] [--json] \\
        [--geometry-mix 5x1x15,3x2x8 [--geometry-lattice 5x2x15]] \\
        [--use_pallas_fused_norm True]
    python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_loadtest \\
        --url http://127.0.0.1:8080 [--way 5 --image-shape 1x28x28] ...

* **open-loop arrivals** - start times are drawn once from a seeded
  Poisson process (exponential gaps at ``--rate``) and fired on schedule
  whatever is in flight, so an overloaded server faces mounting
  concurrency, as in production (a closed loop throttles itself and hides
  overload);
* **ramps** - ``--ramp lo:hi:dur[,...]`` replaces the flat rate with
  triangles (``2:20:60`` climbs from 2 to 20 requests/s over 60 s and back
  over another 60), a seeded nonhomogeneous Poisson process by thinning;
  ``serve_ramp_p99_ms`` is the p99 over the swing;
* **SLO verdict** - ``p99 <= --p99-budget-ms`` and ``error rate <=
  --error-slo`` over the run, one JSON line with ``--json``; exit code 0
  on a pass, 2 on a fail;
* **recovery** - a sampler tracks degraded windows (a pool: fewer healthy
  replicas than its size; one engine: not ready) and ``serve_recovery_s``
  is the longest: with ``--kill-replica-at K`` the replica's death to full
  health under live traffic;
* **durable tier** - ``--tier-dir DIR`` gives replica i a tier at
  ``DIR/replica-<i>`` and routes by digest; ``serve_replica_ready_s`` is
  the newest respawn's factory-to-HEALTHY time;
* **geometry stream** - ``--geometry-mix WxSxQ[,...]`` cycles seeded
  episodes of those geometries (``data/synth_geometry.geometry_mix_episodes``)
  instead of one bucket. An in-process engine then serves a geometry
  lattice (``ServeConfig.geometry_lattice``): ``--geometry-lattice``, or
  else the elementwise maximum of the mix, one bucket every episode is
  coarsened onto; it is warmed at every lattice bucket and, as the JAX
  harness does, its backbone is switched to layer norm (the lattice needs
  a forward whose rows do not depend on each other) unless
  ``--norm_layer`` is given.

Targets: one in-process ``ServingAPI`` (the default), an in-process
``LocalReplica`` pool (``--replicas N``), both built by
``serve_maml.build_api`` from an experiment JSON (random weights from seed
0 without ``--checkpoint``; flags this command does not know go to the
training parser), or a running server (``--url``). The in-process targets
run on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

OUTCOME_OK = "ok"
OUTCOME_SHED = "shed"
OUTCOME_DEADLINE = "deadline"
OUTCOME_ERROR = "error"


# ---------------------------------------------------------------------------
# Ramp schedules (nonhomogeneous Poisson arrivals)
# ---------------------------------------------------------------------------


def parse_ramp(spec: str) -> list[tuple[float, float, float]]:
    """``lo:hi:dur[,lo:hi:dur...]`` → validated ``(lo, hi, dur)`` segments.

    Each segment is a TRIANGLE: the rate climbs lo→hi over ``dur``
    seconds, then descends hi→lo over another ``dur`` seconds, so one
    segment occupies ``2*dur`` of wall clock. Segments concatenate."""
    segments = []
    for part in spec.split(","):
        fields = part.split(":")
        if len(fields) != 3:
            raise ValueError(
                f"ramp segment {part!r} must be lo:hi:dur (e.g. 2:20:60)"
            )
        lo, hi, dur = (float(f) for f in fields)
        if lo < 0 or hi <= 0 or dur <= 0:
            raise ValueError(
                f"ramp segment {part!r}: need lo >= 0, hi > 0, dur > 0"
            )
        if hi < lo:
            raise ValueError(
                f"ramp segment {part!r}: hi must be >= lo (the segment "
                "ramps up then back down on its own)"
            )
        segments.append((lo, hi, dur))
    return segments


def ramp_rate_fn(segments):
    """``(rate(t), total_duration_s, peak_rate)`` for triangle segments."""
    total = sum(2.0 * dur for _, _, dur in segments)
    peak = max(hi for _, hi, _ in segments)

    def rate(t: float) -> float:
        if t < 0 or t >= total:
            return 0.0
        for lo, hi, dur in segments:
            if t < 2.0 * dur:
                if t < dur:  # climbing
                    return lo + (hi - lo) * (t / dur)
                return hi - (hi - lo) * ((t - dur) / dur)  # descending
            t -= 2.0 * dur
        return 0.0

    return rate, total, peak


def ramp_arrivals(segments, *, seed: int = 0) -> list[float]:
    """Seeded arrival times for the triangle schedule, by thinning.

    Draw a homogeneous Poisson process at the PEAK rate over the whole
    schedule, then keep each arrival ``t`` with probability
    ``rate(t)/peak`` — the standard exact construction for a
    nonhomogeneous Poisson process, so the offered stream is genuinely
    Poisson at every instant of the ramp (bursty where it should be),
    not a deterministic staircase."""
    rate, total, peak = ramp_rate_fn(segments)
    rng = np.random.RandomState(seed)
    arrivals = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= total:
            break
        if rng.rand() <= rate(t) / peak:
            arrivals.append(t)
    return arrivals


class _HealthSampler:
    """Samples the target's health on a cadence and reports the longest
    window in which it was degraded (not all replicas healthy / engine not
    ready) — the recovery clock for replica-death experiments."""

    def __init__(self, target, interval_s: float = 0.05):
        self.target = target
        self.interval_s = interval_s
        self._samples: list[tuple[float, bool]] = []  # (t, fully_healthy)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="loadtest-health", daemon=True
        )

    def _healthy(self) -> bool:
        try:
            try:
                h = self.target.healthz(timeout=2.0)
            except TypeError:  # in-process targets take no timeout kwarg
                h = self.target.healthz()
        except Exception:
            return False
        if "healthy_replicas" in h:
            return h["healthy_replicas"] >= h.get("pool_size", 1)
        return bool(h.get("ready", True)) and not h.get("degraded", False)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._samples.append((time.monotonic(), self._healthy()))
            self._stop.wait(self.interval_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def longest_degraded_window_s(self) -> float:
        worst = 0.0
        window_start: float | None = None
        for t, healthy in self._samples:
            if not healthy and window_start is None:
                window_start = t
            elif healthy and window_start is not None:
                worst = max(worst, t - window_start)
                window_start = None
        if window_start is not None and self._samples:
            worst = max(worst, self._samples[-1][0] - window_start)
        return worst


def synth_episodes(
    n: int, *, way: int, shot: int, query: int, image_shape, seed: int = 0
):
    """``n`` distinct synthetic episodes at one bucket."""
    rng = np.random.RandomState(seed)
    episodes = []
    for _ in range(n):
        xs = rng.rand(way * shot, *image_shape).astype(np.float32)
        ys = np.repeat(np.arange(way), shot).astype(np.int32)
        xq = rng.rand(query, *image_shape).astype(np.float32)
        episodes.append((xs, ys, xq))
    return episodes


def _classify_outcome(
    target, episode, timeout_s: float, tag: str | None = None
) -> str:
    from .serve.errors import OverloadedError

    xs, ys, xq = episode
    try:
        if tag is not None:
            target.classify(xs, ys, xq, timeout=timeout_s, tag=tag)
        else:
            target.classify(xs, ys, xq, timeout=timeout_s)
        return OUTCOME_OK
    except OverloadedError:
        return OUTCOME_SHED
    except TimeoutError:
        return OUTCOME_DEADLINE
    except Exception:
        return OUTCOME_ERROR


def run_loadtest(
    target,
    episodes,
    *,
    rate_qps: float,
    duration_s: float,
    p99_budget_ms: float,
    error_slo: float,
    timeout_s: float = 10.0,
    seed: int = 0,
    max_workers: int = 32,
    sample_health: bool = True,
    tag_seed_base: int | None = None,
    arrivals: list[float] | None = None,
    ramp: str | None = None,
) -> dict:
    """Offers an open-loop Poisson stream to ``target.classify`` and
    returns the measured result + SLO verdict (see module docstring).

    ``target`` is anything with the ``ServingAPI`` classify/healthz
    surface (a pool, or an ``HttpReplica`` pointed at a live server).
    ``episodes`` are cycled round-robin, so distinct support sets keep the
    adapt path honest (pass one episode to measure the pure cache-hit
    tier). ``tag_seed_base`` stamps episode ``i`` with the telemetry tag
    ``seed:<base+i>``, which rides its ``serve_dispatch`` event.

    ``arrivals`` overrides the flat-rate Poisson draw with a precomputed
    schedule (e.g. ``ramp_arrivals``); ``ramp`` labels the result and
    turns on the ``serve_ramp_p99_ms`` export."""
    if arrivals is None:
        rng = np.random.RandomState(seed)
        # The whole arrival schedule up front: reproducible, and the
        # firing loop does no RNG work.
        arrivals = []
        t = 0.0
        while t < duration_s:
            t += float(rng.exponential(1.0 / rate_qps))
            if t < duration_s:
                arrivals.append(t)
    results: list[tuple[str, float]] = []
    results_lock = threading.Lock()
    t_start = time.monotonic()

    def fire(index: int, due: float) -> None:
        slot = index % len(episodes)
        tag = (
            f"seed:{tag_seed_base + slot}"
            if tag_seed_base is not None else None
        )
        outcome = _classify_outcome(
            target, episodes[slot], timeout_s, tag=tag
        )
        # Latency is measured from the SCHEDULED arrival, not from when an
        # executor worker got around to the task — client-side queueing
        # under overload is exactly the delay an open-loop harness exists
        # to expose, and timing from dequeue would hide it from the p99.
        latency_ms = (time.monotonic() - (t_start + due)) * 1e3
        with results_lock:
            results.append((outcome, latency_ms))

    sampler = (
        _HealthSampler(target)
        if sample_health and hasattr(target, "healthz")
        else None
    )
    if sampler is not None:
        sampler.__enter__()
    try:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            for index, due in enumerate(arrivals):
                delay = (t_start + due) - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                # Open loop: fire on schedule no matter what's in flight;
                # executor exit waits for stragglers.
                pool.submit(fire, index, due)
    finally:
        if sampler is not None:
            sampler.__exit__()
    wall_s = time.monotonic() - t_start
    recovery_s = (
        round(sampler.longest_degraded_window_s(), 3)
        if sampler is not None
        else None
    )

    # Durable-tier receipt: a pool target reports how long its most
    # recent replica took from factory start to HEALTHY — with a warm
    # tier (--tier-dir) a respawn loads its kernel library and spill.
    replica_ready_s = None
    stats_fn = getattr(target, "stats", None)
    if callable(stats_fn):
        try:
            replica_ready_s = stats_fn().get("replica_ready_s")
        except Exception:
            replica_ready_s = None

    offered = len(arrivals)
    by_outcome = {k: 0 for k in (
        OUTCOME_OK, OUTCOME_SHED, OUTCOME_DEADLINE, OUTCOME_ERROR,
    )}
    ok_latencies = []
    for outcome, latency_ms in results:
        by_outcome[outcome] += 1
        if outcome == OUTCOME_OK:
            ok_latencies.append(latency_ms)
    ok = by_outcome[OUTCOME_OK]
    failed = offered - ok
    error_rate = failed / offered if offered else 0.0
    p50 = float(np.percentile(ok_latencies, 50)) if ok_latencies else 0.0
    p99 = float(np.percentile(ok_latencies, 99)) if ok_latencies else 0.0
    slo_pass = bool(p99 <= p99_budget_ms and error_rate <= error_slo)
    result = {
        "offered": offered,
        "completed_ok": ok,
        "shed": by_outcome[OUTCOME_SHED],
        "deadline_exceeded": by_outcome[OUTCOME_DEADLINE],
        "errors": by_outcome[OUTCOME_ERROR],
        "rate_qps_requested": rate_qps,
        "rate_qps_offered": round(offered / wall_s, 3) if wall_s else 0.0,
        "serve_loadtest_qps": round(ok / wall_s, 3) if wall_s else 0.0,
        "serve_loadtest_p50_ms": round(p50, 3),
        "serve_loadtest_p99_ms": round(p99, 3),
        "serve_slo_p99_ms": p99_budget_ms,
        "serve_error_rate": round(error_rate, 6),
        "serve_shed_rate": round(
            by_outcome[OUTCOME_SHED] / offered, 6
        ) if offered else 0.0,
        "serve_error_slo": error_slo,
        "serve_recovery_s": recovery_s,
        "serve_replica_ready_s": (
            round(replica_ready_s, 3) if replica_ready_s is not None else None
        ),
        "slo_pass": slo_pass,
        "duration_s": round(wall_s, 3),
    }
    if ramp is not None:
        result["ramp"] = ramp
        result["serve_ramp_p99_ms"] = round(p99, 3)
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def parse_geometries(spec: str) -> list[tuple[int, int, int]]:
    """``"5x1x15,3x2x8"`` -> ``[(5, 1, 15), (3, 2, 8)]``: the command-line
    spelling of a geometry mix or lattice (the JAX repo's
    ``tools/serve_bench.parse_geometries``)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        dims = tuple(int(d) for d in part.split("x"))
        if len(dims) != 3:
            raise ValueError(
                f"geometry {part!r} must be WxSxQ (e.g. 5x1x15)"
            )
        out.append(dims)
    if not out:
        raise ValueError(f"no geometries in {spec!r}")
    return out


def _build_local_target(opts, train_flags=()):
    """The in-process target: one ``ServingAPI`` or a ``LocalReplica``
    pool, each engine built by ``serve_maml.build_api`` and warmed at the
    stream's bucket, or at every bucket of its lattice under a geometry
    mix. Returns ``(target, backbone_config)``; the backbone gives the
    synthetic episodes their geometry."""
    from . import serve_maml
    from .serve.pool import PoolConfig, ReplicaPool
    from .serve.resilience.replica import LocalReplica

    tier_dir = opts.tier_dir
    # A mix is served by a lattice engine: the given lattice, or else the
    # elementwise maximum of the mix, one bucket every episode coarsens onto.
    lattice = None
    if opts.geometry_mix:
        mix = parse_geometries(opts.geometry_mix)
        lattice = (parse_geometries(opts.geometry_lattice) if opts.geometry_lattice
                   else [tuple(max(g[i] for g in mix) for i in range(3))])
        if "--norm_layer" not in train_flags:
            train_flags = [*train_flags, "--norm_layer", "layer_norm"]
    argv = ["--config", opts.config, "--max_batch", str(opts.max_batch),
            "--max_wait_ms", "2.0", "--cache_capacity", "512"]
    argv += ["--checkpoint", opts.checkpoint] if opts.checkpoint else ["--init_from_scratch"]
    serve_opts, _ = serve_maml.get_parser().parse_known_args(argv)

    def replica_tier(index: int):
        # The layout of PoolConfig.tier_root: a restarted slot reuses its
        # directory (warm respawn); a retired slot's is adopted by its
        # ring successor.
        return os.path.join(tier_dir, f"replica-{index}") if tier_dir else None

    def one_api(replica_tier_dir=None):
        serve_opts.tier_dir = replica_tier_dir
        api, _ = serve_maml.build_api(serve_opts, train_flags, opts.device,
                                      geometry_lattice=lattice)
        if lattice is not None:
            api.warmup()  # every lattice bucket
        else:
            way = api.engine.learner.cfg.backbone.num_classes
            api.warmup([(way, opts.shot, opts.query)])
        return api

    if opts.replicas > 0:
        # Slot 0's engine also gives the geometry (slots start in order at
        # construction); restarts build fresh ones.
        prebuilt = [one_api(replica_tier(0))]
        backbone = prebuilt[0].engine.learner.cfg.backbone

        def factory(index: int) -> LocalReplica:
            api = prebuilt.pop() if index == 0 and prebuilt else one_api(replica_tier(index))
            return LocalReplica(api, replica_id=f"local-{index}")

        pool = ReplicaPool(factory, PoolConfig(
            n_replicas=opts.replicas, health_interval_s=0.1, restart_backoff_s=0.1,
            min_uptime_s=0.5, tier_root=tier_dir or None, route_by_digest=bool(tier_dir),
        ))
        if not pool.wait_ready(timeout=300.0):
            pool.close()
            raise RuntimeError("in-process replica pool never became healthy: "
                               "cannot offer load to a dead fleet")
        return pool, backbone
    api = one_api(tier_dir or None)
    return api, api.engine.learner.cfg.backbone


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Open-loop serving load test of the PyTorch port")
    add = parser.add_argument
    add("--rate", type=float, default=4.0, help="offered Poisson arrival rate, requests/s")
    add("--duration-s", type=float, default=5.0)
    add("--ramp", default=None, metavar="LO:HI:DUR[,...]",
        help="triangle arrival schedule instead of the flat --rate: each segment "
             "climbs LO to HI requests/s over DUR seconds and back over another DUR; "
             "overrides --rate/--duration-s and exports serve_ramp_p99_ms")
    add("--p99-budget-ms", type=float, default=2000.0)
    add("--error-slo", type=float, default=0.01, help="largest tolerated non-OK share")
    add("--timeout-s", type=float, default=10.0, help="per-request deadline")
    add("--seed", type=int, default=0)
    add("--episodes", type=int, default=32, help="distinct support sets the stream cycles")
    add("--shot", type=int, default=1)
    add("--query", type=int, default=15)
    add("--config", default=None,
        help="experiment JSON of the in-process target (required without --url)")
    add("--checkpoint", default=None,
        help="checkpoint of the in-process target (random weights without it)")
    add("--device", default=None, help="device of the in-process target; the card by default")
    add("--max-batch", type=int, default=4)
    add("--replicas", type=int, default=0, help="load an in-process LocalReplica pool")
    add("--url", default=None, help="load a running server instead")
    add("--way", type=int, default=5,
        help="episode way for --url (in-process targets take the model's)")
    add("--image-shape", default="1x28x28",
        help="CxHxW images for --url (must match the served model)")
    add("--tag-seed-base", type=int, default=None,
        help="tag episode i 'seed:<base+i>' in the serve_dispatch events")
    add("--kill-replica-at", type=int, default=None,
        help="kill the replica serving the Kth request (in-process targets) and "
             "measure recovery")
    add("--tier-dir", default=None,
        help="durable tier root of the in-process target: replica i's at "
             "<dir>/replica-<i>, routing by digest, warm respawns")
    add("--geometry-mix", default=None,
        help="comma-separated WxSxQ triples: the stream cycles these geometries "
             "(seeded data.synth_geometry.geometry_mix_episodes episodes) instead "
             "of one bucket; in-process targets get a geometry-lattice engine")
    add("--geometry-lattice", default=None,
        help="WxSxQ bucket lattice of the in-process engines under --geometry-mix "
             "(default: the elementwise maximum of the mix, one bucket)")
    add("--json", action="store_true", help="print the result as one JSON line")
    return parser


def main(argv=None) -> int:
    parser = get_parser()
    opts, train_flags = parser.parse_known_args(argv)
    if not opts.url and not opts.config:
        parser.error("--config is required for an in-process target (or pass --url)")
    if opts.url and train_flags:
        parser.error(f"unrecognized arguments: {' '.join(train_flags)}")

    from .utils import faultinject

    close_target = None
    if opts.url:
        from .serve.resilience.replica import HttpReplica

        target = HttpReplica(opts.url, replica_id="loadtest")
        dims = tuple(int(d) for d in opts.image_shape.split("x"))
        if len(dims) != 3:
            parser.error("--image-shape must be CxHxW (e.g. 1x28x28)")
        image_shape, way = dims, opts.way
    else:
        target, bb = _build_local_target(opts, train_flags)
        close_target = target
        image_shape = (bb.image_channels, bb.image_height, bb.image_width)
        way = bb.num_classes

    if opts.geometry_mix:
        from .data.synth_geometry import geometry_mix_episodes

        episodes = geometry_mix_episodes(
            opts.episodes, parse_geometries(opts.geometry_mix),
            image_shape=image_shape, seed=opts.seed)
    else:
        episodes = synth_episodes(opts.episodes, way=way, shot=opts.shot,
                                  query=opts.query, image_shape=image_shape,
                                  seed=opts.seed)
    if opts.kill_replica_at is not None:
        faultinject.activate(faultinject.FaultPlan(
            replica_kill_at_request=opts.kill_replica_at))
    rate_qps, duration_s, arrivals = opts.rate, opts.duration_s, None
    if opts.ramp:
        try:
            segments = parse_ramp(opts.ramp)
        except ValueError as exc:
            parser.error(str(exc))
        arrivals = ramp_arrivals(segments, seed=opts.seed)
        _, duration_s, rate_qps = ramp_rate_fn(segments)
    try:
        result = run_loadtest(
            target, episodes, rate_qps=rate_qps, duration_s=duration_s,
            p99_budget_ms=opts.p99_budget_ms, error_slo=opts.error_slo,
            timeout_s=opts.timeout_s, seed=opts.seed, tag_seed_base=opts.tag_seed_base,
            arrivals=arrivals, ramp=opts.ramp or None,
        )
    finally:
        if opts.kill_replica_at is not None:
            faultinject.deactivate()
        if close_target is not None:
            close_target.close()
    result["target"] = opts.url or (
        f"in-process pool x{opts.replicas}" if opts.replicas else "in-process")
    if opts.json:
        print(json.dumps(result))
    else:
        print(verdict_line(result))
    return 0 if result["slo_pass"] else 2


def verdict_line(result: dict) -> str:
    """The human-readable SLO verdict of one ``run_loadtest`` result."""
    verdict = "PASS" if result["slo_pass"] else "FAIL"
    return (
        f"[{verdict}] offered {result['offered']} @ {result['rate_qps_requested']} qps "
        f"for {result['duration_s']} s: ok {result['completed_ok']}, shed "
        f"{result['shed']}, deadline {result['deadline_exceeded']}, errors "
        f"{result['errors']}; p99 {result['serve_loadtest_p99_ms']} ms (budget "
        f"{result['serve_slo_p99_ms']}), error rate {result['serve_error_rate']} "
        f"(slo {result['serve_error_slo']}), recovery {result['serve_recovery_s']} s, "
        f"replica ready {result['serve_replica_ready_s']} s"
    )


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

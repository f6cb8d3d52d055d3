"""Ledger-guided autotuner: roofline position -> ranked A/B probes ->
mechanical keep or revert by the gate judge (JAX ``tune/autotuner.py``).

No human choice on the way: the knob space is data (``tune/space.py``),
the roofline regime comes from the program ledger (the probe program's
arithmetic intensity against the card's ridge, peak FLOP/s over HBM
bytes/s), every probe is measured under the contention sentinel's protocol
(``tune/sentinel.py``: a flagged probe is retried, then discarded; a
poisoned number is never judged), and the verdict is ``tune/judge.judge``'s.
Only on ``keep`` does the caller append the winning lever's gate to a
gates file, with provenance ``source: autotune:<run_id>``.

The probe is a small first-order MAML (2 stages of 4 filters, 8 tasks,
28x28 synthetic episodes) with the fused norm on, the port's train path:
the tuned knobs move dispatch and layout costs, which a small program
shows undiluted, and a probe must be cheap enough to run on a quiet host
between real work. On a card each dispatch replays the captured step
(``models/step_graph.py``). Measured values go into
``AUTOTUNE_<run_id>_r0*.json`` receipts in the layout of the JAX repo's
``BENCH_*`` trajectory, so they replay through the same judge.

The measure and sentinel functions are injectable (``measure_fn``,
``sentinel_fn``), so the decision is testable without a probe. The
command line is ``python -m howtotrainyourmamlpytorch_tpu_torch.autotune``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

from . import sentinel as contention
from .space import SPACE, TuneContext, config_fingerprint, resolve

#: The probe's judged key and the baseline key its gate references.
PROBE_KEY = "autotune_probe_meta_iters_per_s"
BASELINE_KEY = "autotune_baseline_meta_iters_per_s"

#: HBM bandwidth (bytes/s) by card, for the roofline ridge: NVIDIA's H100
#: data sheet, the SXM part (``torch.cuda.get_device_name()`` "NVIDIA H100
#: 80GB HBM3"). Matched by substring of the card's name, as
#: ``telemetry/device.resolve_peak_flops`` matches its table. A card
#: missing here, and the CPU, classify as the dispatch regime.
HBM_BW_BY_KIND = {
    "H100 80GB HBM3": 3.35e12,
}


def hbm_bandwidth(device_kind: str | None) -> float | None:
    """The table's bytes/s for ``device_kind``; None when no row matches."""
    for name, bandwidth in HBM_BW_BY_KIND.items():
        if device_kind and name.lower() in device_kind.lower():
            return bandwidth
    return None


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """The A/B workload, the same for the baseline and every candidate:
    only the knob under test differs."""

    batch_size: int = 8
    num_classes: int = 5
    shots: int = 1
    num_stages: int = 2
    num_filters: int = 4
    image_size: int = 28
    inner_steps: int = 2
    #: Meta-iterations a timing window aims for (rounded up to whole
    #: dispatches of the candidate's K).
    window_iters: int = 50
    windows: int = 3
    #: Sentinel retries before a contended probe is discarded.
    contention_retries: int = 2


def classify_regime(
    arithmetic_intensity: float | None,
    device_kind: str,
    peak_flops: float | None,
) -> tuple[str, str]:
    """Roofline position -> knob regime (``dispatch``, ``memory`` or
    ``compute``) and the reason. Below the ridge the program is bound by
    HBM bytes, above it by FLOPs; without an intensity, a peak or a
    bandwidth (the CPU) per-dispatch overhead is the lever that can be
    measured."""
    bw = hbm_bandwidth(device_kind)
    if arithmetic_intensity is None or not peak_flops or not bw:
        return "dispatch", (
            f"no roofline position for {device_kind!r} (no cost analysis "
            "or no bandwidth table entry): dispatch overhead is the "
            "measurable lever"
        )
    ridge = peak_flops / bw
    if arithmetic_intensity < ridge:
        return "memory", (
            f"intensity {arithmetic_intensity:.1f} FLOP/B below the "
            f"{device_kind} ridge {ridge:.1f}: HBM-bound"
        )
    return "compute", (
        f"intensity {arithmetic_intensity:.1f} FLOP/B above the "
        f"{device_kind} ridge {ridge:.1f}: FLOPs-bound"
    )


def rank_candidates(
    regime: str, ctx: TuneContext, max_candidates: int = 6
) -> list[tuple[str, object]]:
    """Single-knob candidates ``(knob_name, value)``, the regime's knobs
    first (each knob's values in declared order), at most
    ``max_candidates``. Only train knobs the probe can apply are ranked: a
    knob it cannot apply would judge noise."""
    ranked: list[tuple[str, object]] = []
    knobs = sorted(
        (k for k in SPACE.values()
         if k.plane == "train" and k.name in PROBE_APPLIERS),
        key=lambda k: (k.regime != regime, k.name),
    )
    for knob in knobs:
        for value in knob.legal_candidates(ctx):
            ranked.append((knob.name, value))
    return ranked[:max_candidates]


# ---------------------------------------------------------------------------
# The default probe, injectable for tests
# ---------------------------------------------------------------------------


def _probe_batch(spec: ProbeSpec, rng):
    """One numpy episode batch of the probe from ``rng`` (a
    ``numpy.random.RandomState``): ``(B, N*K, 1, H, W)`` images in [0, 1),
    the labels of the support and target sets alike."""
    import numpy as np

    n = spec.num_classes * spec.shots
    img = (1, spec.image_size, spec.image_size)
    xs = rng.rand(spec.batch_size, n, *img).astype(np.float32)
    xt = rng.rand(spec.batch_size, n, *img).astype(np.float32)
    ys = np.tile(
        np.repeat(np.arange(spec.num_classes, dtype=np.int32), spec.shots),
        (spec.batch_size, 1),
    )
    return xs, xt, ys, ys.copy()


def _probe_config(overrides: dict, spec: ProbeSpec):
    """The probe learner's ``MAMLConfig`` under ``overrides``: the JAX
    probe's, with the port's fused norm on (the one-level op, the any-order
    op and the pooled op, as the trainer's fused flags set them)."""
    from ..models import BackboneConfig, MAMLConfig

    backbone = BackboneConfig(
        num_stages=spec.num_stages,
        num_filters=spec.num_filters,
        per_step_bn_statistics=True,
        num_steps=spec.inner_steps,
        num_classes=spec.num_classes,
        image_channels=1,
        image_height=spec.image_size,
        image_width=spec.image_size,
        use_pallas_fused_norm=True,
        fused_norm_train=True,
        fused_norm_pool=True,
        lane_pad_channels=bool(overrides.get("lane_pad_channels", False)),
    )
    return MAMLConfig(
        backbone=backbone,
        number_of_training_steps_per_iter=spec.inner_steps,
        number_of_evaluation_steps_per_iter=spec.inner_steps,
        task_learning_rate=0.1,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        second_order=False,
        use_multi_step_loss_optimization=False,
        task_chunk=int(overrides.get("task_chunk", 0)),
    )


#: Knob name -> how the default probe applies it. Membership is the
#: "probe can apply it" predicate ``rank_candidates`` filters on.
PROBE_APPLIERS = {
    "iters_per_dispatch": "K batches per run_train_iters dispatch (K replays)",
    "task_chunk": "MAMLConfig.task_chunk",
    "lane_pad_channels": "BackboneConfig.lane_pad_channels",
}


def probe_learner(overrides: dict, spec: ProbeSpec, device=None):
    """``(learner, state, batches)`` of a probe under ``overrides`` on
    ``device`` (the card by default): the learner from ``_probe_config``,
    its state from seed 0, K batches (``iters_per_dispatch``) from
    ``RandomState(1)``."""
    import numpy as np
    import torch

    from ..models import MAMLFewShotLearner
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    learner = MAMLFewShotLearner(_probe_config(overrides, spec))
    state = learner.init_state(torch.Generator().manual_seed(0), device)
    rng = np.random.RandomState(1)
    k = int(overrides.get("iters_per_dispatch", 1))
    return learner, state, [_probe_batch(spec, rng) for _ in range(k)]


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_measure(overrides: dict, spec: ProbeSpec, device=None) -> float:
    """The probe's median-window meta-iterations/s under ``overrides``:
    one dispatch first (on a card it captures the step), then
    ``spec.windows`` windows of whole K-dispatches, each timed to a
    synchronisation (the windowed-median shape of the JAX bench: robust to
    a transient dip, no max-selection bias)."""
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    learner, state, batches = probe_learner(overrides, spec, device)
    k = len(batches)
    state, _ = learner.run_train_iters(state, batches, epoch=0)
    _synchronize(device)
    per_window = max(1, -(-spec.window_iters // k))
    rates = []
    for _ in range(spec.windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            state, _ = learner.run_train_iters(state, batches, epoch=0)
        _synchronize(device)
        rates.append(per_window * k / (time.perf_counter() - t0))
    return statistics.median(rates)


def probe_program(spec: ProbeSpec, device=None):
    """The probe's train program at the baseline knobs as a program-ledger
    row (``telemetry/device.ProgramEntry``: FLOPs, bytes and intensity
    per iteration). On a card it is the row of the step's capture (the
    ledger's warm-up hook); on the CPU the hook is entered around the
    eager step."""
    from ..models import step_graph
    from ..telemetry.device import ProgramLedger
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    learner, state, batches = probe_learner({}, spec, device)
    ledger = ProgramLedger(emit_events=False)
    if device.type == "cuda":
        step_graph.warmup_hooks.append(ledger.warmup_hook)
        try:
            learner.run_train_iters(state, batches, epoch=0)
        finally:
            step_graph.warmup_hooks.remove(ledger.warmup_hook)
        _synchronize(device)
    else:
        with ledger.warmup_hook((False, True, ())):
            learner.run_train_iters(state, batches, epoch=0)
    return ledger.train_entry()


class ContentionSentinel:
    """The default ``sentinel_fn``: one contention reading per call, judged
    against this object's run-local floor, the smallest of three readings
    at its first call (``BENCH_QUIET_SENTINEL_MS`` wins when set). An A/B
    probe needs both sides measured under the same load within a run, not
    a norm from another host. A live trainer on this host (the direct
    signal) always marks the reading contended.

    The JAX package keeps the floor in its module, once a process; an
    autotune run here makes its own sentinel, so the floor is the run's."""

    #: Timed runs of the sentinel program a reading.
    REPEATS = 10

    def __init__(self, device=None):
        self.device = device
        self.floor_ms: float | None = None

    def __call__(self) -> dict:
        if self.floor_ms is None:
            self.floor_ms = contention.quiet_floor_override()
        if self.floor_ms is None:
            self.floor_ms = min(
                contention.sentinel_ms(self.REPEATS, self.device) for _ in range(3)
            )
        ms = contention.sentinel_ms(self.REPEATS, self.device)
        trainers = contention.live_trainer_pids()
        contended = bool(trainers) or (
            ms > contention.SENTINEL_CONTENTION_FACTOR * self.floor_ms
        )
        return {
            "contended": contended,
            "sentinel_ms": ms,
            "floor_ms": self.floor_ms,
            "live_trainers": trainers,
        }


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def _measure_clean(
    overrides: dict, spec: ProbeSpec, measure_fn, sentinel_fn
) -> tuple[float | None, list[dict]]:
    """One sentinel-bracketed measurement, retried while flagged. Returns
    ``(value, sentinel_log)``; the value is None when every attempt was
    contended (the probe is discarded, never judged)."""
    log: list[dict] = []
    for _attempt in range(spec.contention_retries + 1):
        before = sentinel_fn()
        value = measure_fn(overrides, spec)
        after = sentinel_fn()
        flagged = bool(before["contended"] or after["contended"])
        log.append({"before": before, "after": after, "flagged": flagged})
        if not flagged:
            return value, log
    return None, log


def autotune_run(
    *,
    run_id: str,
    ctx: TuneContext | None = None,
    spec: ProbeSpec | None = None,
    min_gain: float = 0.05,
    max_candidates: int = 6,
    device_kind: str | None = None,
    peak_flops: float | None = None,
    arithmetic_intensity: float | None = None,
    measure_fn=None,
    sentinel_fn=None,
    judge_fn=None,
    device=None,
    sentinel_log: list | None = None,
) -> dict:
    """The loop: classify -> rank -> probe (sentinel-clean) -> judge ->
    the verdict document, the JAX autotuner's keys and values.

    The caller (the command line) owns the files (the receipts, the gates
    file); this returns the document only. ``measure_fn`` defaults to
    ``default_measure`` on ``device``, ``sentinel_fn`` to a fresh
    :class:`ContentionSentinel` on it, ``judge_fn`` to ``tune/judge.judge``.
    ``sentinel_log``, when given, receives each measurement's
    ``{"overrides", "measured", "attempts"}`` (every attempt's readings
    before and after), in order, beside the document."""
    ctx = ctx or TuneContext()
    spec = spec or ProbeSpec()
    if measure_fn is None:
        def measure_fn(overrides, probe_spec):
            return default_measure(overrides, probe_spec, device)
    if sentinel_fn is None:
        sentinel_fn = ContentionSentinel(device)
    if judge_fn is None:
        from .judge import judge as judge_fn

    def measure(overrides):
        value, log = _measure_clean(overrides, spec, measure_fn, sentinel_fn)
        if sentinel_log is not None:
            sentinel_log.append(
                {"overrides": dict(overrides), "measured": value, "attempts": log}
            )
        return value, log

    regime, regime_reason = classify_regime(
        arithmetic_intensity, device_kind or "cpu", peak_flops
    )
    candidates = rank_candidates(regime, ctx, max_candidates)

    baseline, baseline_log = measure({})
    result = {
        "run_id": run_id,
        "regime": regime,
        "regime_reason": regime_reason,
        "ranked_candidates": [
            {"knob": name, "value": value} for name, value in candidates
        ],
        "baseline": baseline,
        "baseline_sentinel": baseline_log[-1] if baseline_log else None,
        "probes": [],
        "winner": None,
        "emissions": None,
    }
    if baseline is None:
        result["error"] = (
            "baseline probe contended on every attempt — nothing judged"
        )
        return result

    best = None  # (value, knob_name, knob_value, fingerprint)
    for name, value in candidates:
        overrides = {name: value}
        measured, _log = measure(overrides)
        result["probes"].append({
            "knob": name,
            "value": value,
            "measured": measured,
            "discarded": measured is None,
        })
        if measured is None:
            continue
        if best is None or measured > best[0]:
            fp = config_fingerprint(resolve(overrides, ctx))
            best = (measured, name, value, fp)

    if best is None:
        result["error"] = "every candidate probe contended — nothing judged"
        return result

    measured, knob_name, knob_value, fingerprint = best
    knob = SPACE[knob_name]
    lever = f"{knob.flag}={knob_value}"
    gate_expr = f"this > {1.0 + min_gain:g} * {BASELINE_KEY}"
    gates_doc = {
        "schema": 1,
        "gates": {
            PROBE_KEY: {
                "direction": "higher",
                "gate": gate_expr,
                "lever": lever,
                "source": f"autotune:{run_id}",
            },
        },
        "ungated_ok": [
            BASELINE_KEY, "contended", "config_fingerprint",
            "autotune_knob", "autotune_value",
        ],
    }
    baseline_fp = config_fingerprint(resolve({}, ctx))
    runs = [
        {
            "name": f"AUTOTUNE_{run_id}_r01.json",
            "n": 1,
            "parsed": {
                PROBE_KEY: baseline,
                BASELINE_KEY: baseline,
                "contended": False,
                "config_fingerprint": baseline_fp,
            },
            "contended": False,
        },
        {
            "name": f"AUTOTUNE_{run_id}_r02.json",
            "n": 2,
            "parsed": {
                PROBE_KEY: measured,
                BASELINE_KEY: baseline,
                "autotune_knob": knob_name,
                "autotune_value": knob_value,
                "contended": False,
                "config_fingerprint": fingerprint,
            },
            "contended": False,
        },
    ]
    judged = judge_fn(gates_doc, runs)
    verdict = judged["verdicts"][PROBE_KEY]["verdict"]
    result["emissions"] = [dict(run) for run in runs]
    result["judge"] = {
        "verdict": verdict,
        "reason": judged["verdicts"][PROBE_KEY]["reason"],
        "gate": gate_expr,
    }
    result["winner"] = (
        {
            "knob": knob_name,
            "value": knob_value,
            "lever": lever,
            "measured": measured,
            "baseline": baseline,
            "gain": measured / baseline - 1.0,
            "config_fingerprint": fingerprint,
            "gate_entry": {
                **gates_doc["gates"][PROBE_KEY],
                "note": (
                    f"autotuned on {device_kind or 'cpu'}: {lever} "
                    f"{baseline:.2f} -> {measured:.2f} meta-iters/s "
                    f"({(measured / baseline - 1.0) * 100:.0f}% gain, "
                    f"sentinel-clean)"
                ),
            },
        }
        if verdict == "keep"
        else None
    )
    return result


def append_gate(
    gates_path: str, key: str, entry: dict, ungated_extra=()
) -> None:
    """Adds or replaces one gate in a gates file (written to a temporary
    file and renamed, so a killed autotuner never leaves a torn file) and
    records the helper keys it references in ``ungated_ok``."""
    with open(gates_path) as f:
        doc = json.load(f)
    doc["gates"][key] = entry
    ungated = list(doc.get("ungated_ok", []))
    for name in ungated_extra:
        if name not in ungated:
            ungated.append(name)
    doc["ungated_ok"] = ungated
    tmp = gates_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, gates_path)

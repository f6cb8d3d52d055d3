"""The knob space: every tunable registered as data (JAX ``tune/space.py``).

Each :class:`Knob` records its command-line flag (train) or config field
(serve), its legal candidates, a guard that refuses an illegal value with
the reason (``ValueError``, never a silent clamp) and the bench keys it
moves. ``config_fingerprint`` hashes the resolved knob set into the
12-hex id that the trainer stamps on its ``step`` events, its event
context and ``logs/status.json``, so every event is attributable to the
configuration that produced it. Names, flags, defaults, candidates,
``moves`` and guards are the JAX package's, so a namespace hashes to the
same fingerprint in both packages; the descriptions say what each knob
does in this package. ``mesh_shape`` stays registered: its guard refuses
a mesh the host cannot have, so on one card only ``(1, 1)`` is legal.

Host Python only: this module imports no torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class TuneContext:
    """The machine/run facts guards check candidates against.

    ``dp``/``mp`` are the CURRENT mesh extents (the context a non-mesh
    knob must stay compatible with); ``n_devices`` bounds candidate mesh
    shapes; ``global_batch`` is the meta-batch size divisibility anchor.
    """

    n_devices: int = 1
    dp: int = 1
    mp: int = 1
    global_batch: int = 8


GuardFn = Callable[[Any, TuneContext], None]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable, as data.

    ``flag`` is the CLI spelling (train plane) or the config field path
    (serve plane) — the autotuner renders it verbatim into the winning
    one-liner. ``regime`` names the roofline regime the knob attacks
    (``dispatch``/``memory``/``compute``/``latency``): the autotuner
    ranks regime-matching knobs first after classifying the ledger's
    roofline position. ``moves`` are the bench keys an A/B on this knob
    is judged over.
    """

    name: str
    flag: str
    plane: str  # "train" | "serve"
    regime: str  # "dispatch" | "memory" | "compute" | "latency"
    default: Any
    candidates: tuple
    moves: tuple[str, ...]
    guard: GuardFn | None = None
    description: str = ""

    def check(self, value: Any, ctx: TuneContext) -> None:
        """Refuses an illegal ``value`` under ``ctx`` (ValueError with the
        reason). Legal values pass silently."""
        if value != self.default and value not in self.candidates:
            raise ValueError(
                f"{self.flag} {value!r} is not a registered candidate for "
                f"knob {self.name!r} (legal: {list(self.candidates)})"
            )
        if self.guard is not None:
            self.guard(value, ctx)

    def legal_candidates(self, ctx: TuneContext) -> tuple:
        """The candidate values whose guards pass under ``ctx`` — the
        autotuner's probe set. The default is excluded (it is the A side
        of every A/B)."""
        out = []
        for value in self.candidates:
            if value == self.default:
                continue
            try:
                self.check(value, ctx)
            except ValueError:
                continue
            out.append(value)
        return tuple(out)


# ---------------------------------------------------------------------------
# Guards: each names the flag, the value and the fact that rejects it
# ---------------------------------------------------------------------------


def _guard_task_chunk(value: Any, ctx: TuneContext) -> None:
    chunk = int(value)
    if chunk <= 0:
        return
    if ctx.dp > 1 and chunk % ctx.dp != 0:
        raise ValueError(
            f"--task_chunk {chunk} must be a multiple of the mesh's dp "
            f"extent {ctx.dp} (each scan step shards its chunk of tasks "
            "over 'dp')"
        )
    if ctx.global_batch % chunk != 0:
        raise ValueError(
            f"--task_chunk {chunk} must divide the meta-batch size "
            f"{ctx.global_batch} (the step reshapes (B, ...) -> "
            "(B//chunk, chunk, ...))"
        )


def _guard_mesh_shape(value: Any, ctx: TuneContext) -> None:
    dp, mp = int(value[0]), int(value[1])
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh shape dp{dp}xmp{mp}: extents must be >= 1")
    if dp * mp > ctx.n_devices:
        raise ValueError(
            f"mesh shape dp{dp}xmp{mp} needs {dp * mp} devices but only "
            f"{ctx.n_devices} are available"
        )
    if ctx.global_batch % dp != 0:
        raise ValueError(
            f"mesh shape dp{dp}xmp{mp}: the meta-batch size "
            f"{ctx.global_batch} must be a multiple of the dp extent {dp} "
            "(the task axis shards over 'dp')"
        )


def _guard_positive_int(flag: str) -> GuardFn:
    def guard(value: Any, ctx: TuneContext) -> None:  # noqa: ARG001
        if int(value) < 1:
            raise ValueError(f"{flag} must be >= 1, got {value}")

    return guard


def _guard_nonneg(flag: str) -> GuardFn:
    def guard(value: Any, ctx: TuneContext) -> None:  # noqa: ARG001
        if float(value) < 0:
            raise ValueError(f"{flag} must be >= 0, got {value}")

    return guard


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

SPACE: dict[str, Knob] = {
    knob.name: knob
    for knob in (
        Knob(
            name="iters_per_dispatch",
            flag="--iters_per_dispatch",
            plane="train",
            regime="dispatch",
            default=1,
            candidates=(1, 5, 25),
            moves=(
                "maml++_omniglot_5w1s_meta_iters_per_s",
                "sustained_meta_iters_per_s",
            ),
            guard=_guard_positive_int("--iters_per_dispatch"),
            description=(
                "K meta-updates per dispatch: the captured train step's "
                "CUDA graph replayed K times from one staged group, "
                "amortizing the per-dispatch host overhead."
            ),
        ),
        Knob(
            name="task_chunk",
            flag="--task_chunk",
            plane="train",
            regime="memory",
            default=0,
            candidates=(0, 2, 4, 8),
            moves=("hbm_peak_bytes", "imagenet_shape_meta_iters_per_s"),
            guard=_guard_task_chunk,
            description=(
                "The meta-batch's tasks taken a chunk at a time inside "
                "the step: trades the tasks' device memory for sequential "
                "chunks, the memory lever for imagenet-shape batches."
            ),
        ),
        Knob(
            name="lane_pad_channels",
            flag="--lane_pad_channels",
            plane="train",
            regime="compute",
            default=False,
            candidates=(False, True),
            moves=("maml++_omniglot_5w1s_meta_iters_per_s", "mfu_pct"),
            description=(
                "Pad conv channel counts up to the next multiple of 64 "
                "(zero lanes, archives unpadded); judged on the "
                "aggregate key."
            ),
        ),
        Knob(
            name="device_prefetch",
            flag="--device_prefetch",
            plane="train",
            regime="dispatch",
            default=-1,
            candidates=(-1, 0, 2, 4, 8),
            moves=("data_wait_frac", "sustained_meta_iters_per_s"),
            description=(
                "Device-prefetch stager depth (-1 auto, 0 off): pinned "
                "host groups copied on a stream of their own, hiding "
                "the transfer behind compute at device-memory cost."
            ),
        ),
        Knob(
            name="mesh_shape",
            flag="--data_parallel_devices/--model_parallel_devices",
            plane="train",
            regime="compute",
            default=(1, 1),
            candidates=((1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2)),
            moves=(
                "multichip_maml_scaling_efficiency",
                "comm_bytes_per_iter",
            ),
            guard=_guard_mesh_shape,
            description=(
                "dp x mp mesh shape: dp shards the task axis, mp the "
                "channel axes. Guarded by device count and meta-batch "
                "divisibility; on one card only (1, 1) is legal."
            ),
        ),
        Knob(
            name="serve_max_batch",
            flag="serve.meta_batch_size",
            plane="serve",
            regime="latency",
            default=4,
            candidates=(1, 2, 4, 8, 16),
            moves=("serve_qps", "serve_p99_ms"),
            guard=_guard_positive_int("serve.meta_batch_size"),
            description=(
                "Serving micro-batch width per dispatch: wider batches "
                "buy QPS at tail-latency cost (the bucket set re-warms "
                "on change)."
            ),
        ),
        Knob(
            name="serve_max_wait_ms",
            flag="serve.max_wait_ms",
            plane="serve",
            regime="latency",
            default=2.0,
            candidates=(0.0, 0.5, 2.0, 5.0, 10.0),
            moves=("serve_p99_ms", "serve_qps"),
            guard=_guard_nonneg("serve.max_wait_ms"),
            description=(
                "Batcher deadline: how long an under-full micro-batch "
                "may wait for co-riders before dispatching anyway."
            ),
        ),
        Knob(
            name="serve_queue_margin",
            flag="serve.degrade_queue_depth/serve.max_queue_depth",
            plane="serve",
            regime="latency",
            default=(16, 64),
            candidates=((8, 32), (16, 64), (32, 128)),
            moves=("serve_error_rate", "serve_p99_ms"),
            description=(
                "Queue-depth margin pair (degrade threshold, hard "
                "cap): where the engine starts shedding accuracy and "
                "where it starts refusing — the overload-vs-tail "
                "dispatch margin."
            ),
        ),
    )
}


def resolve(
    overrides: dict[str, Any] | None = None,
    ctx: TuneContext | None = None,
) -> dict[str, Any]:
    """The full resolved knob set: defaults overlaid with ``overrides``
    (knob-name keyed), every value guard-checked under ``ctx``. Unknown
    override names refuse loudly — a typo must not silently tune
    nothing."""
    ctx = ctx or TuneContext()
    overrides = dict(overrides or {})
    unknown = sorted(set(overrides) - set(SPACE))
    if unknown:
        raise ValueError(
            f"unknown knob(s) {unknown}; registered: {sorted(SPACE)}"
        )
    resolved: dict[str, Any] = {}
    for name, knob in SPACE.items():
        value = overrides.get(name, knob.default)
        knob.check(value, ctx)
        resolved[name] = value
    return resolved


def config_fingerprint(resolved: dict[str, Any]) -> str:
    """Stable 12-hex id of a resolved knob set: sha256 over the
    canonical (sorted-key, no-whitespace) JSON rendering. Tuples and
    lists hash identically (JSON has only arrays) — the fingerprint is
    a value hash, not a Python-type hash."""
    canon = json.dumps(
        {k: resolved[k] for k in sorted(resolved)},
        sort_keys=True,
        separators=(",", ":"),
        default=str,
    )
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:12]


#: argparse attribute -> knob name for the train plane (the serve knobs
#: live on the serve config, not the train parser).
_ARG_ATTRS = {
    "iters_per_dispatch": "iters_per_dispatch",
    "task_chunk": "task_chunk",
    "lane_pad_channels": "lane_pad_channels",
    "device_prefetch": "device_prefetch",
}


def fingerprint_from_args(args: Any) -> str:
    """``config_fingerprint`` of a parsed train-CLI namespace (or any
    object carrying the knob attributes). Missing attributes fall back
    to the knob default — an older config JSON without a knob hashes as
    if the knob were at its default, which is what it runs as. Guards
    are NOT re-checked here: the fingerprint attributes the config that
    actually ran, including one an operator forced past the space."""
    resolved = {name: knob.default for name, knob in SPACE.items()}
    for attr, name in _ARG_ATTRS.items():
        if hasattr(args, attr):
            value = getattr(args, attr)
            # Coerce to the default's type so a pre-normalized namespace
            # (string bools, numeric strings) hashes identically to the
            # processed one.
            if isinstance(SPACE[name].default, bool):
                value = str(value).lower() == "true" if isinstance(value, str) else bool(value)
            elif isinstance(SPACE[name].default, int):
                value = int(value)
            resolved[name] = value
    dp = int(getattr(args, "data_parallel_devices", 1) or 1)
    mp = int(getattr(args, "model_parallel_devices", 1) or 1)
    resolved["mesh_shape"] = (dp, mp)
    return config_fingerprint(resolved)

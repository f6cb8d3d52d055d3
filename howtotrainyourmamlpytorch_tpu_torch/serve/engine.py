"""Bucketed adapt + classify serving engine
(``howtotrainyourmamlpytorch_tpu/serve/engine.py``).

A request class is the bucket ``(way, shot, query)``. ``dispatch`` takes a
group of same-bucket episodes, cuts it into chunks of
``ServeConfig.meta_batch_size`` tasks, pads each chunk's task axis to that
size by repeating row 0 (tasks never mix, so padding leaves the real tasks'
logits as they are), adapts the cache misses and classifies every episode.
Adapted fast weights are cached by support-set digest (``serve/cache.py``).

One interface over the learners' two serving forms: MAML and ANIL adapt
and classify a ``(T, ...)`` task axis in one call; gradient descent,
matching nets and ProtoNets take one task a call, so the engine loops over
the chunk's tasks and stacks their artifacts and logits. With a geometry
lattice (``serve/geometry.py``) every episode is coarsened onto a bucket
at preparation and adapted through the learner's masked twin.

The served state is published as one ``(version, istate)`` pair that a
dispatch reads once, so a concurrent ``update_state`` never mixes two
states in one dispatch; the new state's copy to the card has finished
before it is published, and a cached artifact is used only under the
version it was adapted with. ``warmup`` runs a synthetic episode per
declared bucket and marks the engine ready; ``canary_probe`` runs them
against a candidate state for a safe swap (``serve/resilience/swap.py``).

Each dispatch feeds ``ServeMetrics`` on ``engine.metrics``
(``serve/metrics.py``) and emits a ``serve_dispatch`` event
(``telemetry/events.py``; nothing without a sink). The first dispatch of
each ``(kind, shape)`` signature is counted in the compile table and
emits ``serve_compile``: the port compiles nothing per signature, the
count stands where JAX counts its XLA traces. The program ledger is
ROADMAP A12.

With ``ServeConfig.tier_dir`` the engine keeps a durable tier
(``serve/tier/``): the cache writes through to a crash-consistent spill at
``<tier_dir>/spill``, rehydrated at construction, and on a card the
fused-norm kernel library is loaded from the fenced executable cache at
``<tier_dir>/exec`` (built and stored there on a miss), so a warm respawn
runs no nvcc build. The ``nan_next_logits`` fault poisons the host logits
of a dispatch and of a canary.

The engine runs on the card unless built with ``device="cpu"``, and serves
in float32 with TF32 off and deterministic cuDNN algorithms
(``utils/platform.set_f32_numerics``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..models.common import encode_images
from ..models.maml import MAMLFewShotLearner
from ..telemetry import events as telemetry_events
from ..utils import faultinject
from ..utils.platform import resolve_device, set_f32_numerics
from ..utils.trees import tree_map
from .cache import AdaptedParamsCache, support_digest
from .errors import SwapRejectedError
from .geometry import GeometryPolicy, GeometryRejectedError
from .metrics import ServeMetrics
from .tier import ArtifactSpill, ExecutableCache
from .tier.execcache import PROGRAM

Tree = Any

#: Cap on the client's telemetry tag, which rides every serve_dispatch
#: event.
MAX_TAG_LEN = 128


def confidence_stats(logits: np.ndarray) -> tuple[float, float]:
    """Per-episode confidence from host logits ``(T, C)``: mean top1-top2
    softmax margin and mean predictive entropy; NaN for non-finite logits."""
    logits = np.asarray(logits, np.float64)
    if logits.ndim != 2 or logits.shape[-1] < 2:
        return 1.0, 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        z = logits - np.max(logits, axis=-1, keepdims=True)
        p = np.exp(z)
        p = p / np.sum(p, axis=-1, keepdims=True)
        top2 = np.partition(p, -2, axis=-1)[..., -2:]
        margin = float(np.mean(top2[..., 1] - top2[..., 0]))
        entropy = float(
            np.mean(-np.sum(p * np.log(np.clip(p, 1e-12, None)), axis=-1))
        )
    return margin, entropy


class _Published(NamedTuple):
    """The served state as one object: rebinding it is atomic, so a reader
    never sees one swap's version with another's parameters."""

    version: int
    istate: Any


#: Learner class -> the family name in digests, signatures and metrics.
_LEARNER_FAMILIES = {
    "MAMLFewShotLearner": "maml",
    "ANILLearner": "anil",
    "GradientDescentLearner": "gradient_descent",
    "MatchingNetsLearner": "matching_nets",
    "ProtoNetsLearner": "protonets",
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (the command line: ``serve_maml``)."""

    #: Fixed task axis of every dispatch; groups are chunked and padded to it.
    meta_batch_size: int = 4
    #: Micro-batching window: a request waits at most this long for
    #: same-bucket traffic before its group is flushed.
    max_wait_ms: float = 2.0
    #: Adapted-params cache capacity, in episodes. 0 disables caching.
    cache_capacity: int = 256
    #: Admission hard limit: at this queue depth every request is shed
    #: (503 + Retry-After).
    max_queue_depth: int = 64
    #: Soft limit: at this depth the server is degraded and sheds
    #: cache-miss traffic first. <= 0 disables the degraded tier.
    degrade_queue_depth: int = 16
    #: Age of the oldest queued request that also makes it degraded.
    max_queue_age_ms: float = 2_000.0
    #: ``Retry-After`` seconds of a shed response.
    retry_after_s: float = 1.0
    #: The durable serving tier's root (``serve/tier/``): the cache's
    #: disk spill at ``<tier_dir>/spill`` and the kernel library's
    #: executable cache at ``<tier_dir>/exec``. ``None``: RAM only.
    tier_dir: str | None = None
    #: Disk-spill retention in entries; the oldest (mtime) are pruned past
    #: it. <= 0 disables pruning.
    spill_max_entries: int = 4096
    #: Geometry lattice of ``(way, shot, query)`` buckets; needs
    #: ``norm_layer="layer_norm"``. ``None``: exact buckets.
    geometry_lattice: tuple | None = None

    def __post_init__(self):
        if self.meta_batch_size < 1:
            raise ValueError(
                f"meta_batch_size must be >= 1, got {self.meta_batch_size}"
            )
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )


@dataclasses.dataclass
class EpisodeRequest:
    """One prepared episode: wire-format arrays and its bucket."""

    x_support: np.ndarray  # (S, C, H, W), wire dtype
    y_support: np.ndarray  # (S,), int32
    x_query: np.ndarray  # (Q, C, H, W), wire dtype
    way: int
    shot: int
    digest: str
    #: Absolute ``time.monotonic()`` deadline, or ``None``. The batcher
    #: flushes early for the tightest one and drops expired episodes
    #: before dispatch.
    deadline: float | None = None
    #: Opaque client tag carried into the serve_dispatch event.
    tag: str | None = None
    #: Geometry coarsening, set only with a lattice: the support mask
    #: (1.0 real rows, 0.0 padding) and the real geometry the response is
    #: cut back to; ``way``/``shot`` then hold the bucket's.
    support_mask: np.ndarray | None = None
    real_way: int | None = None
    real_shot: int | None = None
    real_query: int | None = None

    @property
    def bucket(self) -> tuple[int, int, int]:
        return (self.way, self.shot, int(self.x_query.shape[0]))

    @property
    def coarsened(self) -> bool:
        """True when geometry padding grew this episode."""
        return self.real_way is not None and (
            (self.real_way, self.real_shot, self.real_query) != self.bucket
        )

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline


class ServingEngine:
    """Owns the served state, the cache and the metrics."""

    def __init__(self, learner, state, config: ServeConfig | None = None,
                 metrics: ServeMetrics | None = None, device=None):
        self.learner = learner
        self.config = config or ServeConfig()
        self.metrics = metrics or ServeMetrics()
        self.device = resolve_device(device)
        set_f32_numerics()
        self.family = _LEARNER_FAMILIES.get(
            type(learner).__name__, type(learner).__name__.lower()
        )
        # MAML and ANIL take the task axis; the others one task a call.
        self._task_axis = isinstance(learner, MAMLFewShotLearner)
        self.geometry: GeometryPolicy | None = None
        if self.config.geometry_lattice:
            self.geometry = GeometryPolicy(self.config.geometry_lattice)
            self.geometry.validate_backbone(learner.cfg.backbone)
        self.cache = AdaptedParamsCache(self.config.cache_capacity)
        self._published = _Published(0, self.device_istate(state))
        self._lock = threading.Lock()
        self._signatures: dict[str, int] = {}
        self._warmed_buckets: set[tuple[int, int, int]] = set()
        self._dispatch_seq = 0
        #: Warmup done or one dispatch answered; ``/healthz`` is 503 until.
        self.ready = False
        self.trace_id = telemetry_events.ensure_trace_id()
        #: Digest and path of the last promoted checkpoint (``None`` for
        #: the boot state and raw ``update_state`` publishes).
        self.published_digest: str | None = None
        self.published_source: str | None = None
        self._spill: ArtifactSpill | None = None
        self._exec_cache: ExecutableCache | None = None
        #: Where the kernel library came from with a tier on a card
        #: (``"exec_cache"``, ``"build_dir"`` or ``"nvcc"``), else None.
        self.kernel_library: str | None = None
        if self.config.tier_dir:
            self._spill = ArtifactSpill(
                os.path.join(self.config.tier_dir, "spill"),
                max_entries=self.config.spill_max_entries, device=self.device,
            )
            self.cache.attach_spill(self._spill, learner=self.family, state_version=0)
            self._exec_cache = ExecutableCache(
                os.path.join(self.config.tier_dir, "exec"), device=self.device
            )
            self._spill.rehydrate_into(self.cache, learner=self.family, state_version=0,
                                       limit=self.config.cache_capacity)
            if (self.device.type == "cuda"
                    and learner.cfg.backbone.use_pallas_fused_norm):
                self._load_kernel_library()

    # ------------------------------------------------------------------
    # The durable tier
    # ------------------------------------------------------------------

    def _load_kernel_library(self) -> None:
        """The fused-norm library from the executable cache when it holds a
        verified one for this fence; else built (``fused_norm.build``,
        with nvcc afresh after a stale or corrupt entry) and stored. A
        library that does not load raises."""
        from ..ops import fused_norm

        signature = fused_norm.library_digest()
        before = dict(self._exec_cache.stats)
        payload = self._exec_cache.get(PROGRAM, signature)
        if payload is None:
            refused = {k: self._exec_cache.stats[k] - before[k]
                       for k in ("stale", "corrupt_quarantined")}
            path, seconds, _ = fused_norm.build(fresh=any(refused.values()))
            with open(path, "rb") as f:
                self._exec_cache.put(PROGRAM, signature, f.read())
            telemetry_events.emit("tier_exec_rebuilt", program=PROGRAM,
                                  nvcc_s=seconds, **refused)
        self.kernel_library = fused_norm.load_library(payload)

    def tier_stats(self) -> dict | None:
        """The durable tier's counters, or None without one."""
        if self._spill is None:
            return None
        from ..ops import fused_norm

        return {
            "spill": dict(self._spill.stats),
            "spill_promotions": self.cache.spill_hits,
            "spill_write_s": self.cache.spill_write_s,
            "exec": dict(self._exec_cache.stats),
            "kernel_library": self.kernel_library,
            "nvcc_builds": fused_norm.build_stats["nvcc_builds"],
        }

    def rehydrate_spill(self, tier_dir: str) -> int:
        """Adopts the verified entries of another tier directory into this
        cache's RAM: the pool calls it on a dead replica's ring successor,
        so the inherited arc is served from cache. Entries of another
        ``(learner, state_version)`` are skipped."""
        spill = ArtifactSpill(os.path.join(str(tier_dir), "spill"),
                              max_entries=self.config.spill_max_entries,
                              device=self.device)
        return spill.rehydrate_into(self.cache, learner=self.family,
                                    state_version=self.state_version,
                                    limit=self.config.cache_capacity)

    def close(self) -> None:
        """Lands the spill's queued write-throughs."""
        self.cache.close()

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    @property
    def state_version(self) -> int:
        return self._published.version

    def device_istate(self, state):
        """The learner's inference state of ``state`` on the engine's
        device, its copy finished."""
        istate = tree_map(
            lambda a: a.to(self.device), self.learner.inference_state(state)
        )
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return istate

    def update_state(self, state) -> int:
        """Publishes ``state`` with no check (``serve/resilience/swap.py``
        adds the canary; ``ServingAPI.promote`` is the safe entry). The
        ``(version, istate)`` pair is rebound at once; the cache is cleared,
        and new digests carry the new version. Returns the version."""
        istate = self.device_istate(state)
        with self._lock:
            self._published = _Published(self._published.version + 1, istate)
            self.cache.clear()
            if self._spill is not None:
                # Spill reads now verify against the new version, so the
                # old entries are unreachable, as in the RAM LRU.
                self.cache.attach_spill(self._spill, learner=self.family,
                                        state_version=self._published.version)
            return self._published.version

    def warmed_buckets(self) -> list[tuple[int, int, int]]:
        """Buckets served so far (warmup and traffic): the canary set."""
        with self._lock:
            return sorted(self._warmed_buckets)

    def compile_table(self) -> dict[str, int]:
        """``{signature: 1}`` for each ``adapt:BxS`` and ``classify:BxQ``
        dispatched so far."""
        with self._lock:
            return dict(self._signatures)

    def _note_signature(self, label: str) -> None:
        with self._lock:
            first = label not in self._signatures
            if first:
                self._signatures[label] = 1
        if first:
            telemetry_events.emit("serve_compile", program=label, family=self.family)

    # ------------------------------------------------------------------
    # Request preparation
    # ------------------------------------------------------------------

    def prepare_episode(self, x_support, y_support, x_query, *,
                        tag: str | None = None) -> EpisodeRequest:
        """Validates and wire-encodes one raw episode: images
        ``(way, shot, C, H, W)`` or flat ``(S, C, H, W)``, labels ``(S,)`` or
        ``(way, shot)``. Raises ``ValueError`` on what the model cannot
        answer for (``GeometryRejectedError`` where no bucket holds it)."""
        bb = self.learner.cfg.backbone
        expect = (bb.image_channels, bb.image_height, bb.image_width)

        def flat_images(arr, name):
            arr = np.asarray(arr, np.float32)
            if arr.ndim < 4:
                arr = arr.reshape((-1,) + expect)
            else:
                arr = arr.reshape((-1,) + arr.shape[-3:])
            if arr.shape[1:] != expect:
                raise ValueError(
                    f"{name} images have shape {arr.shape[1:]}, the served "
                    f"model expects {expect}"
                )
            return arr

        xs = flat_images(x_support, "support")
        xq = flat_images(x_query, "query")
        ys = np.asarray(y_support, np.int32).reshape(-1)
        if ys.shape[0] != xs.shape[0]:
            raise ValueError(
                f"{ys.shape[0]} support labels for {xs.shape[0]} support images"
            )
        if xs.shape[0] < 1:
            raise ValueError(
                "episode has no support images — a 0-row support set would "
                "adapt on a mean-of-empty (NaN) loss"
            )
        if xq.shape[0] < 1:
            raise ValueError("episode has no query images")
        if ys.min() < 0 or int(ys.max()) >= bb.num_classes:
            raise ValueError(
                f"support labels must lie in [0, {bb.num_classes}) for the "
                "served head"
            )
        # Every class 0..way-1 with the same shot count, so (way, shot) is
        # a shape class and same-bucket episodes stack.
        way = int(ys.max()) + 1
        counts = np.bincount(ys, minlength=way)
        if counts.min() != counts.max():
            raise ValueError(
                "support set must be class-uniform (every class the same "
                f"shot count); got per-class counts {counts.tolist()}"
            )
        shot = int(counts[0])
        support_mask = real_way = real_shot = real_query = None
        if self.geometry is not None:
            # Coarsened before encoding and digesting: the padded arrays
            # are the episode's identity.
            try:
                padded = self.geometry.pad_episode(xs, ys, xq, way=way, shot=shot)
            except GeometryRejectedError:
                self.metrics.geometry_rejected_total.inc()
                raise
            if padded.coarsened:
                self.metrics.geometry_coarsened_total.inc()
            xs, ys, xq = padded.x_support, padded.y_support, padded.x_query
            support_mask = padded.support_mask
            way, shot = padded.way, padded.shot
            real_way, real_shot = padded.real_way, padded.real_shot
            real_query = padded.real_query
        codec = self.learner.cfg.wire_codec
        if codec is not None:
            xs, xq = encode_images(xs, codec), encode_images(xq, codec)
        digest = support_digest(
            xs, ys, learner=self.family, state_version=self.state_version,
            mask=support_mask,
        )
        return EpisodeRequest(
            x_support=xs, y_support=ys, x_query=xq, way=way, shot=shot,
            digest=digest, tag=None if tag is None else str(tag)[:MAX_TAG_LEN],
            support_mask=support_mask, real_way=real_way, real_shot=real_shot,
            real_query=real_query,
        )

    # ------------------------------------------------------------------
    # The learner's serving halves over a task axis
    # ------------------------------------------------------------------

    def _run_adapt(self, istate, xs, ys, mask=None) -> Tree:
        """Adapted artifacts of ``(B, S, ...)`` support sets, with a leading
        ``B`` axis; the masked twin under a geometry lattice."""
        self._note_signature(f"adapt:{xs.shape[0]}x{xs.shape[1]}")
        learner = self.learner
        if self._task_axis:
            if mask is None:
                return learner.serve_adapt(istate, xs, ys)
            return learner.serve_adapt_masked(istate, xs, ys, mask)
        tasks = [
            learner.serve_adapt(istate, xs[t], ys[t]) if mask is None
            else learner.serve_adapt_masked(istate, xs[t], ys[t], mask[t])
            for t in range(xs.shape[0])
        ]
        return tree_map(lambda *a: torch.stack(a), *tasks)

    def _run_classify(self, istate, adapted, xq) -> torch.Tensor:
        """Float32 logits ``(B, Q, classes)`` of ``(B, Q, ...)`` queries."""
        self._note_signature(f"classify:{xq.shape[0]}x{xq.shape[1]}")
        learner = self.learner
        if self._task_axis:
            return learner.serve_classify(istate, adapted, xq)
        return torch.stack([
            learner.serve_classify(istate, tree_map(lambda a: a[t], adapted), xq[t])
            for t in range(xq.shape[0])
        ])

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------

    def dispatch(self, episodes: Sequence[EpisodeRequest]) -> list[np.ndarray]:
        """Serves same-bucket episodes; returns per-episode ``(Q,
        num_classes)`` float32 logits in input order (the real slice of a
        coarsened episode, its padded classes at ``-inf``)."""
        if not episodes:
            return []
        bucket = episodes[0].bucket
        for ep in episodes[1:]:
            if ep.bucket != bucket:
                raise ValueError(
                    f"mixed buckets in one dispatch: {ep.bucket} vs {bucket}"
                    " (the batcher groups by bucket; direct callers must too)"
                )
        out: list[np.ndarray] = []
        chunk = self.config.meta_batch_size
        for start in range(0, len(episodes), chunk):
            out.extend(self._dispatch_chunk(episodes[start : start + chunk]))
        return out

    def _pad_rows(self, arrays: list[np.ndarray]) -> torch.Tensor:
        """Stacks per-episode arrays on a task axis of ``meta_batch_size``,
        row 0 repeated into the padding, and moves them to the device."""
        pad = self.config.meta_batch_size - len(arrays)
        return torch.from_numpy(np.stack(arrays + [arrays[0]] * pad)).to(
            self.device
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_chunk(self, eps: Sequence[EpisodeRequest]) -> list[np.ndarray]:
        b = self.config.meta_batch_size
        # One snapshot for both stages.
        published = self._published
        istate = published.istate
        metrics = self.metrics
        metrics.batches_dispatched.inc()
        metrics.padded_tasks.inc(b - len(eps))
        metrics.record_bucket_dispatch(eps[0].bucket, len(eps))

        # An artifact is cached with the version it was adapted under, and
        # used only under that version.
        artifacts: list[Tree | None] = []
        for ep in eps:
            cached = self.cache.get(ep.digest)
            hit = cached is not None and cached[0] == published.version
            artifacts.append(cached[1] if hit else None)
        miss = [i for i, a in enumerate(artifacts) if a is None]
        metrics.cache_hits.inc(len(eps) - len(miss))
        metrics.cache_misses.inc(len(miss))
        adapt_ms = None
        if miss:
            xs = self._pad_rows([eps[i].x_support for i in miss])
            ys = self._pad_rows([eps[i].y_support for i in miss])
            mask = None
            if self.geometry is not None:
                mask = self._pad_rows([eps[i].support_mask for i in miss])
            t0 = time.perf_counter()
            adapted = self._run_adapt(istate, xs, ys, mask)
            self._sync()
            adapt_ms = (time.perf_counter() - t0) * 1e3
            metrics.adapt_latency.observe(adapt_ms)
            for row, i in enumerate(miss):
                artifacts[i] = tree_map(lambda a: a[row].clone(), adapted)
                self.cache.put(eps[i].digest, (published.version, artifacts[i]))

        padded = artifacts + [artifacts[0]] * (b - len(eps))
        stacked = tree_map(lambda *leaves: torch.stack(leaves), *padded)
        xq = self._pad_rows([ep.x_query for ep in eps])
        t0 = time.perf_counter()
        host = faultinject.poison_logits(
            self._run_classify(istate, stacked, xq).cpu().numpy())
        classify_ms = (time.perf_counter() - t0) * 1e3
        metrics.classify_latency.observe(classify_ms)
        metrics.episodes_served.inc(len(eps))
        with self._lock:
            self._warmed_buckets.add(eps[0].bucket)
            self._dispatch_seq += 1
            dispatch_id = self._dispatch_seq
        self.ready = True

        # Padded query rows are cut off and classes past the real way set
        # to -inf; confidence and the non-finite count read the real slice.
        margins, entropies, nonfinite, results = [], [], 0, []
        for i, ep in enumerate(eps):
            row = host[i]
            if ep.real_query is not None and ep.real_query < row.shape[0]:
                row = row[: ep.real_query]
            real = row
            if ep.real_way is not None and ep.real_way < row.shape[1]:
                real = row[:, : ep.real_way]
                row = row.copy()
                row[:, ep.real_way :] = -np.inf
            nonfinite += int(not np.isfinite(real).all())
            margin, entropy = confidence_stats(real)
            margins.append(margin)
            entropies.append(entropy)
            results.append(row)
        if nonfinite:
            metrics.nonfinite_logits_total.inc(nonfinite)
        telemetry_events.emit(
            "serve_dispatch",
            dispatch_id=dispatch_id,
            bucket="x".join(str(d) for d in eps[0].bucket),
            family=self.family,
            episodes=len(eps),
            coarsened=sum(1 for ep in eps if ep.coarsened),
            cache_hits=len(eps) - len(miss),
            adapt_ms=adapt_ms,
            classify_ms=classify_ms,
            n_devices=1,
            margins=margins,
            entropies=entropies,
            tags=[ep.tag for ep in eps],
            nonfinite=nonfinite,
        )
        return results

    # ------------------------------------------------------------------
    # Warmup and the hot-swap canary
    # ------------------------------------------------------------------

    def _synthetic_episode(self, way: int, shot: int, query: int) -> EpisodeRequest:
        """A fixed episode at a bucket, drawn from a seeded
        ``torch.Generator``: uniform images (non-zero, so a NaN bias cannot
        hide behind a ReLU), classes in order."""
        bb = self.learner.cfg.backbone
        way = min(int(way), bb.num_classes)
        img = (bb.image_channels, bb.image_height, bb.image_width)
        gen = torch.Generator().manual_seed(0)
        xs = torch.rand((way * shot,) + img, generator=gen).numpy()
        ys = np.repeat(np.arange(way), shot).astype(np.int32)
        xq = torch.rand((query,) + img, generator=gen).numpy()
        return self.prepare_episode(xs, ys, xq)

    def _probe(self, istate, ep: EpisodeRequest) -> np.ndarray:
        """Host logits ``(B, Q, classes)`` of one episode, padded to the
        task axis, outside the cache and the episode counters."""
        mask = None if self.geometry is None else self._pad_rows([ep.support_mask])
        adapted = self._run_adapt(
            istate, self._pad_rows([ep.x_support]), self._pad_rows([ep.y_support]),
            mask,
        )
        return self._run_classify(
            istate, adapted, self._pad_rows([ep.x_query])
        ).cpu().numpy()

    def warmup(self, buckets: Sequence[tuple[int, int, int]] | None = None) -> None:
        """Serves one synthetic episode at each ``(way, shot, query)``
        bucket (the whole lattice by default under one), outside the cache,
        and marks the engine ready."""
        if buckets is None:
            if self.geometry is None:
                raise ValueError(
                    "warmup() needs explicit buckets without a geometry "
                    "lattice (with one, the lattice IS the warm set)"
                )
            buckets = list(self.geometry.lattice)
        istate = self._published.istate
        for way, shot, query in buckets:
            ep = self._synthetic_episode(way, shot, query)
            self._probe(istate, ep)
            with self._lock:
                self._warmed_buckets.add(ep.bucket)
        self.ready = True

    def canary_probe(self, istate, buckets=None) -> list[tuple[int, int, int]]:
        """One synthetic episode per bucket (the warmed ones by default)
        against a candidate ``istate`` on the engine's device; raises
        ``SwapRejectedError`` at the first non-finite logit. Returns the
        buckets probed."""
        probed = list(buckets) if buckets is not None else self.warmed_buckets()
        for way, shot, query in probed:
            logits = faultinject.poison_logits(
                self._probe(istate, self._synthetic_episode(way, shot, query)))
            if not np.isfinite(logits).all():
                raise SwapRejectedError(
                    f"canary episode at bucket {way}x{shot}x{query} produced "
                    "non-finite logits — refusing to promote this state",
                    reason="nonfinite_logits",
                )
        return probed

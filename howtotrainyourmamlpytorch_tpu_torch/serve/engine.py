"""Bucketed adapt + classify serving engine
(``howtotrainyourmamlpytorch_tpu/serve/engine.py:63-81,104-216,566-806``).

A request class is the bucket ``(way, shot, query)``. ``dispatch`` takes a
group of same-bucket episodes, cuts it into chunks of
``ServeConfig.meta_batch_size`` tasks, pads each chunk's task axis to that
size by repeating row 0 (tasks never mix, so padding leaves the real tasks'
logits as they are), adapts the cache misses, and classifies every episode.
Adapted fast weights are cached by support-set digest.

The engine runs on the card unless built with ``device="cpu"``, and serves
in float32 with TF32 off and deterministic cuDNN algorithms
(``utils/platform.set_f32_numerics``). Stage timings and
counts go to the plain ``ServeStats`` on ``engine.stats``. Geometry
coarsening, the durable tier, the batcher, the HTTP API, metrics and
telemetry come with the later serving slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..models.common import encode_images
from ..utils.platform import resolve_device, set_f32_numerics
from ..utils.trees import tree_map
from .cache import AdaptedParamsCache, support_digest

Tree = Any


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


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    #: Fixed task axis of every dispatch; groups are chunked and padded to it.
    meta_batch_size: int = 4
    #: Adapted-params cache capacity, in episodes. 0 disables caching.
    cache_capacity: int = 256

    def __post_init__(self):
        if self.meta_batch_size < 1:
            raise ValueError(
                f"meta_batch_size must be >= 1, got {self.meta_batch_size}"
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

    @property
    def bucket(self) -> tuple[int, int, int]:
        return (self.way, self.shot, int(self.x_query.shape[0]))


@dataclasses.dataclass
class ServeStats:
    """Counts, per-episode confidence (``confidence_stats``) and
    per-dispatch stage times (milliseconds, host clock around work that
    ends in a device synchronize)."""

    batches_dispatched: int = 0
    padded_tasks: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    episodes_served: int = 0
    nonfinite_episodes: int = 0
    margins: list = dataclasses.field(default_factory=list)
    entropies: list = dataclasses.field(default_factory=list)
    adapt_ms: list = dataclasses.field(default_factory=list)
    classify_ms: list = dataclasses.field(default_factory=list)


class ServingEngine:
    """Owns the served state, the cache and the stats."""

    family = "maml"

    def __init__(self, learner, state, config: ServeConfig | None = None,
                 device=None):
        self.learner = learner
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        set_f32_numerics()
        self.istate = tree_map(
            lambda a: a.to(self.device), learner.inference_state(state)
        )
        self.state_version = 0
        self.cache = AdaptedParamsCache(self.config.cache_capacity)
        self.stats = ServeStats()

    # ------------------------------------------------------------------
    # Request preparation
    # ------------------------------------------------------------------

    def prepare_episode(self, x_support, y_support, x_query) -> EpisodeRequest:
        """Validates and wire-encodes one raw episode: images
        ``(way, shot, C, H, W)`` or flat ``(S, C, H, W)``, labels ``(S,)`` or
        ``(way, shot)``. Raises ``ValueError`` on what the model cannot
        answer for."""
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
            raise ValueError("episode has no support images")
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
        codec = self.learner.cfg.wire_codec
        if codec is not None:
            xs, xq = encode_images(xs, codec), encode_images(xq, codec)
        digest = support_digest(
            xs, ys, learner=self.family, state_version=self.state_version
        )
        return EpisodeRequest(
            x_support=xs, y_support=ys, x_query=xq,
            way=way, shot=int(counts[0]), digest=digest,
        )

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------

    def dispatch(self, episodes: Sequence[EpisodeRequest]) -> list[np.ndarray]:
        """Serves same-bucket episodes; returns per-episode ``(Q,
        num_classes)`` float32 logits in input order."""
        if not episodes:
            return []
        bucket = episodes[0].bucket
        for ep in episodes[1:]:
            if ep.bucket != bucket:
                raise ValueError(
                    f"mixed buckets in one dispatch: {ep.bucket} vs {bucket}"
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
        istate = self.istate
        stats = self.stats
        stats.batches_dispatched += 1
        stats.padded_tasks += b - len(eps)

        artifacts: list[Tree | None] = [self.cache.get(ep.digest) for ep in eps]
        miss = [i for i, a in enumerate(artifacts) if a is None]
        stats.cache_hits += len(eps) - len(miss)
        stats.cache_misses += len(miss)
        if miss:
            xs = self._pad_rows([eps[i].x_support for i in miss])
            ys = self._pad_rows([eps[i].y_support for i in miss])
            t0 = time.perf_counter()
            adapted = self.learner.serve_adapt(istate, xs, ys)
            self._sync()
            stats.adapt_ms.append((time.perf_counter() - t0) * 1e3)
            for row, i in enumerate(miss):
                artifacts[i] = tree_map(lambda a: a[row].clone(), adapted)
                self.cache.put(eps[i].digest, artifacts[i])

        padded = artifacts + [artifacts[0]] * (b - len(eps))
        stacked = tree_map(lambda *leaves: torch.stack(leaves), *padded)
        xq = self._pad_rows([ep.x_query for ep in eps])
        t0 = time.perf_counter()
        logits = self.learner.serve_classify(istate, stacked, xq).cpu().numpy()
        stats.classify_ms.append((time.perf_counter() - t0) * 1e3)
        stats.episodes_served += len(eps)
        results = [logits[i] for i in range(len(eps))]
        for row in results:
            stats.nonfinite_episodes += int(not np.isfinite(row).all())
            margin, entropy = confidence_stats(row)
            stats.margins.append(margin)
            stats.entropies.append(entropy)
        return results

"""Episode-geometry coarsening: mixed (way, shot, query) traffic through a
fixed set of buckets (``howtotrainyourmamlpytorch_tpu/serve/geometry.py``).

The operator declares a small lattice of ``(way, shot, query)`` buckets.
Every episode is coarsened up to the smallest entry that holds it:

* the support grows from ``way * shot`` rows to ``W * S`` rows of zero
  images with label 0, and a float32 ``support_mask`` (1.0 over the real
  prefix, 0.0 over the padding) rides with it into the masked adapt;
* the queries grow from ``query`` rows to ``Q`` zero rows, sliced off the
  response again;
* an episode no entry holds is rejected at the front door
  (``GeometryRejectedError``, a ``ValueError``: HTTP 400, naming the
  lattice).

Padding adds exactly zero to each learner's masked adapt (the masked
cross-entropy of MAML, ANIL and gradient descent, zero-weight rows of the
prototype means, masked attention slots of matching nets), so the logits
over the real classes are those of a dispatch at the episode's true
geometry. That needs a forward in which rows do not mix:
``norm_layer="layer_norm"``. Batch statistics would let a padded row move
every real row, so the policy refuses any other backbone.

NumPy only: the policy runs at request preparation and holds no tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["GeometryPolicy", "GeometryRejectedError", "PaddedEpisode"]

#: The row-independent norm coarsening requires (``models/backbone.py``).
ROW_INDEPENDENT_NORM = "layer_norm"


class GeometryRejectedError(ValueError):
    """No lattice entry can hold the episode: a client error (400), not
    overload; the message names the lattice."""


@dataclasses.dataclass(frozen=True)
class PaddedEpisode:
    """An episode coarsened onto a lattice entry: padded arrays, the mask
    and both geometries (``way``/``shot``/``query`` the bucket it rides,
    ``real_*`` the slice the client gets back)."""

    x_support: np.ndarray  # (W*S, C, H, W) float32, zero tail
    y_support: np.ndarray  # (W*S,) int32, label 0 over the padding
    x_query: np.ndarray  # (Q, C, H, W) float32, zero tail
    support_mask: np.ndarray  # (W*S,) float32
    way: int
    shot: int
    query: int
    real_way: int
    real_shot: int
    real_query: int

    @property
    def coarsened(self) -> bool:
        return (self.way, self.shot, self.query) != (
            self.real_way, self.real_shot, self.real_query
        )


def _slot_cost(entry: tuple[int, int, int]) -> int:
    """The rows a bucket dispatches, which coarsening keeps least."""
    way, shot, query = entry
    return way * shot + query


class GeometryPolicy:
    """A declared bucket lattice and the map onto it; immutable."""

    def __init__(self, lattice: Sequence[Sequence[int]]):
        entries = []
        for raw in lattice:
            entry = tuple(int(d) for d in raw)
            if len(entry) != 3 or min(entry) < 1:
                raise ValueError(
                    "geometry lattice entries must be (way, shot, query) "
                    f"triples of positive ints, got {raw!r}"
                )
            entries.append(entry)
        if not entries:
            raise ValueError("geometry lattice must declare at least one bucket")
        # Slot cost, then lexicographic: ``coarsen`` takes the first entry
        # that holds an episode, so every process picks the same bucket.
        self.lattice: tuple[tuple[int, int, int], ...] = tuple(
            sorted(set(entries), key=lambda e: (_slot_cost(e), e))
        )

    def __repr__(self) -> str:
        return f"GeometryPolicy({list(self.lattice)!r})"

    def describe(self) -> str:
        return ", ".join("x".join(str(d) for d in e) for e in self.lattice)

    def validate_backbone(self, backbone_cfg) -> None:
        """Refuses a backbone whose forward mixes rows, or a head narrower
        than the lattice's widest way."""
        norm = getattr(backbone_cfg, "norm_layer", None)
        if norm != ROW_INDEPENDENT_NORM:
            raise ValueError(
                "episode-geometry coarsening requires a row-independent "
                f"backbone forward (norm_layer={ROW_INDEPENDENT_NORM!r}); "
                f"got norm_layer={norm!r}, whose batch statistics would let "
                "padded zero rows perturb real logits"
            )
        max_way = max(e[0] for e in self.lattice)
        num_classes = int(getattr(backbone_cfg, "num_classes", max_way))
        if max_way > num_classes:
            raise ValueError(
                f"geometry lattice declares way {max_way} but the served "
                f"head has only {num_classes} classes"
            )

    def coarsen(self, way: int, shot: int, query: int) -> tuple[int, int, int]:
        """The first (fewest slots) lattice entry holding ``(way, shot,
        query)``, or ``GeometryRejectedError``."""
        for entry in self.lattice:
            if entry[0] >= way and entry[1] >= shot and entry[2] >= query:
                return entry
        raise GeometryRejectedError(
            f"no geometry bucket can contain a {way}-way {shot}-shot "
            f"{query}-query episode; the declared lattice is "
            f"[{self.describe()}] — re-shape the episode to fit a bucket "
            "(this is a request-shape error, not overload: retrying the "
            "same episode cannot succeed)"
        )

    def pad_episode(self, x_support: np.ndarray, y_support: np.ndarray,
                    x_query: np.ndarray, *, way: int, shot: int) -> PaddedEpisode:
        """Coarsens one validated flat float32 episode (support ``(way*shot,
        C, H, W)``, labels ``(way*shot,)``, queries ``(T, C, H, W)``) up to
        its bucket; the real rows stay a prefix in their order."""
        real_query = int(x_query.shape[0])
        target_way, target_shot, target_query = self.coarsen(way, shot, real_query)
        n_real = int(x_support.shape[0])
        n_rows = target_way * target_shot
        xs = np.zeros((n_rows,) + x_support.shape[1:], np.float32)
        xs[:n_real] = x_support
        ys = np.zeros((n_rows,), np.int32)
        ys[:n_real] = y_support
        mask = np.zeros((n_rows,), np.float32)
        mask[:n_real] = 1.0
        xq = np.zeros((target_query,) + x_query.shape[1:], np.float32)
        xq[:real_query] = x_query
        return PaddedEpisode(
            x_support=xs, y_support=ys, x_query=xq, support_mask=mask,
            way=target_way, shot=target_shot, query=target_query,
            real_way=int(way), real_shot=int(shot), real_query=real_query,
        )

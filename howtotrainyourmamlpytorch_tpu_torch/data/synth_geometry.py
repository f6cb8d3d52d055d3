"""Seeded synthetic episodes at any (way, shot, query) geometry
(``howtotrainyourmamlpytorch_tpu/data/synth_geometry.py``).

The serving tests and ``chip_smoke.py`` need streams of well-formed
episodes whose geometry varies per episode, which the training pipeline
never makes. NumPy's ``RandomState`` draws them in the JAX module's order,
so the same seed gives byte-identical episodes in both packages. Each
class has its own mean image plus small noise, so the classes are
separable and served logits are not degenerate.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["synthesize_episode", "geometry_mix_episodes"]


def synthesize_episode(way: int, shot: int, query: int, *,
                       image_shape: tuple[int, int, int], seed: int = 0):
    """One class-uniform ``(x_support (way*shot, C, H, W) float32 in class
    order, y_support (way*shot,) int32, x_query (query, C, H, W) float32)``
    episode, queries drawn round-robin from the class means."""
    way, shot, query = int(way), int(shot), int(query)
    if min(way, shot, query) < 1:
        raise ValueError(f"episode geometry must be positive, got {(way, shot, query)}")
    rng = np.random.RandomState(seed)
    img = tuple(int(d) for d in image_shape)
    means = rng.rand(way, *img).astype(np.float32)
    xs = np.clip(
        np.repeat(means, shot, axis=0)
        + 0.05 * rng.randn(way * shot, *img).astype(np.float32),
        0.0, 1.0,
    ).astype(np.float32)
    ys = np.repeat(np.arange(way), shot).astype(np.int32)
    q_classes = np.arange(query) % way
    xq = np.clip(
        means[q_classes] + 0.05 * rng.randn(query, *img).astype(np.float32),
        0.0, 1.0,
    ).astype(np.float32)
    return xs, ys, xq


def geometry_mix_episodes(n: int, mix: Sequence[Sequence[int]], *,
                          image_shape: tuple[int, int, int], seed: int = 0):
    """``n`` episodes cycling ``mix``: episode ``i`` at geometry ``mix[i %
    len(mix)]`` with seed ``seed + i``."""
    mix = [tuple(int(d) for d in g) for g in mix]
    if not mix:
        raise ValueError("geometry mix must name at least one geometry")
    return [
        synthesize_episode(*mix[i % len(mix)], image_shape=image_shape, seed=seed + i)
        for i in range(int(n))
    ]

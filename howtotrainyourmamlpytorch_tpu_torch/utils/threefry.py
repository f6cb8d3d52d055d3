"""The counter-based Threefry-2x32 generator of ``jax.random``, bit for bit,
in torch integer ops (``jax._src.prng``, with ``jax_threefry_partitionable``
on, jax 0.9's default).

A key is an int64 tensor of shape ``(2,)`` holding two unsigned 32-bit
words; every word is kept in ``[0, 2**32)`` by masking, as torch has no
unsigned 32-bit arithmetic. The functions run on the key's device and
launch no host synchronisation, so a captured train step may call them.
Only ``models/common.crop_flip_by_key`` uses them: the on-device crop and
flip of the cifar episodes, whose draws must be JAX's own.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of the count pairs ``(x0, x1)`` (int64, words
    in ``[0, 2**32)``) under ``key``: 20 rounds, the key injected every
    four (``_threefry2x32_lowering``)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of a seed in ``[0, 2**32)`` (an int or
    a scalar tensor): the words ``(0, seed)``."""
    seed = torch.as_tensor(seed, device=device).to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(seed), seed])


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, zero, zero + (int(data) & MASK))
    return torch.stack([y0, y1])


def _counts(n: int, device):
    """``iota_2x32_shape``'s two words of the counts ``0 .. n-1``."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the fold-like form): ``(num, 2)`` keys."""
    y0, y1 = threefry2x32(key, *_counts(num, key.device))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape``: the two words of each
    count's hash, xored."""
    n = 1
    for d in shape:
        n *= int(d)
    y0, y1 = threefry2x32(key, *_counts(n, key.device))
    return (y0 ^ y1).reshape(tuple(shape))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32 in ``[minval, maxval)``: two draws
    of 32 bits reduced modulo the span, the first scaled by ``2**32`` mod
    the span (``_randint``)."""
    span = max(int(maxval) - int(minval), 1)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    multiplier = (2 ** 16 % span) ** 2 % span
    offset = ((higher % span) * multiplier + lower % span) % span
    return (offset + int(minval)).to(torch.int32)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform`` float32 in ``[0, 1)``: 23 random mantissa
    bits under the exponent of 1.0, less 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < p``."""
    return uniform(key, shape) < p

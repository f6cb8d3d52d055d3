"""The port's Threefry-2x32 (``utils/threefry.py``) against ``jax.random``
under jax's default partitionable mode, bit for bit: keys from seeds,
``fold_in``, ``split``, ``randint``, ``uniform`` and ``bernoulli``, over 120
seeds across the uint32 range (the episode seeds of the cifar crop/flip
are uint32)."""

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu_torch.utils import threefry

SEEDS = [int(s) for s in np.random.RandomState(3).randint(0, 2**32, size=100, dtype=np.uint64)]
SEEDS += list(range(10)) + [2**31 - 1, 2**31, 2**32 - 1, 77, 1234, 5, 11, 123456789,
                            4000000000, 65536]


def _np(key):
    return np.asarray(jax.random.key_data(key) if jax.dtypes.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key)


def test_partitionable_mode_is_the_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("group", range(4))
def test_draws_match_jax(group):
    for seed in SEEDS[group::4]:
        jkey = jax.random.PRNGKey(np.uint32(seed))
        key = threefry.prng_key(seed)
        np.testing.assert_array_equal(key.numpy(), _np(jkey).astype(np.int64))
        for stream in (0, 1, 7):
            jk, k = jax.random.fold_in(jkey, stream), threefry.fold_in(key, stream)
            np.testing.assert_array_equal(k.numpy(), _np(jk))
            (ja, jb), (a, b) = jax.random.split(jk), threefry.split(k)
            np.testing.assert_array_equal(a.numpy(), _np(ja))
            np.testing.assert_array_equal(b.numpy(), _np(jb))
            got = threefry.randint(a, (6, 2), 0, 9)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax.random.randint(ja, (6, 2), 0, 9))
            )
            (jc, jd), (c, d) = jax.random.split(jb), threefry.split(b)
            np.testing.assert_array_equal(
                threefry.uniform(c, (5,)).numpy(),
                np.asarray(jax.random.uniform(jc, (5,))),
            )
            np.testing.assert_array_equal(
                threefry.bernoulli(d, 0.5, (6,)).numpy(),
                np.asarray(jax.random.bernoulli(jd, 0.5, (6,))),
            )


def test_randint_spans_match_jax():
    """Spans that are not powers of two, each from its own key of a key
    split four ways."""
    keys = threefry.split(threefry.prng_key(2024), 4)
    jkeys = jax.random.split(jax.random.PRNGKey(2024), 4)
    np.testing.assert_array_equal(keys.numpy(), _np(jkeys))
    for key, jkey, (lo, hi) in zip(keys, jkeys, ((0, 9), (0, 3), (-5, 17), (3, 1000))):
        np.testing.assert_array_equal(
            threefry.randint(key, (4, 3), lo, hi).numpy(),
            np.asarray(jax.random.randint(jkey, (4, 3), lo, hi)),
        )

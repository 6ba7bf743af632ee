"""grafx_tpu_torch.random against jax.random: PRNGKey, fold_in, split,
uniform and randint bit for bit, for several keys (one of them above
2^31) and the shapes (), (3,) and (2, 2, 2048), under JAX's defaults
(threefry2x32, partitionable)."""

import jax
import numpy as np
import pytest
import torch

from grafx_tpu_torch import random as tr

SEEDS = [0, 42, 2**31 + 5, -1]
SHAPES = [(), (3,), (2, 2, 2048)]
BOUNDS = [(0, 240000), (-5, 7), (3, 3), (-(2**31), 2**31 - 1)]


def test_defaults_are_the_ones_matched():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_are_bit_equal(seed):
    jkey, tkey = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(tr.key_to_numpy(tkey), np.asarray(jkey))
    assert tkey.dtype == torch.int64 and tkey.shape == (2,)
    for data in (0, 1, 7, 2**31 + 3):
        np.testing.assert_array_equal(
            tr.key_to_numpy(tr.fold_in(tkey, data)), np.asarray(jax.random.fold_in(jkey, data))
        )
    for num in (2, 5, (2, 3)):
        np.testing.assert_array_equal(tr.split(tkey, num).numpy(), np.asarray(jax.random.split(jkey, num)))
    # a key carried across from JAX draws as the key made here
    np.testing.assert_array_equal(tr.key_from_numpy(np.asarray(jkey)).numpy(), tkey.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint_are_bit_equal(seed, shape):
    # a derived key: both words of a fold are anywhere in [0, 2^32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tkey = tr.key_from_numpy(np.asarray(jkey))
    got = tr.uniform(tkey, shape).numpy()
    ref = np.asarray(jax.random.uniform(jkey, shape))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    for lo, hi in BOUNDS:
        got = tr.randint(tkey, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.random.randint(jkey, shape, lo, hi)))


def test_keys_refuse_what_jax_would_not_take():
    with pytest.raises(ValueError, match="int64 tensor of shape"):
        tr.uniform(torch.zeros(2, dtype=torch.int32), (3,))
    with pytest.raises(ValueError, match="two integer words"):
        tr.key_from_numpy(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="int32 range"):
        tr.randint(tr.PRNGKey(0), (), 0, 2**31)
    with pytest.raises(TypeError, match="integer"):
        tr.PRNGKey(1.5)

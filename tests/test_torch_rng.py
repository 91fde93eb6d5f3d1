"""The port's threefry stream is bit-identical to jax.random (x64 mode, the
partitionable threefry layout of the pinned JAX)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)


def _np(k):
    return np.asarray(k).astype(np.int64)


def test_partitionable_layout_is_the_pinned_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 1769, 0x5CA9, 2**31 - 1, 2**40 + 12345])
def test_prng_key(seed):
    assert rng.PRNGKey(seed).tolist() == _np(jax.random.PRNGKey(seed)).tolist()


def test_split_and_fold_in_many():
    base = jax.random.PRNGKey(1769)
    kt = rng.PRNGKey(1769)
    np.testing.assert_array_equal(rng.split(kt, 4096).numpy(), _np(jax.random.split(base, 4096)))
    data = np.arange(0, 40000, 7, dtype=np.int64)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(base, jnp.asarray(data))
    np.testing.assert_array_equal(rng.fold_in(kt, torch.from_numpy(data)).numpy(), _np(want))
    # batched keys folded with per-key data (the tree's per-node draws)
    keys = jax.random.split(base, 1000)
    got = rng.fold_in(rng.split(kt, 1000), torch.arange(1000) * 3 + 1)
    want = jax.vmap(jax.random.fold_in)(keys, jnp.arange(1000) * 3 + 1)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_uniform_bitwise(dtype):
    base = jax.random.PRNGKey(42)
    kt = rng.PRNGKey(42)
    tdt = getattr(torch, dtype)
    want = np.asarray(jax.random.uniform(base, (12000,), dtype=getattr(jnp, dtype)))
    got = rng.uniform(kt, (12000,), dtype=tdt).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # one scalar draw per key over many keys (the sampler's per-event draws)
    keys = jax.random.split(base, 10000)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, dtype=getattr(jnp, dtype)))(keys))
    np.testing.assert_array_equal(rng.uniform(rng.split(kt, 10000), dtype=tdt).numpy(), want)
    # vector draws per key
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,), dtype=getattr(jnp, dtype)))(keys))
    np.testing.assert_array_equal(rng.uniform(rng.split(kt, 10000), (3,), dtype=tdt).numpy(),
                                  want)


@pytest.mark.parametrize("lo,hi", [(1, 7), (0, 2), (3, 1000), (-5, 5)])
def test_randint_bitwise(lo, hi):
    keys = jax.random.split(jax.random.PRNGKey(7), 10000)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(keys))
    got = rng.randint(rng.split(rng.PRNGKey(7), 10000), (), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)

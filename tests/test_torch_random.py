"""The port's threefry RNG against ``jax.random`` (partitionable layout,
the installed default): key/split/fold_in bits and uniforms bitwise,
normals within 1 ulp (they come out bitwise equal; 1 ulp is the bound
the port promises)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import integrators as jI
from repro_torch import random as jr
from repro_torch.md import integrators as tI

SEEDS = [0, 1, 42, 123456789, 2 ** 31 - 1]


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    jk, tk = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(jr.split(tk, num).numpy(),
                                      _data(jax.random.split(jk, num)))
    for d in (0, 1, 7, 2 ** 31 + 5):
        np.testing.assert_array_equal(jr.fold_in(tk, d).numpy(),
                                      _data(jax.random.fold_in(jk, d)))


def test_batched_keys_match_vmap():
    """A leading key axis is the counterpart of vmap over keys."""
    jks = jax.random.split(jax.random.key(3), 5)
    tks = jr.split(jr.key(3), 5)
    np.testing.assert_array_equal(
        jr.split(tks, 3).numpy(),
        _data(jax.vmap(lambda k: jax.random.split(k, 3))(jks)))
    np.testing.assert_array_equal(
        jr.fold_in(tks, 4).numpy(),
        _data(jax.vmap(lambda k: jax.random.fold_in(k, 4))(jks)))
    assert _ulps(jr.normal(tks, (6, 3)).numpy(), np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (6, 3)))(jks))).max() <= 1


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (33, 5)])
def test_uniform_bitwise(seed, shape):
    jk, tk = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(jr.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        jr.uniform(tk, shape, -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(10, 3), (4000, 3)])
def test_normal_within_one_ulp(seed, shape):
    got = jr.normal(jr.key(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    assert _ulps(got, want).max() <= 1


def test_normal_tails_within_one_ulp():
    """A large draw reaches the w >= 5 branch of erf_inv (|u| > 0.9966)."""
    got = jr.normal(jr.key(7), (500_000,)).numpy()
    want = np.asarray(jax.random.normal(jax.random.key(7), (500_000,)))
    assert np.abs(want).max() > 3.0
    assert _ulps(got, want).max() <= 1


def test_erf_inv_within_one_ulp():
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    x = np.linspace(lo, -lo, 200_001, dtype=np.float32)
    got = jr.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert _ulps(got, want).max() <= 1


@pytest.mark.parametrize("n_steps", [1, 4])
def test_stacked_step_noise_matches(n_steps):
    """The propagate loop's pre-drawn noise: fold_in(key_r, t) streams."""
    jkeys = jax.random.split(jax.random.key(11), 3)
    tkeys = jr.split(jr.key(11), 3)
    got = tI.stacked_step_noise(tkeys, n_steps, (5, 3)).numpy()
    want = np.asarray(jI.stacked_step_noise(jkeys, n_steps, (5, 3)))
    assert got.shape == want.shape
    assert _ulps(got, want).max() <= 1


@pytest.mark.parametrize("k0", [0, 5, 2 ** 31 - 3])
def test_random_bits_past_two_to_the_32(k0):
    """Element i of a draw hashes the counter words (i >> 32, i &
    0xffffffff) under JAX's partitionable threefry
    (``prng.iota_2x32_shape``): the port's words at flat index 2^32 + k
    are JAX's threefry2x32 on (1, k), called on those words directly (a
    DeepSeek-MoE-16B expert leaf holds 4.98e9 elements)."""
    from jax._src import prng
    hi, lo = prng.iota_2x32_shape((3, 4))
    np.testing.assert_array_equal(np.asarray(hi), 0)
    np.testing.assert_array_equal(np.asarray(lo).ravel(), np.arange(12))
    key = jax.random.fold_in(jax.random.key(0), 17)
    k1, k2 = (jnp.asarray(w, jnp.uint32) for w in _data(key))
    lo = jnp.arange(k0, k0 + 8, dtype=jnp.uint32)
    b1, b2 = prng.threefry2x32_p.bind(k1, k2, jnp.ones_like(lo), lo)
    want = np.asarray(b1 ^ b2).astype(np.int64)
    got = jr.random_bits(torch.from_numpy(_data(key)), (8,), 2 ** 32 + k0)
    np.testing.assert_array_equal(got.numpy(), want)
    # across the boundary: the high word steps from 0 to 1
    got = jr.random_bits(torch.from_numpy(_data(key)), (4,), 2 ** 32 - 2)
    b1, b2 = prng.threefry2x32_p.bind(
        k1, k2, jnp.asarray([0, 0, 1, 1], jnp.uint32),
        jnp.asarray([2 ** 32 - 2, 2 ** 32 - 1, 0, 1], jnp.uint32))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(b1 ^ b2).astype(np.int64))

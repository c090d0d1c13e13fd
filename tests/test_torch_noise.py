"""The fused path's noise stream: the port's ``md/noise.py`` against the
JAX package's ``repro.md.noise`` — the threefry counter layout with the
halved (legacy) counters, an odd flat size padded with one zero, and the
bits -> normal map.

Tolerance: none.  The exchange decisions of the fused path depend on
every normal, so the stream must be bitwise equal (the installed JAX
keeps its default, partitionable threefry; the flag is not flipped).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import integrators as jI
from repro.md import noise as jN
from repro_torch.kernels.noise import ref as tR
from repro_torch.md import integrators as tI
from repro_torch.md import noise as tN

R = 4


def _keys(seed):
    kd = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), R)))
    return kd, torch.from_numpy(kd.astype(np.int64))


@pytest.mark.parametrize("shape", [(5, 3), (8, 3), (7, 1), (2,)])
@pytest.mark.parametrize("t", [0, 1, 7, 1000])
def test_step_noise_unrolled_bitwise(shape, t):
    """Odd (15, 7) and even (24, 2) flat sizes, several iterations."""
    kd, tk = _keys(t + len(shape))
    want = np.asarray(jN.step_noise_unrolled(jnp.asarray(kd), t, shape))
    got = tN.step_noise_unrolled(tk, t, shape).numpy()
    assert got.shape == (R,) + shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [1, 6, 15])
def test_counts_pad_an_odd_size_with_one_zero(size):
    want, half, _ = jN._counts(size)
    got, t_half = tR._counts(size, "cpu")
    assert t_half == half
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_is_not_the_per_pass_stream():
    """The fused stream differs from ``stacked_step_noise``'s under the
    installed JAX (ROADMAP fault R1), in both packages alike."""
    kd, tk = _keys(3)
    fused = tN.step_noise_unrolled(tk, 2, (5, 3))
    stacked = tI.stacked_step_noise(tk, 3, (5, 3))[2]
    j_stacked = np.asarray(jI.stacked_step_noise(jnp.asarray(kd), 3,
                                                 (5, 3))[2])
    np.testing.assert_array_equal(stacked.numpy(), j_stacked)
    assert not torch.equal(fused, stacked)

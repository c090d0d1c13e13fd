"""The bits -> normal map on every input it reads, on the CPU.

``random.bits_to_normal`` reads only the top 23 bits of a word (``bits
>> 9``), so its whole domain is the 2^23 mantissas.  Over all of them:

  * the port's plain map is bitwise JAX's jitted
    ``repro.md.noise._bits_to_normal`` on the same words (``m << 9`` with
    seeded low bits, which the map drops);
  * the plain map's FMAs (``random._fma``: the exact double product plus
    c, rounded to double, then to float) round as an FMA that rounds once
    (XLA's CPU FMA, the noise kernel's ``__fmaf_rn``).  The two differ
    only where the double sum is exactly halfway between two floats while
    the exact sum is not (the second rounding then breaks a tie the exact
    value does not have).  Every FMA of the map, on both branches of its
    selects, is checked for that: halfway double sums occur (the exact
    sum on the midpoint, where both round alike), halfway sums with a
    nonzero error never.  So the kernel's float32 FMAs give the plain
    map's bits on the whole domain; ``chip_smoke.py`` phase 47 checks the
    kernel's map against the plain one on the card.

Tolerance: none.  One torch thread, slices of 2^20 words; well under a
minute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import noise as jN
from repro_torch import random as jr

SLICE = 1 << 20
N_MANTISSAS = 1 << 23


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slices():
    for a in range(0, N_MANTISSAS, SLICE):
        yield np.arange(a, a + SLICE, dtype=np.uint32)


def test_plain_map_is_jax_on_every_mantissa():
    rng = np.random.default_rng(23)
    jax_map = jax.jit(jN._bits_to_normal)
    differ = 0
    for m in _slices():
        bits = (m << 9) | rng.integers(0, 512, m.size, dtype=np.uint32)
        want = np.asarray(jax_map(jnp.asarray(bits)))
        got = jr.bits_to_normal(torch.from_numpy(bits.astype(np.int64)))
        differ += int((got.numpy().view(np.uint32)
                       != want.view(np.uint32)).sum())
    assert differ == 0


def _halfway(a, b, c):
    """(the plain FMA's value, its double sum halfway between two floats,
    halfway with a nonzero error): ``s = a b + c`` rounded to double (the
    product is exact), its error by Knuth's TwoSum, halfway when the 29
    bits below a float's mantissa are 1 then zeros."""
    ab = a.double() * jr._f64(b)
    cc = jr._f64(c)
    cc = cc if torch.is_tensor(cc) else torch.full_like(ab, cc)
    s = ab + cc
    bb = s - ab
    err = (ab - (s - bb)) + (cc - bb)
    half = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    return s.float(), half, half & (err != 0)


def test_tie_detector_on_built_cases():
    one = torch.tensor([1.0])
    # 1 + 2^-24: exactly halfway between 1 and 1 + 2^-23, no error
    _, half, bad = _halfway(torch.tensor([2.0 ** -24]), 1.0, one)
    assert half.item() and not bad.item()
    # 2^-24 (1 + 2^-23)(1 - 2^-23) + 1 = 1 + 2^-24 - 2^-70: the double
    # sum rounds onto the midpoint, the exact one lies below it
    a = torch.tensor([2.0 ** -24 * (1 + 2.0 ** -23)])
    _, half, bad = _halfway(a, float(np.float32(1 - 2.0 ** -23)), one)
    assert half.item() and bad.item()
    # away from a midpoint: neither
    _, half, bad = _halfway(torch.tensor([0.3]), 0.7, one)
    assert not half.item() and not bad.item()


def test_plain_fma_rounds_as_a_single_rounding_fma(monkeypatch):
    seen = {"fmas": 0, "half": 0, "bad": 0}
    plain = jr._fma

    def counted(a, b, c):
        out, half, bad = _halfway(a, b, c)
        seen["fmas"] += int(half.numel())
        seen["half"] += int(half.sum())
        seen["bad"] += int(bad.sum())
        return out

    for m in _slices():
        bits = torch.from_numpy(m.astype(np.int64)) << 9
        want = jr.bits_to_erf_inv(bits)
        monkeypatch.setattr(jr, "_fma", counted)
        got = jr.bits_to_erf_inv(bits)
        monkeypatch.setattr(jr, "_fma", plain)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # 34 FMAs a word on both branches: the uniform, 14 of log1p's
    # rational, 9 of log, 2 of sqrt, 8 of erf_inv
    assert seen["fmas"] == 34 * N_MANTISSAS
    assert seen["half"] > 0 and seen["bad"] == 0

"""The noise kernel's three entry points on the CPU, where they run their
plain versions (``kernels/noise/ref.py``), against the JAX package:
the fused path's legacy-layout block (``repro.md.noise``), the per-pass
path's stacked draw (``repro.md.integrators.stacked_step_noise``) and
the SGLD update (``repro.optim.sgld``, jitted) on a leaf longer than
one 2^26 slice, read through the offset entry point around the slice
border.  Then what binds the CUDA source to those plain versions without
a card: its float32 constants are the plain version's values, its
wrappers refuse CPU tensors, and the dispatch sends CPU keys to the plain
versions without a launch.  ``tests/test_torch_cuda.py`` holds the
kernel against the plain versions on the card.

Tolerance: none.  Every draw is bitwise (the exchange decisions and the
RE-SGLD trajectory depend on every normal).
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import integrators as jI
from repro.md import noise as jN
from repro.optim import sgld as j_sgld
from repro_torch import random as jr
from repro_torch.kernels.noise import ops, ref
from repro_torch.md import integrators as tI
from repro_torch.md import noise as tN
from repro_torch.models import params as P
from repro_torch.optim import sgld as t_sgld

R = 4
SOURCE = (Path(ops.__file__).parent / "csrc" / "threefry_normal.cu"
          ).read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seed, n=R):
    kd = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), n)))
    return kd, torch.from_numpy(kd.astype(np.int64))


# sizes 1, 2 and 3 (odd: one zero counter pads the second half) and the
# main path's 2,881 atoms x 3 = 8,643, odd too
@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (2881, 3)])
@pytest.mark.parametrize("t", [0, 10])
def test_step_noise_unrolled_is_jax(shape, t):
    kd, tk = _keys(t + math.prod(shape))
    want = np.asarray(jN.step_noise_unrolled(jnp.asarray(kd), t, shape))
    got = tN.step_noise_unrolled(tk, t, shape)
    assert got.dtype == torch.float32 and got.shape == (R,) + shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_steps,shape", [(1, (3,)), (11, (7, 3)),
                                           (3, (2881, 3))])
def test_stacked_step_noise_is_jax(n_steps, shape):
    kd, tk = _keys(n_steps)
    want = np.asarray(jI.stacked_step_noise(jnp.asarray(kd), n_steps, shape))
    got = tI.stacked_step_noise(tk, n_steps, shape)
    assert got.shape == (n_steps, R) + shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_sgld_noise_past_one_slice_is_jax(monkeypatch):
    """JAX's jitted ``sgld_noise`` on one leaf of 2^26 + 3,000 elements;
    the port's SGLD update read at flat offsets around the 2^26 border
    (``ref.add_noise(..., offset)``, the kernel's offset entry point),
    its own draw sliced every 1,000 elements, each window bitwise JAX's;
    and the whole of a small leaf through ``sgld_noise``'s dispatch."""
    border = P.SLICE
    n = border + 3000
    rng = np.random.default_rng(0)
    leaf = rng.standard_normal(n).astype(np.float32)
    key = jax.random.key(11)
    lr, temp = np.float32(3e-4), np.float32(3.73e-5)
    want = np.asarray(jax.jit(j_sgld.sgld_noise)(
        key, {"w": jnp.asarray(leaf)}, lr, temp)["w"])
    tkey = jr.split(torch.tensor(np.asarray(jax.random.key_data(key)
                                            ).astype(np.int64)), 1)[0]
    std = t_sgld.sgld_std(torch.tensor(lr), torch.tensor(temp))
    monkeypatch.setattr(P, "SLICE", 1000)
    for a, b in ((0, 2500), (border - 1200, border + 1300), (n - 7, n)):
        got = ref.add_noise(torch.from_numpy(leaf[a:b]), tkey, std,
                            offset=a)
        np.testing.assert_array_equal(got.numpy(), want[a:b])
    small = {"w": torch.from_numpy(leaf[:2500].copy())}
    got = t_sgld.sgld_noise(torch.tensor(np.asarray(
        jax.random.key_data(key)).astype(np.int64)), small,
        torch.tensor(lr), torch.tensor(temp))["w"]
    np.testing.assert_array_equal(got.numpy(), want[:2500])


def _source_constants():
    """{name: [float, ...]} of the CUDA source's float32 constants."""
    out = {}
    for name, body in re.findall(
            r"constexpr float (k\w+) = ([^;]+);", SOURCE):
        out[name] = [float.fromhex(body.split("//")[0].strip().rstrip("f"))]
    for name, body in re.findall(
            r"__constant__ float (k\w+)\[\d+\] = \{([^}]*)\}", SOURCE):
        out[name] = [float.fromhex(v.strip().rstrip("f"))
                     for v in body.split(",")]
    return out


def test_kernel_constants_are_the_plain_versions():
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    lo = jr._NORMAL_LO
    want = {"kNormalLo": [f32(lo)],
            "kSpan": [float(np.float32(1.0) - np.float32(lo))],
            "kSqrt2": [jr._SQRT2], "kSqrtHalf": [jr._SQRT_HALF],
            "kLog1pSplit": [f32(0.41421356237309504880)],
            "kLogQ1": [jr._LOG_Q1], "kLogQ2": [jr._LOG_Q2],
            "kLogP": jr._LOG_P, "kLog1pNum": jr._LOG1P_NUM,
            "kLog1pDen": jr._LOG1P_DEN, "kErfInvLt5": jr._ERFINV_LT5,
            "kErfInvGe5": jr._ERFINV_GE5}
    assert _source_constants() == want
    # _log1p's branch compares a float32 with this double: no float32
    # lies between the two, so the float32 comparison the kernel makes
    # selects the same branch
    assert f32(0.41421356237309504880) > 0.41421356237309504880


def test_wrappers_refuse_cpu_tensors_and_dispatch_counts_nothing():
    _, tk = _keys(1)
    p = torch.zeros(5)
    std = torch.tensor(0.5)
    for call in (lambda: ops.step_noise_unrolled_batched(tk, 0, (3,)),
                 lambda: ops.stacked_step_noise_batched(tk, 2, (3,)),
                 lambda: ops.add_noise_batched(p, tk[0], std)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    ops.LIBRARY.reset()
    assert torch.equal(ops.step_noise_unrolled(tk, 3, (5,)),
                       ref.step_noise_unrolled(tk, 3, (5,)))
    assert torch.equal(ops.stacked_step_noise(tk, 2, (5,)),
                       ref.stacked_step_noise(tk, 2, (5,)))
    assert torch.equal(ops.add_noise(p, tk[0], std),
                       ref.add_noise(p, tk[0], std))
    assert ops.LIBRARY.launches == 0 and ops.LIBRARY.variants == {}

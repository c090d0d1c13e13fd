"""The sparse neighbor-list path of the port against the JAX package's, at
a small size (``chain_molecule`` of 22-40 atoms, 4 replicas):

  * the sparse pass of the oracle (``lj_forces.ref``), with and without
    the build-time parameter planes and with salt, against JAX's oracle,
    and the planes form bitwise against the gather form;
  * the oracle, which is also the sparse kernel's plain version, against
    the JAX Pallas kernel in interpret mode, as
    ``tests/test_neighbor_list.py`` runs it;
  * the dense matched-cutoff oracle, ``sparse_features`` and the bonded
    pass's ``sparse`` option;
  * ``REMDDriver.run_fused`` on a T x salt grid, on both force paths and
    both exchange schemes, at chunk sizes 1 and 3, with a skin small
    enough that the list is rebuilt inside the run (the T x U x U grid
    and one sparse propagate per force path are in
    ``test_torch_sparse_tsu.py``).

Tolerances, with their reasons:
  * forces 1e-5 of max |F|, energies 1e-5 relative: the same float32
    formulas, summed in another order (XLA's and PyTorch's reductions);
  * the oracle against the Pallas kernel: the same, and eps differs by
    a rounding (sqrt(eps_i eps_j) there, sqrt(eps_i) sqrt(eps_j) here);
  * the planes form against the gather form: bitwise (the same float
    steps);
  * the driver: assignment rows, acceptance, ``nb_overflow`` and
    ``nb_rebuilds`` identical; positions within 1e-4 A.  When a decision
    flips, the failure message carries the Metropolis margins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.kernels.chain_forces import ops as jcops
from repro.kernels.lj_forces import ops as jnb_ops
from repro.kernels.lj_forces import ref as jnb_ref
from repro.md import MDEngine as JEngine
from repro.md import energy as JE
from repro.md import neighbors as JNB
from repro.md.system import base_positions as j_base_positions
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.kernels.chain_forces import ops as tcops
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.kernels.lj_forces import ref as nb_ref
from repro_torch.md import MDEngine
from repro_torch.md import energy as E

R = 4
CUTOFF, R_LIST, K_MAX = 8.0, 9.5, 14
TOL = 1e-5


@pytest.fixture(scope="module", params=[22, 40])
def case(request):
    """A JAX system, the port's, a stack moved off the chain and its
    list (JAX-built, as numpy)."""
    jsys = j_chain_molecule(request.param)
    tsys = convert.system_from_arrays(jsys, device="cpu")
    rng = np.random.default_rng(request.param)
    base = np.asarray(j_base_positions(jsys))
    pos = (base[None] + 0.4 * rng.standard_normal((R,) + base.shape)
           ).astype(np.float32)
    idx, valid, _ = JNB.build_dense(jnp.asarray(pos), jsys.nb_mask, R_LIST,
                                    K_MAX)
    return dict(jsys=jsys, tsys=tsys, pack=nb_ops.build_pack(tsys), pos=pos,
                idx=np.array(idx), valid=np.array(valid),
                salt=rng.uniform(0.5, 1.0, R).astype(np.float32))


def _jargs(c):
    s = c["jsys"]
    return (jnp.asarray(c["pos"]), s.lj_sigma, s.lj_eps, s.charges,
            jnp.asarray(c["idx"]), jnp.asarray(c["valid"]), CUTOFF)


def _targs(c):
    s = c["tsys"]
    return (torch.from_numpy(c["pos"]), s.lj_sigma, s.lj_eps, s.charges,
            torch.from_numpy(c["idx"]), torch.from_numpy(c["valid"]),
            CUTOFF)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.ndim == 1:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _planes(c, lib):
    s = c["jsys"] if lib == "jax" else c["tsys"]
    if lib == "jax":
        return JNB.pair_planes(jnp.asarray(c["idx"]), s.lj_sigma, s.lj_eps,
                               s.charges)
    from repro_torch.md import neighbors as NB
    return NB.pair_planes(torch.from_numpy(c["idx"]), s.lj_sigma, s.lj_eps,
                          s.charges)


@pytest.mark.parametrize("planes", [False, True])
def test_sparse_oracle_matches_jax(case, planes):
    pj = _planes(case, "jax") if planes else None
    pt = _planes(case, "torch") if planes else None
    want = jnb_ref.nonbonded_sparse(*_jargs(case), pair=pj)
    got = nb_ref.nonbonded_sparse(*_targs(case), pair=pt)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    salt = case["salt"]
    _close(nb_ref.nonbonded_force_sparse(*_targs(case),
                                         torch.from_numpy(salt),
                                         pair=pt).numpy(),
           jnb_ref.nonbonded_force_sparse(*_jargs(case), jnp.asarray(salt),
                                          pair=pj))


def test_planes_form_is_bitwise_the_gather_form(case):
    gather = nb_ref.nonbonded_sparse(*_targs(case))
    planes = nb_ref.nonbonded_sparse(*_targs(case),
                                     pair=_planes(case, "torch"))
    for a, b in zip(gather, planes):
        assert torch.equal(a, b)


def test_plain_version_matches_jax_pallas_kernel(case):
    """The sparse kernel's plain version (the oracle) against the JAX
    Pallas sparse kernel in interpret mode, split outputs and the
    salt-combined force (the combination the kernel path makes outside
    the kernel)."""
    want = jnb_ops.nonbonded_sparse(*_jargs(case), use_kernel=True,
                                    interpret=True)
    got = nb_ref.nonbonded_sparse(*_targs(case))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    salt = case["salt"]
    f_j = jnb_ops.nonbonded_force_sparse(*_jargs(case), jnp.asarray(salt),
                                         use_kernel=True, interpret=True)
    _close((got[0] + torch.from_numpy(salt)[:, None, None] * got[1]).numpy(),
           f_j)


def test_dispatch_takes_the_oracle_on_the_cpu(case):
    t = _targs(case)
    for planes in (None, _planes(case, "torch")):
        got = nb_ops.nonbonded_sparse(t[0], case["pack"], t[4], t[5], CUTOFF,
                                      pair=planes)
        for a, b in zip(got, nb_ref.nonbonded_sparse(*t, pair=planes)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        nb_ops.nonbonded_sparse_batched(t[0], case["pack"], t[4], t[5],
                                        CUTOFF)


def test_sparse_pass_matches_the_dense_cutoff_oracle(case):
    """With a list that holds every pair within the cutoff, the sparse
    pass is the dense pass truncated at the cutoff (and that oracle
    matches JAX's)."""
    s, pk = case["tsys"], case["pack"]
    pos = torch.from_numpy(case["pos"])
    full = JNB.build_dense(jnp.asarray(case["pos"]), case["jsys"].nb_mask,
                           R_LIST, s.n_atoms - 1)
    sparse = nb_ref.nonbonded_sparse(pos, s.lj_sigma, s.lj_eps, s.charges,
                                     torch.from_numpy(np.array(full[0])),
                                     torch.from_numpy(np.array(full[1])),
                                     CUTOFF)
    dense = nb_ref.nonbonded_cutoff(pos, s.lj_sigma, s.lj_eps, s.charges,
                                    pk.nb_mask, CUTOFF)
    want = jnb_ref.nonbonded_cutoff(jnp.asarray(case["pos"]),
                                    case["jsys"].lj_sigma,
                                    case["jsys"].lj_eps,
                                    case["jsys"].charges,
                                    case["jsys"].nb_mask, CUTOFF)
    for a, b, w in zip(sparse, dense, want):
        _close(a.numpy(), b.numpy())
        _close(b.numpy(), w)


@pytest.mark.parametrize("planes", [False, True])
def test_sparse_features_match_jax(case, planes):
    j, t = _jargs(case), _targs(case)
    want = JE.sparse_features(j[0], case["jsys"], j[4], j[5], CUTOFF,
                              pair=_planes(case, "jax") if planes else None)
    got = E.sparse_features(t[0], case["tsys"], E.feature_quads(case["tsys"]),
                            case["pack"], t[4], t[5], CUTOFF,
                            pair=_planes(case, "torch") if planes else None)
    assert set(got) == set(want)
    for key in got:
        _close(got[key].numpy(), want[key])


def test_bonded_sparse_option_matches_jax():
    jsys = j_chain_molecule(30)
    jeng = JEngine(jsys)
    teng = MDEngine(convert.system_from_arrays(jsys, "cpu"), device="cpu")
    rng = np.random.default_rng(5)
    pos = (np.asarray(j_base_positions(jsys))[None]
           + 0.2 * rng.standard_normal((R, 30, 3))).astype(np.float32)
    c = rng.uniform(0, 360, (R, 2)).astype(np.float32)
    k = np.full((R, 2), 0.02, np.float32)
    f_j, e_j = jcops.bonded_forces(jnp.asarray(pos), jeng._pack,
                                   jnp.asarray(c), jnp.asarray(k),
                                   use_kernel=False, sparse=True)
    f_t, e_t = tcops.bonded_forces(torch.from_numpy(pos), teng._pack,
                                   torch.from_numpy(c), torch.from_numpy(k),
                                   sparse=True)
    _close(f_t.numpy(), f_j)
    _close(e_t.numpy(), e_j)


# -- the driver --------------------------------------------------------------

DRIVER_ATOMS = 24
N_CYCLES = 6
SPARSE = dict(nonbonded="sparse", bonded="sparse", skin=0.3)
_JAX_RUNS = {}


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


def _record_metropolis(monkeypatch):
    seen = []
    orig = tX.metropolis

    def spy(delta, rng):
        seen.append((delta.clone(), tX.jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)

    monkeypatch.setattr(tX, "metropolis", spy)
    return seen


def _jax_run(dims, scheme, path, extra):
    """The JAX driver's run, once per configuration: its trajectory does
    not depend on the chunk size, so both port chunk sizes are held
    against one run."""
    key = (dims, scheme, path, tuple(sorted(extra.items())))
    if key not in _JAX_RUNS:
        jsys = j_chain_molecule(DRIVER_ATOMS)
        cfg = JConfig(dimensions=dims, md_steps_per_cycle=3,
                      n_cycles=N_CYCLES, exchange_scheme=scheme)
        drv = JDriver(JEngine(jsys, force_path=path, **SPARSE, **extra), cfg)
        out = drv.run_fused(drv.init(0), chunk_cycles=3)
        _JAX_RUNS[key] = (jsys, drv, out)
    return _JAX_RUNS[key]


def run_sparse_pair(dims, scheme, path, chunk, monkeypatch, **extra):
    """The port's driver at ``chunk`` against the JAX driver's run, both
    from their own ``init(0)``; fails with the margins of the first
    differing cycle's decisions."""
    jsys, jdrv, jout = _jax_run(dims, scheme, path, extra)
    cfg = RepExConfig(dimensions=dims, md_steps_per_cycle=3,
                      n_cycles=N_CYCLES, exchange_scheme=scheme)
    tdrv = REMDDriver(MDEngine(convert.system_from_arrays(jsys, "cpu"),
                               force_path=path, device="cpu", **SPARSE,
                               **extra), cfg, device="cpu")
    seen = _record_metropolis(monkeypatch)
    tout = tdrv.run_fused(tdrv.init(0), chunk_cycles=chunk)
    jrows, trows = _rows(jdrv), _rows(tdrv)
    if not np.array_equal(jrows, trows):
        c = int(np.nonzero((jrows != trows).any(axis=1))[0][0])
        delta, u = seen[c]
        margin = torch.abs(u - torch.exp(torch.clamp_max(-delta, 0.0)))
        pytest.fail(f"assignment differs first at cycle {c}: jax "
                    f"{jrows[c]}, port {trows[c]}; Metropolis margins "
                    f"{margin.tolist()}")
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    for key in ("nb_overflow", "nb_rebuilds", "failed"):
        assert ([h[key] for h in tdrv.history]
                == [float(h[key]) for h in jdrv.history]), key
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), atol=1e-4)
    for key in ("idx", "valid", "overflow", "rebuilds"):
        np.testing.assert_array_equal(tout.state["nlist"][key].numpy(),
                                      np.asarray(jout.state["nlist"][key]))
    return tdrv


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
@pytest.mark.parametrize("path", ["fused", "pallas"])
def test_run_fused_t_salt_matches_jax(path, scheme, chunk, monkeypatch):
    tdrv = run_sparse_pair((("temperature", 2), ("salt", 2)), scheme, path,
                           chunk, monkeypatch)
    assert tdrv.history[-1]["nb_rebuilds"] > 0
    assert sum(tdrv.acceptance[k][0] for k in tdrv.acceptance) > 0

"""``force_path="fused"`` of the port against the JAX package's, at a
small size (``chain_molecule`` of 10-40 atoms, 4 replicas):

  * the bonded forces with the umbrella torque (``chain_forces.ref``),
    dense and slot forms, and the (R, 8) bias rows;
  * one fused iteration, plain (``fused_propagate.ref``), and the kernel's
    plain version against the JAX Pallas fused kernel in interpret mode
    (``fused_propagate.ops.fused_propagate(..., interpret=True)``);
  * the fused propagate loop of the engine's CPU path;
  * ``REMDDriver.run_fused`` on a 2x2x2 T x U x U grid and a 2x2 T x salt
    grid with both exchange schemes, chunk sizes 1 and 3;
  * the fused kernel's pack-time mask form (``lj_forces.ops.tile_flags``):
    the 32-bit rows of bits and the per-64-atom-tile "all kept" flags
    against the JAX system's exclusion mask, exactly, on the 2881-atom
    chain and on ragged N = 130 and 257.

Tolerances, with their reasons:
  * bonded forces: 1e-5 of max |F| (same formulas; the dense incidence
    contraction and the slot sums add in another order);
  * one iteration against the JAX oracle: 1e-5 (the same float32 steps);
  * against the JAX Pallas kernel: 1e-4 A in positions and A/ps in
    velocities after three iterations: the kernel takes
    ``c1 = exp(float32(-gamma dt))`` in float32, 1 ulp from the port's
    ``baoab_scales`` (ROADMAP P3), and sums ``(fb + lj) + salt * el``
    where the port sums ``fb + (lj + salt * el)``;
  * the driver: assignment rows and acceptance identical; positions
    within 1e-4 A.  When a decision flips, the failure message carries
    the Metropolis margins ``|u - exp(min(-delta, 0))|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.kernels.chain_forces import ops as jcops
from repro.kernels.chain_forces import ref as jcref
from repro.kernels.fused_propagate import ops as jfops
from repro.kernels.fused_propagate import ref as jfref
from repro.md import MDEngine as JEngine
from repro.md.system import base_positions
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.kernels.chain_forces import ops as tcops
from repro_torch.kernels.chain_forces import ref as tcref
from repro_torch.kernels.fused_propagate import ops as tfops
from repro_torch.kernels.fused_propagate import ref as tfref
from repro_torch.md import MDEngine

R = 4
N_STEPS = np.array([2, 1, 0, 2])            # lane 2 stays frozen
MAX_STEPS = 2


def _engines(n_atoms):
    """(JAX engine, port engine) on the same chain, fused path."""
    jsys = j_chain_molecule(n_atoms)
    return (JEngine(jsys, force_path="fused"),
            MDEngine(convert.system_from_arrays(jsys, device="cpu"),
                     force_path="fused", device="cpu"))


@pytest.fixture(scope="module")
def pair():
    return _engines(30)


@pytest.fixture(scope="module", params=[22, 40])
def pair_sizes(request):
    return _engines(request.param)


def _inputs(jeng, n_u=2, salt=True, seed=0):
    rng = np.random.default_rng(seed)
    n = jeng.system.n_atoms
    f32 = np.float32
    pos = (np.asarray(base_positions(jeng.system))[None]
           + 0.1 * rng.standard_normal((R, n, 3))).astype(f32)
    ctrl = {"temperature": np.geomspace(273.0, 373.0, R).astype(f32)}
    if n_u:
        ctrl["umbrella_center"] = rng.uniform(0, 360, (R, n_u)).astype(f32)
        ctrl["umbrella_k"] = np.full((R, n_u), 0.02, f32)
    if salt:
        ctrl["salt"] = rng.uniform(0, 1, R).astype(f32)
    return dict(pos=pos, vel=rng.standard_normal((R, n, 3)).astype(f32),
                noise=rng.standard_normal((R, n, 3)).astype(f32),
                keys=np.asarray(jax.random.key_data(
                    jax.random.split(jax.random.key(seed), R))),
                ctrl=ctrl)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _close(got, want, atol, scale=1.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol * scale)


@pytest.mark.parametrize("n_u", [1, 2])
def test_bonded_bias_matches_jax(pair, n_u):
    jeng, teng = pair
    d = _inputs(jeng, n_u=n_u)
    c, k = d["ctrl"]["umbrella_center"], d["ctrl"]["umbrella_k"]
    f_j, e_j = jcref.bonded_forces(jnp.asarray(d["pos"]), jeng._pack.top,
                                   jnp.asarray(c), jnp.asarray(k))
    scale = float(np.abs(np.asarray(f_j)).max())
    pos = torch.from_numpy(d["pos"])
    f_t, e_t = tcref.bonded_forces(pos, teng._pack.top, torch.from_numpy(c),
                                   torch.from_numpy(k))
    f_s, e_s = tcref.bonded_forces_sparse(pos, teng._pack.top,
                                          teng._pack.slots,
                                          torch.from_numpy(c),
                                          torch.from_numpy(k))
    for f, e in ((f_t, e_t), (f_s, e_s)):
        _close(f, f_j, 1e-5, scale)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-5)
    # the torque moves the forces: without it they differ
    f_0, _ = tcref.bonded_forces(pos, teng._pack.top)
    assert float((f_0 - f_t).abs().max()) > 1e-3


@pytest.mark.parametrize("n_u", [0, 1, 2])
def test_bias_rows_match_jax(n_u):
    rng = np.random.default_rng(n_u)
    c = rng.uniform(0, 360, (R, max(n_u, 1))).astype(np.float32)
    k = rng.uniform(0, 1, (R, max(n_u, 1))).astype(np.float32)
    args = (None, None) if n_u == 0 else (c, k)
    want = jcops._pack_bias(*[None if a is None else jnp.asarray(a)
                              for a in args], R)
    got = tcops.pack_bias(*[None if a is None else torch.from_numpy(a)
                            for a in args], R, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i", range(MAX_STEPS + 1))
@pytest.mark.parametrize("n_u,salt", [(0, False), (2, True)])
def test_fused_iteration_ref_matches_jax(pair, i, n_u, salt):
    jeng, teng = pair
    d = _inputs(jeng, n_u=n_u, salt=salt)
    want = jfref.fused_iteration_ref(
        i, jnp.asarray(d["pos"]), jnp.asarray(d["vel"]),
        jnp.asarray(d["noise"]), jeng.system, _j(d["ctrl"]),
        jnp.asarray(N_STEPS), MAX_STEPS, jeng.dt, jeng.gamma)
    got = tfref.fused_iteration_ref(
        i, torch.from_numpy(d["pos"]), torch.from_numpy(d["vel"]),
        torch.from_numpy(d["noise"]), teng.system, _t(d["ctrl"]),
        torch.from_numpy(N_STEPS), MAX_STEPS, teng.dt, teng.gamma)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def _plain_propagate(teng, d):
    return tfops.fused_propagate(
        {"pos": torch.from_numpy(d["pos"]), "vel": torch.from_numpy(d["vel"])},
        teng._pack, teng._nb_pack, teng.system.masses, _t(d["ctrl"]),
        torch.from_numpy(N_STEPS), torch.from_numpy(d["keys"].astype(
            np.int64)), MAX_STEPS, teng.dt, teng.gamma)


@pytest.mark.parametrize("n_u,salt", [(0, False), (1, True), (2, True)])
def test_plain_version_matches_jax_pallas_kernel(pair_sizes, n_u, salt):
    """The kernel's plain version, driven by ``fused_propagate`` on the
    CPU, against the JAX Pallas fused kernel (interpret mode)."""
    jeng, teng = pair_sizes
    d = _inputs(jeng, n_u=n_u, salt=salt)
    want = jfops.fused_propagate(
        {"pos": jnp.asarray(d["pos"]), "vel": jnp.asarray(d["vel"])},
        jeng._pack, jeng.system, _j(d["ctrl"]), jnp.asarray(N_STEPS),
        jnp.asarray(d["keys"]), MAX_STEPS, jeng.dt, jeng.gamma,
        interpret=True)
    got = _plain_propagate(teng, d)
    for key in ("pos", "vel"):
        _close(got[key], want[key], 1e-4)
    # lane 2 takes no step: both leave it exactly where it was
    np.testing.assert_array_equal(got["pos"][2].numpy(), d["pos"][2])


@pytest.mark.parametrize("n_u,salt", [(0, False), (2, True)])
def test_engine_fused_loop_matches_jax(pair, n_u, salt):
    """The engine's CPU fused path (the oracles inside the fused loop)
    against the JAX package's jnp fused loop, and the kernel's plain
    version against both."""
    jeng, teng = pair
    d = _inputs(jeng, n_u=n_u, salt=salt)
    state = {"pos": d["pos"], "vel": d["vel"]}
    want = jeng.propagate(_j(state), _j(d["ctrl"]), jnp.asarray(N_STEPS),
                          jnp.asarray(d["keys"]), MAX_STEPS)
    got = teng.propagate(_t(state), _t(d["ctrl"]),
                         torch.from_numpy(N_STEPS),
                         torch.from_numpy(d["keys"].astype(np.int64)),
                         MAX_STEPS)
    plain = _plain_propagate(teng, d)
    for key in ("pos", "vel"):
        _close(got[key], want[key], 1e-5)
        _close(plain[key], got[key].numpy(), 1e-5)


def test_fused_kernel_takes_no_cpu_tensor(pair):
    _, teng = pair
    d = _inputs(pair[0])
    st = tfops.step_par(0, torch.from_numpy(N_STEPS), MAX_STEPS,
                        torch.ones(R))
    pos = torch.from_numpy(d["pos"])
    with pytest.raises(ValueError, match="CUDA"):
        tfops.fused_baoab_batched(pos, pos, pos, st, None, teng._pack,
                                  teng._nb_pack, teng.system.masses, 0.9,
                                  5e-4)


@pytest.mark.parametrize("n_atoms", [2881, 130, 257])
def test_tile_flags_match_the_mask(n_atoms):
    from repro_torch.kernels.lj_forces import ops as tnops
    jsys = j_chain_molecule(n_atoms)
    pk = tnops.build_pack(convert.system_from_arrays(jsys, device="cpu"))
    ld, t = pk.mask_u8.shape[1], tnops.PAIR_TILE
    full = np.zeros((ld, ld), np.uint8)
    full[:n_atoms, :n_atoms] = np.asarray(jsys.nb_mask) > 0.5
    np.testing.assert_array_equal(pk.mask_u8.numpy(), full[:n_atoms])
    words = pk.mask_bits.numpy().astype(np.int64) & 0xFFFFFFFF
    unpacked = (words[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(unpacked.reshape(ld, ld), full)
    nt = ld // t
    want = np.array([[full[t * i:t * i + t, t * j:t * j + t].all()
                      for j in range(nt)] for i in range(nt)])
    np.testing.assert_array_equal(pk.tile_kept.numpy().astype(bool), want)
    assert not want.diagonal().any()          # the self pairs are excluded
    if n_atoms == 2881:                       # 89 of 1035 tile pairs masked
        assert int((~want[np.triu_indices(nt, 1)]).sum()) == 89


# -- the driver --------------------------------------------------------------

GRIDS = {
    "TUU": (("temperature", 2), ("umbrella", 2), ("umbrella", 2)),
    "Tsalt": (("temperature", 2), ("salt", 2)),
}
N_CYCLES = 6


@pytest.fixture(scope="module")
def driver_system():
    return j_chain_molecule(10)


def _cfg(grid, scheme):
    return dict(dimensions=GRIDS[grid], md_steps_per_cycle=3,
                n_cycles=N_CYCLES, exchange_scheme=scheme)


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


def run_pair(jsys, cfg, chunk, monkeypatch, force_path="fused"):
    """Both drivers from their own ``init(0)``; fails with the margins
    of the first differing cycle's decisions."""
    jdrv = JDriver(JEngine(jsys, force_path=force_path), JConfig(**cfg))
    jout = jdrv.run_fused(jdrv.init(0), chunk_cycles=chunk)
    tdrv = REMDDriver(MDEngine(convert.system_from_arrays(jsys, device="cpu"),
                               force_path=force_path, device="cpu"),
                      RepExConfig(**cfg), device="cpu")
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
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), atol=1e-4)
    return tdrv, tout


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
@pytest.mark.parametrize("grid", ["TUU", "Tsalt"])
def test_run_fused_matches_jax(grid, scheme, chunk, driver_system,
                               monkeypatch):
    tdrv, _ = run_pair(driver_system, _cfg(grid, scheme), chunk,
                       monkeypatch)
    assert len(tdrv.history) == N_CYCLES
    assert sum(tdrv.acceptance[k][0] for k in tdrv.acceptance) > 0


def test_fused_and_pallas_paths_draw_different_streams(driver_system):
    """The fused path's legacy-layout stream (ROADMAP fault R1) gives
    another trajectory than the per-pass path from the same seed."""
    cfg = RepExConfig(**_cfg("TUU", "neighbor"))
    out = {}
    for path in ("fused", "pallas"):
        drv = REMDDriver(MDEngine(convert.system_from_arrays(
            driver_system, device="cpu"), force_path=path, device="cpu"),
            cfg, device="cpu")
        out[path] = drv.run_fused(drv.init(0), n_cycles=1).state["pos"]
    assert not torch.equal(out["fused"], out["pallas"])


def test_fused_row_layout_by_atom_count():
    """The fused kernel keeps a replica's force rows in shared memory
    while they fit beside its warps' staged atoms (24 warps x 64 atoms x
    24 bytes + ld x 12 bytes <= 232,448: N <= 16,256) and in device
    memory above, chosen by N alone: the main path's 2881 atoms stay in
    shared memory, 16,384 and 20,000 do not."""
    from repro_torch.kernels import pad_to_block
    from repro_torch.kernels.lj_forces import ops as tnops
    cases = {130: True, 2881: True, 10000: True, 16256: True, 16257: False,
             16384: False, 20000: False}
    for n, shared in cases.items():
        assert tfops.rows_in_shared(pad_to_block(n, tnops.TILE)) is shared
    lds = range(128, 40960, 128)
    flags = [tfops.rows_in_shared(ld) for ld in lds]
    for ld, flag in zip(lds, flags):
        warps = min(ld // 128, 24)
        assert flag == (warps * 64 * 24 + 12 * ld <= 232448)
    edge = flags.index(False)
    assert all(flags[:edge]) and not any(flags[edge:])       # one edge

"""The LJ fluid slice: the port's ``LJEngine`` and its oracles against
the JAX package's, on the CPU, from the same numpy inputs.

  * ``lj_forces/ref.py``: ``lj_energy`` / ``lj_forces`` against JAX's
    ``ref`` and against the JAX Pallas kernels in interpret mode (block
    32, so N = 27 carries padding atoms at the origin and N = 64 two
    blocks), at R = 4;
  * ``LJEnergy``: its gradient is minus the forces pass, bitwise;
  * ``LJEngine.init_state`` bitwise, one ``propagate`` on both
    ``batched`` values against JAX's ``use_pallas`` False and True;
  * ``run_fused`` at 8 rungs for 8 cycles, chunk sizes 1 and 4, both
    exchange schemes: assignment rows and ``acceptance_ratios()``
    identical to the JAX driver's; ``REMDDriver.run``'s history equal to
    ``run_fused``'s;
  * the periodic wrap bitwise against ``jnp.mod``, and ``box=0`` leaving
    the BAOAB update bitwise unchanged.

Tolerance: energies 1e-5 relative and forces 1e-5 of max |F| (the same
formulas summed in another order: the kernels per tile, XLA and PyTorch
by their own reductions); one propagate within 1e-5 A and A/ps (the
vmap oracle's forces come from ``jax.grad`` of the jnp energy on the JAX
side, from the analytic forces pass on the port's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.core import build_grid as j_build_grid
from repro.core import ctrl_for_assignment as j_ctrl_for_assignment
from repro.kernels.lj_forces import ops as j_ops
from repro.kernels.lj_forces import ref as j_ref
from repro.md import LJEngine as JLJEngine
from repro.md import integrators as jI
from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.core import exchange as tX
from repro_torch.core.controls import build_grid, ctrl_for_assignment
from repro_torch.kernels.lj_forces import ops as t_ops
from repro_torch.kernels.lj_forces import ref as t_ref
from repro_torch.md import LJEngine
from repro_torch.md import integrators as tI

SIGMA, EPS, BOX = 3.4, 0.238, 12.0
R = 4
E_RTOL, F_ATOL_REL, STATE_ATOL = 1e-5, 1e-5, 1e-5
RUN_CFG = dict(dimensions=(("temperature", 8),), t_min=94.4, t_max=150.0,
               md_steps_per_cycle=10, n_cycles=8)


def _fluid(n_atoms, n_rep=R, seed=0):
    """Lattice + 0.3 A jitter, wrapped into the box: pairs across the
    boundary and atoms near the origin's corner."""
    side = int(np.ceil(n_atoms ** (1 / 3) - 1e-9))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_atoms]
    rng = np.random.default_rng(seed)
    pos = (g + 0.5) * (BOX / side) + 0.3 * rng.standard_normal(
        (n_rep, n_atoms, 3))
    return np.mod(pos, BOX).astype(np.float32)


def _assert_forces(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=F_ATOL_REL * scale)


@pytest.mark.parametrize("n_atoms", [27, 64])
def test_oracle_matches_jax_ref_and_pallas_kernels(n_atoms):
    pos = _fluid(n_atoms)
    tp = torch.from_numpy(pos)
    e_t = t_ref.lj_energy(tp, SIGMA, EPS, BOX).numpy()
    f_t = t_ref.lj_forces(tp, SIGMA, EPS, BOX).numpy()
    jp = jnp.asarray(pos)
    for e_j, f_j in (
            (j_ref.lj_energy(jp, SIGMA, EPS, BOX),
             j_ref.lj_forces(jp, SIGMA, EPS, BOX)),
            (j_ops.lj_energy_batched(jp, SIGMA, EPS, BOX, 32, True),
             j_ops.lj_forces_batched(jp, SIGMA, EPS, BOX, 32, True))):
        np.testing.assert_allclose(e_t, np.asarray(e_j), rtol=E_RTOL)
        _assert_forces(f_t, np.asarray(f_j))
    # single configurations: the R = 1 entry points
    np.testing.assert_allclose(
        t_ops.lj_energy(tp[1], SIGMA, EPS, BOX).numpy(),
        np.asarray(j_ops.lj_energy(jp[1], SIGMA, EPS, BOX, 32, True)),
        rtol=E_RTOL)
    _assert_forces(t_ops.lj_forces(tp[1], SIGMA, EPS, BOX).numpy(),
                   np.asarray(j_ops.lj_forces(jp[1], SIGMA, EPS, BOX, 32,
                                              True)))


def test_oracle_chunks_replicas_without_changing_them():
    pos = torch.from_numpy(_fluid(27, n_rep=11))
    whole = t_ref._lj_forces(pos, SIGMA, EPS, BOX)
    assert torch.equal(t_ref.lj_forces(pos, SIGMA, EPS, BOX), whole)
    np.testing.assert_allclose(t_ref.lj_energy(pos, SIGMA, EPS, BOX),
                               t_ref._lj_energy(pos, SIGMA, EPS, BOX),
                               rtol=1e-7)


def test_energy_gradient_is_minus_the_forces_pass():
    pos = torch.from_numpy(_fluid(64)).requires_grad_(True)
    u = t_ops.LJEnergy.apply(pos, SIGMA, EPS, BOX)
    np.testing.assert_allclose(
        u.detach().numpy(),
        t_ref.lj_energy(pos.detach(), SIGMA, EPS, BOX).numpy(), rtol=0)
    (g,) = torch.autograd.grad(u.sum(), pos)
    assert torch.equal(g, -t_ref.lj_forces(pos.detach(), SIGMA, EPS, BOX))
    # and JAX's custom_vjp agrees with it within the force tolerance
    g_j = jax.grad(lambda p: jnp.sum(j_ops.lj_energy_batched(
        p, SIGMA, EPS, BOX, 32, True)))(jnp.asarray(pos.detach().numpy()))
    _assert_forces(g.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("n_atoms", [27, 64])
def test_init_state_bitwise(n_atoms):
    j = JLJEngine(n_particles=n_atoms).init_state(jax.random.key(3), R)
    t = LJEngine(n_particles=n_atoms, device="cpu").init_state(jr.key(3), R)
    for k in ("pos", "vel"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_propagate_matches_jax(batched, use_pallas):
    """Lanes with 3, 3, 2 and 0 of the 3 steps; lane 3 stays frozen."""
    cfg = dict(dimensions=(("temperature", R),), t_min=94.4, t_max=150.0)
    jeng = JLJEngine(n_particles=27, batched=batched, use_pallas=use_pallas)
    teng = LJEngine(n_particles=27, batched=batched, use_pallas=use_pallas,
                    device="cpu")
    jstate = jeng.init_state(jax.random.key(0), R)
    tstate = teng.init_state(jr.key(0), R)
    jctrl = j_ctrl_for_assignment(j_build_grid(JConfig(**cfg)),
                                  jnp.arange(R), jeng.ctrl_keys)
    tctrl = ctrl_for_assignment(build_grid(RepExConfig(**cfg), "cpu"),
                                torch.arange(R), teng.ctrl_keys)
    n = np.array([3, 3, 2, 0])
    out_j = jeng.propagate(jstate, jctrl, jnp.asarray(n, jnp.int32),
                           jax.random.split(jax.random.key(5), R),
                           max_steps=3)
    out_t = teng.propagate(tstate, tctrl, torch.from_numpy(n),
                           jr.split(jr.key(5), R), max_steps=3)
    for k in ("pos", "vel"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=0, atol=STATE_ATOL, err_msg=k)
        assert torch.equal(out_t[k][3], tstate[k][3])
    pos = out_t["pos"]
    assert bool(((pos >= 0) & (pos <= BOX)).all())
    np.testing.assert_allclose(teng.energy(out_t, tctrl).numpy(),
                               np.asarray(jeng.energy(out_j, jctrl)),
                               rtol=E_RTOL)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's ``run_fused`` per (scheme, chunk size)."""
    runs = {}
    for scheme in ("neighbor", "matrix"):
        for k in (1, 4):
            drv = JDriver(JLJEngine(), JConfig(**RUN_CFG,
                                               exchange_scheme=scheme))
            out = drv.run_fused(drv.init(0), chunk_cycles=k)
            runs[scheme, k] = (drv, out)
    return runs


def _port_driver(scheme):
    return REMDDriver(LJEngine(device="cpu"),
                      RepExConfig(**RUN_CFG, exchange_scheme=scheme),
                      device="cpu")


def _rows(driver):
    return np.stack([np.asarray(h["assignment"]) for h in driver.history])


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_run_fused_matches_jax(scheme, chunk, jax_runs, monkeypatch):
    seen = []
    orig = tX.metropolis

    def spy(delta, rng):
        seen.append((delta.clone(), tX.jr.uniform(rng, tuple(delta.shape))))
        return orig(delta, rng)

    monkeypatch.setattr(tX, "metropolis", spy)
    jdrv, jout = jax_runs[scheme, chunk]
    tdrv = _port_driver(scheme)
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
    for h_t, h_j in zip(tdrv.history, jdrv.history):
        for key in ("cycle", "dim", "accept", "attempt", "failed"):
            assert h_t[key] == h_j[key], key
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
def test_run_history_equals_run_fused(scheme):
    fused = _port_driver(scheme)
    f_ens = fused.run_fused(fused.init(0), chunk_cycles=4)
    per_cycle = _port_driver(scheme)
    r_ens = per_cycle.run(per_cycle.init(0))
    assert len(per_cycle.history) == RUN_CFG["n_cycles"]
    for h_f, h_r in zip(fused.history, per_cycle.history):
        assert set(h_f) == set(h_r)
        for key in ("cycle", "dim", "accept", "attempt", "failed",
                    "esc_relaunch", "esc_reinit", "esc_dead", "ready_frac",
                    "nb_overflow", "nb_rebuilds"):
            assert h_f[key] == h_r[key], key
        np.testing.assert_array_equal(h_f["assignment"], h_r["assignment"])
        assert min(h_r[k] for k in ("t_step", "t_prep", "t_recover",
                                    "t_data")) >= 0.0
    assert per_cycle.acceptance == fused.acceptance
    for k in ("pos", "vel"):
        assert torch.equal(r_ens.state[k], f_ens.state[k])
    assert int(r_ens.cycle) == RUN_CFG["n_cycles"]


def test_run_and_jax_run_make_the_same_decisions(jax_runs):
    """The per-cycle paths of both packages (4 cycles)."""
    jdrv = JDriver(JLJEngine(), JConfig(**RUN_CFG))
    jdrv.run(jdrv.init(0), n_cycles=4)
    tdrv = _port_driver("neighbor")
    tdrv.run(tdrv.init(0), n_cycles=4)
    np.testing.assert_array_equal(_rows(tdrv), _rows(jdrv))
    assert tdrv.acceptance_ratios() == jdrv.acceptance_ratios()
    np.testing.assert_array_equal(_rows(tdrv),
                                  _rows(jax_runs["neighbor", 4][0])[:4])


def test_wrap_is_jnp_mod_bitwise():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-3 * BOX, 3 * BOX, 200_000),
                        [-1e-8, -0.0, 0.0, BOX, -BOX, 2 * BOX, 1e-30,
                         -1e-30, BOX - 1e-6]]).astype(np.float32)
    np.testing.assert_array_equal(
        torch.remainder(torch.from_numpy(x), BOX).numpy(),
        np.asarray(jnp.mod(jnp.asarray(x), BOX)))


def _iteration_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = {"pos": rng.uniform(-1, BOX + 1, (R, 27, 3)).astype(f32),
         "vel": rng.standard_normal((R, 27, 3)).astype(f32) * 30,
         "f": rng.standard_normal((R, 27, 3)).astype(f32) * 5,
         "noise": rng.standard_normal((R, 27, 3)).astype(f32),
         "masses": np.full(27, 39.9, f32),
         "temperature": np.geomspace(94.4, 150.0, R).astype(f32)}
    return t


@pytest.mark.parametrize("i", [0, 1, 3])
def test_box_wrap_in_the_baoab_update(i):
    """``box > 0`` wraps exactly the lanes that step, and the update
    agrees with JAX's; ``box=0`` is the update of every earlier path,
    bitwise."""
    d = _iteration_inputs(seed=i)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    n_steps = torch.tensor([3, 1, 0, 2])
    c1, ns = tI.baoab_scales(t["masses"], t["temperature"], 2e-3, 2.0)
    args = (i, t["pos"], t["vel"], t["f"], t["noise"], c1, ns, t["masses"],
            n_steps, 3, 2e-3)
    plain = tI.baoab_fused_iteration(*args)
    zero = tI.baoab_fused_iteration(*args, 0.0)
    wrapped = tI.baoab_fused_iteration(*args, BOX)
    for a, b in zip(plain, zero):
        assert torch.equal(a, b)
    lead = ((n_steps > i) & (i < 3))[:, None, None]
    assert torch.equal(wrapped[0], torch.where(
        lead, torch.remainder(plain[0], BOX), t["pos"]))
    assert torch.equal(wrapped[1], plain[1])
    j = {k: jnp.asarray(v) for k, v in d.items()}
    jc1, jns = jI.baoab_scales(j["masses"], j["temperature"], 2e-3, 2.0)
    pos_j, vel_j = jI.baoab_fused_iteration(
        i, j["pos"], j["vel"], j["f"], j["noise"], jc1, jns, j["masses"],
        jnp.asarray(n_steps.numpy()), 3, 2e-3, BOX)
    np.testing.assert_allclose(wrapped[0].numpy(), np.asarray(pos_j),
                               atol=1e-6)
    np.testing.assert_allclose(wrapped[1].numpy(), np.asarray(vel_j),
                               atol=1e-6)


def test_failure_detectors_match_jax():
    j = JLJEngine(max_energy=1e5)
    t = LJEngine(max_energy=1e5, device="cpu")
    assert t.failure_detectors == j.failure_detectors == ("nonfinite",
                                                           "energy")
    state = t.init_state(jr.key(0), R)
    vel = state["vel"].clone()
    vel[1] *= 100.0
    pos = state["pos"].clone()
    pos[2, 0, 0] = float("nan")
    bad = {"pos": pos, "vel": vel}
    np.testing.assert_array_equal(
        t.is_failed(bad).numpy(),
        np.asarray(j.is_failed({k: jnp.asarray(v.numpy())
                                for k, v in bad.items()})))
    assert t.is_failed(bad).tolist() == [False, True, True, False]
    assert LJEngine(device="cpu").failure_detectors == ("nonfinite",)


# -- the forces kernel's arithmetic (csrc/lj_fluid.cu), emulated ------------
#
# The kernel runs only on the card.  Here: its minimum image by one
# reciprocal and its division-free pair terms in float32, each unordered
# pair once, against JAX's ref and Pallas kernel, within chip_smoke.py's
# TOL_LJ_FORCE (max |diff| / max |want|).  The emulation's 1 / r2 is
# IEEE, the kernel's rcp.approx within an ulp of it.
TOL_LJ_FORCE = 1e-4
MAGIC = np.float32(1.5 * 2 ** 23)


def _rint(x):
    """The kernel's rint: (x + 1.5 * 2^23) - 1.5 * 2^23, two float32
    adds, half to even for |x| < 2^22."""
    return (x + MAGIC) - MAGIC


def _reciprocal_image_forces(pos, sigma, eps, box):
    sig2, _, c24, box = t_ref.fluid_constants(sigma, eps, box)
    inv_box = np.float32(1.0 / box)
    n = pos.shape[-2]
    i, j = torch.triu_indices(n, n, 1)
    d = pos[:, i] - pos[:, j]
    d = d - np.float32(box) * _rint(d * inv_box)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    inv_r2 = 1.0 / r2
    tt = np.float32(sig2) * inv_r2
    s6 = tt * (tt * tt)
    c = (s6 * (2.0 * s6 - 1.0) * inv_r2)[..., None]
    f = torch.zeros_like(pos)
    f.index_add_(1, i, c * d)
    f.index_add_(1, j, -c * d)
    return np.float32(c24) * f, d, (i, j)


def test_kernel_rint_is_round_half_to_even():
    x = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, 0.49999997, -0.49999997,
                      0.50000006, 1.0, -1.0, 0.0], dtype=torch.float32)
    x = torch.cat([x, torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, 4096).astype(np.float32))])
    assert torch.equal(_rint(x), torch.round(x))


def _half_box_fluid():
    """64 atoms on the 4^3 lattice (spacing box / 4) with jitter, three of
    them put back on their sites so that pairs sit exactly +-box/2 apart:
    atoms 0, 32 (= site (2, 0, 0)) and 42 (= site (2, 2, 2))."""
    pos = _fluid(64)
    site = (np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) + 0.5) * np.float32(BOX / 4)
    for a in (0, 32, 42):
        pos[:, a] = site[a]
    return pos


@pytest.mark.parametrize("n_atoms", [27, 64])
def test_reciprocal_image_forces_match_jax(n_atoms):
    pos = _half_box_fluid() if n_atoms == 64 else _fluid(n_atoms)
    f_t, d, (i, j) = _reciprocal_image_forces(torch.from_numpy(pos), SIGMA,
                                              EPS, BOX)
    jp = jnp.asarray(pos)
    for f_j in (j_ref.lj_forces(jp, SIGMA, EPS, BOX),
                j_ops.lj_forces_batched(jp, SIGMA, EPS, BOX, 32, True)):
        f_j = np.asarray(f_j)
        err = np.abs(f_t.numpy() - f_j).max() / np.abs(f_j).max()
        assert err <= TOL_LJ_FORCE, err
    # the image is odd in d, so F_ij = -F_ji; on the half-box pairs it is
    # the division's image exactly (d * inv_box is 1/2 or just below)
    raw = torch.from_numpy(pos)[:, i] - torch.from_numpy(pos)[:, j]
    want = raw - np.float32(BOX) * torch.round(raw / np.float32(BOX))
    assert torch.equal(d, want)
    if n_atoms == 64:
        half = (raw.abs() == np.float32(BOX / 2)).any(-1)
        assert int(half.sum()) >= 3 * pos.shape[0]
        neg = -raw
        assert torch.equal(neg - np.float32(BOX) * _rint(
            neg * np.float32(1.0 / BOX)), -d)


# -- the energy kernel's summation order (csrc/lj_fluid.cu) ------------------
#
# At N = 17,500 an energy summed atom by atom in one float32 register (an
# earlier kernel's order) loses the far pairs' terms, each under half an
# ulp of the running sum.  The kernel now sums each lane's pairs of one
# tile entry (at most 128), then its entries, the lanes of a warp in a
# butterfly, the warps of a block in order, the blocks in order.  Both
# orders are emulated here in float32 on the same float32 pair terms and
# held to the float64 energy with TOL_LJ_ENERGY (chip_smoke.py's).
TOL_LJ_ENERGY = 1e-5


def _argon(n_atoms, seed=0):
    """A lattice with 0.3 A jitter at argon's density (Rahman's 864 atoms
    in 34.8 A), wrapped into the box: the card test's configuration."""
    box = 34.8 * (n_atoms / 864) ** (1 / 3)
    side = int(np.ceil(n_atoms ** (1 / 3) - 1e-9))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_atoms]
    rng = np.random.default_rng(seed)
    pos = (g + 0.5) * (box / side) + 0.3 * rng.standard_normal((n_atoms, 3))
    return torch.from_numpy(np.mod(pos, box).astype(np.float32)), box


def _pair_u(pos, i, j, box, inv_box, sig2, m):
    """float32 s6 (s6 - 1) m of the pairs (i, j) with their 0/1 masks m,
    the minimum image by one reciprocal and r2 += 1 - m, as the kernel
    forms them (1 / r^2 rounded once here, an ulp from the kernel's
    rcp)."""
    d = pos[i] - pos[j]
    d = d - box * torch.round(d * inv_box)
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    tt = sig2 * (1.0 / (r2 + (1.0 - m)))
    s6 = tt * (tt * tt)
    return s6 * (s6 - 1.0) * m


def _tile_walk_energy(pos, box, sig2, c4):
    """The kernel's order at R = 1: lanes' sums per tile entry, entries
    per lane, the butterfly, warps, blocks (float32 throughout)."""
    from repro_torch.kernels import pad_to_block
    n = pos.shape[0]
    ld = pad_to_block(n, t_ops.TILE)
    n_t = ld // t_ops.PAIR_TILE
    split = t_ops.block_split(1, n_t, waves=2)
    n_warps = t_ops.pair_warps(n_t)
    sched = t_ops.tile_schedule(n_t, "cpu")
    inv_box = float(np.float32(1.0 / box))
    padded = torch.cat([pos, torch.zeros(ld - n, 3)])
    lane = torch.arange(32)
    ent = torch.zeros(n_t, n_t, 32)              # (round, slot, lane)

    def add(e, ia, ja, keep=True):              # one step of every lane
        m = ((ia < n) & (ja < n) & keep).to(torch.float32)
        return e + _pair_u(padded, ia, ja, box, inv_box, sig2, m)

    u, k = torch.nonzero(sched >= 0, as_tuple=True)
    tiles = sched[u, k]
    ti, tj = tiles & 0xFFFF, tiles >> 16
    off = ti != tj
    ii, jj = (64 * ti[off])[:, None], (64 * tj[off])[:, None]
    e = torch.zeros(int(off.sum()), 32)
    for h in range(2):
        for s in range(32):
            j = jj + 32 * h + (lane + s) % 32
            e = add(e, ii + lane, j)
            e = add(e, ii + 32 + lane, j)
    ent[u[off], k[off]] = e
    dg = ~off
    base = (64 * ti[dg])[:, None]
    e = torch.zeros(int(dg.sum()), 32)
    for s in range(32):                          # lower half x upper half
        e = add(e, base + lane, base + 32 + (lane + s) % 32)
    for h in range(2):                           # each half with itself
        for s in range(1, 17):                   # (l, l + 16) once
            keep = lane < 16 if s == 16 else torch.ones(32, dtype=torch.bool)
            e = add(e, base + 32 * h + lane, base + 32 * h + (lane + s) % 32,
                    keep)
    ent[u[dg], k[dg]] = e
    # each lane's entries in its block's order: rounds s, s + S, ...; the
    # warp's slots w, w + n_warps, ... (a slot past the round's end adds 0)
    t = torch.zeros(split, n_warps, 32)
    for r0 in range(0, n_t, split):
        for k0 in range(0, n_t, n_warps):
            rr = torch.arange(r0, r0 + split)[:, None]
            kk = torch.arange(k0, k0 + n_warps)[None, :]
            ok = (rr < n_t) & (kk < n_t)
            t = t + torch.where(ok[..., None], ent[rr.clamp(max=n_t - 1),
                                                   kk.clamp(max=n_t - 1)], 0)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lane ^ o]
    blocks = torch.zeros(split)
    for w in range(n_warps):
        blocks = blocks + t[:, w, 0]
    total = torch.zeros(())
    for b in blocks:
        total = total + b
    return float(c4 * total)


def _one_register_energy(pos, box, sig2, c4):
    """The earlier order: each atom's sum over all j in one float32
    register (c4 in every term, the diagonal masked), 128-thread blocks
    in a tree, the blocks in order, halved."""
    n = pos.shape[0]
    inv_box = float(np.float32(1.0 / box))
    i = torch.arange(n)
    e = torch.zeros(n)
    for j in range(n):
        m = (i != j).to(torch.float32)
        e = e + c4 * _pair_u(pos, i, torch.full_like(i, j), box, inv_box,
                             sig2, m)
    nb = -(-n // 128)
    sh = torch.cat([e, torch.zeros(nb * 128 - n)]).reshape(nb, 128)
    s = 64
    while s:
        sh = torch.cat([sh[:, :s] + sh[:, s:2 * s], sh[:, s:]], dim=1)
        s //= 2
    total = torch.zeros(())
    for b in sh[:, 0]:
        total = total + b
    return float(0.5 * total)


def _float64_energy(pos, box, sig2, c4):
    p = pos.double()
    out = 0.0
    for i0 in range(0, p.shape[0], 2048):
        d = p[i0:i0 + 2048, None, :] - p[None, :, :]
        d = d - box * torch.round(d / box)
        r2 = (d * d).sum(-1)
        idx = torch.arange(i0, min(i0 + 2048, p.shape[0]))
        r2[idx - i0, idx] = 1.0
        s6 = (sig2 / r2) ** 3
        u = s6 * (s6 - 1.0)
        u[idx - i0, idx] = 0.0
        out += float(u.sum())
    return 0.5 * c4 * out


def test_tile_walk_energy_order_holds_at_17500_atoms():
    pos, box = _argon(17500)
    sig2, c4, _, box = t_ref.fluid_constants(SIGMA, EPS, box)
    want = _float64_energy(pos, box, sig2, c4)
    new = _tile_walk_energy(pos, box, sig2, c4)
    old = _one_register_energy(pos, box, sig2, c4)
    assert abs(new - want) <= TOL_LJ_ENERGY * abs(want), (new, want)
    assert abs(old - want) > TOL_LJ_ENERGY * abs(want), (old, want)

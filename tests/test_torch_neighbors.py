"""The port's neighbor lists against the JAX package's, at a small size
(``chain_molecule`` of 22-64 atoms, up to 8 replicas):

  * ``build_dense``: idx, valid and dropped identical (an overflow case
    included), and two-sided;
  * ``pair_planes`` bitwise equal;
  * ``needs_rebuild`` and ``maybe_rebuild`` (both policies) identical,
    for a tripped and an untripped list, counters included;
  * the gated build's plain version: flag 0 keeps the old rows, flag 1
    is a fresh build, a flag row mixes them;
  * the host-side ``suggest_*`` heuristics equal;
  * the card build's tile cull in PyTorch (``ref.build_culled``: 32-atom
    bounding boxes, the 2^-16 margin, candidate tiles in ascending
    order): lists bitwise equal to ``build_dense`` and to JAX's, on the
    chain, on a random gas, and on pairs at r_list and one float32 ulp on
    either side of it, placed so that tile boxes meet the cull's edge;
  * the engine's sparse constants, its first list, and the nested state
    through failure recovery: a replica that fails (a low ``max_energy``)
    gets its ``nlist`` rows back from the backup exactly as the JAX
    driver restores them.

The lists are integer data and compared exactly; positions within
1e-4 A (the float steps are the same, XLA and PyTorch fuse them
differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.md import MDEngine as JEngine
from repro.md import neighbors as JNB
from repro.md.system import base_positions as j_base_positions
from repro.md.system import chain_molecule as j_chain_molecule
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.kernels.nlist_build import ops as nl_ops
from repro_torch.kernels.nlist_build import ref as nl_ref
from repro_torch.md import MDEngine
from repro_torch.md import neighbors as NB

CUTOFF, SKIN = 8.0, 1.5
R_LIST = CUTOFF + SKIN


def _system(n_atoms):
    jsys = j_chain_molecule(n_atoms)
    tsys = convert.system_from_arrays(jsys, device="cpu")
    return jsys, tsys, nb_ops.build_pack(tsys)


def _stack(jsys, n_rep, scale=0.3, seed=0):
    rng = np.random.default_rng(seed)
    base = np.asarray(j_base_positions(jsys))
    return (base[None] + scale * rng.standard_normal(
        (n_rep,) + base.shape)).astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n_atoms,n_rep,k_max", [(22, 4, 12), (40, 3, 16),
                                                 (64, 8, 18), (40, 2, 4)])
def test_build_dense_matches_jax(n_atoms, n_rep, k_max):
    jsys, tsys, _ = _system(n_atoms)
    pos = _stack(jsys, n_rep)
    want = JNB.build_dense(jnp.asarray(pos), jsys.nb_mask, R_LIST, k_max)
    got = NB.build_dense(torch.from_numpy(pos), tsys.nb_mask, R_LIST, k_max)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    for g, w in zip(got, want):
        _same(g.numpy(), w)
    if k_max == 4:
        assert int(got[2].min()) > 0                   # pairs dropped
    else:
        assert int(got[2].max()) == 0


def test_lists_are_two_sided_and_ascending():
    jsys, tsys, _ = _system(40)
    idx, valid, _ = NB.build_dense(torch.from_numpy(_stack(jsys, 2)),
                                   tsys.nb_mask, R_LIST, 30)
    for r in range(2):
        rows = [set(idx[r, i][valid[r, i] > 0].tolist()) for i in range(40)]
        for i, row in enumerate(rows):
            assert all(i in rows[j] for j in row)
            listed = idx[r, i][valid[r, i] > 0]
            assert torch.equal(listed, torch.sort(listed).values)


def test_pair_planes_match_jax_bitwise():
    jsys, tsys, _ = _system(40)
    pos = _stack(jsys, 3)
    idx_j, _, _ = JNB.build_dense(jnp.asarray(pos), jsys.nb_mask, R_LIST, 16)
    want = JNB.pair_planes(idx_j, jsys.lj_sigma, jsys.lj_eps, jsys.charges)
    got = NB.pair_planes(torch.from_numpy(np.array(idx_j)), tsys.lj_sigma,
                         tsys.lj_eps, tsys.charges)
    _same(got.numpy(), want)


def _lists(jsys, tsys, npack, pos, planes):
    pp_j = (jsys.lj_sigma, jsys.lj_eps, jsys.charges) if planes else None
    pp_t = (tsys.lj_sigma, tsys.lj_eps, tsys.charges) if planes else None
    jl = JNB.build_neighbor_list(jnp.asarray(pos), jsys.nb_mask, R_LIST, 16,
                                 pair_params=pp_j)
    tl = NB.build_neighbor_list(torch.from_numpy(pos), npack, R_LIST, 16,
                                pair_params=pp_t)
    return jl, tl, pp_j, pp_t


def _same_list(tl, jl):
    assert set(tl) == set(jl)
    for key in tl:
        _same(tl[key].numpy(), jl[key])


@pytest.mark.parametrize("planes", [False, True])
def test_build_neighbor_list_matches_jax(planes):
    jsys, tsys, npack = _system(40)
    jl, tl, _, _ = _lists(jsys, tsys, npack, _stack(jsys, 3), planes)
    _same_list(tl, jl)
    assert tl["overflow"].dtype == torch.int32
    assert tl["rebuilds"].dtype == torch.int32


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("drift", [0.1, 1.0])
def test_maybe_rebuild_matches_jax(sync, planes, drift):
    """A list built at one stack, checked at a moved one: with a drift of
    0.1 A nothing trips; at 1.0 A some replicas trip (one does not move),
    and the counters, ref_pos and rows follow the policy."""
    jsys, tsys, npack = _system(40)
    pos0 = _stack(jsys, 4)
    jl, tl, pp_j, pp_t = _lists(jsys, tsys, npack, pos0, planes)
    pos1 = pos0.copy()
    pos1[1:] += drift * np.random.default_rng(1).standard_normal(
        pos1[1:].shape).astype(np.float32)
    need = NB.needs_rebuild(torch.from_numpy(pos1), tl, SKIN)
    _same(need.numpy(), JNB.needs_rebuild(jnp.asarray(pos1), jl, SKIN))
    assert bool(need.any()) == (drift > 0.5) and not bool(need[0])
    want = JNB.maybe_rebuild(jnp.asarray(pos1), jl, jsys.nb_mask, R_LIST,
                             SKIN, 16, sync=sync, pair_params=pp_j)
    got = NB.maybe_rebuild(torch.from_numpy(pos1), tl, npack, R_LIST, SKIN,
                           16, sync=sync, pair_params=pp_t)
    _same_list(got, want)
    rebuilt = got["rebuilds"].numpy()
    if drift < 0.5:
        assert rebuilt.sum() == 0
    else:
        assert rebuilt[0] == (1 if sync else 0) and rebuilt[1:].min() == 1
    assert got["idx"].data_ptr() != tl["idx"].data_ptr()     # out of place


def test_gated_plain_build_keeps_or_builds_by_flag():
    jsys, tsys, npack = _system(40)
    pos0, pos1 = (torch.from_numpy(_stack(jsys, 3, seed=s)) for s in (0, 1))
    old = NB.build_dense(pos0, tsys.nb_mask, R_LIST, 6)[:2]
    fresh = NB.build_dense(pos1, tsys.nb_mask, R_LIST, 6)
    assert int(fresh[2].min()) > 0
    for flag, rows in ((torch.zeros(1, dtype=torch.bool), [0, 0, 0]),
                       (torch.ones(1, dtype=torch.bool), [1, 1, 1]),
                       (torch.tensor([True, False, True]), [1, 0, 1])):
        got = nl_ops.build_gated(pos1, flag, old, npack, R_LIST, 6)
        for r, take in enumerate(rows):
            src = fresh if take else old + (torch.zeros(3, dtype=torch.int32),)
            for g, w in zip(got, src):
                assert torch.equal(g[r], w[r])


def test_build_kernel_takes_no_cpu_tensor():
    jsys, tsys, npack = _system(22)
    pos = torch.from_numpy(_stack(jsys, 2))
    with pytest.raises(ValueError, match="CUDA"):
        nl_ops.nlist_build_batched(pos, None, None, npack.mask_u8, R_LIST, 8)


@pytest.mark.parametrize("n_atoms", [22, 64, 300])
def test_suggestions_match_jax(n_atoms):
    jsys, tsys, _ = _system(n_atoms)
    base = np.asarray(j_base_positions(jsys))
    stack = _stack(jsys, 3, scale=0.5)
    mask = np.asarray(jsys.nb_mask)
    for r_list in (R_LIST, 10.5):
        extent = base.max(0) - base.min(0) + 2.0 * r_list
        dims = NB.suggest_grid_dims(extent, r_list)
        assert dims == JNB.suggest_grid_dims(extent, r_list)
        for positions in (base, stack):
            assert (NB.suggest_k_max(n_atoms, positions, mask, r_list)
                    == JNB.suggest_k_max(n_atoms, positions, mask, r_list))
            cap = NB.suggest_cell_capacity(positions, r_list, dims)
            assert cap == JNB.suggest_cell_capacity(positions, r_list, dims)
            assert (NB.suggest_cell_capacity(positions, r_list, dims,
                                             max_capacity=5)
                    == JNB.suggest_cell_capacity(positions, r_list, dims,
                                                 max_capacity=5))
            assert (NB.suggest_build_method(n_atoms, dims, cap)
                    == JNB.suggest_build_method(n_atoms, dims, cap))
    assert NB.suggest_build_method(5000, (16, 16, 16), 8) == "cell"


@pytest.mark.parametrize("n_atoms", [22, 64])
def test_engine_constants_and_first_list_match_jax(n_atoms):
    jsys, tsys, _ = _system(n_atoms)
    jeng = JEngine(jsys, nonbonded="sparse", bonded="sparse")
    teng = MDEngine(tsys, nonbonded="sparse", bonded="sparse", device="cpu")
    for attr in ("cutoff", "skin", "r_list", "k_max", "nlist_build"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert teng._pair_params is not None                 # CPU default
    jstate = jeng.init_state(jax.random.key(3), 4)
    tstate = teng.init_state(jr.key(3, "cpu"), 4)
    _same(tstate["pos"].numpy(), jstate["pos"])
    _same_list(tstate["nlist"], jstate["nlist"])
    stats = teng.nb_stats(tstate)
    assert {k: float(v) for k, v in stats.items()} == {
        k: float(v) for k, v in jeng.nb_stats(jstate).items()}


def _fake_ens(state):
    """A stand-in JAX ``Ensemble`` with the fields the converter reads."""
    from repro.core.ensemble import Ensemble
    r = state["pos"].shape[0]
    z = jnp.zeros(r)
    return Ensemble(state=state, assignment=jnp.arange(r),
                    rng=jax.random.key(0), cycle=jnp.zeros((), jnp.int32),
                    debt=z, speed=z + 1, alive=jnp.ones(r, bool),
                    failures=jnp.zeros((), jnp.int32),
                    relaunches=jnp.zeros(r, jnp.int32))


def test_converter_keeps_the_nested_state_and_its_dtypes():
    jsys, _, _ = _system(22)
    jstate = JEngine(jsys, nonbonded="sparse").init_state(
        jax.random.key(0), 2)
    ens = convert.ensemble_from_arrays(_fake_ens(jstate), np.zeros(2), "cpu")
    nl = ens.state["nlist"]
    assert nl["idx"].dtype == torch.int32 and nl["valid"].dtype == \
        torch.float32 and nl["rebuilds"].dtype == torch.int32
    _same_list(nl, jstate["nlist"])


def test_failed_replica_gets_its_list_back_as_jax_restores_it():
    """A kinetic-energy threshold below the ensemble's makes replicas fail
    every cycle; the driver relaunches them from the backup, list and
    counters included, as the JAX driver does."""
    jsys = j_chain_molecule(24)
    dims = (("temperature", 2), ("umbrella", 2))
    cfg = dict(dimensions=dims, md_steps_per_cycle=3, n_cycles=4)
    kw = dict(nonbonded="sparse", bonded="sparse", skin=0.3,
              max_energy=60000.0)
    jdrv = JDriver(JEngine(jsys, force_path="fused", **kw), JConfig(**cfg))
    jout = jdrv.run_fused(jdrv.init(0), chunk_cycles=2)
    tdrv = REMDDriver(MDEngine(convert.system_from_arrays(jsys, "cpu"),
                               force_path="fused", device="cpu", **kw),
                      RepExConfig(**cfg), device="cpu")
    tout = tdrv.run_fused(tdrv.init(0), chunk_cycles=2)
    failed = [h["failed"] for h in tdrv.history]
    assert failed == [h["failed"] for h in jdrv.history]
    assert 0 < sum(failed) < 4 * len(failed)         # some, not all, fail
    for key in ("nb_rebuilds", "nb_overflow"):
        assert [h[key] for h in tdrv.history] == [h[key] for h in
                                                  jdrv.history]
    jnl, tnl = jout.state["nlist"], tout.state["nlist"]
    for key in ("idx", "valid", "overflow", "rebuilds"):
        _same(tnl[key].numpy(), jnl[key])
    for key in ("pair", "ref_pos"):
        np.testing.assert_allclose(tnl[key].numpy(), np.asarray(jnl[key]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout.state["pos"].numpy(),
                               np.asarray(jout.state["pos"]), atol=1e-4)
    assert np.array_equal(np.stack([h["assignment"] for h in tdrv.history]),
                          np.stack([np.asarray(h["assignment"])
                                    for h in jdrv.history]))


# -- the card build's tile cull (kernels/nlist_build/csrc/nlist_build.cu) --

def _culled_vs_dense_and_jax(jsys, tsys, npack, pos, k_max):
    want = JNB.build_dense(jnp.asarray(pos), jsys.nb_mask, R_LIST, k_max)
    tpos = torch.from_numpy(pos)
    dense = NB.build_dense(tpos, tsys.nb_mask, R_LIST, k_max)
    got = nl_ref.build_culled(tpos, npack.mask_bits, R_LIST, k_max)
    for g, d, w in zip(got, dense, want):
        _same(g.numpy(), d.numpy())
        _same(g.numpy(), w)
    return got


@pytest.mark.parametrize("kind,n_atoms,n_rep,k_max", [
    ("chain", 300, 3, 16), ("chain", 130, 2, 4), ("gas", 300, 2, 24),
    ("gas", 257, 2, 6)])
def test_tile_cull_build_equals_dense_and_jax(kind, n_atoms, n_rep, k_max):
    jsys, tsys, npack = _system(n_atoms)
    if kind == "chain":
        pos = _stack(jsys, n_rep)
    else:   # no locality in the atom order: 40 A box, ~17 neighbors each
        pos = np.random.default_rng(1).uniform(
            0, 40.0, (n_rep, n_atoms, 3)).astype(np.float32)
    got = _culled_vs_dense_and_jax(jsys, tsys, npack, pos, k_max)
    near = nl_ref.near_tiles(nl_ref.tile_boxes(torch.from_numpy(pos)),
                             nl_ops.f32_square(R_LIST))
    assert bool(near.transpose(1, 2).eq(near).all())       # symmetric
    if kind == "chain":
        assert not bool(near.all())                    # some tiles culled
    assert (int(got[2].min()) > 0) == (k_max <= 6)


def _boundary_stack():
    """160 atoms (five 32-atom tiles) on the x axis: tile 0 at x <= 0
    (atom 0 at the origin), tiles 1-4 starting exactly at r_list, one
    float32 ulp above and below it, and 2^-14 above it (past the cull's
    margin), so that pairs with atom 0 sit at r2 = r_list^2 and one ulp of
    x on either side, and tile boxes sit on, inside and just past the
    cull's edge."""
    r = np.float32(R_LIST)
    starts = [r, np.nextafter(r, np.float32(np.inf)),
              np.nextafter(r, np.float32(0)), np.float32(r * (1 + 2.0 ** -14))]
    x = [-0.25 * np.arange(32, dtype=np.float32)]
    x += [s + np.float32(0.125) * np.arange(32, dtype=np.float32)
          for s in starts]
    pos = np.zeros((1, 160, 3), np.float32)
    pos[0, :, 0] = np.concatenate(x)
    return pos


def test_tile_cull_keeps_pairs_at_the_list_radius():
    jsys, tsys, npack = _system(160)
    pos = _boundary_stack()
    r2 = nl_ops.f32_square(R_LIST)
    x = pos[0, :, 0]
    assert np.float32(x[32] * x[32]) == r2             # on r_list
    assert np.float32(x[64] * x[64]) > r2              # one ulp above
    assert np.float32(x[96] * x[96]) < r2              # one ulp below
    got = _culled_vs_dense_and_jax(jsys, tsys, npack, pos, 64)
    row0 = set(got[0][0, 0][got[1][0, 0] > 0].tolist())
    assert 32 in row0 and 96 in row0 and 64 not in row0
    near = nl_ref.near_tiles(nl_ref.tile_boxes(torch.from_numpy(pos)), r2)
    # gap^2 on r_list, one ulp past it (inside the margin) and below it:
    # kept; 2^-13 past it: culled
    assert near[0, 0, 1:4].all() and not near[0, 0, 4]


def test_tile_boxes_hold_their_atoms():
    jsys, tsys, npack = _system(130)
    pos = torch.from_numpy(_stack(jsys, 2))
    boxes = nl_ref.tile_boxes(pos)
    assert boxes.shape == (2, 5, 6)
    for t in range(5):
        atoms = pos[:, 32 * t:min(130, 32 * (t + 1))]
        assert torch.equal(boxes[:, t, :3], atoms.amin(1))
        assert torch.equal(boxes[:, t, 3:], atoms.amax(1))
    r2 = nl_ops.f32_square(R_LIST)
    assert nl_ref.cull_threshold(r2) == np.float32(r2 * (1 + 2.0 ** -16))
    assert nl_ref.cull_threshold(r2) > r2

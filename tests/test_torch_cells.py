"""The port's cell-list build against the JAX package's ``build_cells``,
on the CPU.

JAX's ``build_cells`` packs each row in candidate order (stencil cell,
then rank in the cell), not in ascending j, and the sparse pass sums in
slot order: so ``idx``, ``valid`` and ``dropped`` are held bitwise, not
as sets, on

  * JAX's own cases (``tests/test_neighbor_list.py``): a random gas over
    several grid shapes and capacities, the chain with exclusions, a
    cell-capacity overflow and a ``k_max`` overflow, with the neighbor
    sets also equal to ``build_dense``'s;
  * atoms placed exactly on cell borders and pairs at the list radius
    and one float32 ulp on either side of it;
  * ``build_neighbor_list(method="cell")`` and ``maybe_rebuild`` on both
    policies, counters included.

The plain build equals the plain form of the card kernel's algorithm
(``ref.build_cells_counting``: a counting sort over bin blocks, then
each cell's rows against its stencil's runs, culled a warp's rows at a
time), also with the bins split over blocks of 1, 7, 32 and N atoms and
at pairs one ulp either side of r_list;
``MDEngine(nonbonded="sparse", nlist_build="cell")``
makes JAX's ``run_fused`` decisions at R = 8, chunk sizes 1 and 3, with
its lists bitwise JAX's at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import MDEngine as JEngine
from repro.md import neighbors as JNB
from repro.md.system import chain_molecule as j_chain_molecule
from repro.md.system import initial_positions as j_initial_positions
from repro_torch import convert
from repro_torch.kernels.lj_forces import ops as nb_ops
from repro_torch.kernels.nlist_build import ops as nl_ops
from repro_torch.kernels.nlist_build import ref as nl_ref
from repro_torch.md import MDEngine
from repro_torch.md import neighbors as NB
from test_torch_sparse import run_sparse_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R_LIST = 9.5
SKIN = 1.5


def _gas(n_rep=2, n=50, side=12.0, seed=0):
    pos = np.asarray(jax.random.uniform(jax.random.key(seed), (n_rep, n, 3))
                     * side)
    return pos, np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)


def _chain(n_atoms=40, n_rep=4):
    jsys = j_chain_molecule(n_atoms)
    pos = np.asarray(jnp.stack([j_initial_positions(jsys, jax.random.key(i))
                                for i in range(n_rep)]))
    return jsys, pos


def _chain_dims(n_atoms=40):
    return JNB.suggest_grid_dims(np.array([n_atoms * 1.45, 8.0, 8.0]),
                                 R_LIST)


def _bits(mask):
    """The kernels' mask bits of an (N, N) 0/1 mask."""
    n = mask.shape[0]
    u8 = torch.zeros((n, nb_ops.pad_to_block(n, nb_ops.TILE)),
                     dtype=torch.uint8)
    u8[:, :n] = torch.from_numpy(np.asarray(mask)).to(torch.uint8)
    return nb_ops.tile_flags(u8)[0]


def _sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [[frozenset(int(j) for j, v in zip(idx[r, i], valid[r, i])
                       if v > 0) for i in range(idx.shape[1])]
            for r in range(idx.shape[0])]


def _check(pos, mask, r_list, k_max, grid_dims, capacity):
    """Bitwise JAX's build_cells; returns the port's lists."""
    want = JNB.build_cells(jnp.asarray(pos), jnp.asarray(mask), r_list,
                           k_max, grid_dims, capacity)
    got = NB.build_cells(torch.from_numpy(np.array(pos)),
                         torch.from_numpy(np.array(mask)), r_list, k_max,
                         grid_dims, capacity)
    for name, g, w in zip(("idx", "valid", "dropped"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("grid_dims,capacity", [
    ((1, 1, 1), 50), ((2, 2, 2), 50), ((3, 3, 3), 50), ((5, 4, 3), 32),
])
def test_gas_matches_jax_bitwise_and_dense_as_sets(grid_dims, capacity):
    pos, mask = _gas()
    idx, valid, dropped = _check(pos, mask, 4.0, 49, grid_dims, capacity)
    i_d, v_d, d_d = nl_ref.build_dense(torch.from_numpy(pos),
                                       torch.from_numpy(mask), 4.0, 49)
    assert _sets(idx, valid) == _sets(i_d, v_d)
    assert int(dropped.max()) == 0 == int(d_d.max())


def test_chain_matches_jax_bitwise_and_prunes_exclusions():
    jsys, pos = _chain()
    mask = np.asarray(jsys.nb_mask)
    idx, valid, _ = _check(pos, mask, R_LIST, 39, _chain_dims(), 24)
    i_d, v_d, _ = nl_ref.build_dense(torch.from_numpy(pos),
                                     torch.from_numpy(mask), R_LIST, 39)
    sets = _sets(idx, valid)
    assert sets == _sets(i_d, v_d)
    for i, j in np.asarray(jsys.bonds):
        assert int(j) not in sets[0][int(i)]


@pytest.mark.parametrize("capacity,k_max", [(2, 39), (24, 6), (3, 5)])
def test_overflow_is_counted_as_jax_counts_it(capacity, k_max):
    """Cell-capacity drops (each dropped atom once) and k_max drops."""
    jsys, pos = _chain()
    _, _, dropped = _check(pos, np.asarray(jsys.nb_mask), R_LIST, k_max,
                           _chain_dims(), capacity)
    assert int(dropped.min()) > 0


def test_atoms_on_cell_borders_and_pairs_at_the_radius():
    """A lattice whose atoms sit exactly on cell borders (the bounding box
    a whole number of widths), and pairs at r_list^2 and one ulp either
    side: the floors and the distance test agree with JAX's."""
    r_list = 4.0
    g = np.arange(6, dtype=np.float32) * np.float32(r_list)
    lat = np.stack(np.meshgrid(g, g[:3], g[:2], indexing="ij"),
                   -1).reshape(-1, 3)
    r2 = np.float32(r_list * r_list)
    ds = [np.sqrt(np.nextafter(r2, np.float32(np.inf))),
          np.sqrt(r2), np.sqrt(np.nextafter(r2, np.float32(0)))]
    extra = np.array([[1.0 + d, 2.0, 1.0] for d in ds]
                     + [[1.0, 2.0, 1.0]], np.float32)
    pos = np.concatenate([lat, extra])[None].repeat(2, 0)
    pos[1] += np.float32(0.5)
    n = pos.shape[1]
    mask = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    for dims in ((6, 3, 2), (5, 3, 2), (7, 4, 3)):
        _check(pos, mask, r_list, n - 1, dims, n)


@pytest.mark.parametrize("case", ["gas", "chain", "overflow"])
def test_plain_build_equals_the_kernel_algorithm(case):
    if case == "gas":
        pos, mask = _gas(n_rep=3, n=60, side=10.0, seed=3)
        args = (4.0, 59, (4, 3, 2), 12)
    else:
        jsys, pos = _chain(n_rep=3)
        mask = np.asarray(jsys.nb_mask)
        args = ((R_LIST, 39, _chain_dims(), 24) if case == "chain"
                else (R_LIST, 5, _chain_dims(), 3))
    p = torch.from_numpy(pos)
    plain = nl_ref.build_cells(p, torch.from_numpy(mask), *args)
    counting = nl_ref.build_cells_counting(p, _bits(mask), *args)
    for name, a, b in zip(("idx", "valid", "dropped"), plain, counting):
        assert torch.equal(a, b), name


def _straddle(n_rep=2, n=40):
    """Every other atom in one tight cluster (one cell, its atoms spread
    over the index range and so over every bin block), the rest spread
    over a 12 A box: with capacity 5 that cell's kept atoms lie in the
    first blocks and its dropped ones in the later."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, 12.0, (n_rep, n, 3)).astype(np.float32)
    pos[:, ::2] = (1.0 + 0.5 * rng.uniform(size=(n_rep, n // 2, 3))
                   ).astype(np.float32)
    return pos, np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)


def _mirror_case(case):
    """(pos, mask, (r_list, k_max, grid_dims, capacity)) of the counting
    mirror's cases."""
    if case == "gas":
        pos, mask = _gas(n_rep=3, n=60, side=10.0, seed=3)
        return pos, mask, (4.0, 59, (4, 3, 2), 12)
    if case == "straddle":
        pos, mask = _straddle()
        return pos, mask, (4.0, 8, (3, 3, 3), 5)
    jsys, pos = _chain(n_rep=3)
    args = ((R_LIST, 39, _chain_dims(), 24) if case == "chain"
            else (R_LIST, 5, _chain_dims(), 3))
    return pos, np.asarray(jsys.nb_mask), args


@pytest.mark.parametrize("block", [1, 7, 32, "N"])
@pytest.mark.parametrize("case", ["gas", "chain", "overflow", "straddle"])
def test_kernel_algorithm_over_bin_blocks_equals_jax(case, block):
    """The card's algorithm with its bins split over blocks of 1, 7, 32
    and N atoms (a cell's atoms, its kept ones and its capacity drops
    spread over several blocks): bitwise JAX's build_cells and the plain
    build; the position scratch is the positions in the bin order."""
    pos, mask, args = _mirror_case(case)
    n = pos.shape[1]
    size = n if block == "N" else block
    p = torch.from_numpy(pos.copy())
    want = _check(pos, mask, *args)
    plain = nl_ref.build_cells(p, torch.from_numpy(mask), *args)
    got = nl_ref.build_cells_counting(p, _bits(mask), *args,
                                      block_size=size)
    for name, a, b, c in zip(("idx", "valid", "dropped"), got, plain, want):
        assert torch.equal(a, b) and torch.equal(a, c), name
    if case in ("overflow", "straddle"):
        assert int(got[2].min()) > 0
    order, table, posc = nl_ref.bin_counting(p, args[0], args[2], size)
    assert torch.equal(posc[..., :3], torch.gather(
        p, 1, order[..., None].expand(-1, -1, 3)))
    assert torch.equal(posc[..., 3].contiguous().view(torch.int32),
                       order.to(torch.int32))
    cc = nl_ref._cell_coords(p, args[0], args[2])
    gx, gy, gz = args[2]
    cell_id = (cc[..., 0] * gy + cc[..., 1]) * gz + cc[..., 2]
    for rep in range(pos.shape[0]):
        for c in range(gx * gy * gz):
            atoms = torch.cat([order[rep, s:s + k]
                               for s, k in table[rep, c].tolist()])
            assert torch.equal(atoms, torch.nonzero(
                cell_id[rep] == c).flatten())


@pytest.mark.parametrize("block", [1, 32])
def test_kernel_algorithm_cull_keeps_pairs_at_the_radius(block):
    """The row pass's cull (a warp's rows' bounding box) on a lattice
    whose atoms sit on cell borders and on pairs at r_list^2 and one ulp
    either side: no pair within r_list is culled."""
    r_list = 4.0
    g = np.arange(6, dtype=np.float32) * np.float32(r_list)
    lat = np.stack(np.meshgrid(g, g[:3], g[:2], indexing="ij"),
                   -1).reshape(-1, 3)
    r2 = np.float32(r_list * r_list)
    ds = [np.sqrt(np.nextafter(r2, np.float32(np.inf))),
          np.sqrt(r2), np.sqrt(np.nextafter(r2, np.float32(0)))]
    extra = np.array([[1.0 + d, 2.0, 1.0] for d in ds]
                     + [[1.0, 2.0, 1.0]], np.float32)
    pos = np.concatenate([lat, extra])[None].repeat(2, 0)
    pos[1] += np.float32(0.5)
    n = pos.shape[1]
    mask = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    for dims in ((6, 3, 2), (5, 3, 2), (7, 4, 3)):
        want = _check(pos, mask, r_list, n - 1, dims, n)
        got = nl_ref.build_cells_counting(torch.from_numpy(pos.copy()),
                                          _bits(mask), r_list, n - 1, dims,
                                          n, block_size=block)
        for name, a, b in zip(("idx", "valid", "dropped"), got, want):
            assert torch.equal(a, b), (dims, name)


def test_bin_block_keeps_the_card_within_16_blocks():
    """The card's bin block: 1024 atoms up to N = 16,384, then the least
    multiple of 1024 that keeps the blocks at 16 or fewer."""
    for n, block in ((1, 1024), (2881, 1024), (16384, 1024),
                     (16385, 2048), (20000, 2048), (10 ** 6, 63488)):
        assert nl_ref.bin_block(n) == block
        assert -(-n // block) <= nl_ref.MAX_BIN_BLOCKS


def _list_same(got, want):
    for k in ("idx", "valid", "ref_pos", "overflow", "rebuilds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_cell_build_is_ported():
    """``build_neighbor_list(method="cell")`` (it raised before the cell
    build was ported) gives JAX's list."""
    jsys, pos = _chain()
    tsys = convert.system_from_arrays(jsys, device="cpu")
    dims, cap = _chain_dims(), 24
    got = NB.build_neighbor_list(torch.from_numpy(pos),
                                 nb_ops.build_pack(tsys), R_LIST, 16,
                                 method="cell", grid_dims=dims,
                                 cell_capacity=cap)
    want = JNB.build_neighbor_list(jnp.asarray(pos), jsys.nb_mask, R_LIST,
                                   16, method="cell", grid_dims=dims,
                                   cell_capacity=cap)
    _list_same(got, want)
    with pytest.raises(ValueError, match="unknown"):
        NB.build_neighbor_list(torch.from_numpy(pos),
                               nb_ops.build_pack(tsys), R_LIST, 16,
                               method="verlet")


@pytest.mark.parametrize("sync", [False, True])
def test_maybe_rebuild_matches_jax(sync):
    jsys, pos = _chain()
    tsys = convert.system_from_arrays(jsys, device="cpu")
    pack = nb_ops.build_pack(tsys)
    kw = dict(method="cell", grid_dims=_chain_dims(), cell_capacity=24)
    jl = JNB.build_neighbor_list(jnp.asarray(pos), jsys.nb_mask, R_LIST, 16,
                                 **kw)
    tl = NB.build_neighbor_list(torch.from_numpy(pos), pack, R_LIST, 16,
                                **kw)
    moved = pos.copy()
    moved[1] += np.float32(SKIN)              # replica 1 trips the skin
    for p in (pos, moved):
        want = JNB.maybe_rebuild(jnp.asarray(p), jl, jsys.nb_mask, R_LIST,
                                 SKIN, 16, sync=sync, **kw)
        got = NB.maybe_rebuild(torch.from_numpy(p), tl, pack, R_LIST, SKIN,
                               16, sync=sync, **kw)
        _list_same(got, want)


def test_gated_plain_cell_build_keeps_or_builds_by_flag():
    jsys, pos = _chain(n_rep=3)
    tsys = convert.system_from_arrays(jsys, device="cpu")
    pack = nb_ops.build_pack(tsys)
    cells = (_chain_dims(), 24)
    p0 = torch.from_numpy(pos)
    old = nl_ops.build_gated(p0, None, None, pack, R_LIST, 16, cells)[:2]
    p1 = p0 + 0.7
    fresh = nl_ref.build_cells(p1, tsys.nb_mask, R_LIST, 16, *cells)
    for flag in ([0, 0, 0], [1, 0, 1], [1]):
        take = torch.tensor(flag, dtype=torch.bool)
        got = nl_ops.build_gated(p1, take, old, pack, R_LIST, 16, cells)
        rows = take.expand(3)
        for r in range(3):
            kept = old + (torch.zeros(3, dtype=torch.int32),)
            src = fresh if rows[r] else kept
            for g, w in zip(got, src):
                assert torch.equal(g[r], w[r])


def test_cell_kernel_takes_no_cpu_tensor():
    jsys, pos = _chain(n_rep=2)
    pack = nb_ops.build_pack(convert.system_from_arrays(jsys, device="cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        nl_ops.cell_build_batched(torch.from_numpy(pos), None, None,
                                  pack.mask_bits, R_LIST, 8, _chain_dims(),
                                  24)


def test_engine_paths_build_as_in_jax():
    """``MDEngine(nonbonded="sparse", nlist_build="cell")`` (it raised
    before the cell build was ported): the grid, the capacity and the
    first list as JAX's engine has them; a capacity below 1 raises."""
    jsys = j_chain_molecule(40)
    tsys = convert.system_from_arrays(jsys, device="cpu")
    for cap in (None, 3):
        jeng = JEngine(jsys, nonbonded="sparse", nlist_build="cell",
                       cell_capacity=cap)
        teng = MDEngine(tsys, nonbonded="sparse", nlist_build="cell",
                        cell_capacity=cap, device="cpu")
        assert teng._grid_dims == jeng._grid_dims
        assert teng._cell_capacity == jeng._cell_capacity
        assert teng.nlist_build == jeng.nlist_build == "cell"
        from repro_torch import random as jr
        tstate = teng.init_state(jr.key(3, "cpu"), 4)
        jstate = jeng.init_state(jax.random.key(3), 4)
        _list_same(tstate["nlist"], jstate["nlist"])
    with pytest.raises(ValueError, match="cell_capacity"):
        MDEngine(tsys, nonbonded="sparse", nlist_build="cell",
                 cell_capacity=0, device="cpu")


def test_build_method_picks_cells_for_a_spread_gas():
    """The LJ fluid's density (0.0205 / A^3) spread over a box: the cell
    build; the chain: the dense build."""
    n = 4000
    side = (n / 0.0205) ** (1.0 / 3.0)
    pos = np.random.default_rng(0).uniform(0.0, side, (n, 3))
    r_list = 10.5
    dims = NB.suggest_grid_dims(pos.max(0) - pos.min(0) + 2 * r_list,
                                r_list)
    cap = NB.suggest_cell_capacity(pos, r_list, dims)
    assert NB.suggest_build_method(n, dims, cap) == "cell"
    assert (JNB.suggest_build_method(n, dims, cap) == "cell"
            and JNB.suggest_cell_capacity(pos, r_list, dims) == cap)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("extra", [dict(nlist_build="cell"),
                                   dict(nlist_build="cell", cell_capacity=3)],
                         ids=["cell", "cell_overflow"])
def test_run_fused_on_the_cell_path_matches_jax(chunk, extra, monkeypatch):
    tdrv = run_sparse_pair((("temperature", 8),), "neighbor", "pallas",
                           chunk, monkeypatch, **extra)
    assert tdrv.engine.nlist_build == "cell"
    assert tdrv.history[-1]["nb_rebuilds"] > 0
    if "cell_capacity" in extra:
        assert tdrv.history[-1]["nb_overflow"] > 0

"""The masked O(N^2) neighbor-list build, in PyTorch.

The same contract as the JAX package's ``md/neighbors.py::build_dense``
(with ``_pack_rows``): row i of a replica holds the first ``k_max``
columns j, in ascending order, with ``r2(i, j) <= r_list^2`` and
``nb_mask[i, j] > 0``, padded with index N and validity 0; ``dropped``
counts, per replica, the hits past ``k_max``.  Compaction is a cumsum
plus a batched binary search, as there.  The (R, N, N) planes are built
in replica chunks (``REPLICA_CHUNK``): at R = 384 and N = 2881 one
unchunked mask is 3.2 GB and its cumsum several times that.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import REPLICA_CHUNK, f32_square


def pack_rows(within: torch.Tensor, k_max: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., N, C) bool candidate membership -> (cols (..., N, K) int64,
    valid (..., N, K) f32, dropped (...,) int64): slot s holds the column
    where the running hit count first reaches s + 1."""
    count = within.sum(dim=-1)                                 # (..., N)
    csum = torch.cumsum(within.to(torch.int32), dim=-1).contiguous()
    ranks = torch.arange(1, k_max + 1, dtype=torch.int32,
                         device=within.device)
    ranks = ranks.expand(csum.shape[:-1] + (k_max,)).contiguous()
    cols = torch.searchsorted(csum, ranks, side="left")
    cols = torch.clamp_max(cols, within.shape[-1] - 1)
    valid = (torch.arange(k_max, device=within.device)
             < count[..., None]).to(torch.float32)
    dropped = torch.clamp_min(count - k_max, 0).sum(dim=-1)
    return cols, valid, dropped


def _build_block(pos, nb_mask, r_list2: float, k_max: int):
    n = pos.shape[-2]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    dz = z[..., :, None] - z[..., None, :]
    r2 = dx * dx + dy * dy + dz * dz
    within = (r2 <= r_list2) & (nb_mask > 0)
    cols, valid, dropped = pack_rows(within, k_max)
    idx = torch.where(valid > 0, cols, n).to(torch.int32)
    return idx, valid, dropped.to(torch.int32)


def build_dense(pos: torch.Tensor, nb_mask: torch.Tensor, r_list: float,
                k_max: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, N, 3) -> (idx (R, N, K) int32, valid (R, N, K) f32,
    dropped (R,) int32).  ``nb_mask`` (N, N): 0 on the diagonal and on
    excluded pairs, so exclusions are pruned at build time."""
    r2 = f32_square(r_list)
    parts = [_build_block(pos[i:i + REPLICA_CHUNK], nb_mask, r2, k_max)
             for i in range(0, pos.shape[0], REPLICA_CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))


# -- the kernels' tile cull, in PyTorch ---------------------------------------
#
# csrc/nlist_build.cu tests only the 32-atom tile pairs whose bounding boxes
# lie within the list radius.  ``build_culled`` is that algorithm, tile by
# tile, with the same float32 operations (the tests hold it bitwise to
# ``build_dense`` and to the JAX package's build).

TILE = 32                 # atoms per tile; kT in csrc/nlist_build.cu
CULL_MARGIN = 2.0 ** -16  # skip a tile pair only where gap^2 > r_list^2 (1 +
                          # CULL_MARGIN)


def cull_threshold(r_list2: float) -> float:
    """The float32 threshold of the cull, ``r_list2 (1 + 2^-16)``."""
    return float(np.float32(r_list2 * (1.0 + CULL_MARGIN)))


def tile_boxes(pos: torch.Tensor) -> torch.Tensor:
    """(R, N, 3) -> (R, ceil(N / 32), 6): each tile's min x, y, z and max
    x, y, z over its real atoms."""
    r, n, _ = pos.shape
    n_t = -(-n // TILE)
    pad = (0, 0, 0, n_t * TILE - n)
    lo = torch.nn.functional.pad(pos, pad, value=float("inf"))
    hi = torch.nn.functional.pad(pos, pad, value=float("-inf"))
    return torch.cat([lo.reshape(r, n_t, TILE, 3).amin(2),
                      hi.reshape(r, n_t, TILE, 3).amax(2)], dim=-1)


def near_tiles(boxes: torch.Tensor, r_list2: float) -> torch.Tensor:
    """(R, n_t, 6) boxes -> (R, n_t, n_t) bool: tile pairs (I, J) whose
    box gap^2 (per-axis gaps, 0 where the boxes overlap, summed unfused in
    x, y, z order) does not exceed the cull threshold."""
    lo, hi = boxes[..., None, :, :3], boxes[..., None, :, 3:]
    lo_i, hi_i = boxes[..., :, None, :3], boxes[..., :, None, 3:]
    g = torch.clamp_min(torch.maximum(lo - hi_i, lo_i - hi), 0.0)
    g2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    return ~(g2 > cull_threshold(r_list2))


def build_culled(pos: torch.Tensor, mask_bits: torch.Tensor, r_list: float,
                 k_max: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' build: per replica and 32-row tile I, the candidate
    tiles J in ascending order (``near_tiles``), their atoms tested in
    ascending j against the mask bits (``mask_bits[i, J]`` bit j - 32 J) and
    r2 <= r_list^2, the hits compacted in order.  Same outputs as
    :func:`build_dense`; O(R n_t) Python steps, for small tests."""
    r, n, _ = pos.shape
    r2_max = f32_square(r_list)
    near = near_tiles(tile_boxes(pos), r_list2=r2_max)
    n_t = near.shape[-1]
    idx = torch.full((r, n, k_max), n, dtype=torch.int32)
    valid = torch.zeros((r, n, k_max), dtype=torch.float32)
    dropped = torch.zeros(r, dtype=torch.int32)
    lane = torch.arange(TILE)
    for rep in range(r):
        for t in range(n_t):
            rows = torch.arange(TILE * t, min(TILE * (t + 1), n))
            cand = torch.nonzero(near[rep, t]).flatten()     # ascending
            cols = (TILE * cand[:, None] + lane).flatten()
            words = mask_bits[rows][:, cand.repeat_interleave(TILE)]
            kept = ((words >> lane.repeat(len(cand))) & 1) > 0
            cols_c = cols.clamp(max=n - 1)
            d = pos[rep, rows][:, None, :] - pos[rep, cols_c][None, :, :]
            r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            within = kept & (cols < n) & (r2 <= r2_max)
            slot, hit, over = pack_rows(within, k_max)
            idx[rep, rows] = torch.where(hit > 0, cols[slot], n).to(
                torch.int32)
            valid[rep, rows] = hit
            dropped[rep] += int(over)
    return idx, valid, dropped


# -- the cell-list build ------------------------------------------------------
#
# The JAX package's ``build_cells`` (md/neighbors.py:120-232), op for op:
# atoms binned into a static (G_x, G_y, G_z) grid of cells at least r_list
# wide, each row packed in candidate order (stencil cell, then rank in the
# cell, where rank is the order of atom index within the cell), not in
# ascending j.  The sparse pass sums in slot order, so the lists are held
# bitwise, not as sets.  Every function takes a leading replica axis.

CELL_BYTES = 2 ** 31      # candidate-plane bytes per replica chunk


def _stencil(grid_dims) -> np.ndarray:
    """Neighbor-cell offsets, (S, 3): an axis with one cell has no +-1
    neighbors, so a (16, 1, 1) grid searches 3 cells, not 27."""
    axes = [(-1, 0, 1) if g > 1 else (0,) for g in grid_dims]
    return np.array([(i, j, k)
                     for i in axes[0]
                     for j in axes[1]
                     for k in axes[2]], np.int32)


def _cell_coords(pos: torch.Tensor, r_list: float, grid_dims) -> torch.Tensor:
    """(..., N, 3) -> (..., N, 3) int32 cell coordinates: the cell width is
    max(r_list, extent / G) per axis, the coordinates clipped into the grid.
    Divided tensor by tensor, as JAX divides (a reciprocal would move atoms
    that sit on a cell border)."""
    g = torch.tensor(grid_dims, dtype=torch.float32, device=pos.device)
    lo = torch.amin(pos, dim=-2, keepdim=True)
    hi = torch.amax(pos, dim=-2, keepdim=True)
    r = torch.tensor(np.float32(r_list), device=pos.device)
    width = torch.maximum((hi - lo) / g, r)
    cc = torch.floor((pos - lo) / width).to(torch.int32)
    top = torch.tensor(grid_dims, dtype=torch.int32, device=pos.device) - 1
    return torch.minimum(torch.clamp_min(cc, 0), top)


def _bin_atoms(cell_id: torch.Tensor, n_cells: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, N) cell ids -> (bins (R, n_cells + 1, C) int32, dropped (R,)):
    slot k of a cell holds its k-th atom by index (a stable sort), padding
    N; ranks past ``capacity`` are dropped and counted.  Row ``n_cells``
    stays all padding.  JAX's ``.at[].set(mode="drop")``: the dropped
    ranks are written to a spare row, then cut off."""
    r, n = cell_id.shape
    order = torch.sort(cell_id, dim=-1, stable=True).indices
    sorted_id = torch.gather(cell_id, 1, order).contiguous()
    first = torch.searchsorted(sorted_id, sorted_id, side="left")
    rank = torch.arange(n, device=cell_id.device) - first
    flat = torch.where(rank < capacity,
                       sorted_id.to(torch.int64) * capacity + rank,
                       (n_cells + 1) * capacity)
    bins = torch.full((r, (n_cells + 2) * capacity), n, dtype=torch.int32,
                      device=cell_id.device)
    bins = bins.scatter(1, flat, order.to(torch.int32))
    n_dropped = torch.sum(rank >= capacity, dim=-1)
    return (bins[:, :(n_cells + 1) * capacity]
            .reshape(r, n_cells + 1, capacity), n_dropped)


def _cell_candidates(pos: torch.Tensor, r_list: float, grid_dims,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, N, 3) -> (candidates (R, N, S C) int32, bin dropped (R,)): each
    atom's stencil cells in stencil order, each cell's slots in rank order;
    out-of-grid cells and repeats of an earlier stencil cell gather the
    padding row."""
    gx, gy, gz = grid_dims
    n_cells = gx * gy * gz
    dev = pos.device
    stencil = torch.from_numpy(_stencil(grid_dims)).to(dev)
    n_st = stencil.shape[0]
    cc = _cell_coords(pos, r_list, grid_dims)                 # (R, N, 3)
    cell_id = (cc[..., 0] * gy + cc[..., 1]) * gz + cc[..., 2]
    bins, bin_dropped = _bin_atoms(cell_id, n_cells, capacity)
    dims = torch.tensor(grid_dims, dtype=torch.int32, device=dev)
    ncc = cc[..., None, :] + stencil                          # (R, N, S, 3)
    in_grid = torch.all((ncc >= 0) & (ncc < dims), dim=-1)
    ncc = torch.minimum(torch.clamp_min(ncc, 0), dims - 1)
    nid = (ncc[..., 0] * gy + ncc[..., 1]) * gz + ncc[..., 2]
    nid = torch.where(in_grid, nid, n_cells)
    ar = torch.arange(n_st, device=dev)
    dup = torch.any((nid[..., :, None] == nid[..., None, :])
                    & (ar[None, :] < ar[:, None]), dim=-1)
    nid = torch.where(~dup, nid, n_cells).to(torch.int64)
    r, n = cell_id.shape
    cand = torch.gather(bins, 1, nid.reshape(r, -1, 1).expand(
        -1, -1, capacity))                                    # (R, N S, C)
    return cand.reshape(r, n, n_st * capacity), bin_dropped


def _cells_block(pos, nb_mask, r_list: float, k_max: int, grid_dims,
                 capacity: int):
    r, n, _ = pos.shape
    cand, bin_dropped = _cell_candidates(pos, r_list, grid_dims, capacity)
    c = torch.clamp(cand, 0, n - 1).to(torch.int64)           # (R, N, SC)
    flat = c.reshape(r, -1)
    d = [pos[..., a, None] - torch.gather(pos[..., a], 1, flat).reshape(
        c.shape) for a in range(3)]
    r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    rows = torch.arange(n, device=pos.device)[:, None]
    within = (r2 <= f32_square(r_list)) & (nb_mask[rows, c] > 0) & (cand < n)
    cols, valid, dropped = pack_rows(within, k_max)
    idx = torch.where(valid > 0, torch.gather(cand, -1, cols), n)
    return (idx.to(torch.int32), valid,
            (dropped + bin_dropped).to(torch.int32))


def build_cells(pos: torch.Tensor, nb_mask: torch.Tensor, r_list: float,
                k_max: int, grid_dims, cell_capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cell-list build: (R, N, 3) -> (idx, valid, dropped), the contract of
    :func:`build_dense` (the same neighbor sets) with each row in candidate
    order.  ``nb_mask`` (N, N), any dtype: > 0 where the pair is kept.
    ``dropped`` counts both the atoms past a cell's capacity (once each)
    and the hits past ``k_max``.  Replicas go in chunks of CELL_BYTES of
    candidate planes."""
    r, n, _ = pos.shape
    width = len(_stencil(grid_dims)) * int(cell_capacity)
    step = max(1, CELL_BYTES // max(1, n * width * 40))
    parts = [_cells_block(pos[i:i + step], nb_mask, r_list, k_max,
                          grid_dims, int(cell_capacity))
             for i in range(0, r, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


BIN_THREADS = 1024        # kBinThreads in csrc/cell_build.cu
MAX_BIN_BLOCKS = 16       # kMaxBinBlocks: bin blocks a replica at most
ROW_CHUNK = 32            # rows a warp of the row pass


def bin_block(n: int) -> int:
    """Atoms a bin block of the card's cell build: a multiple of
    BIN_THREADS, the least that keeps N within MAX_BIN_BLOCKS blocks."""
    return BIN_THREADS * max(1, -(-n // (BIN_THREADS * MAX_BIN_BLOCKS)))


def bin_counting(pos: torch.Tensor, r_list: float, grid_dims,
                 block_size: int):
    """The card's bin pass, per replica and bin block of ``block_size``
    atoms (block b takes atoms [b T, b T + T)): each block counts its
    atoms per cell, scans the counts into each cell's start within its
    segment of the cell order, and ranks its atoms stably (ascending
    index).  Returns (order (R, N) int64: the atom at each position,
    cell-sorted within each block's segment; table (R, cells, B, 2)
    int64: each (cell, block)'s segment start and count; posc (R, N, 4)
    float32: the atoms' positions in that order beside their indices'
    bits)."""
    r, n, _ = pos.shape
    gx, gy, gz = grid_dims
    n_cells = gx * gy * gz
    cc = _cell_coords(pos, r_list, grid_dims)
    cell_id = ((cc[..., 0] * gy + cc[..., 1]) * gz + cc[..., 2]).tolist()
    n_blocks = -(-n // block_size)
    order = torch.zeros((r, n), dtype=torch.int64)
    table = torch.zeros((r, n_cells, n_blocks, 2), dtype=torch.int64)
    for rep in range(r):
        for b in range(n_blocks):
            i0, i1 = b * block_size, min((b + 1) * block_size, n)
            count = [0] * n_cells
            for i in range(i0, i1):
                count[cell_id[rep][i]] += 1
            start = np.concatenate([[0], np.cumsum(count)[:-1]]).tolist()
            table[rep, :, b, 0] = torch.tensor(start) + i0
            table[rep, :, b, 1] = torch.tensor(count)
            run = list(start)
            for i in range(i0, i1):          # ascending atom index
                c = cell_id[rep][i]
                order[rep, i0 + run[c]] = i
                run[c] += 1
    gathered = torch.gather(pos, 1, order[..., None].expand(-1, -1, 3))
    bits = order.to(torch.int32).view(torch.float32)[..., None]
    return order, table, torch.cat([gathered, bits], dim=-1)


def build_cells_counting(pos: torch.Tensor, mask_bits: torch.Tensor,
                         r_list: float, k_max: int, grid_dims,
                         cell_capacity: int, block_size: int = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The card kernels' algorithm (csrc/cell_build.cu), step for step,
    in Python loops for small tests.  The bin pass (``bin_counting``,
    blocks of ``block_size`` atoms, the card's ``bin_block(N)`` by
    default); then per cell: its rows are its atoms, its runs block by
    block; its candidates the in-grid stencil cells' runs in stencil
    order, each cell's clipped to its first ``cell_capacity`` atoms
    across the blocks; the rows in chunks of 32 (a warp), each chunk's
    candidates culled against the chunk's bounding box (gap^2 formed as
    r2 is, dropped where > r_list^2) and the survivors tested in order
    against the mask bits (``mask_bits[i, j >> 5]`` bit ``j & 31``) and
    r2 <= r_list^2.  ``dropped``: each cell's atoms past the capacity,
    and each row's hits past ``k_max``.  Same outputs as
    :func:`build_cells`."""
    r, n, _ = pos.shape
    gx, gy, gz = grid_dims
    n_cells = gx * gy * gz
    cap = int(cell_capacity)
    r2_max = torch.tensor(f32_square(r_list), dtype=torch.float32)
    _, table, posc = bin_counting(pos, r_list, grid_dims,
                                  block_size or bin_block(n))
    bits = mask_bits.to(torch.int64) & 0xFFFFFFFF
    idx = torch.full((r, n, k_max), n, dtype=torch.int32)
    valid = torch.zeros((r, n, k_max), dtype=torch.float32)
    dropped = torch.zeros(r, dtype=torch.int32)
    offsets = [(dx, dy, dz)
               for dx in ((-1, 0, 1) if gx > 1 else (0,))
               for dy in ((-1, 0, 1) if gy > 1 else (0,))
               for dz in ((-1, 0, 1) if gz > 1 else (0,))]
    zero = torch.zeros((), dtype=torch.float32)

    def gap(lo, hi, c):
        return torch.maximum(torch.maximum(lo - c, c - hi), zero)

    for rep in range(r):
        tab, q = table[rep].tolist(), posc[rep]
        over = 0
        for c in range(n_cells):
            rows = [s + t for s, k in tab[c] for t in range(k)]
            if not rows:
                continue
            over += max(len(rows) - cap, 0)
            cx, cy, cz = c // (gy * gz), (c // gz) % gy, c % gz
            cand = []
            for dx, dy, dz in offsets:
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                if not (0 <= nx < gx and 0 <= ny < gy and 0 <= nz < gz):
                    continue
                seen = 0
                for s, k in tab[(nx * gy + ny) * gz + nz]:
                    cand += range(s, s + min(k, max(cap - seen, 0)))
                    seen += k
            cq = q[torch.tensor(cand, dtype=torch.int64)]
            cj = cq[:, 3].view(torch.int32).to(torch.int64)
            for c0 in range(0, len(rows), ROW_CHUNK):
                rq = q[torch.tensor(rows[c0:c0 + ROW_CHUNK])]
                lo, hi = rq[:, :3].amin(0), rq[:, :3].amax(0)
                g = [gap(lo[a], hi[a], cq[:, a]) for a in range(3)]
                keep = ~(((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2])
                         > r2_max)
                sq, sj = cq[keep], cj[keep]
                for p in rq:
                    i = int(p[3:].view(torch.int32))
                    d = p[:3] - sq[:, :3]
                    r2 = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                          + d[:, 2] * d[:, 2])
                    on = ((bits[i, sj >> 5] >> (sj & 31)) & 1) > 0
                    hits = sj[(r2 <= r2_max) & on]
                    m = min(len(hits), k_max)
                    idx[rep, i, :m] = hits[:m].to(torch.int32)
                    valid[rep, i, :m] = 1.0
                    over += max(len(hits) - k_max, 0)
        dropped[rep] = over
    return idx, valid, dropped

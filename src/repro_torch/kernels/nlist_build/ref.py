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

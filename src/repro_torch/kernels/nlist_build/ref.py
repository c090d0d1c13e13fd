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

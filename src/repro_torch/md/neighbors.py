"""Fixed-capacity neighbor lists for the sparse nonbonded path.

The port of the JAX package's ``md/neighbors.py``: a padded (R, N, K)
index table replaces the (R, N, N) pair sweep.  Each atom lists every
atom within ``r_list = cutoff + skin`` (exclusions removed), and the list
stays valid until some atom drifts more than ``skin / 2`` from its
build-time position.  A list is a dict of tensors, each with a leading
replica axis, kept in the engine state as ``state["nlist"]``:

  idx      (R, N, K) int32  neighbor atom indices, padded with N
  valid    (R, N, K) f32    1.0 for real neighbors, 0.0 for padding
  ref_pos  (R, N, 3) f32    positions at build time (the skin check)
  overflow (R,)      int32  cumulative count of dropped pairs
  rebuilds (R,)      int32  cumulative rebuild count
  pair     (R, 3, N, K) f32 optional build-time planes
                            [sig^2, eps, COULOMB * qq] (``pair_planes``)

Two builds give the same neighbor sets: ``build_dense`` (the masked
O(N^2) build, rows in ascending j) and ``build_cells`` (the cell-list
build: atoms binned into a static grid of cells at least ``r_list`` wide,
each row in candidate order, bitwise the JAX package's ``build_cells``);
``method`` picks one.  The rebuild of ``maybe_rebuild`` is gated on the
device: ``needs_rebuild`` leaves a flag tensor that the build kernels
(``kernels.nlist_build``: ``nlist_build.cu`` for "dense",
``cell_build.cu`` for "cell") read, so no host read, no Python branch and
no unconditional build stands in for the JAX package's ``lax.cond``.
Capacity overflow is never silent: it accumulates in ``overflow``, which
the driver reports per cycle as ``nb_overflow``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.kernels import f32_square
from repro_torch.kernels.lj_forces.ref import COULOMB
from repro_torch.kernels.nlist_build import ops as build_ops
from repro_torch.kernels.nlist_build.ref import (  # noqa: F401
    _bin_atoms, _cell_candidates, _cell_coords, _stencil, build_cells,
    build_dense)

NeighborList = Dict[str, torch.Tensor]


def _cells(method: str, grid_dims, cell_capacity):
    """The build's cell geometry: None for "dense", (grid_dims,
    cell_capacity) for "cell"."""
    if method == "cell":
        return tuple(int(g) for g in grid_dims), int(cell_capacity)
    if method != "dense":
        raise ValueError(f"unknown neighbor-list build method {method!r}")
    return None


def pair_planes(idx, lj_sigma, lj_eps, charges) -> torch.Tensor:
    """Build-time per-slot parameter planes: idx (..., N, K) ->
    (..., 3, N, K) stack [sig^2, eps, COULOMB * qq], each exactly the
    sub-expression the gather path of ``lj_forces.ref._sparse_pair_coefs``
    forms first.  Padding slots gather atom N - 1 (masked in the pass)."""
    n = lj_sigma.shape[-1]
    j = torch.clamp(idx, 0, n - 1).to(torch.int64)
    sig = 0.5 * (lj_sigma[..., :, None] + lj_sigma[j])
    eps = torch.sqrt(lj_eps[..., :, None] * lj_eps[j])
    cqq = COULOMB * (charges[..., :, None] * charges[j])
    return torch.stack([sig * sig, eps, cqq], dim=-3)


def build_neighbor_list(pos, nb_pack, r_list: float, k_max: int, *,
                        method: str = "dense",
                        grid_dims: Tuple[int, int, int] = (1, 1, 1),
                        cell_capacity: int = 8,
                        prev: Optional[NeighborList] = None,
                        pair_params=None) -> NeighborList:
    """A fresh list for a (R, N, 3) stack (the build kernel on the card,
    the plain build on the CPU).  ``nb_pack``: the engine's
    ``lj_forces.ops.NonbondedPack`` (the exclusion mask).  ``method``:
    "dense" or "cell" (on the static ``grid_dims`` grid with
    ``cell_capacity`` atoms a cell).  ``prev`` carries the cumulative
    counters forward (None zeroes them); ``pair_params`` (lj_sigma,
    lj_eps, charges) adds the ``pair`` leaf."""
    cells = _cells(method, grid_dims, cell_capacity)
    idx, valid, dropped = build_ops.build_gated(pos, None, None, nb_pack,
                                                r_list, k_max, cells)
    overflow = dropped
    rebuilds = torch.zeros(pos.shape[0], dtype=torch.int32,
                           device=pos.device)
    if prev is not None:
        overflow = overflow + prev["overflow"]
        rebuilds = prev["rebuilds"]
    out = {"idx": idx, "valid": valid, "ref_pos": pos,
           "overflow": overflow, "rebuilds": rebuilds}
    if pair_params is not None:
        out["pair"] = pair_planes(idx, *pair_params)
    return out


def needs_rebuild(pos, nlist: NeighborList, skin: float) -> torch.Tensor:
    """(R,) bool: some atom drifted further than ``skin / 2`` since the
    build, so that replica's list may miss pairs next step."""
    d = pos - nlist["ref_pos"]
    drift2 = torch.sum(d * d, dim=-1)                      # (R, N)
    return torch.amax(drift2, dim=-1) > f32_square(0.5 * skin)


def maybe_rebuild(pos, nlist: NeighborList, nb_pack, r_list: float,
                  skin: float, k_max: int, *, method: str = "dense",
                  grid_dims: Tuple[int, int, int] = (1, 1, 1),
                  cell_capacity: int = 8,
                  sync: bool = False, pair_params=None) -> NeighborList:
    """Skin check and a rebuild gated on the device, with no host read.

    ``sync=False`` (lazy): each replica rebuilds only when its own drift
    tripped.  ``sync=True`` (collective, the propagate loop's policy):
    one tripped replica rebuilds every replica; the flag is then one
    element, ``any(need)``, over the whole ensemble when ``pos`` is one
    rank's block of it (``sharding.ensemble_scope``).  Either way the new
    list is written out of place; a replica that keeps its list gets its
    old rows, ref_pos and counters back unchanged, one that rebuilds gets
    the fresh list, its dropped pairs added to ``overflow`` and one added
    to ``rebuilds``."""
    cells = _cells(method, grid_dims, cell_capacity)
    need = needs_rebuild(pos, nlist, skin)                 # (R,)
    take = (sharding.ensemble_any(torch.any(need).reshape(1)) if sync
            else need)
    idx, valid, dropped = build_ops.build_gated(
        pos, take, (nlist["idx"], nlist["valid"]), nb_pack, r_list, k_max,
        cells)
    rows = take.expand(need.shape)
    out = {"idx": idx, "valid": valid,
           "ref_pos": torch.where(rows[:, None, None], pos,
                                  nlist["ref_pos"]),
           "overflow": nlist["overflow"] + dropped,        # 0 where kept
           "rebuilds": nlist["rebuilds"] + rows.to(torch.int32)}
    if pair_params is not None:
        out["pair"] = torch.where(rows[:, None, None, None],
                                  pair_planes(idx, *pair_params),
                                  nlist["pair"])
    return out


# -- host-side heuristics (numpy, run once by the engine's constructor) -------


def suggest_grid_dims(extent: np.ndarray, r_list: float,
                      max_cells_axis: int = 16) -> Tuple[int, int, int]:
    """Static cell-grid dims from a host-side extent estimate: one cell
    per ``r_list`` of extent, clamped to [1, max_cells_axis] per axis."""
    dims = np.maximum(1, np.minimum(
        np.ceil(np.asarray(extent, np.float64) / max(r_list, 1e-6)),
        max_cells_axis)).astype(int)
    return int(dims[0]), int(dims[1]), int(dims[2])


def suggest_cell_capacity(positions: np.ndarray, r_list: float,
                          grid_dims: Tuple[int, int, int],
                          safety: float = 4.0,
                          max_capacity: Optional[int] = None) -> int:
    """Per-cell capacity: the peak occupancy of the reference
    configuration(s) binned as the cell build bins them, times
    ``safety``, clamped to [8, N] (and to ``max_capacity`` if given).
    ``positions``: one (N, 3) configuration or an (R, N, 3) stack."""
    stack = np.asarray(positions, np.float64)
    if stack.ndim == 2:
        stack = stack[None]
    g = np.asarray(grid_dims, np.float64)
    peak = 0
    for p in stack:
        lo, hi = p.min(0), p.max(0)
        width = np.maximum((hi - lo) / g, max(r_list, 1e-6))
        cc = np.clip(np.floor((p - lo) / width).astype(int), 0,
                     np.asarray(grid_dims) - 1)
        ids = (cc[:, 0] * grid_dims[1] + cc[:, 1]) * grid_dims[2] + cc[:, 2]
        peak = max(peak, int(np.bincount(ids).max()))
    cap = int(np.clip(int(np.ceil(peak * safety)), 8, stack.shape[1]))
    if max_capacity is not None:
        cap = max(min(cap, int(max_capacity)), 1)
    return cap


def suggest_build_method(n_atoms: int, grid_dims: Tuple[int, int, int],
                         cell_capacity: int) -> str:
    """"cell" only when the stencil's candidate count (up to 3 cells per
    axis, ``cell_capacity`` atoms each) undercuts the dense build's
    ``n_atoms``; a compact or chain-like geometry stays "dense"."""
    stencil_cells = 1
    for g in grid_dims:
        stencil_cells *= min(3, int(g))
    return "cell" if stencil_cells * cell_capacity < n_atoms else "dense"


def suggest_k_max(n_atoms: int, positions: np.ndarray, nb_mask: np.ndarray,
                  r_list: float, safety: float = 1.5) -> int:
    """K_max: the largest neighbor count of the reference configuration
    (or the largest over an (R, N, 3) stack) times ``safety``, clamped
    to [8, n_atoms - 1].  An undersized K shows in ``nb_overflow``."""
    stack = np.asarray(positions, np.float64)
    if stack.ndim == 2:
        stack = stack[None]
    base = 0
    for p in stack:
        d2 = np.sum((p[:, None, :] - p[None, :, :]) ** 2, axis=-1)
        within = (d2 <= r_list * r_list) & (np.asarray(nb_mask) > 0)
        base = max(base, int(within.sum(axis=1).max()))
    return int(np.clip(int(np.ceil(base * safety)), 8,
                       max(n_atoms - 1, 8)))

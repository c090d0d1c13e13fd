"""Control-parameter ladders and multi-dimensional exchange grids.

A simulation is an ordered list of exchange dimensions (the paper's
T/U/S); the replica count is the product of the window counts and ctrl
index c is the row-major multi-index of the grid.

  temperature : geometric ladder t_min..t_max
  umbrella    : restraint centers uniform on [0, 360) degrees
  salt        : linear scaling of the charge-charge term

The grid's tensors and its stacked neighbor-pair table are built once on
the host (float64 numpy, cast to float32 exactly as the JAX package
does) and moved to the driver's device, so no cycle copies to the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import RepExConfig

KB = 0.0019872041   # kcal/mol/K  (Boltzmann, Amber units)


class PairTable(NamedTuple):
    """Stacked neighbor-pair tables for ALL (dim, parity) sweeps, each
    (n_dims, 2, max_pairs); rows shorter than ``max_pairs`` are padded
    with self-pairs (0, 0) carrying ``valid == False``."""
    left: torch.Tensor    # int64
    right: torch.Tensor   # int64
    valid: torch.Tensor   # bool
    count: torch.Tensor   # (n_dims, 2) f32: real pairs per sweep


@dataclass(frozen=True)
class ExchangeDim:
    kind: str          # temperature | umbrella | salt
    n_windows: int
    index: int         # which axis of the grid
    umbrella_axis: int = 0   # which torsion this umbrella restrains


@dataclass(frozen=True)
class ControlGrid:
    dims: Tuple[ExchangeDim, ...]
    values: Dict[str, torch.Tensor]     # per-ctrl tensors, each (n_ctrl, ...)
    shape: Tuple[int, ...]
    pair_table: PairTable

    @property
    def n_ctrl(self) -> int:
        return int(np.prod(self.shape))


def neighbor_pairs(shape, dim_index: int, parity: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Ctrl-space neighbor pairs along one grid dimension (DEO parity)."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    n = shape[dim_index]
    starts = np.arange(parity % 2, n - 1, 2)
    left = np.take(idx, starts, axis=dim_index).reshape(-1)
    right = np.take(idx, starts + 1, axis=dim_index).reshape(-1)
    return left, right


def _pair_table(shape, device) -> PairTable:
    n_dims = len(shape)
    sweeps = [[neighbor_pairs(shape, d, p) for p in (0, 1)]
              for d in range(n_dims)]
    max_pairs = max([len(l) for row in sweeps for l, _ in row] + [1])
    left = np.zeros((n_dims, 2, max_pairs), np.int64)
    right = np.zeros((n_dims, 2, max_pairs), np.int64)
    valid = np.zeros((n_dims, 2, max_pairs), bool)
    for d in range(n_dims):
        for p in (0, 1):
            l, r = sweeps[d][p]
            left[d, p, :len(l)] = l
            right[d, p, :len(r)] = r
            valid[d, p, :len(l)] = True

    def t(a):
        return torch.as_tensor(a, device=device)

    return PairTable(left=t(left), right=t(right), valid=t(valid),
                     count=t(valid.sum(-1).astype(np.float32)))


def build_grid(cfg: RepExConfig, device) -> ControlGrid:
    dims: List[ExchangeDim] = []
    n_umbrella = 0
    shape = []
    for i, (kind, n) in enumerate(cfg.dimensions):
        dims.append(ExchangeDim(kind=kind, n_windows=n, index=i,
                                umbrella_axis=n_umbrella))
        if kind == "umbrella":
            n_umbrella += 1
        shape.append(n)
    shape = tuple(shape)
    n_ctrl = int(np.prod(shape))

    window_vals = []
    for d in dims:
        if d.kind == "temperature":
            vals = np.geomspace(cfg.t_min, cfg.t_max, d.n_windows)
        elif d.kind == "umbrella":
            vals = np.linspace(0.0, 360.0, d.n_windows, endpoint=False)
        elif d.kind == "salt":
            vals = np.linspace(cfg.salt_min, cfg.salt_max, d.n_windows)
        else:
            raise ValueError(d.kind)
        window_vals.append(vals)

    mesh = np.meshgrid(*window_vals, indexing="ij")
    temperature = np.full(n_ctrl, 300.0)
    umbrella_centers = np.zeros((n_ctrl, max(n_umbrella, 1)))
    umbrella_k = np.zeros((n_ctrl, max(n_umbrella, 1)))
    salt = np.zeros(n_ctrl)
    for d, vals in zip(dims, mesh):
        flat = vals.reshape(-1)
        if d.kind == "temperature":
            temperature = flat
        elif d.kind == "umbrella":
            umbrella_centers[:, d.umbrella_axis] = flat
            umbrella_k[:, d.umbrella_axis] = cfg.umbrella_k
        elif d.kind == "salt":
            salt = flat

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # only carry ctrl fields for dimensions the grid has (engines treat
    # absent fields as inert); beta is formed in float64, then cast
    values = {"temperature": f32(temperature),
              "beta": f32(1.0 / (KB * temperature))}
    if n_umbrella:
        values["umbrella_center"] = f32(umbrella_centers)
        values["umbrella_k"] = f32(umbrella_k)
    if any(d.kind == "salt" for d in dims):
        values["salt"] = f32(salt)
    return ControlGrid(dims=tuple(dims), values=values, shape=shape,
                       pair_table=_pair_table(shape, device))


def ctrl_for_assignment(grid: ControlGrid, assignment: torch.Tensor,
                        keys: Sequence[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """Gather each replica's current control parameters: (R, ...)."""
    values = grid.values
    if keys is not None:
        values = {k: values[k] for k in keys}
    return {k: torch.index_select(v, 0, assignment)
            for k, v in values.items()}

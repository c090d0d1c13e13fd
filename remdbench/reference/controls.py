"""The control grid of a configuration's ``exchange`` block: one row of
controls (temperature, beta, umbrella centres and constants) per grid
point, in row-major order of the dimensions."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from .units import KB


@dataclass(frozen=True)
class Grid:
    """The control grid: ``dims`` [(kind, n)], row-major flat index."""
    dims: Tuple[Tuple[str, int], ...]
    temperature: np.ndarray       # (C,) float32
    beta: np.ndarray              # (C,) float32
    umbrella_center: np.ndarray   # (C, U) float32, U >= 1
    umbrella_k: np.ndarray        # (C, U) float32
    n_umbrella: int

    @property
    def shape(self):
        return tuple(n for _, n in self.dims)

    @property
    def n_ctrl(self) -> int:
        return int(np.prod(self.shape))


def grid(spec: Dict) -> Grid:
    """A geometric temperature ladder over ``t_min`` .. ``t_max``,
    umbrella centres uniform on [0, 360) degrees at ``umbrella_k``."""
    dims = tuple((str(k), int(n)) for k, n in spec["dimensions"])
    shape = tuple(n for _, n in dims)
    c = int(np.prod(shape))
    vals = []
    for kind, n in dims:
        if kind == "temperature":
            vals.append(np.geomspace(spec["t_min"], spec["t_max"], n))
        elif kind == "umbrella":
            vals.append(np.linspace(0.0, 360.0, n, endpoint=False))
        else:
            raise ValueError(f"unsupported exchange dimension {kind!r}")
    mesh = np.meshgrid(*vals, indexing="ij")
    n_u = sum(kind == "umbrella" for kind, _ in dims)
    temp = np.full(c, 300.0)
    center = np.zeros((c, max(n_u, 1)))
    k = np.zeros((c, max(n_u, 1)))
    u = 0
    for (kind, _), v in zip(dims, mesh):
        if kind == "temperature":
            temp = v.reshape(-1)
        else:
            center[:, u] = v.reshape(-1)
            k[:, u] = spec["umbrella_k"]
            u += 1
    return Grid(dims=dims, temperature=np.float32(temp),
                beta=np.float32(1.0 / (KB * temp)),
                umbrella_center=np.float32(center),
                umbrella_k=np.float32(k), n_umbrella=n_u)

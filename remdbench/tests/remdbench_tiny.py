"""Tiny cells for the benchmark's CPU tests: a cell's own configuration,
traffic and limits with the chain cut to 22 atoms, 4 temperatures (or a
2 x 2 x 2 T x U x U grid) and 3 MD steps an exchange."""
from __future__ import annotations

import copy

from remdbench import harness


def tiny_spec(cell: str = "tremd64-x10", n_temperatures: int = 4,
              n_atoms: int = 22):
    spec = copy.deepcopy(harness.load_cell(cell))
    ex = spec["config"]["exchange"]
    spec["config"]["system"]["n_atoms"] = n_atoms
    ex["dimensions"] = [
        [k, 2 if k == "umbrella" else
         (n_temperatures if len(ex["dimensions"]) == 1 else 2)]
        for k, _ in ex["dimensions"]]
    ex["md_steps_per_cycle"] = 3
    return spec

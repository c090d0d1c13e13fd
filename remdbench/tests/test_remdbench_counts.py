"""The yardstick's counts from the topology: the kernel bounds the port's
kernel table states (kernel 2 at R = 64, kernel 3 at R = 384, N = 2,881)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from remdbench.counts import chain as counts
from remdbench.reference import system_chain

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(scope="module")
def topo():
    spec = json.loads((CONFIGS / "tremd64_chain2881.json").read_text())
    return counts.topology(system_chain.build(spec["system"]))


def test_topology_counts(topo):
    assert topo == {"n_atoms": 2881, "bonds": 2880, "angles": 2879,
                    "quads": 2880, "slots": 15, "pairs": 4142881}


def test_kernel_two_bound(topo):
    b = counts.nonbonded_bound(topo, 64)
    assert b["by"] == "operations"
    assert round(b["ms"], 4) == 0.2058


def test_kernel_three_bound(topo):
    b = counts.fused_bound(topo, 384, bias=True)
    assert b["by"] == "operations"
    assert round(b["ms"], 4) == 1.0978


def _config(md_steps, dims):
    return {"exchange": {"md_steps_per_cycle": md_steps,
                         "dimensions": dims}}


def test_cycle_ops_count_no_feature_pass(topo):
    t64 = [["temperature", 64]]
    per_eval = counts.cycle_ops(topo, _config(0, t64), 1)
    assert counts.cycle_ops(topo, _config(10, t64), 64) == 11 * 64 * per_eval
    assert per_eval > topo["pairs"] * counts.PAIR_OPS
    tuu = [["temperature", 6], ["umbrella", 8], ["umbrella", 8]]
    assert counts.cycle_ops(topo, _config(0, tuu), 1) == \
        per_eval + counts.BIAS_OPS

"""The comparison that decides ``correct`` fails what it must: the
control (the reference computed in bfloat16 in the program's place), and
a run of the harness with the timed path broken underneath, once for
each fault these cells can have (one chip: no exchange between chips)."""
from __future__ import annotations


import pytest
import torch

from remdbench import checks, harness
from remdbench_tiny import tiny_spec

SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 4_000_000_007])
@pytest.mark.parametrize("cell", ["tremd64-x10", "tsu384-x10"])
def test_control_is_not_correct(cell, seed):
    spec = tiny_spec(cell)
    numbers = checks.control_readings(
        spec["config"], seed, spec["traffic"]["chunk_cycles"], "cpu")
    assert not checks.verdict(numbers, spec["limits"]), numbers


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 4_000_000_007])
def test_feature_control_is_not_correct(seed):
    """Only the exchange's feature pass in bfloat16 (the propagate in
    float32), at 200 atoms and 16 rungs: the exchange judged at the
    control's own positions catches it."""
    spec = tiny_spec("tremd64-x10", n_temperatures=16, n_atoms=200)
    numbers = checks.control_readings(
        spec["config"], seed, spec["traffic"]["chunk_cycles"], "cpu",
        "features")
    assert numbers["exchange_gap"] > spec["limits"]["exchange_gap"], numbers
    assert not checks.verdict(numbers, spec["limits"])


def _frozen(self, state, ctrl, n_steps, rngs, max_steps, stack=None,
            **kw):
    return {k: v.clone() for k, v in state.items()}


def _half(orig):
    def propagate(self, state, ctrl, n_steps, rngs, max_steps, stack=None,
                  **kw):
        out = orig(self, state, ctrl, n_steps, rngs, max_steps, stack, **kw)
        h = state["pos"].shape[0] // 2
        return {k: torch.cat([v[:h], state[k][h:]]) for k, v in out.items()}
    return propagate


def _flipped(orig):
    def metropolis(delta, rng):
        acc = orig(delta, rng).clone()
        acc[0] = ~acc[0]
        return acc
    return metropolis


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_replicas",
                                   "answer_altered"])
def test_broken_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core import exchange
    from repro_torch.md import engine
    if fault == "state_unchanged":
        monkeypatch.setattr(engine.MDEngine, "propagate", _frozen)
    elif fault == "half_the_replicas":
        monkeypatch.setattr(engine.MDEngine, "propagate",
                            _half(engine.MDEngine.propagate))
    else:
        monkeypatch.setattr(exchange, "metropolis",
                            _flipped(exchange.metropolis))
    res = harness.run_cell(tiny_spec("tremd64-x10"), SEED, 0.3, False, "cpu")
    assert res["correct"] is False, res["checks"]

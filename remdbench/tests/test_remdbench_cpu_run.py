"""A tiny cell end to end through the harness on the CPU (the look for a
chip skipped): the result line has the contract's keys, its metrics are
marked as not measured on a device, and a sound run comes out correct."""
from __future__ import annotations

import json

import pytest
import torch

from remdbench import checks, harness, run
from remdbench_tiny import tiny_spec

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,trace_on", [("tremd64-x10", False),
                                           ("tremd64-x200", False),
                                           ("tsu384-x10", False),
                                           ("tremd64-x10", True)])
def test_tiny_cell_end_to_end(cell, trace_on, capsys):
    spec = tiny_spec(cell)
    res = harness.run_cell(spec, SEED, 0.3, trace_on, "cpu")
    run.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert line["checks"]["exchange_gap"]["value"] == 0.0
    want = spec["per_layer"] if trace_on else spec["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in line["metrics"].values():
        assert m["value"] is None and "not_measured" in m
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") for s in last)


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code = run.main(["--workload", "tremd64-x10", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert code != 0 and out.strip() == ""


def test_configuration_blocks_are_forwarded_whole():
    """Keys the harness never names reach the program: the ``md`` block
    the engine, ``exchange`` (with the traffic's merged in) the run's
    configuration, ``driver`` the driver."""
    spec = tiny_spec("tremd64-x10")
    cfg = spec["config"]
    cfg["md"]["max_energy"] = 1e9
    cfg["exchange"]["execution_mode"] = "mode2"
    cfg["driver"] = {"failure_rate": 0.25}
    sysm, sysmod = checks.system(cfg)
    drv = harness._driver(cfg, sysm, sysmod, SEED, torch.device("cpu"))
    assert drv.engine.max_energy == 1e9
    assert drv.cfg.md_steps_per_cycle == 3
    assert drv.cfg.dimensions == (("temperature", 4),)
    assert drv.execution["mode"] == "mode2"
    assert drv.failure_rate == 0.25
    cfg["md"]["no_such_option"] = 1
    with pytest.raises(TypeError):
        harness._driver(cfg, sysm, sysmod, SEED, torch.device("cpu"))

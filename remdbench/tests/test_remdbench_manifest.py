"""The manifest (``BENCHMARK.json``) against the benchmark contract's
schema and character set, and every cell resolving to its files."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "remdbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert manifest["command"][1].startswith(manifest["paths"][0] + "/")
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("remdbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics(manifest):
    e2e, pl = manifest["end_to_end"], manifest["per_layer"]
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    cells = {w["name"] for w in manifest["workloads"]}
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in e2e}
        assert _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.add(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in e2e + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in cells:      # every cell: setup_s, another end-to-end, a layer
        mine = [m["name"] for m in e2e if c in m.get("workloads", [c])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(c in m.get("workloads", [c]) for m in pl)


def test_every_cell_resolves(manifest):
    from remdbench import harness
    for w in manifest["workloads"]:
        spec = harness.load_cell(w["name"], ROOT)
        assert spec["traffic"]["chunk_cycles"] >= 1
        assert set(spec["limits"]) == {"start_ulps", "rows_bad",
                                       "exchange_gap", "vel_gap",
                                       "decision_gap"}
        assert spec["limits"]["rows_bad"] == 0


def test_every_configuration_selects_its_modules(manifest):
    """A configuration names the modules that build and judge it: its
    system kind, reference model, exchange scheme and pattern in
    ``reference/``, its kind's counts, and the program's classes."""
    for c in manifest["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        ref = BENCH / "reference"
        assert (ref / f"system_{body['system']['kind']}.py").is_file()
        assert (ref / f"model_{body['reference']['model']}.py").is_file()
        ex = body["exchange"]
        assert (ref / f"exchange_{ex['exchange_scheme']}.py").is_file()
        assert (ref / f"pattern_{ex['pattern']}.py").is_file()
        assert (BENCH / "counts" / f"{body['system']['kind']}.py").is_file()
        assert {"engine", "config", "driver", "telemetry"} <= \
            set(body["program"])


def test_check_budget(manifest):
    """A full check of 24 cells at this run length fits its 43,200 s."""
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

"""The port's ``repex_run`` CLI against the JAX package's, on the CPU
(``--device cpu``): on the same flags it prints the same lines, timings
aside (the per-cycle and per-chunk ``t ... ms`` figures and the Eq. (1)
split), and its ``--report-out`` JSON validates under both packages'
``validate_report`` with the JAX report's counters.  ``--resume`` takes
a checkpoint of either package; ``--engine lm`` on a model family not
yet ported raises, naming its ROADMAP item (``--shards`` is held in
``test_torch_sharded``)."""
import contextlib
import dataclasses
import io
import json
import re
import shutil

import pytest

from repro.launch import repex_run as j_repex_run
from repro.obs import validate_report as j_validate_report
from repro_torch.launch import repex_run
from repro_torch.models import registry
from repro_torch.obs import validate_report

_TIMING = re.compile(r"\s+t\s+[\d.]+ ms(/cycle)?")


def _lines(main, argv, monkeypatch, report):
    """Printed lines of ``main`` on ``argv``, the timings cut out, the
    report path replaced."""
    monkeypatch.setattr("sys.argv", ["repex_run"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main()
    out = []
    for line in buf.getvalue().splitlines():
        if line.startswith("Eq.(1) split:"):
            continue
        line = _TIMING.sub("", line)
        out.append(line.replace(str(report), "<report>") if report
                   else line)
    return out


def _both(argv, tmp_path, monkeypatch):
    reports = {}
    lines = {}
    for name, main, extra in (("jax", j_repex_run.main, []),
                              ("port", repex_run.main, ["--device", "cpu"])):
        report = tmp_path / f"{name}.json"
        args = argv + ["--report-out", str(report)] + extra
        lines[name] = _lines(main, args, monkeypatch, report)
        with open(report) as f:
            reports[name] = json.load(f)
    return lines, reports


_COUNTERS = ("path", "engine", "pattern", "scheme", "n_replicas", "n_dims",
             "chunk_cycles", "cycles", "exchange", "failures", "neighbor")


@pytest.mark.parametrize("argv", [
    ["--dims", "temperature:4", "--cycles", "4", "--md-steps", "2",
     "--chunk", "2", "--atoms", "8"],
    ["--dims", "temperature:4", "--cycles", "3", "--md-steps", "2",
     "--atoms", "8", "--scheme", "matrix"],
    ["--dims", "temperature:4", "--cycles", "4", "--md-steps", "4",
     "--chunk", "2", "--atoms", "8", "--pattern", "async",
     "--failure-rate", "0.25", "--relaunch-budget", "1"],
], ids=["fused", "run_matrix", "fused_async_faults"])
def test_cli_prints_jax_lines_and_a_valid_report(argv, tmp_path,
                                                 monkeypatch):
    lines, reports = _both(argv, tmp_path, monkeypatch)
    assert lines["port"] == lines["jax"]
    assert any(ln.startswith("acceptance:") for ln in lines["port"])
    rep = reports["port"]
    validate_report(rep)
    j_validate_report(rep)
    assert {k: rep[k] for k in _COUNTERS} == \
        {k: reports["jax"][k] for k in _COUNTERS}
    assert rep["meta"]["backend"] == "cpu"
    assert rep["phases"]["samples"] > 0 and rep["phases"]["eq1"] is not None


def test_cli_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    flags = ["--dims", "temperature:4", "--md-steps", "2", "--chunk", "2",
             "--atoms", "8", "--pattern", "async", "--failure-rate", "0.25"]
    ckpt = tmp_path / "ckpt"
    full = _lines(j_repex_run.main, flags + ["--cycles", "6", "--ckpt-dir",
                                             str(ckpt)], monkeypatch, "")
    # a run killed after cycle 3: its last checkpoint (cycle 5) is gone
    shutil.rmtree(ckpt / "step-00000005")
    report = tmp_path / "resumed.json"
    resumed = _lines(repex_run.main,
                     flags + ["--cycles", "6", "--resume", str(ckpt),
                              "--report-out", str(report), "--device",
                              "cpu"], monkeypatch, report)
    # the stitched run ends as the uninterrupted one: the same tail lines
    tail = [ln for ln in full if ln.startswith(("multiset", "acceptance",
                                                "failures"))]
    assert [ln for ln in resumed if ln.startswith(
        ("multiset", "acceptance", "failures"))] == tail
    assert any(ln.startswith("chunk @cycle    6") for ln in resumed)
    with open(report) as f:
        validate_report(json.load(f))


@pytest.mark.parametrize("argv,item", [(["--engine", "lm"], "item 8")])
def test_unported_flags_name_their_roadmap_item(argv, item, monkeypatch):
    """``--engine lm`` runs (``test_torch_lm_engine`` holds it against
    JAX's CLI); what it cannot run yet is another model family, whose
    error names the ROADMAP item."""
    cfg = dataclasses.replace(registry.get_smoke_config("olmo_1b"),
                              family="moe")
    monkeypatch.setattr(registry, "get_smoke_config", lambda arch: cfg)
    with pytest.raises(NotImplementedError, match=item):
        repex_run.main(argv + ["--device", "cpu", "--cycles", "1"])

"""The trace reading and the per-layer readers on a synthetic trace: a
reader with nothing to read returns nothing, shares come from the
frozen counts."""
from __future__ import annotations

import json

import pytest

from remdbench import harness, trace
from remdbench.counts import chain as counts

TOPO = {"n_atoms": 2881, "bonds": 2880, "angles": 2879, "quads": 2880,
        "slots": 15, "pairs": 4142881}


def _chrome(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "nonbonded_pairs_kernel(x)",
         "ts": 0.0, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "nonbonded_combine_kernel(x)",
         "ts": 500.0, "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "fused_baoab_kernel(x)",
         "ts": 700.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 900.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 520.0, "dur": 200.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_trace(str(path))


CONFIG = {"exchange": {"md_steps_per_cycle": 10,
                      "dimensions": [["temperature", 64]]}}


def _ctx(tr, **kw):
    ctx = {"trace": tr, "window_s": 2e-3, "cycles": 1, "cycle_s": 1e-3,
           "phase_s": {}, "counts": counts, "topology": TOPO,
           "replicas_per_chip": 64, "config": CONFIG}
    ctx.update(kw)
    return ctx


def test_busy_gaps_and_breakdown(tmp_path):
    tr = _chrome(tmp_path)
    assert tr.busy_s() == pytest.approx(740e-6)
    assert tr.gaps(0.0, 1000.0) == [(540.0, 700.0), (800.0, 900.0)]
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["nonbonded_pairs_kernel(x)",
                                   pytest.approx(500e-6)]
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"cudaStreamSynchronize": 160e-6, "host idle": 100e-6})
    assert len(bd["device_ops"]) == 3


def test_readers(tmp_path):
    """Shares of the untraced cycle (``cycle_s``, 1 ms here; the traced
    window took 2 ms) and of the frozen counts."""
    tr = _chrome(tmp_path)
    read = {m: harness._reader(m) for m in (
        "device_idle_pct", "kernels_per_cycle", "nonbonded_roofline_pct",
        "fused_baoab_roofline_pct", "exchange_probe_ms",
        "propagate_probe_ms", "cycle_mfu_pct")}
    ctx = _ctx(tr, phase_s={"exchange": 0.04, "propagate": 0.01})
    assert read["device_idle_pct"](ctx) == pytest.approx(26.0)
    assert read["kernels_per_cycle"](ctx) == 3
    bound = counts.nonbonded_bound(TOPO, 64)["ms"]
    assert read["nonbonded_roofline_pct"](ctx) == pytest.approx(
        100 * bound / 0.54)
    k3 = counts.fused_bound(TOPO, 64, False)["ms"]
    assert read["fused_baoab_roofline_pct"](ctx) == pytest.approx(
        100 * k3 / 0.1)
    assert read["exchange_probe_ms"](ctx) == pytest.approx(40.0)
    assert read["propagate_probe_ms"](ctx) == pytest.approx(10.0)
    ops = counts.cycle_ops(TOPO, CONFIG, 64)
    assert read["cycle_mfu_pct"](ctx) == pytest.approx(
        100 * ops / (1e-3 * 67e12))
    empty = _ctx(None)
    for name, fn in read.items():
        assert fn(empty) is None, name

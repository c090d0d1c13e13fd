"""Observability of the port (``repro_torch.obs``) against the JAX
package's, on the CPU; ``tests/test_telemetry.py`` without its HLO and
sharded cases, whose contracts are XLA's (ROADMAP R3, R2).

  * telemetry on and off: the same trajectory, bitwise (assignment rows,
    counters, acceptance, final positions), over patterns x schemes,
    chunk sizes, the "pallas" and "batched" force paths, the sparse path
    and failures;
  * telemetry off dispatches the same aten operations per chunk as the
    driver did before observability was ported (counted with a
    ``TorchDispatchMode``; the numbers were measured on that tree);
  * a phase probe reads the ensemble and never writes it;
  * the report's counters equal the JAX report's on the same seed:
    totals, ``per_dim``, pair rows, occupancy, round trips, failures,
    neighbor, cycles, on ``run`` and ``run_fused``, both schemes, the
    asynchronous pattern with faults;
  * the matrix scheme has no pair rows; ``reset`` scopes the counters; a
    report is built without telemetry; either package's
    ``validate_report`` accepts either's report;
  * a resume restores the counters, across the packages both ways.
"""
import collections
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import RepExConfig as JConfig
from repro.core import REMDDriver as JDriver
from repro.md import HarmonicEngine as JHarmonicEngine
from repro.md import MDEngine as JEngine
from repro.md.system import chain_molecule as j_chain_molecule
from repro.obs import Telemetry as JTelemetry
from repro.obs import validate_report as j_validate_report
from repro_torch import convert
from repro_torch.config import RepExConfig
from repro_torch.core import REMDDriver
from repro_torch.md import HarmonicEngine, MDEngine
from repro_torch.md.system import chain_molecule
from repro_torch.obs import (PHASES, RunReport, Telemetry,
                             make_phase_probes, sample_phases,
                             validate_report)

SEED = 0


def _cfg(pattern="synchronous", scheme="neighbor", n_replicas=6,
         n_cycles=8, md_steps=2, **kw):
    return dict(dimensions=(("temperature", n_replicas),),
                md_steps_per_cycle=md_steps, n_cycles=n_cycles,
                pattern=pattern, exchange_scheme=scheme, **kw)


def _harmonic(cfg, **kw):
    return REMDDriver(HarmonicEngine(device="cpu"), RepExConfig(**cfg),
                      device="cpu", **kw)


def _md(cfg, n_atoms=10, **kw):
    eng_kw = kw.pop("engine", {})
    return REMDDriver(MDEngine(chain_molecule(n_atoms), device="cpu",
                               **eng_kw), RepExConfig(**cfg), device="cpu",
                      **kw)


def _trajectory(d):
    return (np.stack([np.asarray(h["assignment"]) for h in d.history]),
            [(h["accept"], h["attempt"], h["failed"], h["esc_relaunch"],
              h["esc_reinit"], h["esc_dead"], h["nb_overflow"],
              h["nb_rebuilds"]) for h in d.history],
            d.acceptance)


def _bitwise(a, b) -> bool:
    """Equal bit for bit (a failed replica's NaNs included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_same_run(d_on, d_off, ens_on, ens_off):
    a_on, c_on, acc_on = _trajectory(d_on)
    a_off, c_off, acc_off = _trajectory(d_off)
    np.testing.assert_array_equal(a_on, a_off)
    assert c_on == c_off
    assert acc_on == acc_off
    for k, v in ens_on.state.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert _bitwise(vv, ens_off.state[k][kk]), (k, kk)
        else:
            assert _bitwise(v, ens_off.state[k]), k


# -- invariance: telemetry on == telemetry off, bitwise ----------------------


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
@pytest.mark.parametrize("pattern", ["synchronous", "asynchronous"])
def test_fused_invariance(pattern, scheme):
    cfg = _cfg(pattern=pattern, scheme=scheme)
    d_on = _harmonic(cfg, telemetry=Telemetry(phase_probe_every=1))
    d_off = _harmonic(cfg)
    e_on = d_on.run_fused(d_on.init(), chunk_cycles=4)
    e_off = d_off.run_fused(d_off.init(), chunk_cycles=4)
    _assert_same_run(d_on, d_off, e_on, e_off)
    for d in (d_on, d_off):
        validate_report(d.last_report.to_dict())
        j_validate_report(d.last_report.to_dict())


def test_fused_invariance_across_chunk_sizes():
    """Telemetry on at K = 2 against off at K = 5 (a partial last chunk)."""
    cfg = _cfg(n_cycles=7)
    d_on = _harmonic(cfg, telemetry=Telemetry())
    d_off = _harmonic(cfg)
    e_on = d_on.run_fused(d_on.init(), chunk_cycles=2)
    e_off = d_off.run_fused(d_off.init(), chunk_cycles=5)
    _assert_same_run(d_on, d_off, e_on, e_off)


@pytest.mark.parametrize("engine", [dict(force_path="pallas"),
                                    dict(force_path="batched"),
                                    dict(nonbonded="sparse", skin=0.3,
                                         nlist_build="cell")])
def test_fused_invariance_force_paths(engine):
    cfg = _cfg(n_replicas=4, n_cycles=4)
    n = 24 if "nonbonded" in engine else 10
    d_on = _md(cfg, n, engine=engine, telemetry=Telemetry())
    d_off = _md(cfg, n, engine=engine)
    e_on = d_on.run_fused(d_on.init(), chunk_cycles=2)
    e_off = d_off.run_fused(d_off.init(), chunk_cycles=2)
    _assert_same_run(d_on, d_off, e_on, e_off)


def test_fused_invariance_under_failures():
    cfg = _cfg(n_replicas=4, n_cycles=6, relaunch_budget=1)
    d_on = _md(cfg, failure_rate=0.4,
               telemetry=Telemetry(phase_probe_every=1))
    d_off = _md(cfg, failure_rate=0.4)
    e_on = d_on.run_fused(d_on.init(), chunk_cycles=3)
    e_off = d_off.run_fused(d_off.init(), chunk_cycles=3)
    _assert_same_run(d_on, d_off, e_on, e_off)
    assert d_on.last_report.failures["total"] > 0
    assert d_on.last_report.failures == d_off.last_report.failures


@pytest.mark.parametrize("scheme", ["neighbor", "matrix"])
def test_run_invariance(scheme):
    cfg = _cfg(scheme=scheme, n_cycles=5)
    d_on = _harmonic(cfg, telemetry=Telemetry(phase_probe_every=2))
    d_off = _harmonic(cfg)
    e_on = d_on.run(d_on.init())
    e_off = d_off.run(d_off.init())
    _assert_same_run(d_on, d_off, e_on, e_off)
    validate_report(d_on.last_report.to_dict())
    assert d_on.last_report.phases["samples"] == 3     # cycles 0, 2, 4


# -- telemetry off: the same operations as before it was ported --------------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


# aten operations one chunk of 2 cycles dispatched on the tree before
# observability was ported, counted by this test's _CountOps
OPS_PER_CHUNK = {"main": 5261, "matrix": 6529, "async_faults": 5499,
                 "sparse": 6105, "harmonic_tsu": 2705}
_OP_CASES = {
    "main": (lambda: MDEngine(chain_molecule(10), device="cpu"),
             dict(dimensions=(("temperature", 4),), md_steps_per_cycle=3),
             {}),
    "matrix": (lambda: MDEngine(chain_molecule(10), device="cpu"),
               dict(dimensions=(("temperature", 4),), md_steps_per_cycle=3,
                    exchange_scheme="matrix"), {}),
    "async_faults": (lambda: MDEngine(chain_molecule(10), device="cpu"),
                     dict(dimensions=(("temperature", 4),),
                          md_steps_per_cycle=3, pattern="asynchronous",
                          relaunch_budget=1), dict(failure_rate=0.3)),
    "sparse": (lambda: MDEngine(chain_molecule(24), nonbonded="sparse",
                                skin=0.3, device="cpu"),
               dict(dimensions=(("temperature", 4),), md_steps_per_cycle=3),
               {}),
    "harmonic_tsu": (lambda: HarmonicEngine(device="cpu"),
                     dict(dimensions=(("temperature", 2), ("umbrella", 2)),
                          md_steps_per_cycle=2), {}),
}


@pytest.mark.parametrize("case", sorted(OPS_PER_CHUNK))
@pytest.mark.parametrize("telemetry", [None, "disabled"])
def test_telemetry_off_dispatches_the_same_ops(case, telemetry):
    make, cfg, kw = _OP_CASES[case]
    tel = None if telemetry is None else Telemetry(enabled=False)
    d = REMDDriver(make(), RepExConfig(**cfg), device="cpu", telemetry=tel,
                   **kw)
    ens = d.init(SEED)
    backup, fail_key = d._start_carry(ens)
    with _CountOps() as c:
        d._chunk(ens, backup, fail_key, 2)
    assert sum(c.n.values()) == OPS_PER_CHUNK[case], c.n.most_common(8)


def test_telemetry_on_adds_only_the_pair_rows():
    """With the counters on, a chunk adds the rows' casts and nothing in
    the cycle itself: 2 casts a cycle in the exchange, 2 to float64 and a
    wider cat in the row."""
    make, cfg, kw = _OP_CASES["main"]
    counts = {}
    for tel in (None, Telemetry()):
        d = REMDDriver(make(), RepExConfig(**cfg), device="cpu",
                       telemetry=tel, **kw)
        ens = d.init(SEED)
        backup, fail_key = d._start_carry(ens)
        with _CountOps() as c:
            d._chunk(ens, backup, fail_key, 2)
        counts[tel is None] = c.n
    extra = counts[False] - counts[True]
    assert set(extra) == {"aten._to_copy.default"}
    assert extra["aten._to_copy.default"] == 2 * 4
    assert not counts[True] - counts[False]


# -- the probes read the ensemble and never write it -------------------------


@pytest.mark.parametrize("pattern", ["synchronous", "asynchronous"])
def test_phase_probes_leave_the_ensemble_untouched(pattern):
    cfg = _cfg(pattern=pattern, n_replicas=4, n_cycles=2)
    d = _md(cfg, 24, engine=dict(nonbonded="sparse", skin=0.3),
            telemetry=Telemetry())
    ens = d.run_fused(d.init(), chunk_cycles=2)
    before = {k: v.clone() for k, v in ens._asdict().items()
              if k != "state"}
    state = {k: v.clone() for k, v in ens.state.items() if k != "nlist"}
    nlist = {k: v.clone() for k, v in ens.state["nlist"].items()}
    times = sample_phases(make_phase_probes(d), ens, set())
    assert set(times) == set(PHASES) and min(times.values()) >= 0.0
    for k, v in before.items():
        assert torch.equal(getattr(ens, k), v), k
    for k, v in state.items():
        assert torch.equal(ens.state[k], v), k
    for k, v in nlist.items():
        assert torch.equal(ens.state["nlist"][k], v), k


# -- the report against the JAX package's -------------------------------------


def _jax_md(cfg, **kw):
    return JDriver(JEngine(j_chain_molecule(10)), JConfig(**cfg), **kw)


def _port_md(cfg, **kw):
    eng = MDEngine(convert.system_from_arrays(j_chain_molecule(10), "cpu"),
                   device="cpu")
    return REMDDriver(eng, RepExConfig(**cfg), device="cpu", **kw)


def _counters(report):
    """The report's counters: everything but times and backend."""
    d = json.loads(json.dumps(report.to_dict()))
    out = {k: d[k] for k in ("path", "engine", "force_path", "pattern",
                             "scheme", "exchange_comm", "n_replicas",
                             "n_dims", "chunk_cycles", "cycles",
                             "exchange", "failures", "neighbor", "wire",
                             "version")}
    out["samples"] = d["phases"]["samples"]
    out["eq1_terms"] = sorted(d["phases"]["eq1"] or {})
    return out


_REPORT_CASES = {
    "fused_neighbor": (_cfg(n_replicas=4, n_cycles=8, md_steps=3), "fused",
                       {}),
    "fused_matrix": (_cfg(scheme="matrix", n_replicas=4, n_cycles=6,
                          md_steps=3), "fused", {}),
    "fused_async_faults": (_cfg(pattern="asynchronous", n_replicas=6,
                                n_cycles=6, md_steps=4, async_window=0.5,
                                relaunch_budget=1), "fused",
                           dict(failure_rate=0.25)),
    "run_neighbor": (_cfg(n_replicas=4, n_cycles=5, md_steps=3), "run", {}),
    "run_matrix": (_cfg(scheme="matrix", n_replicas=4, n_cycles=4,
                        md_steps=3), "run", {}),
}


@pytest.mark.parametrize("case", sorted(_REPORT_CASES))
def test_report_counters_match_jax(case):
    cfg, path, kw = _REPORT_CASES[case]
    jdrv = _jax_md(cfg, telemetry=JTelemetry(phase_probe_every=2), **kw)
    tdrv = _port_md(cfg, telemetry=Telemetry(phase_probe_every=2), **kw)
    for drv in (jdrv, tdrv):
        if path == "run":
            drv.run(drv.init(SEED))
        else:
            drv.run_fused(drv.init(SEED), chunk_cycles=2)
    jrep, trep = jdrv.last_report, tdrv.last_report
    assert _counters(trep) == _counters(jrep)
    assert trep.meta == {"backend": "cpu",
                         "n_devices": torch.cuda.device_count()}
    if cfg["exchange_scheme"] == "matrix":
        assert trep.exchange["pair_attempt"] is None
    else:
        att = np.asarray(trep.exchange["pair_attempt"])
        assert att.sum() == trep.exchange["attempted"]
    if kw:
        assert trep.failures["total"] > 0
    j_validate_report(trep.to_dict())
    validate_report(jrep.to_dict())


def test_report_counters_match_driver_bookkeeping():
    cfg = _cfg(n_cycles=12)
    d = _harmonic(cfg, telemetry=Telemetry(phase_probe_every=2))
    d.run_fused(d.init(), chunk_cycles=4)
    r = d.last_report
    assert isinstance(r, RunReport)
    ex = r.exchange
    assert np.asarray(ex["pair_accept"]).sum() == pytest.approx(
        ex["accepted"])
    assert np.asarray(ex["pair_attempt"]).sum() == pytest.approx(
        ex["attempted"])
    np.testing.assert_array_less(
        np.asarray(ex["pair_accept"]) - 1e-9, np.asarray(ex["pair_attempt"]))
    occ = np.asarray(ex["occupancy"])
    np.testing.assert_array_equal(occ.sum(axis=1), np.full(6, 12))
    assert r.phases["samples"] == 2          # chunks 0 and 2 of 3
    for ph in PHASES:
        assert r.phases["means"][ph] >= 0.0
    for term, val in r.phases["eq1"].items():
        assert val >= 0.0, term
    validate_report(json.loads(r.to_json()))


def test_report_matrix_scheme_has_no_pair_rows():
    d = _harmonic(_cfg(scheme="matrix"), telemetry=Telemetry())
    d.run_fused(d.init(), chunk_cycles=4)
    ex = d.last_report.exchange
    assert ex["pair_attempt"] is None and ex["pair_accept"] is None
    assert ex["occupancy"] is not None
    validate_report(d.last_report.to_dict())


def test_telemetry_reset_scopes_counters():
    tel = Telemetry(phase_probe_every=0)
    d = _harmonic(_cfg(n_cycles=12), telemetry=tel)
    ens = d.run_fused(d.init(), n_cycles=4, chunk_cycles=4)
    tel.reset()
    d.run_fused(ens, n_cycles=8, chunk_cycles=4)
    r = d.last_report
    assert r.cycles == {"total": 12, "counted": 8}
    np.testing.assert_array_equal(
        np.asarray(r.exchange["occupancy"]).sum(axis=1), np.full(6, 8))


def test_report_without_telemetry_still_emitted():
    d = _harmonic(_cfg(n_cycles=4))
    d.run_fused(d.init(), chunk_cycles=2)
    r = d.last_report
    assert r.cycles == {"total": 4, "counted": 0}
    assert r.exchange["pair_attempt"] is None
    assert r.phases["samples"] == 0 and r.phases["eq1"] is None
    assert r.wire == {}
    validate_report(r.to_dict())
    with pytest.raises(ValueError, match="missing key 'meta'"):
        validate_report({k: v for k, v in r.to_dict().items()
                         if k != "meta"})


def test_state_dict_round_trips_in_the_jax_format():
    tel = Telemetry()
    d = _harmonic(_cfg(n_cycles=4), telemetry=tel)
    d.run_fused(d.init(), chunk_cycles=2)
    sd = json.loads(json.dumps(tel.state_dict()))
    jt, tt = JTelemetry(), Telemetry()
    jt.load_state_dict(sd)
    tt.load_state_dict(sd)
    assert json.dumps(jt.state_dict()) == json.dumps(tel.state_dict())
    assert json.dumps(tt.state_dict()) == json.dumps(tel.state_dict())


# -- resume restores the counters, across the packages both ways -------------

_CKPT_CFG = _cfg(pattern="asynchronous", n_replicas=6, n_cycles=8,
                 md_steps=4, async_window=0.5, relaunch_budget=1)
_CKPT_KW = dict(failure_rate=0.25, ckpt_every=4)


@pytest.fixture(scope="module")
def full_runs(tmp_path_factory):
    """An uninterrupted telemetry run of each package, checkpointing each
    chunk of 4 (steps 3 and 7)."""
    out = {}
    for name, make, tel in (("port", _port_md, Telemetry),
                            ("jax", _jax_md, JTelemetry)):
        d = str(tmp_path_factory.mktemp(f"{name}_tel_ckpt"))
        drv = make(_CKPT_CFG, ckpt_dir=d, telemetry=tel(phase_probe_every=0),
                   **_CKPT_KW)
        drv.run_fused(drv.init(SEED), chunk_cycles=4)
        out[name] = (d, drv)
    return out


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_resume_restores_the_counters(writer, reader, full_runs):
    d, full = full_runs[writer]
    make, tel = ((_port_md, Telemetry) if reader == "port"
                 else (_jax_md, JTelemetry))
    drv = make(_CKPT_CFG, ckpt_dir=d, telemetry=tel(phase_probe_every=0),
               **_CKPT_KW)
    drv.resume(via="fused", chunk_cycles=4, step=3)
    assert _counters(drv.last_report) == _counters(full.last_report)
    assert drv.last_report.cycles == {"total": 8, "counted": 8}
    assert drv.last_report.failures["total"] > 0


def test_resume_past_the_end_still_reports(full_runs):
    d, full = full_runs["port"]
    drv = _port_md(_CKPT_CFG, ckpt_dir=d, telemetry=Telemetry(), **_CKPT_KW)
    drv.resume(via="run", step=7)
    assert drv.last_report.path == "run"
    assert _counters(drv.last_report)["exchange"] == \
        _counters(full.last_report)["exchange"]

"""The synchronous pattern: every cycle propagates every replica, then
takes one exchange sweep; what a run of it produced, judged.

Keys: the seed's key splits into (state, speed, run); before each cycle
the run key splits into (the cycle's propagate key, split once per
replica; its exchange key; the next run key).

A run hands over (``run``): ``init`` (pos, vel) it started from; ``rows``,
every cycle's (cycle, assignment row, accepted count) in order; ``snap``,
the ensemble before the checked chunk (pos, vel, assignment, rng, cycle);
``post``, its (pos, vel) after the chunk's ``k`` cycles; ``md_steps``.
``judge`` returns the compared numbers:

  * ``start_ulps``: the largest difference of an initial position or
    velocity in float32 ulps of the reference's value;
  * ``rows_bad`` (exact): history rows the exchange scheme's
    ``rows_bad`` refuses, plus the chunk's start when its key or row is
    not its cycle's;
  * ``exchange_gap``: the exchange judged at the program's own
    positions.  ``snap``'s positions are those the cycle before the
    chunk exchanged on, ``post``'s those of the chunk's last cycle; for
    each, the reference's features there, the row before that cycle and
    its exchange key give the reference's decisions; over the decisions
    the program took otherwise, the largest distance of the reference's
    log acceptance from the log of the uniform draw (0 when all agree).
    A sound run differs only by rounding at the boundary;
  * ``vel_gap``: the chunk followed from the program's state before it,
    each cycle propagated from the program's state and assignment with
    the noise its key gives, the sweep's decisions taken from the
    reference's own energies, then continued from the program's row;
    over the replicas, the largest norm of the velocity difference after
    the chunk over the norm of the reference's velocities;
  * ``decision_gap``: over the decisions of that follow the program took
    otherwise, as ``exchange_gap`` (the positions there diverge by
    rounding, so its limit is wider);

and, printed beside them and not judged: ``vel_gap_max`` (the largest
element's difference over the largest velocity) and ``u_gap`` (the
largest difference of a replica's reduced energy at the program's and at
the reference's positions after the chunk).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import prng


def cycle_keys(rng: torch.Tensor, n_rep: int):
    """(per-replica propagate keys (R, 2), exchange key, next key)."""
    k_md, k_ex, k_next = prng.split(rng, 3)
    return prng.split(k_md, n_rep), k_ex, k_next


def run_keys(seed: int, cycles) -> Dict[int, torch.Tensor]:
    """The run key before each of ``cycles`` of a run of ``seed``
    (host)."""
    want = sorted(set(int(c) for c in cycles if c >= 0))
    out: Dict[int, torch.Tensor] = {}
    k = prng.split(prng.key(seed), 3)[2]
    c = 0
    for target in want:
        while c < target:
            k = prng.split(k, 3)[2]
            c += 1
        out[target] = k
    return out


def _ulps(prog: torch.Tensor, ref: torch.Tensor) -> float:
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float64),
                      e.to(torch.int64) - 24)
    return float(torch.max(torch.abs(prog.double() - ref.double()) / ulp))


def _row_before(by_cycle, c: int, n_rep: int) -> np.ndarray:
    return by_cycle[c - 1][0] if c > 0 else np.arange(n_rep)


def _miss_gap(ex, d, row) -> float:
    """The largest |log u - log p| over the decisions ``row`` took
    otherwise than ``d`` (0 when all agree)."""
    miss = d.accept != ex.taken(row, d)
    return float(np.max(np.abs(d.log_u - d.log_p)[miss])) if miss.any() \
        else 0.0


def _exchange_gap(ref, by_cycle, keys, pos, c: int) -> Optional[float]:
    if c < 0 or c not in by_cycle:
        return None
    m, ex = ref.model, ref.exchange
    _, k_ex, _ = cycle_keys(keys[c].to(m.device), m.n_rep)
    a = _row_before(by_cycle, c, m.n_rep)
    d = ex.decide(m, m.features(pos.to(m.device)), a, c, k_ex)
    return _miss_gap(ex, d, by_cycle[c][0])


def judge(ref, seed: int, run: Dict) -> Dict[str, float]:
    """The compared numbers of one run (module docstring)."""
    m, ex = ref.model, ref.exchange
    dev, n_rep = m.device, m.n_rep
    init, rows, snap, post = run["init"], run["rows"], run["snap"], \
        run["post"]
    k, md_steps = int(run["k"]), int(run["md_steps"])
    pos0, vel0, _ = m.init_state(seed)
    out = {"start_ulps": max(_ulps(init[0].to(dev), pos0),
                             _ulps(init[1].to(dev), vel0))}
    bad = ex.rows_bad(m, rows)
    by_cycle = {c: (np.asarray(r), acc) for c, r, acc in rows}
    c0 = int(snap["cycle"])
    a = np.asarray(snap["assignment"].cpu())
    keys = run_keys(seed, [c0 - 1, c0, c0 + k - 1])
    if (any(c0 + i not in by_cycle for i in range(k))
            or c0 - 1 not in by_cycle and c0 > 0):
        return dict(out, rows_bad=float(bad + 1), exchange_gap=float("inf"),
                    vel_gap=float("inf"), decision_gap=float("inf"))
    if (not np.array_equal(a, _row_before(by_cycle, c0, n_rep))
            or not torch.equal(snap["rng"].cpu(), keys[c0])):
        bad += 1
    out["rows_bad"] = float(bad)
    gaps = [_exchange_gap(ref, by_cycle, keys, snap["pos"], c0 - 1),
            _exchange_gap(ref, by_cycle, keys, post["pos"], c0 + k - 1)]
    out["exchange_gap"] = max(g for g in gaps if g is not None)

    pos, vel = snap["pos"].to(dev), snap["vel"].to(dev)
    key = keys[c0].to(dev)
    gap = 0.0
    for i in range(k):
        c = c0 + i
        pkeys, k_ex, key = cycle_keys(key, n_rep)
        ctl = m.controls(torch.as_tensor(a, device=dev))
        pos, vel = m.propagate(pos, vel, ctl, pkeys, md_steps)
        d = ex.decide(m, m.features(pos), a, c, k_ex)
        a = by_cycle[c][0]
        gap = max(gap, _miss_gap(ex, d, a))
    ctl = m.controls(torch.as_tensor(a, device=dev))
    u_prog = m.reduced(m.features(post["pos"].to(dev)), ctl).double()
    u_ref = m.reduced(m.features(pos), ctl).double()
    out["u_gap"] = float(torch.max(torch.abs(u_prog - u_ref)))
    dv = post["vel"].to(dev).double() - vel.double()
    v = vel.double()
    out["vel_gap"] = float(torch.max(torch.linalg.vector_norm(dv, dim=(1, 2))
                                     / torch.linalg.vector_norm(v, dim=(1, 2))))
    out["vel_gap_max"] = float(torch.max(torch.abs(dv)) / torch.max(v.abs()))
    out["decision_gap"] = gap
    return out


def control_run(ctl, seed: int, md_steps: int, k: int) -> Dict:
    """``ctl`` (a reference in a lower precision) in the program's place:
    its start from the seed, a chunk of ``k`` cycles, then the checked
    chunk of ``k`` more, each cycle's decisions its own.  Returns what a
    run hands ``judge``."""
    m, ex = ctl.model, ctl.exchange
    pos, vel, key = m.init_state(seed)
    init = (pos, vel)
    a = np.arange(m.n_rep)
    rows: List = []
    snap = None
    for c in range(2 * k):
        if c == k:
            snap = {"pos": pos, "vel": vel, "assignment": torch.as_tensor(a),
                    "rng": key.cpu(), "cycle": c}
        pkeys, k_ex, key = cycle_keys(key, m.n_rep)
        pos, vel = m.propagate(pos, vel, m.controls(
            torch.as_tensor(a, device=m.device)), pkeys, md_steps)
        d = ex.decide(m, m.features(pos), a, c, k_ex)
        a = ex.apply(a, d)
        rows.append((c, a, float(d.accept.sum())))
    return {"init": init, "rows": rows, "snap": snap,
            "post": {"pos": pos, "vel": vel}, "md_steps": md_steps, "k": k}

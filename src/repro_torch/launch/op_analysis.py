"""Per-device cost of a step from the ops it dispatches: the port of the
JAX package's ``repro/launch/hlo_analysis.py``.

The port has no HLO.  It runs the function once under a
``TorchDispatchMode`` (:class:`OpProbe`) and reads every aten op that
reaches a tensor: a plain one, a ``FakeTensor`` (the dry run's, which
allocates nothing) or a DTensor's local shard.  An op on DTensors is
handed to DTensor's own dispatch (the probe returns ``NotImplemented``),
which redistributes the inputs through functional collectives and runs
the op on the local shards, inside the probe: so every quantity below is
one device's, counted on its shards (a count over the DTensors would
give their global sizes).  The fake tensors that DTensor's sharding
propagation makes for its shape inference are not the traced step's and
are left out.

The functions and their JAX counterparts:

  * :func:`analyze` ~ ``analyze(hlo_text)``, the same keys:
      - ``flops``: 2 * |out| * |contracted| of mm, bmm, addmm and
        baddbmm, the aten products that ``matmul`` and ``einsum`` lower
        to, JAX's class of ``dot`` ops; a convolution or a fused
        attention is not a ``dot`` in JAX's count and goes to
        ``other_flops`` (``torch.utils.flop_counter``'s formulas);
      - ``write_bytes``: the output bytes of every op that is not a view,
        an alias or other bookkeeping (JAX's ``_TRIVIAL_OPS`` exclusion);
      - ``collective_bytes`` / ``collective_counts`` /
        ``collective_total``: the functional collectives DTensor issues,
        under JAX's names (all-gather, all-reduce, reduce-scatter,
        all-to-all), each one's output bytes, with the collectives that
        ``repro_torch.sharding`` issues itself (collective-permute among
        them) from the same census;
      - ``peak_bytes``: the high-water mark of the bytes of the storages
        the step allocated and still held (outputs included; the
        arguments' storages are not counted);
    eager mode unrolls every Python loop, so every count is already
    weighted by its trip count (JAX weights while bodies by
    ``known_trip_count``);
  * :func:`count_ops` ~ ``count_ops``: the aten-op census without views
    and bookkeeping; :func:`op_count` ~ ``compiled_op_count``: (total,
    census); :func:`op_budget_check` ~ ``op_budget_check``.  The one
    difference: JAX's census is static, one entry per compiled op, but
    eager mode dispatches a Python loop's body once per trip, and the
    census counts each dispatch;
  * :func:`count_launches`: the CUDA kernels one call launches, from
    ``torch.profiler`` on the card, the counterpart of the op budgets
    that the JAX package pins on its compiled HLO;
  * :func:`collective_shapes` / :func:`collective_budget` ~ their
    namesakes: ``[{"op", "dims", "bytes"}]`` and ``{op: {"count",
    "bytes"}}`` of one call, read from the ``sharding.WireCensus`` open
    around it (the census the sharded driver keeps per chunk).  Unlike
    JAX's static census they count the collectives a call issued.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import sharding as shd

# the products JAX counts as ``dot``; each entry: (the output, the
# contracted length) of the op's arguments
_aten = torch.ops.aten
_DOTS = {
    _aten.mm.default: lambda a, b: a.shape[1],
    _aten.bmm.default: lambda a, b: a.shape[2],
    _aten.addmm.default: lambda c, a, b: a.shape[1],
    _aten.baddbmm.default: lambda c, a, b: a.shape[2],
}

# functional collectives (``torch.distributed._functional_collectives``,
# what DTensor's redistribution issues) by JAX's collective names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no data: queries, aliases and the collectives' plumbing
# (views are told by their schema, ``OpOverload.is_view``)
_BOOKKEEPING = frozenset((
    "prim::device", "aten::detach", "aten::alias", "aten::lift_fresh",
    "aten::_unsafe_view", "aten::sym_size", "aten::sym_stride",
    "aten::sym_numel", "aten::sym_storage_offset", "aten::is_same_size",
    "aten::is_contiguous", "aten::_local_scalar_dense", "aten::set_",
    "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(obj, acc: Optional[list] = None) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments or outputs (tensors, and
    tuples, lists and dicts of them): ``_tensors`` without pytree's
    generality, which the probe would pay on every op."""
    if acc is None:
        acc = []
    if isinstance(obj, torch.Tensor):
        acc.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _op_tensors(x, acc)
    elif isinstance(obj, dict):
        for x in obj.values():
            _op_tensors(x, acc)
    return acc


def _fake_mode(t):
    return getattr(t, "fake_mode", None)


def trace_fake_modes(*trees) -> set:
    """The fake modes of the fake tensors in ``trees`` (a DTensor's by its
    local shard): the modes whose tensors a probe counts."""
    from torch.distributed.tensor import DTensor
    modes = set()
    for t in _tensors(trees):
        if isinstance(t, DTensor):
            t = t._local_tensor
        m = _fake_mode(t)
        if m is not None:
            modes.add(id(m))
    return modes


class OpProbe(TorchDispatchMode):
    """Count the ops dispatched inside the mode on one device's tensors.

    ``fake_modes``: the ids of the fake modes whose tensors belong to the
    traced step (``trace_fake_modes``); an op on a fake tensor of any
    other mode (DTensor's shape inference) is not counted.  ``device``
    (a device type, "cuda"): count only the ops with a tensor there."""

    def __init__(self, fake_modes=(), device: Optional[str] = None,
                 deadline: Optional[float] = None):
        super().__init__()
        self.fake_modes = set(fake_modes)
        self.device = device
        self.deadline = deadline
        self.flops = 0
        self.other_flops = 0
        self.write_bytes = 0
        self.census: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self.census_of_wire: Optional[shd.WireCensus] = None

    # -- dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise TimeoutError("the probe's deadline passed")
        from torch.distributed.tensor import DTensor
        ins = _op_tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            # DTensor's dispatch runs the op on the shards, inside the probe
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _op_tensors(out)
        if self._ours(ins + outs):
            self._record(func, args, kwargs, out, outs)
        return out

    def _ours(self, tensors) -> bool:
        """An op of the traced step: no meta tensor and no fake tensor of
        another mode (DTensor's shape inference); in a fake trace, one of
        its tensors a fake of the trace; with ``device`` set, one of them
        on that device type (DTensor's host-side bookkeeping is left
        out)."""
        mine = not self.fake_modes and self.device is None
        for t in tensors:
            m = _fake_mode(t)
            if m is not None:
                if id(m) not in self.fake_modes:
                    return False
                mine = True
            elif t.device.type == "meta":
                return False
            elif self.device is not None and t.device.type == self.device:
                mine = True
        return mine

    def _record(self, func, args, kwargs, out, outs) -> None:
        name = func._schema.name
        if func.is_view or name in _BOOKKEEPING:
            return
        short = name.split("::")[-1]
        self.census[short] = self.census.get(short, 0) + 1
        self.write_bytes += sum(_nbytes(t) for t in outs)
        if func in _DOTS:
            mats = [a for a in args if isinstance(a, torch.Tensor)]
            self.flops += 2 * outs[0].numel() * _DOTS[func](*mats)
        elif func.overloadpacket in _other_flops():
            self.other_flops += int(_other_flops()[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if name.startswith("_c10d_functional::") and short in _COLLECTIVES:
            census = self.census_of_wire
            if census is not None:
                for t in outs:
                    census.calls.append((_COLLECTIVES[short], tuple(t.shape),
                                         _nbytes(t)))
        # an in-place or out= op writes into storage it was given; only a
        # fresh output is an allocation
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in outs:
                self._hold(t)

    # -- memory: the storages the step allocated, while they live --
    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)


_OTHER_FLOPS: Optional[dict] = None


def _other_flops() -> dict:
    """``torch.utils.flop_counter``'s formulas, by op packet, for the ops
    that are not JAX ``dot``s (convolutions, fused attention)."""
    global _OTHER_FLOPS
    if _OTHER_FLOPS is None:
        from torch.utils.flop_counter import flop_registry
        dots = {op.overloadpacket for op in _DOTS}
        _OTHER_FLOPS = {op: fn for op, fn in flop_registry.items()
                        if op not in dots}
    return _OTHER_FLOPS


def probe(fn, *args, fake_modes=None, device=None, deadline=None,
          **kwargs) -> Tuple[Any, OpProbe]:
    """``(fn(*args, **kwargs), the probe that watched it)``, inside a
    wire census (``probe.census_of_wire``); ``fake_modes`` defaults to
    those of the arguments, ``device`` and ``deadline`` as
    :class:`OpProbe`'s."""
    modes = (trace_fake_modes(args, kwargs) if fake_modes is None
             else set(fake_modes))
    p = OpProbe(modes, device, deadline)
    with shd.wire_census() as census:
        p.census_of_wire = census
        with p:
            out = fn(*args, **kwargs)
    return out, p


def totals(p: OpProbe) -> Dict[str, Any]:
    """JAX's ``analyze`` keys (and ``other_flops``, ``peak_bytes``) of a
    probe."""
    budget = p.census_of_wire.budget() if p.census_of_wire else {}
    coll = {op: b["bytes"] for op, b in budget.items()}
    return {
        "flops": float(p.flops),
        "other_flops": float(p.other_flops),
        "write_bytes": float(p.write_bytes),
        "collective_bytes": coll,
        "collective_counts": {op: b["count"] for op, b in budget.items()},
        "collective_total": sum(coll.values()),
        "peak_bytes": p.peak,
    }


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """One call of ``fn(*args, **kwargs)``: its per-device flops, write
    bytes and collectives (JAX's keys)."""
    _, p = probe(fn, *args, **kwargs)
    return totals(p)


# ---------------------------------------------------------------------------
# Op census
# ---------------------------------------------------------------------------


def count_ops(fn, *args, **kwargs) -> Dict[str, int]:
    """Per-op-name census of the aten ops one call dispatches, views and
    bookkeeping skipped; a Python loop's body counts once per trip."""
    _, p = probe(fn, *args, **kwargs)
    return dict(p.census)


def op_count(fn, *args, **kwargs) -> Tuple[int, Dict[str, int]]:
    """``(total, census)`` of :func:`count_ops`."""
    census = count_ops(fn, *args, **kwargs)
    return sum(census.values()), census


def op_budget_check(fn, *args, budget: int, **kwargs
                    ) -> Tuple[bool, int, Dict[str, int]]:
    """``(total <= budget, total, census)``."""
    total, census = op_count(fn, *args, **kwargs)
    return total <= budget, total, census


def count_launches(fn, *args, **kwargs) -> int:
    """The CUDA kernels one call of ``fn`` launches, from
    ``torch.profiler`` on the card: the largest count of three sessions,
    each recording one call after a warm call in the profiler's warm-up
    step, where the tracer starts.  Late in a long process a session
    recorded from its start has lost its first 56-70 kernels; this count
    has come within one event of a fresh process's (one more on a
    propagate, none of a draw of one kernel), so a count of a few
    kernels is better read from the wrappers' own counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
            prof.step()
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA))
    return max(counts)


# ---------------------------------------------------------------------------
# Collective census
# ---------------------------------------------------------------------------


def collective_shapes(fn, *args, **kwargs) -> List[Dict[str, Any]]:
    """One entry per collective one call issued, ``{"op", "dims",
    "bytes"}``, from the wire census open around it."""
    _, p = probe(fn, *args, **kwargs)
    return [{"op": op, "dims": list(shape), "bytes": nbytes}
            for op, shape, nbytes in p.census_of_wire.calls]


def collective_budget(fn, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """``{op: {"count": n, "bytes": total}}`` of one call (the census's
    ``budget()``)."""
    _, p = probe(fn, *args, **kwargs)
    return p.census_of_wire.budget()

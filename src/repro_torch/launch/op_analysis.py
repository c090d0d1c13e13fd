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
    ``known_trip_count``); a loop that traces one body for its trips in
    a fake trace (the sLSTM's, ``models/recurrent.py``) counts it
    through :meth:`OpProbe.weighted` and holds its trips' outputs
    through :meth:`OpProbe.holding`, so its counts and peak are the
    unrolled loop's; one that records gradients runs unrolled on meta
    twins of its inputs (:func:`on_meta`), counted as on the fake
    tensors but without FakeTensor's dispatch;
  * :func:`count_ops` ~ ``count_ops``: the aten-op census without views
    and bookkeeping; :func:`op_count` ~ ``compiled_op_count``: (total,
    census); :func:`op_budget_check` ~ ``op_budget_check``.  The one
    difference: JAX's census is static, one entry per compiled op, but
    eager mode dispatches a Python loop's body once per trip, and the
    census counts each dispatch;
  * :func:`count_launches`: the CUDA kernels one call launches, the
    kernel nodes of a CUDA graph captured around it on the card
    (:func:`graph_nodes` counts its memset and memcpy nodes apart), the
    counterpart of the op budgets that the JAX package pins on its
    compiled HLO;
  * :func:`collective_shapes` / :func:`collective_budget` ~ their
    namesakes: ``[{"op", "dims", "bytes"}]`` and ``{op: {"count",
    "bytes"}}`` of one call, read from the ``sharding.WireCensus`` open
    around it (the census the sharded driver keeps per chunk).  Unlike
    JAX's static census they count the collectives a call issued.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import sys
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
                 deadline: Optional[float] = None, sites: bool = False):
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
        # the trip count the ops recorded now stand for (``weighted``)
        self.weight = 1
        # with ``sites``: {model source line: {collective: [count,
        # bytes]}}, each collective at the innermost frame of
        # ``repro_torch/models`` that issued it
        self.sites: Optional[Dict[str, Dict[str, list]]] = \
            {} if sites else None
        # plain meta tensors counted as the trace's (``on_meta``), by id,
        # and a switch that lets ops pass uncounted (the twins' making)
        self._twins: Dict[int, Any] = {}
        self._paused = False

    @contextlib.contextmanager
    def weighted(self, trips: int):
        """Inside the block each recorded op counts ``trips`` times in
        the FLOPs, write bytes, census and collectives (one loop body
        standing for its trips, as JAX's ``hlo_analysis`` weights a while
        body by its known trip count); memory is counted once."""
        old, self.weight = self.weight, self.weight * int(trips)
        try:
            yield
        finally:
            self.weight = old

    @contextlib.contextmanager
    def holding(self, nbytes: int):
        """Inside the block ``nbytes`` more are live, as storages of the
        trips a ``weighted`` body stands for would be."""
        self.live += int(nbytes)
        self.peak = max(self.peak, self.live)
        try:
            yield
        finally:
            self.live -= int(nbytes)

    # -- dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise TimeoutError("the probe's deadline passed")
        from torch.distributed.tensor import DTensor
        ins = _op_tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            # DTensor's dispatch runs the op on the shards, inside the probe
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _op_tensors(out)
        if self._twins and any(self._is_twin(t) for t in ins):
            for t in outs:
                if t.device.type == "meta":
                    self._register(t)
        if self._ours(ins + outs):
            self._record(func, args, kwargs, out, outs)
        return out

    def _is_twin(self, t) -> bool:
        ref = self._twins.get(id(t))
        return ref is not None and ref() is t

    def _register(self, t: torch.Tensor) -> None:
        """``t``, a meta tensor, counted as the trace's while it lives."""
        key = id(t)

        def drop(ref, key=key, twins=self._twins):
            if twins.get(key) is ref:
                del twins[key]
        self._twins[key] = weakref.ref(t, drop)

    def twin(self, t: torch.Tensor, like: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """``t``'s twin, made uncounted: a plain meta tensor the probe
        counts as the trace's (``like`` None) or a fake tensor of
        ``like``'s mode.  The twin holds ``t``, so the storage the probe
        counts lives as long as either."""
        with self.paused():
            if like is None:
                out = torch.empty_strided(t.shape, t.stride(),
                                          dtype=t.dtype, device="meta")
                self._register(out)
            else:
                out = like.new_empty_strided(t.shape, t.stride(),
                                             dtype=t.dtype)
        out._twin = t
        return out

    @contextlib.contextmanager
    def paused(self):
        """Inside the block ops pass uncounted."""
        old, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = old

    def _ours(self, tensors) -> bool:
        """An op of the traced step: no meta tensor but the trace's meta
        twins (``on_meta``) and no fake tensor of another mode (DTensor's
        shape inference); in a fake trace, one of its tensors a fake or a
        twin of the trace; with ``device`` set, one of them on that
        device type (DTensor's host-side bookkeeping is left out)."""
        mine = not self.fake_modes and self.device is None
        twins = bool(self._twins) and any(self._is_twin(t) for t in tensors)
        for t in tensors:
            m = _fake_mode(t)
            if m is not None:
                if id(m) not in self.fake_modes:
                    return False
                mine = True
            elif t.device.type == "meta":
                # a meta twin's op (a scalar it meets may be an untracked
                # meta tensor), or DTensor's shape inference
                if not twins:
                    return False
                mine = True
            elif self.device is not None and t.device.type == self.device:
                mine = True
        return mine

    def _record(self, func, args, kwargs, out, outs) -> None:
        name = func._schema.name
        if func.is_view or name in _BOOKKEEPING:
            return
        short = name.split("::")[-1]
        w = self.weight
        self.census[short] = self.census.get(short, 0) + w
        self.write_bytes += w * sum(_nbytes(t) for t in outs)
        if func in _DOTS:
            mats = [a for a in args if isinstance(a, torch.Tensor)]
            self.flops += w * 2 * outs[0].numel() * _DOTS[func](*mats)
        elif func.overloadpacket in _other_flops():
            self.other_flops += w * int(_other_flops()[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if name.startswith("_c10d_functional::") and short in _COLLECTIVES:
            census = self.census_of_wire
            kind = _COLLECTIVES[short]
            for t in outs:
                if census is not None:
                    census.calls.extend(
                        [(kind, tuple(t.shape), _nbytes(t))] * w)
                if self.sites is not None:
                    entry = self.sites.setdefault(_model_site(), {})
                    acc = entry.setdefault(kind, [0, 0])
                    acc[0] += w
                    acc[1] += w * _nbytes(t)
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


def _model_site() -> str:
    """``file:line function`` of the innermost frame of the model code
    (``repro_torch/models``) on the Python stack, else "elsewhere"."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/models/" in path:
            return (f"models/{path.rsplit('/models/', 1)[1]}:"
                    f"{frame.f_lineno} {frame.f_code.co_name}")
        frame = frame.f_back
    return "elsewhere"


class _ToMeta(torch.autograd.Function):
    """A fake tensor of the trace -> its meta twin (``OpProbe.twin``);
    the gradient back to a fake twin like ``like``."""

    @staticmethod
    def forward(ctx, probe, x, like):
        ctx.set_materialize_grads(False)
        ctx.probe, ctx.like = probe, like
        return probe.twin(x)

    @staticmethod
    def backward(ctx, g):
        return (None, None if g is None else ctx.probe.twin(g, ctx.like),
                None)


class _ToFake(torch.autograd.Function):
    """A meta twin -> a fake tensor like ``like``; the gradient back to a
    meta twin."""

    @staticmethod
    def forward(ctx, probe, m, like):
        ctx.set_materialize_grads(False)
        ctx.probe = probe
        return probe.twin(m, like)

    @staticmethod
    def backward(ctx, g):
        return None, (None if g is None else ctx.probe.twin(g)), None


def on_meta(probe: "OpProbe", fn, *args):
    """``fn(*args)`` in a fake trace, run on plain meta twins of its
    tensor arguments and handed back as fake tensors (a tree of tensors
    out): every op of ``fn``, forward and backward, reaches ``probe``
    as it would on the fake tensors (the same aten ops, counted and
    held the same), without FakeTensor's dispatch, which costs ~0.3 ms
    an op.  No op of the crossing is counted, and each twin keeps its
    original alive, so storages live as the fake trace's would."""
    from torch.utils._pytree import tree_map
    with probe.paused():
        like = next(a for a in args
                    if isinstance(a, torch.Tensor)).new_empty(())
    metas = [_ToMeta.apply(probe, a, like) if isinstance(a, torch.Tensor)
             else a for a in args]
    out = fn(*metas)
    return tree_map(lambda t: _ToFake.apply(probe, t, like)
                    if isinstance(t, torch.Tensor) else t, out)


def fake_trace_probe(t) -> Optional["OpProbe"]:
    """The innermost :class:`OpProbe` on the dispatch-mode stack when
    ``t`` is one of its fake trace's tensors (the dry run's), else None:
    a loop that finds one may trace one body ``weighted`` by its trips."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    mode = _fake_mode(t)
    if mode is None:
        return None
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, OpProbe) and id(mode) in m.fake_modes:
            return m
    return None


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
          sites=False, **kwargs) -> Tuple[Any, OpProbe]:
    """``(fn(*args, **kwargs), the probe that watched it)``, inside a
    wire census (``probe.census_of_wire``); ``fake_modes`` defaults to
    those of the arguments, ``device``, ``deadline`` and ``sites`` as
    :class:`OpProbe`'s."""
    modes = (trace_fake_modes(args, kwargs) if fake_modes is None
             else set(fake_modes))
    p = OpProbe(modes, device, deadline, sites)
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


# CUgraphNodeType (cuda.h): the kinds counted apart, and a child graph,
# whose nodes are counted in its place
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CHILD_GRAPH = 4


class _Driver:
    """The three CUDA driver calls that read a graph's nodes, through
    ``ctypes`` on the driver library torch has loaded (a ``cudaGraph_t``
    is a ``CUgraph``)."""

    def __init__(self):
        self._lib = ctypes.CDLL("libcuda.so.1")

    def _call(self, name, *args) -> None:
        code = getattr(self._lib, name)(*args)
        if code != 0:
            raise RuntimeError(f"{name} failed: CUresult {code}")

    def nodes(self, graph: int) -> list:
        n = ctypes.c_size_t(0)
        self._call("cuGraphGetNodes", ctypes.c_void_p(graph), None,
                   ctypes.byref(n))
        arr = (ctypes.c_void_p * n.value)()
        self._call("cuGraphGetNodes", ctypes.c_void_p(graph), arr,
                   ctypes.byref(n))
        return list(arr[:n.value])

    def kind(self, node: int) -> int:
        t = ctypes.c_int(-1)
        self._call("cuGraphNodeGetType", ctypes.c_void_p(node),
                   ctypes.byref(t))
        return t.value

    def child(self, node: int) -> int:
        g = ctypes.c_void_p()
        self._call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node),
                   ctypes.byref(g))
        return g.value


def count_nodes(driver, graph: int, counts: Optional[Dict[str, int]] = None
                ) -> Dict[str, int]:
    """``{"kernel", "memcpy", "memset", "other"}`` node counts of
    ``graph``, a child graph's nodes counted where it stands."""
    if counts is None:
        counts = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    for node in driver.nodes(graph):
        kind = driver.kind(node)
        if kind == _CHILD_GRAPH:
            count_nodes(driver, driver.child(node), counts)
        else:
            name = _NODE_KINDS.get(kind, "other")
            counts[name] += 1
    return counts


def graph_nodes(fn, *args, **kwargs) -> Dict[str, int]:
    """The nodes of a CUDA graph captured around one call of ``fn`` after
    a warm call (which builds the kernels and fills the caches):
    :func:`count_nodes`'s counts.  The count is the call's own, whatever
    ran before it in the process.  A call that cannot be captured (a host
    sync, a copy from pageable memory) raises; nothing falls back."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_nodes captures a CUDA graph: no CUDA")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph):
            fn(*args, **kwargs)
        return count_nodes(_Driver(), graph.raw_cuda_graph())
    finally:
        graph.reset()


def count_launches(fn, *args, **kwargs) -> int:
    """The CUDA kernels one call of ``fn`` launches: the kernel nodes of
    :func:`graph_nodes`' graph."""
    return graph_nodes(fn, *args, **kwargs)["kernel"]


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

"""Placement: the port of the JAX package's ``sharding.py``, its two
parts.

**The LM's logical-axis rules** (MaxText style).  Every parameter and
cache leaf is declared with a tuple of logical axis names
(``models.params.ParamDef.axes``); a rules table per run kind maps them
to mesh axes, and ``spec_for`` checks divisibility and drops a mapping
(replicates) when the dimension does not divide the mesh axis, walking
the dims in ``PRIORITY`` order: the same declarations place on (16, 16),
(2, 16, 16) and the one-device mesh (whisper's vocab 51865 divides no 16
and is replicated).  A spec is a tuple of one entry per dim, None, an
axis name or a tuple of names, entry for entry JAX's ``PartitionSpec``;
a mesh is anything with a ``.shape`` mapping axis names to sizes (JAX's
``Mesh.shape``, an :class:`AbstractMesh`).  ``sharding_for`` gives a
:class:`NamedSharding` record, whose ``placements`` are the
``torch.distributed.tensor`` ``Shard`` / ``Replicate`` of each dim of a
``DeviceMesh``.  The LM's steps run on them in the dry run
(``launch/dryrun.py``), on fake DTensors; a real run is on one device.

**Replica-sharded REMD** (``REMDDriver.run_sharded``).  The ensemble has
two placement classes on a replica mesh (``repro_torch.launch.mesh``):

  * the engine state (positions, velocities, neighbor lists; leading
    axis R): each rank holds its contiguous block of ``B = R / n_shards``
    rows, and rows cross ranks only at the tier-2 reinit hop of one
    boundary backup row, at checkpoints and at the end of a run;
  * the control plane (assignment, rng, cycle, debt, speed, alive,
    failures, relaunches): (R,)-small or scalar, held in full on every
    rank and computed identically there.

The collectives are ``torch.distributed`` calls on the mesh's group:
``ring_all_gather`` (the counterpart of JAX's ladder-ring ``ppermute``
hops, built from ``batch_isend_irecv``), ``all_gather_rows`` and
``all_reduce_max``.  Each records its op, its shape and its bytes in
the active :class:`WireCensus` (``wire_census``): the driver opens one
per chunk, and its per-op totals are the wire ledger of the telemetry,
the torch form of the JAX package's HLO collective census.  Op names are
the HLO ones (``collective-permute``, ``all-gather``, ``all-reduce``),
so the two packages' ledgers read alike; here a chunk's census counts
the collectives it issued (K cycles' worth), where the HLO census counts
the instructions of the compiled chunk.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ensemble import Ensemble
from repro_torch.tree import tree_map

# A rule maps a logical axis name to a tuple of candidate mesh-axis groups,
# tried in order; the first whose total size divides the dimension wins.
Rules = Dict[str, Tuple[Tuple[str, ...], ...]]

# --- LM rule tables ------------------------------------------------------------
# "fsdp" axes are where ZeRO sharding happens (params over the data axis);
# "model" is the tensor-parallel axis.  On the multi-pod mesh the batch
# rides ("pod", "data").


def train_rules(multi_pod: bool) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    fsdp = batch  # ZeRO over the whole data-parallel group
    return {
        "batch": (batch,),
        "embed": (fsdp,),             # FSDP shard of the residual dim
        "vocab": (("model",),),
        "heads": (("model",),),
        "kv_heads": (("model",),),
        "mlp": (("model",),),
        "experts": (("model",),),
        "seq": ((),),                 # activations: seq replicated in train
        "layers": ((),),
        "head_dim": ((),),
        "expert_mlp": ((),),
        "lora": ((),),
        "rec_state": (("model",),),
        "conv_k": ((),),
        "capacity": ((),),
    }


def train_rules_pure_dp(multi_pod: bool) -> Rules:
    """Pure data parallelism + 2D FSDP: the batch and the ZeRO shard both
    span (data x model).  For archs whose head count does not divide the
    16-way model axis (phi3 40 heads, whisper 12): no tensor parallelism,
    the scores stay batch-sharded."""
    batch = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "batch": (batch,),
        "embed": (batch,),            # ZeRO over all devices
        "vocab": ((),),
        "heads": ((),),
        "kv_heads": ((),),
        "mlp": ((),),
        "experts": ((),),
        "seq": ((),),
        "layers": ((),),
        "head_dim": ((),),
        "expert_mlp": ((),),
        "lora": ((),),
        "rec_state": ((),),
        "conv_k": ((),),
        "capacity": ((),),
    }


def pick_train_rules(n_heads: int, multi_pod: bool):
    """(rules, activation batch axes, model axis or None) for this arch."""
    tp = 16
    if n_heads % tp == 0:
        batch = ("pod", "data") if multi_pod else ("data",)
        return train_rules(multi_pod), batch, "model"
    batch = ("pod", "data", "model") if multi_pod else ("data", "model")
    return train_rules_pure_dp(multi_pod), batch, None


def serve_rules(multi_pod: bool) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": (batch,),
        "embed": ((),),               # weights replicated over data in serve
        "vocab": (("model",),),
        "heads": (("model",),),
        "kv_heads": (("model",),),
        # head_dim fallback: the caches and projections of archs whose
        # kv_heads do not divide TP shard the head_dim instead
        "head_dim": (("model",),),
        "kv_seq": ((),),
        "mlp": (("model",),),
        "experts": (("model",),),
        "seq": ((),),
        "layers": ((),),
        "expert_mlp": ((),),
        "lora": (("model",),),        # MLA's latent cache shards on the rank
        "rec_state": (("model",),),
        "conv_k": ((),),
        "capacity": ((),),
    }


def seqshard_serve_rules(multi_pod: bool) -> Rules:
    """Long-context decode (batch 1): the batch axis unmapped."""
    rules = dict(serve_rules(multi_pod))
    rules["batch"] = ((),)
    return rules


def serve_rules_for(cfg, multi_pod: bool, decode: bool) -> Rules:
    """Per-arch serving rules.  Where kv_heads do not divide the 16-way
    model axis (mistral 8, phi3 10, whisper 12, nemotron 8, internvl 8,
    MQA 1): in decode q shards on head_dim as the kv does (a partial dot
    and a small reduction instead of gathering the cache); in prefill the
    (small) kv projections are replicated and q's heads stay sharded."""
    rules = dict(serve_rules(multi_pod))
    tp = 16
    if cfg.n_kv_heads % tp != 0:
        if decode:
            rules["heads"] = ((),)          # q shards on head_dim instead
        else:
            rules["head_dim"] = ((),)       # replicate the kv projections
    return rules


# --- the engine ----------------------------------------------------------------

# Dims earlier in this list take mesh axes first: the KV cache prefers
# kv_heads -> model where they divide, and falls back to another dim where
# the arch's head count does not.
PRIORITY = ("batch", "heads", "kv_heads", "experts", "vocab", "mlp",
            "rec_state", "lora", "embed", "head_dim", "kv_head_dim",
            "kv_seq", "seq")

Spec = Tuple[Optional[object], ...]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, no devices: ``shape`` maps each
    axis name to its size, in the mesh's axis order."""
    axis_sizes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axis_sizes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axis_sizes)


def _axis_size(mesh, group: Tuple[str, ...]) -> int:
    size = 1
    for ax in group:
        size *= mesh.shape[ax]
    return size


def spec_for(mesh, rules: Rules, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
    """Resolve logical axes to a spec, honouring divisibility.  Dims are
    visited in PRIORITY order (then by position), so a lower-priority dim
    only takes a mesh axis a higher-priority sibling could not use."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    order = sorted(
        range(len(shape)),
        key=lambda i: (PRIORITY.index(logical_axes[i])
                       if logical_axes[i] in PRIORITY else len(PRIORITY), i))
    used: set = set()
    out: list = [None] * len(shape)
    for i in order:
        name, dim = logical_axes[i], shape[i]
        placed: Optional[Tuple[str, ...]] = None
        if name is not None:
            for group in rules.get(name, ((),)):
                group = tuple(ax for ax in group if ax in mesh.shape)
                if not group:
                    continue
                if any(ax in used for ax in group):
                    continue
                if dim % _axis_size(mesh, group) == 0:
                    placed = group
                    break
        if placed:
            used.update(placed)
            out[i] = placed if len(placed) > 1 else placed[0]
    return tuple(out)


def _names(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None, one name, or the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Spec, mesh_dim_names: Sequence[str]) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on a device
    mesh with dims ``mesh_dim_names``: ``Shard(i)`` on each mesh dim that
    entry i names, ``Replicate()`` on the others.  A dim named
    "pod+data" is the two axes flattened, the first major: it shards
    entry i when entry i holds both."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {ax: i for i, entry in enumerate(spec) for ax in _names(entry)}
    out = []
    for n in mesh_dim_names:
        dims = {dim_of.get(ax) for ax in n.split("+")}
        if len(dims) > 1:
            raise ValueError(f"spec {spec} splits the flattened mesh dim "
                             f"{n!r}")
        d = dims.pop()
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: the mesh's axis sizes and the spec."""
    mesh_shape: Tuple[Tuple[str, int], ...]
    spec: Spec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of an array of ``shape``."""
        sizes = dict(self.mesh_shape)
        out = []
        for dim, entry in zip(shape, tuple(self.spec)
                              + (None,) * (len(shape) - len(self.spec))):
            n = 1
            for ax in _names(entry):
                n *= sizes[ax]
            out.append(dim // n)
        return tuple(out)

    def placements(self, device_mesh) -> tuple:
        """``Shard`` / ``Replicate`` per dim of ``device_mesh`` (a
        ``torch.distributed.device_mesh.DeviceMesh`` with dim names)."""
        return placements_for(self.spec, device_mesh.mesh_dim_names)


def _mesh_shape(mesh) -> Tuple[Tuple[str, int], ...]:
    shape: Mapping[str, int] = mesh.shape
    return tuple((n, int(shape[n])) for n in shape)


def sharding_for(mesh, rules: Rules, logical_axes, shape) -> NamedSharding:
    return NamedSharding(_mesh_shape(mesh),
                         spec_for(mesh, rules, logical_axes, shape))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(mesh, rules: Rules, spec_tree, shape_tree):
    """A tree of logical-axes tuples and a tree of shapes (nested dicts of
    the same keys) to a tree of :class:`NamedSharding`."""
    if _is_axes(spec_tree):
        return sharding_for(mesh, rules, spec_tree, shape_tree)
    return {k: tree_shardings(mesh, rules, spec_tree[k], shape_tree[k])
            for k in spec_tree}


def single_device_mesh() -> AbstractMesh:
    """A one-device mesh with the production axis names."""
    return AbstractMesh((("data", 1), ("model", 1)))

# dist.all_gather_single replaces all_gather_into_tensor in newer releases
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class WireCensus:
    """The collectives issued while the census is open: one entry per
    collective, ``(op, shape, bytes)`` with the bytes one rank puts on
    the wire (a ring hop's block, an all-gather's output, an all-reduce's
    tensor)."""

    def __init__(self):
        self.calls: List[Tuple[str, tuple, int]] = []

    def budget(self) -> Dict[str, Dict[str, int]]:
        """``{op: {"count": n, "bytes": total}}``, the ledger's form."""
        out: Dict[str, Dict[str, int]] = {}
        for op, _, nbytes in self.calls:
            b = out.setdefault(op, {"count": 0, "bytes": 0})
            b["count"] += 1
            b["bytes"] += nbytes
        return out


# the census open now (``wire_census``), else None
_CENSUS: contextvars.ContextVar = contextvars.ContextVar("census",
                                                         default=None)


@contextlib.contextmanager
def wire_census():
    """Record every collective issued inside the block."""
    census = WireCensus()
    token = _CENSUS.set(census)
    try:
        yield census
    finally:
        _CENSUS.reset(token)


def _note(op: str, t: torch.Tensor) -> None:
    census = _CENSUS.get()
    if census is not None:
        census.calls.append((op, tuple(t.shape),
                             t.numel() * t.element_size()))


# --- collectives -------------------------------------------------------------


def ring_shift(x: torch.Tensor, mesh, reverse: bool = False) -> torch.Tensor:
    """One hop of the ladder ring: each shard sends ``x`` to its upper
    neighbor (``reverse``: its lower one) and returns the block it
    received from the other side.  Identity on one shard."""
    n = mesh.n_shards
    if n == 1:
        return x
    step = -1 if reverse else 1
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (mesh.rank + step) % n, mesh.group),
           dist.P2POp(dist.irecv, recv, (mesh.rank - step) % n, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _note("collective-permute", send)
    return recv


def ring_all_gather(x: torch.Tensor, mesh,
                    reverse: bool = False) -> torch.Tensor:
    """Every shard's block, stacked in global shard order, from
    ``n_shards - 1`` ladder-ring hops and no all-gather: returns
    ``(n_shards,) + x.shape`` (``x[None]`` on one shard), so
    ``out.reshape(-1, ...)`` is the full replica-ordered row, bitwise: the
    blocks are copied, never reduced.  Each hop carries one block."""
    n = mesh.n_shards
    if n == 1:
        return x[None]
    blocks = [None] * n
    blocks[mesh.rank] = x
    blk = x
    step = 1 if reverse else -1
    for t in range(1, n):
        blk = ring_shift(blk, mesh, reverse)
        # after t hops the block in hand started t shards back
        blocks[(mesh.rank + step * t) % n] = blk
    return torch.stack(blocks)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The shards' (B, ...) blocks concatenated in shard order, (R, ...)."""
    src = x.contiguous()
    out = torch.empty((mesh.n_shards * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_flat(out, src, group=mesh.group)
    _note("all-gather", out)
    return out


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise max over the shards (exact in any order)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    _note("all-reduce", out)
    return out


# --- engine calls on a block -------------------------------------------------

# (mesh, R) of the engine call on one rank's block running now
_ENSEMBLE: contextvars.ContextVar = contextvars.ContextVar(
    "ensemble", default=None)


@contextlib.contextmanager
def ensemble_scope(mesh, n_replicas: int):
    """Mark an engine call on one rank's block of an ensemble of
    ``n_replicas`` on ``mesh``.  Inside it a kernel that sizes its
    per-replica split by the stack sizes it by the ensemble
    (:func:`ensemble_rows`), and a decision the engine takes for the
    whole stack (the neighbor list's collective rebuild) is taken for the
    whole ensemble (:func:`ensemble_any`): a replica's bits are then
    those of the unsharded call."""
    token = _ENSEMBLE.set((mesh, n_replicas))
    try:
        yield
    finally:
        _ENSEMBLE.reset(token)


def ensemble_rows():
    """The ensemble's replica count inside :func:`ensemble_scope`, else
    None."""
    scope = _ENSEMBLE.get()
    return None if scope is None else scope[1]


def ensemble_any(flag: torch.Tensor) -> torch.Tensor:
    """``flag`` (a bool tensor, the stack's own ``any``) or-ed over the
    ranks of the mesh in scope; unchanged outside a sharded call."""
    scope = _ENSEMBLE.get()
    if scope is None:
        return flag
    return all_reduce_max(flag.to(torch.uint8), scope[0]).to(torch.bool)


# --- placement ---------------------------------------------------------------


def block_slice(mesh, n_replicas: int) -> slice:
    """This rank's rows ``[rank * B, (rank + 1) * B)``."""
    b = n_replicas // mesh.n_shards
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def ensemble_shardings(mesh, ens: Ensemble) -> Ensemble:
    """Which rows this rank holds, as an ``Ensemble`` of specs: each state
    leaf the slice of its block, each control-plane field None (held in
    full).  ``load_checkpoint(..., shardings=)`` takes the same specs."""
    rows = block_slice(mesh, ens.assignment.shape[0])
    return Ensemble(state=tree_map(lambda _: rows, ens.state),
                    **{f: None for f in Ensemble._fields if f != "state"})


def shard_state(state, mesh, n_replicas: int):
    """This rank's block of a state tree: full (R, ...) leaves are sliced,
    block (B, ...) leaves kept as they are."""
    rows = block_slice(mesh, n_replicas)
    b = rows.stop - rows.start

    def one(x):
        if x.shape[0] == n_replicas:
            return x[rows]
        if x.shape[0] == b:
            return x
        raise ValueError(f"a state leaf of {x.shape[0]} rows is neither "
                         f"the ensemble's {n_replicas} nor a block of {b}")
    return tree_map(one, state)


def shard_ensemble(ens: Ensemble, mesh) -> Ensemble:
    """The ensemble with its state cut to this rank's block (the control
    plane stays whole)."""
    return ens._replace(state=shard_state(ens.state, mesh,
                                          ens.assignment.shape[0]))


def gather_state(state, mesh):
    """The whole state from the shards' blocks (every rank gets it)."""
    if mesh.n_shards == 1:
        return state
    return tree_map(lambda x: all_gather_rows(x, mesh), state)


def gather_ensemble(ens: Ensemble, mesh) -> Ensemble:
    """Inverse of :func:`shard_ensemble`, on every rank."""
    return ens._replace(state=gather_state(ens.state, mesh))

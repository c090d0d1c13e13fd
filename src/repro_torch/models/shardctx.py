"""Ambient activation sharding: the port of the JAX package's
``repro/models/shardctx.py``.

Model code is mesh-agnostic; a launcher opts in to explicit activation
placements (batch axes + vocab axis) with ``set_activation_sharding``.
Each ``constrain_*`` returns its input unchanged unless that was called
and the input is a ``torch.distributed.tensor.DTensor``: then it
redistributes the DTensor to the placements the JAX package's
``with_sharding_constraint`` names, over the DTensor's own device mesh
(``sharding.placements_for``; mesh dims the spec does not name are
replicated).  Plain tensors, on the card or the CPU, pass through as
they are: nothing here launches or allocates then.

``state_layout`` places the decode state a prefill creates
(``zero_state``) as the JAX package's dry run pins its prefill's output
to the layout decode consumes; outside it, or on plain tensors, the
state is plain zeros.

The rest route an op of the model code on DTensors (the dry run's,
``launch/dryrun.py``) as XLA partitions it, where eager DTensor would
place a product by its communication alone (``weight_at_use``,
``constrain_vocab_table``, ``label_logit``), flatten or split split dims
(``attend_locally``, ``splittable``, ``merged``), find no strategy
(``log_sigmoid``'s backward; in some releases ``index_copy_``,
``var_mean``), propagate placements op by op through a time loop
(``recur_locally``), or gather the batch whole for the MoE's token
gathers (``rows_locally``) and expert products (``experts_locally``).
On plain tensors each is the plain op.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

_BATCH_AXES: Optional[Tuple[str, ...]] = None
_MODEL_AXIS: Optional[str] = None
_AXIS_SIZES: dict = {}
_STATE_LAYOUT: Any = None


def set_activation_sharding(batch_axes: Optional[Tuple[str, ...]],
                            model_axis: Optional[str] = "model",
                            axis_sizes: Optional[dict] = None) -> None:
    """``axis_sizes`` ({axis: size}) decides divisibility, as in the JAX
    package, where the abstract mesh is not visible while tracing."""
    global _BATCH_AXES, _MODEL_AXIS, _AXIS_SIZES
    _BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _MODEL_AXIS = model_axis
    _AXIS_SIZES = dict(axis_sizes or {})


def clear() -> None:
    global _STATE_LAYOUT
    set_activation_sharding(None, None, None)
    _STATE_LAYOUT = None


@contextlib.contextmanager
def state_layout(layout):
    """Inside the block, ``zero_state`` places each leaf as ``layout``
    (a tree of ``params.ShapeDtypeStruct`` with a
    ``sharding.NamedSharding``, the decode state's) says."""
    global _STATE_LAYOUT
    old, _STATE_LAYOUT = _STATE_LAYOUT, layout
    try:
        yield
    finally:
        _STATE_LAYOUT = old


def zero_state(defs, like: torch.Tensor):
    """Zeros for a tree of ``ParamDef``s on ``like``'s device; DTensors on
    ``like``'s mesh, placed by the ``state_layout`` in force, when
    ``like`` is a DTensor and a layout is set."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    if _STATE_LAYOUT is None or not isinstance(like, DTensor):
        return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                              device=like.device), defs)
    mesh, shard = like.device_mesh, like.to_local()

    def one(d, sds):
        # a shard like ``like``'s: a fake one when ``like``'s is fake
        local = shard.new_zeros(sds.sharding.shard_shape(d.shape),
                                dtype=d.dtype)
        return DTensor.from_local(local, mesh, sds.sharding.placements(mesh),
                                  run_check=False, shape=torch.Size(d.shape),
                                  stride=contiguous_stride(d.shape))
    return tree_map(one, defs, _STATE_LAYOUT)


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``x`` redistributed to ``spec`` (one entry per dim: None, an axis
    name or a tuple of names) when it is a DTensor, else ``x``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding import placements_for
    mesh = x.device_mesh
    return x.redistribute(mesh, placements_for(spec, mesh.mesh_dim_names))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 to the batch axes, replicate the rest; where the batch
    does not divide them, only sum a DTensor's partial placements (an
    embedding of a vocab-split table is one, whose masked sum DTensor
    reduces only once)."""
    if _BATCH_AXES is None or getattr(x, "ndim", 0) < 1:
        return x
    if x.shape[0] % _prod_size() != 0:
        return _reduced(x)
    return _constrain(x, (_BATCH_AXES,) + (None,) * (x.ndim - 1))


def _reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial placements summed (replicated), its splits
    kept; anything else unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """(B, S, V): batch over the data axes, vocab over the model axis."""
    if _BATCH_AXES is None or x.ndim != 3:
        return x
    if x.shape[0] % _prod_size() != 0:
        return x
    return _constrain(x, (_BATCH_AXES, None, _MODEL_AXIS))


def weight_at_use(w: torch.Tensor) -> torch.Tensor:
    """A weight at its product: its FSDP shards (any split over the batch
    axes) gathered, its other splits kept, as ZeRO gathers a layer's
    weights before using them (XLA places the product from the
    activations' constraints; DTensor picks a product's placement by its
    communication alone, and would rather reduce full activations)."""
    from torch.distributed.tensor import DTensor, Replicate
    if _BATCH_AXES is None or not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    batch = set(_BATCH_AXES)
    placements = [Replicate() if p.is_shard()
                  and set(name.split("+")) <= batch else p
                  for name, p in zip(mesh.mesh_dim_names, w.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(mesh, placements)


def constrain_vocab_table(w: torch.Tensor) -> torch.Tensor:
    """The unembedding (d, V) at its use: d's FSDP shards gathered, V
    over the model axis where it divides it, so the logits' product
    runs on each rank's batch rows and vocab shard, the placement
    ``constrain_logits`` asks of its output (XLA places the product from
    that constraint; DTensor picks a product's placement by its
    communication alone)."""
    if _BATCH_AXES is None or w.ndim != 2:
        return w
    msize = _axis_len(_MODEL_AXIS)
    vocab = _MODEL_AXIS if msize > 1 and w.shape[1] % msize == 0 else None
    return _constrain(w, (None, vocab))


def label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(..., V) logits, (...) labels -> each row's label logit.  A plain
    tensor gathers it; on a DTensor the row's sum against a one-hot of
    the label, as the JAX package contracts it (every other term a zero,
    so the sum is the label logit exactly): the one-hot is placed as the
    vocab dim is, a partial sum per shard, where a gather's placement
    would need the labels' values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    labels = constrain_batch(labels.long())
    mesh = logits.device_mesh
    ids = DTensor.from_local(
        torch.arange(logits.shape[-1], device=logits.to_local().device),
        mesh, [Replicate()] * mesh.ndim, run_check=False)
    last = logits.ndim - 1
    ids = ids.redistribute(mesh, [
        Shard(0) if p.is_shard() and getattr(p, "dim", None) == last
        else Replicate() for p in logits.placements])
    return torch.sum(logits * (ids == labels[..., None]), -1)


def constrain_seq_parallel_q(q: torch.Tensor,
                             n_heads_total: int) -> torch.Tensor:
    """q (B, S, H, D): when the head count does not divide the model axis,
    shard the query sequence over it (context-parallel attention)."""
    if _BATCH_AXES is None or q.ndim != 4:
        return q
    msize = _axis_len(_MODEL_AXIS)
    if msize <= 1 or n_heads_total % msize == 0:
        return q
    if q.shape[1] % msize != 0:
        return q
    return _constrain(q, (_BATCH_AXES, _MODEL_AXIS, None, None))


def constrain_qchunk(qc: torch.Tensor, n_heads_total: int) -> torch.Tensor:
    """qc (B, c, G, Hg, D), a chunk of ``chunked_attention``'s queries:
    for head counts that do not divide the model axis, the chunk dim over
    the model axis."""
    if _BATCH_AXES is None or qc.ndim != 5:
        return qc
    msize = _axis_len(_MODEL_AXIS)
    if msize <= 1 or n_heads_total % msize == 0:
        return qc
    if qc.shape[1] % msize != 0 or qc.shape[0] % _prod_size() != 0:
        return qc
    return _constrain(qc, (_BATCH_AXES, _MODEL_AXIS, None, None, None))


def constrain_expert_weight(w: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Expert weights (E, d_in, d_out) at their use site: experts over the
    model axis (where they divide it), the other dims gathered."""
    if _BATCH_AXES is None or w.ndim != 3:
        return w
    msize = _axis_len(_MODEL_AXIS)
    if msize <= 1:
        return w
    e_spec = _MODEL_AXIS if n_experts % msize == 0 else None
    return _constrain(w, (e_spec, None, None))


def index_copy_(dst: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``dst.index_copy_(dim, index, src)``; a DTensor ``dst`` not split
    along ``dim`` is written shard by shard (``src`` placed as ``dst``,
    the index whole on every rank), which every DTensor release runs
    (some have no strategy for ``index_copy_``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(dst, DTensor) or any(
            not p.is_replicate() and getattr(p, "dim", None) in (None, dim)
            for p in dst.placements):
        return dst.index_copy_(dim, index, src)
    mesh = dst.device_mesh
    if isinstance(index, DTensor):
        index = index.full_tensor()
    if isinstance(src, DTensor):
        src = src.redistribute(mesh, dst.placements).to_local()
    dst.to_local().index_copy_(dim, index, src)
    return dst


def var_mean(x: torch.Tensor):
    """``torch.var_mean(x, -1, correction=0, keepdim=True)``; on a
    DTensor the mean and then the mean of the squared deviation, ops
    every DTensor release places (some have no strategy for
    ``var_mean``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.var_mean(x, -1, correction=0, keepdim=True)
    mu = torch.mean(x, -1, keepdim=True)
    dev = x - mu
    return torch.mean(dev * dev, -1, keepdim=True), mu


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid(x)``; on a DTensor the op runs on each rank's shard
    (any partial sum reduced first), and so does its backward: it is
    elementwise, and DTensor has no strategy for its backward
    (``log_sigmoid_backward``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    x = _reduced(x)
    out = F.logsigmoid(_ContiguousGrad.apply(x.to_local())).contiguous()
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=contiguous_stride(x.shape))


def attend_locally(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)``, an attention over (B, S, H, D) queries and
    (B, T, G, D) keys and values.  On DTensors split over nothing but the
    batch (dim 0) and the heads (dim 2) it runs on each rank's shards, k
    and v placed as q: the attention is independent across those dims,
    as XLA partitions it, and DTensor would otherwise flatten the split
    dims of its products (which some releases refuse).  Where q's heads
    are split over more ranks than divide G, each kv head is first
    repeated H / G times (JAX's ``jnp.repeat`` of the GQA expansion), so
    every rank holds its own query heads' kv heads.  Anything else goes
    through ``fn`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    mesh, placements = q.device_mesh, q.placements
    if not all(p.is_replicate() or (type(p) is Shard and p.dim in (0, 2))
               for p in placements):
        return fn(q, k, v, **kw)
    n = _split_count(q, 2)
    h, g = q.shape[2], k.shape[2]
    if g % n:
        whole = [Replicate()] * mesh.ndim
        k, v = (torch.repeat_interleave(t.redistribute(mesh, whole), h // g,
                                        dim=2) for t in (k, v))
    k, v = (t.redistribute(mesh, placements) for t in (k, v))
    local = {name: (a.to_local() if isinstance(a, DTensor) else a)
             for name, a in kw.items()}
    # contiguous, as the DTensor's strides below say; the gradients of the
    # shards contiguous too, as their DTensors' strides say
    ql, kl, vl = (_ContiguousGrad.apply(t.to_local()) for t in (q, k, v))
    out = fn(ql, kl, vl, **local).contiguous()
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def rows_locally(fn, *args):
    """``fn(*args)``, a function independent across the batch rows (dim 0
    of every tensor argument and output).  Where the first argument is a
    DTensor it runs on each rank's rows, as XLA partitions the JAX
    package's ``vmap`` over the rows: every DTensor argument keeps the
    first's batch split (where the split divides B) and is whole along
    every other mesh dim, and each output is placed as that.  Eager
    DTensor would place an index op on the rows (the MoE's token
    gather) by its own strategy, and gathers the batch whole.  Anything
    else: ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate
    first = args[0]
    if not isinstance(first, DTensor):
        return fn(*args)
    mesh = first.device_mesh
    split = (_split_count(first, 0)
             if first.shape[0] % _split_count(first, 0) == 0 else 1)
    placements = [p if split > 1 and p.is_shard()
                  and getattr(p, "dim", None) == 0 else Replicate()
                  for p in first.placements]
    local = [_ContiguousGrad.apply(a.redistribute(mesh, placements)
                                   .to_local())
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local)

    def placed(t):
        t = t.contiguous()
        shape = torch.Size((t.shape[0] * split,) + tuple(t.shape[1:]))
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=contiguous_stride(shape))
    return tuple(map(placed, out)) if isinstance(out, tuple) else placed(out)


def experts_locally(fn, buf: torch.Tensor, *weights: torch.Tensor
                    ) -> torch.Tensor:
    """``fn(buf, *weights)``: ``buf`` (B, E, cap, D) an expert dispatch
    buffer, each weight (E, ...), the output (B, E, cap, D').  On a
    DTensor ``buf`` it runs on each rank's batch rows and experts, as
    XLA partitions the JAX package's expert einsums, vmapped over the
    batch rows: ``buf`` keeps its batch split where the split divides B,
    takes the weights' expert split (their dim 0's mesh dims) and is
    whole along every other mesh dim, and the output is placed as
    ``buf`` then is.  Eager DTensor merges the batch into the slots for
    the products' ``bmm`` and gathers it whole on every data rank.
    Anything else: ``fn(buf, *weights)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(buf, DTensor):
        return fn(buf, *weights)
    mesh = buf.device_mesh
    w0 = weights[0]
    placements = []
    for i, p in enumerate(buf.placements):
        wp = w0.placements[i] if isinstance(w0, DTensor) else Replicate()
        if type(wp) is Shard and wp.dim == 0:
            placements.append(Shard(1))
        elif type(p) is Shard and p.dim == 0 \
                and buf.shape[0] % _split_count(buf, 0) == 0:
            placements.append(p)
        else:
            placements.append(Replicate())
    local = _ContiguousGrad.apply(buf.redistribute(mesh, placements)
                                  .to_local())
    ws = []
    for w in weights:
        if isinstance(w, DTensor):
            wp = [Shard(0) if type(p) is Shard and p.dim == 1
                  else Replicate() for p in placements]
            w = _ContiguousGrad.apply(w.redistribute(mesh, wp).to_local())
        ws.append(w)
    out = fn(local, *ws).contiguous()
    shape = torch.Size(tuple(buf.shape[:3]) + (out.shape[3],))
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def recur_locally(loop, z: torch.Tensor, r: torch.Tensor):
    """``loop(z, r)``: a recurrence over ``z`` (S, H, B, ...) with
    per-head weights ``r`` (H, ...), returning ``h`` (H, S, B, ...) and a
    final state ``{name: (H, B, ...)}``.  On a DTensor ``z`` the loop
    runs on each rank's shards, as XLA partitions its scan: the
    recurrence is independent across heads and batch, so ``z`` keeps its
    splits of those dims where they divide them (``r``'s heads split as
    ``z``'s), every other split or partial sum of ``z`` is gathered, and
    the outputs are placed as the kept splits say.  Each step then runs
    on plain shards, where eager DTensor would propagate the placements
    of every op of every step.  ``to_local`` and ``from_local`` are
    differentiable, so training and remat run through it, and the
    probe of ``launch/op_analysis`` counts each step's products on the
    shards.  Anything else: ``loop(z, r)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(z, DTensor):
        return loop(z, r)
    mesh = z.device_mesh
    kept = [d for d in (1, 2) if z.shape[d] % _split_count(z, d) == 0]
    zp = [p if type(p) is Shard and p.dim in kept else Replicate()
          for p in z.placements]
    zl = _ContiguousGrad.apply(z.redistribute(mesh, zp).to_local())
    if isinstance(r, DTensor):
        rp = [Shard(0) if p.is_shard() and p.dim == 1 else Replicate()
              for p in zp]
        r = _ContiguousGrad.apply(r.redistribute(mesh, rp).to_local())
    h, state = loop(zl, r)
    s, n_heads, b = z.shape[:3]

    def placed(local, dims, shape):
        # z's kept dims 1 (heads) and 2 (batch) at ``dims`` of the output
        shape = torch.Size(shape)
        return DTensor.from_local(
            local.contiguous(), mesh,
            [Shard(dims[p.dim]) if p.is_shard() else Replicate()
             for p in zp],
            run_check=False, shape=shape, stride=contiguous_stride(shape))
    h = placed(h, {1: 0, 2: 2}, (n_heads, s, b) + tuple(h.shape[3:]))
    state = {k: placed(v, {1: 0, 2: 1}, (n_heads, b) + tuple(v.shape[2:]))
             for k, v in state.items()}
    return h, state


def _split_count(x, dim: int) -> int:
    """The number of ranks a DTensor's dim ``dim`` is split over."""
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard() and getattr(p, "dim", None) == dim:
            n *= x.device_mesh.size(i)
    return n


def _whole_for(x, dim: int, outer: int):
    """A DTensor's placements with dim ``dim`` made whole where it is
    split over ranks that do not divide ``outer``, or None where they
    do."""
    from torch.distributed.tensor import Replicate
    n = _split_count(x, dim)
    if n <= 1 or outer % n == 0:
        return None
    return tuple(Replicate() if p.is_shard()
                 and getattr(p, "dim", None) == dim else p
                 for p in x.placements)


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` ready for its dim ``dim`` to be split with ``outer`` as the
    leading factor: a DTensor whose dim is split over ranks that do not
    divide ``outer`` gets that dim whole (DTensor cannot keep such a
    split through the reshape); anything else unchanged."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = _whole_for(x, dim, outer)
    return x if placements is None else _Whole.apply(x, placements)


def merged(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` just after a reshape merged its dim ``dim`` from ``outer``
    and an inner factor: ``splittable`` for the backward.  On a DTensor
    the identity whose gradient gets that dim whole where it is split
    over ranks that do not divide ``outer``, since the reshape's backward
    splits the dim again (a product with a weight split 256 or 512 ways
    hands the gradient such a split); anything else unchanged."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _WholeGrad.apply(x, dim, outer)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


class _Whole(torch.autograd.Function):
    """A redistribution whose backward keeps the gradient as it comes:
    the gradient of a dim made whole for a split stays whole, so the
    product that made the dim sees it whole in its backward too (the
    default backward would split it again, and the weight's gradient
    then meets the same split)."""

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _WholeGrad(torch.autograd.Function):
    """The identity; its gradient's dim made whole as ``splittable``
    makes a forward's."""

    @staticmethod
    def forward(ctx, x, dim, outer):
        ctx.dim, ctx.outer = dim, outer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        placements = _whole_for(grad, ctx.dim, ctx.outer)
        if placements is not None:
            grad = grad.redistribute(grad.device_mesh, placements)
        return grad, None, None


def _axis_len(axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return _AXIS_SIZES.get(axis, 1)


def _prod_size() -> int:
    size = 1
    for ax in _BATCH_AXES or ():
        size *= _AXIS_SIZES.get(ax, 1)
    return size

"""The LM's placements: the port's ``sharding`` rule tables and
``spec_for``, ``models/params.py``'s abstract trees,
``launch/steps.py``'s sharding helpers, ``models/registry.py``'s
``input_specs`` and ``applicable``, and ``models/shardctx.py``, against
the JAX package's, on the CPU.  Definitions only: nothing is allocated
at full width.

  * for every architecture at its full config, the spec of every leaf of
    ``param_defs``, ``make_train_state_defs`` and ``decode_state_defs``
    at each ``SHAPE_CELLS`` cell's batch and length equals JAX's
    ``PartitionSpec`` entry by entry, under ``pick_train_rules``,
    ``serve_rules_for`` (decode and prefill) and ``seqshard_serve_rules``,
    on the meshes {data: 1, model: 1}, {data: 16, model: 16} and {pod: 2,
    data: 16, model: 16} (mesh stand-ins with a ``.shape`` mapping, as
    ``tests/test_substrate.py`` uses);
  * on JAX's one-device mesh, ``abstract_params``, ``param_shardings``,
    ``abstract_train_state``, ``train_state_shardings``,
    ``abstract_params_for_serve``, ``abstract_decode_state`` and
    ``batch_shardings`` of ``input_specs`` give JAX's shapes, dtypes and
    specs;
  * ``input_specs`` and ``applicable`` equal JAX's for each arch x cell;
  * the cases of ``tests/test_substrate.py``'s rule-engine tests;
  * ``shard_shape``; ``placements`` on a one-rank gloo ``DeviceMesh``
    ("data", "model"); every ``constrain_*`` is the identity on plain
    tensors, set or unset, and on a DTensor while unset, and once set
    redistributes a DTensor to the spec's placements.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import config as j_config
from repro import sharding as j_shd
from repro.launch import steps as j_steps
from repro.models import params as j_params
from repro.models import registry as j_registry
from repro_torch import config
from repro_torch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import params as P
from repro_torch.models import registry, shardctx
from repro_torch.tree import tree_paths

MESHES = {"1x1": ({"data": 1, "model": 1}, False),
          "16x16": ({"data": 16, "model": 16}, False),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, True)}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _rule_tables(jc, tc, multi_pod):
    """(name, JAX rules, port rules) for the four tables."""
    return (("train", j_shd.pick_train_rules(jc.n_heads, multi_pod)[0],
             shd.pick_train_rules(tc.n_heads, multi_pod)[0]),
            ("serve_decode", j_shd.serve_rules_for(jc, multi_pod, True),
             shd.serve_rules_for(tc, multi_pod, True)),
            ("serve_prefill", j_shd.serve_rules_for(jc, multi_pod, False),
             shd.serve_rules_for(tc, multi_pod, False)),
            ("seqshard", j_shd.seqshard_serve_rules(multi_pod),
             shd.seqshard_serve_rules(multi_pod)))


def _trees(arch):
    """(name, JAX defs, port defs) at the full config."""
    jc, tc = j_registry.get_config(arch), registry.get_config(arch)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    out = [("params", jlm.param_defs(), tlm.param_defs()),
           ("train_state", j_steps.make_train_state_defs(jlm),
            steps.make_train_state_defs(tlm))]
    for cell in config.SHAPE_CELLS:
        out.append((f"decode_state@{cell.name}",
                    jlm.decode_state_defs(cell.global_batch, cell.seq_len),
                    tlm.decode_state_defs(cell.global_batch, cell.seq_len)))
    return jc, tc, out


def _pairs(jdefs, tdefs):
    want = jax.tree_util.tree_leaves_with_path(jdefs, is_leaf=j_params.is_def)
    got = tree_paths(tdefs)
    assert [tuple(k.key for k in p) for p, _ in want] == [p for p, _ in got]
    return [(tpath, w, g) for (_, w), (tpath, g) in zip(want, got)]


def test_rule_tables_and_cells_as_jax():
    for multi_pod in (False, True):
        assert shd.train_rules(multi_pod) == j_shd.train_rules(multi_pod)
        assert shd.train_rules_pure_dp(multi_pod) == \
            j_shd.train_rules_pure_dp(multi_pod)
        assert shd.serve_rules(multi_pod) == j_shd.serve_rules(multi_pod)
        assert shd.seqshard_serve_rules(multi_pod) == \
            j_shd.seqshard_serve_rules(multi_pod)
        for n_heads in (12, 16, 40, 48, 96):
            got = shd.pick_train_rules(n_heads, multi_pod)
            want = j_shd.pick_train_rules(n_heads, multi_pod)
            assert got == want
    assert shd.PRIORITY == j_shd.PRIORITY
    assert [dataclasses.asdict(c) for c in config.SHAPE_CELLS] == \
        [dataclasses.asdict(c) for c in j_config.SHAPE_CELLS]


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_spec_for_every_leaf_as_jax(arch):
    jc, tc, trees = _trees(arch)
    n = 0
    for mname, (shape, multi_pod) in MESHES.items():
        mesh = FakeMesh(shape)
        for rname, jrules, trules in _rule_tables(jc, tc, multi_pod):
            for tname, jdefs, tdefs in trees:
                for path, w, g in _pairs(jdefs, tdefs):
                    assert (g.shape, g.axes) == (w.shape, w.axes), path
                    want = tuple(j_shd.spec_for(mesh, jrules, w.axes,
                                                w.shape))
                    got = shd.spec_for(mesh, trules, g.axes, g.shape)
                    assert got == want, (mname, rname, tname, path)
                    n += 1
    assert n > 0


def _spec(sharding):
    return tuple(sharding.spec)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_abstract_trees_on_one_device_as_jax(arch):
    """The abstract trees on JAX's one-device mesh and on its stand-in:
    shapes, dtypes and specs leaf for leaf."""
    jc, tc = j_registry.get_config(arch), registry.get_config(arch)
    jlm, tlm = j_registry.build(jc), registry.build(tc)
    jmesh, tmesh = j_shd.single_device_mesh(), shd.single_device_mesh()
    assert tmesh.shape == dict(jmesh.shape)
    jrules, _, _ = j_shd.pick_train_rules(jc.n_heads, False)
    trules, _, _ = shd.pick_train_rules(tc.n_heads, False)
    srules = (j_shd.serve_rules_for(jc, False, True),
              shd.serve_rules_for(tc, False, True))
    cases = (
        (j_params.abstract_params(jlm.param_defs(), jmesh, jrules),
         P.abstract_params(tlm.param_defs(), tmesh, trules)),
        (j_params.param_shardings(jlm.param_defs(), jmesh, jrules),
         P.param_shardings(tlm.param_defs(), tmesh, trules)),
        (j_steps.abstract_train_state(jlm, jmesh, jrules),
         steps.abstract_train_state(tlm, tmesh, trules)),
        (j_steps.train_state_shardings(jlm, jmesh, jrules),
         steps.train_state_shardings(tlm, tmesh, trules)),
        (j_steps.abstract_params_for_serve(jlm, jmesh, srules[0]),
         steps.abstract_params_for_serve(tlm, tmesh, srules[1])),
        (j_steps.abstract_decode_state(jlm, 8, 64, jmesh, srules[0]),
         steps.abstract_decode_state(tlm, 8, 64, tmesh, srules[1]))) + \
        tuple((j_steps.batch_shardings(j_registry.input_specs(jc, jcell),
                                       jmesh, False),
               steps.batch_shardings(registry.input_specs(tc, cell), tmesh,
                                     False))
              for jcell, cell in zip(j_config.SHAPE_CELLS,
                                     config.SHAPE_CELLS))
    for want, got in cases:
        wl = jax.tree_util.tree_leaves_with_path(want)
        gl = tree_paths(got)
        assert [tuple(k.key for k in p) for p, _ in wl] == [p for p, _ in gl]
        for (_, w), (path, g) in zip(wl, gl):
            if isinstance(g, P.ShapeDtypeStruct):
                assert g.shape == w.shape, path
                assert str(g.dtype)[6:] == np.dtype(w.dtype).name, path
                w, g = w.sharding, g.sharding
            assert g.spec == _spec(w), path


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_and_applicable_as_jax(arch):
    jc, tc = j_registry.get_config(arch), registry.get_config(arch)
    for jcell, cell in zip(j_config.SHAPE_CELLS, config.SHAPE_CELLS):
        assert registry.applicable(tc, cell) == \
            j_registry.applicable(jc, jcell)
        for override in (None, 4):
            want = j_registry.input_specs(jc, jcell, override)
            got = registry.input_specs(tc, cell, override)
            assert list(got) == list(want)
            for k, w in want.items():
                assert got[k].shape == w.shape, (cell.name, k)
                assert str(got[k].dtype)[6:] == np.dtype(w.dtype).name
                assert got[k].sharding is None


def test_spec_for_divisibility_and_priority():
    """``tests/test_substrate.py``'s cases, on the port."""
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = shd.serve_rules(False)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    # kv_heads divisible -> heads take model
    assert shd.spec_for(mesh, rules, axes, (128, 32768, 16, 128)) == \
        ("data", None, "model", None)
    # kv_heads not divisible -> head_dim fallback
    assert shd.spec_for(mesh, rules, axes, (128, 32768, 8, 128)) == \
        ("data", None, None, "model")
    # indivisible everything -> fully replicated
    assert shd.spec_for(mesh, rules, ("vocab",), (51865,)) == (None,)


def test_train_rules_pure_dp_pick():
    rules, batch_axes, model_axis = shd.pick_train_rules(40, False)
    assert model_axis is None and batch_axes == ("data", "model")
    rules, batch_axes, model_axis = shd.pick_train_rules(96, False)
    assert model_axis == "model" and batch_axes == ("data",)


def test_shard_shape_and_tree_shardings():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    rules = shd.train_rules(True)
    s = shd.sharding_for(mesh, rules, ("embed", "mlp"), (4096, 14336))
    assert s.spec == (("pod", "data"), "model")
    assert s.shard_shape((4096, 14336)) == (128, 896)
    tree = shd.tree_shardings(mesh, rules,
                              {"a": ("embed", "mlp"), "b": {"c": (None,)}},
                              {"a": (4096, 14336), "b": {"c": (7,)}})
    assert tree["a"] == s and tree["b"]["c"].spec == (None,)
    assert tree["b"]["c"].shard_shape((7,)) == (7,)


@pytest.fixture
def device_mesh(tmp_path):
    """A one-rank gloo group and a (1, 1) ("data", "model") DeviceMesh."""
    from torch.distributed.device_mesh import init_device_mesh
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    assert dist.get_world_size() == 1
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    if own:
        dist.destroy_process_group()


def test_placements_on_a_device_mesh(device_mesh):
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"data": 1, "model": 1})
    s = shd.sharding_for(mesh, shd.train_rules(False),
                         ("batch", "seq", "vocab"), (8, 16, 32))
    assert s.spec == ("data", None, "model")
    assert s.placements(device_mesh) == (Shard(0), Shard(2))
    s = shd.sharding_for(mesh, shd.serve_rules(False), ("embed", "mlp"),
                         (8, 16))
    assert s.placements(device_mesh) == (Replicate(), Shard(1))
    assert shd.placements_for((("data", "model"), None),
                              ("data", "model")) == (Shard(0), Shard(0))


def _constrained(x):
    """(input, output) of each ``constrain_*`` on views of ``x`` (2, 4, 4)
    shaped as it takes them."""
    q, qc = x.reshape(2, 4, 4, 1), x.reshape(2, 4, 1, 1, 4)
    return ((x, shardctx.constrain_batch(x)),
            (x, shardctx.constrain_logits(x)),
            (q, shardctx.constrain_seq_parallel_q(q, 12)),
            (qc, shardctx.constrain_qchunk(qc, 12)),
            (x, shardctx.constrain_expert_weight(x, 4)))


def test_constrain_is_the_identity_unless_set(device_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.arange(32, dtype=torch.float32).reshape(2, 4, 4)
    dx = distribute_tensor(x, device_mesh, (Replicate(), Replicate()))
    shardctx.clear()
    assert all(o is i for t in (x, dx) for i, o in _constrained(t))
    try:
        shardctx.set_activation_sharding(("data",), "model",
                                         {"data": 1, "model": 1})
        assert all(o is i for i, o in _constrained(x))
        b = shardctx.constrain_batch(dx)
        assert b.placements == (Shard(0), Replicate())
        torch.testing.assert_close(b.full_tensor(), x, rtol=0, atol=0)
        assert shardctx.constrain_logits(dx).placements == (Shard(0),
                                                            Shard(2))
        # a model axis of one: the expert and context-parallel constraints
        # leave the tensor as it is, as JAX's do
        assert shardctx.constrain_expert_weight(dx, 4) is dx
        assert shardctx.constrain_seq_parallel_q(dx.unsqueeze(-1), 12) \
            .placements == (Replicate(), Replicate())
    finally:
        shardctx.clear()
    assert shardctx._BATCH_AXES is None

"""Spec parity of the port's sharding policy (``launch/sharding.py``) with
the reference's, on every config of the zoo at both production mesh
shapes, (16, 16) and (2, 16, 16).  No devices are needed: the reference
runs on ``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` trees, the
port on its ``MeshShape`` over ``transformer.abstract_params`` and
``init_cache(..., device="meta")``.

Equal, leaf for leaf as tuples: ``param_specs``, ``cohort_specs``' inner
specs, ``cache_specs`` of the ``decode_32k`` cache, ``batch_specs`` of
``input_specs`` for every input shape; ``bytes_per_chip`` to the byte.
A hypothesis property holds ``MeshPolicy.spec`` to the reference's for
random dims, logical names, meshes and ``attn_shard`` modes (the
reference's own property needs 4 devices and returns early without them;
this one needs none).  The reference's trees are built once per module.
"""

import functools

import jax
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JaxP

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = list(configs.ARCH_NAMES)
MESHES = ("single", "multi")
DECODE = INPUT_SHAPES["decode_32k"]


def ref_mesh(which):
    if which == "multi":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def port_mesh(which):
    return mesh_lib.make_production_mesh(multi_pod=which == "multi")


@functools.lru_cache(maxsize=None)
def ref_trees(arch):
    cfg = ref_configs.get_config(arch)
    params = jax.eval_shape(lambda k: ref_tfm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: ref_tfm.init_cache(
        cfg, DECODE.global_batch, DECODE.seq_len))
    return cfg, params, cache


@functools.lru_cache(maxsize=None)
def port_trees(arch):
    cfg = configs.get_config(arch)
    return cfg, tfm.abstract_params(cfg), tfm.init_cache(
        cfg, DECODE.global_batch, DECODE.seq_len, device="meta")


def ref_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JaxP))]


def port_leaves(tree):
    return [tuple(s) for s in tree_leaves(tree)]


def test_production_meshes_are_the_reference_shapes():
    for which in MESHES:
        m, r = port_mesh(which), ref_mesh(which)
        assert m.axis_names == tuple(r.axis_names)
        assert m.shape == dict(r.shape) and m.size == r.size
    assert mesh_lib.data_axes(port_mesh("multi")) == ("pod", "data")
    assert mesh_lib.model_axis_size(port_mesh("single")) == 16


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_reference(arch, which):
    r_cfg, r_params, r_cache = ref_trees(arch)
    cfg, params, cache = port_trees(arch)
    rm, pm = ref_mesh(which), port_mesh(which)
    r_specs = ref_sharding.param_specs(r_params, r_cfg, rm)
    p_specs = sharding.param_specs(params, cfg, pm)
    assert port_leaves(p_specs) == ref_leaves(r_specs)
    assert sharding.bytes_per_chip(params, p_specs, pm) == \
        ref_sharding.bytes_per_chip(r_params, r_specs, rm)
    # the cohort's inner specs: the reference wraps P(data, *spec) of each
    # leaf in a NamedSharding, which refuses kimi-k2's (its experts also
    # shard over data); the port's to_placements refuses it the same way
    data = tuple(a for a in ("pod", "data") if a in rm.axis_names)
    inner = [tuple(JaxP(data, *s)) for s in ref_leaves(r_specs)]
    p_cohort = sharding.cohort_specs(params, cfg, pm)
    assert port_leaves(p_cohort) == inner
    try:
        r_cohort = [tuple(s.spec) for s in jax.tree.leaves(
            ref_sharding.cohort_specs(r_params, r_cfg, rm))]
    except Exception as e:  # jax's DuplicateSpecError
        assert "duplicate" in str(e)
        with pytest.raises(ValueError, match="two dims"):
            for s in tree_leaves(p_cohort):
                sharding.to_placements(s, pm)
    else:
        assert port_leaves(p_cohort) == r_cohort
    r_cs = ref_sharding.cache_specs(r_cache, r_cfg, rm)
    p_cs = sharding.cache_specs(cache, cfg, pm)
    assert port_leaves(p_cs) == ref_leaves(r_cs)
    assert sharding.bytes_per_chip(cache, p_cs, pm) == \
        ref_sharding.bytes_per_chip(r_cache, r_cs, rm)


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, which):
    r_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    rm, pm = ref_mesh(which), port_mesh(which)
    r_pol = ref_sharding.MeshPolicy(rm, r_cfg)
    p_pol = sharding.MeshPolicy(pm, cfg)
    for shape in INPUT_SHAPES.values():
        r_in = ref_configs.input_specs(r_cfg, ref_configs.INPUT_SHAPES[
            shape.name])
        p_in = configs.input_specs(cfg, shape)
        r_b = ref_sharding.batch_specs(r_in, rm, r_pol)
        p_b = sharding.batch_specs(p_in, pm, p_pol)
        assert sorted(p_b) == sorted(r_b)
        for k in r_b:
            assert tuple(p_b[k]) == tuple(r_b[k]), (shape.name, k)
        assert sharding.bytes_per_chip(p_in, p_b, pm) == \
            ref_sharding.bytes_per_chip(r_in, r_b, rm)


MODES = ("auto", "replicate", "head_dim", "seq2d", "seq2d_fsdp", "dp2d")
NAMES = (None, "batch", "seq", "seq_chunks", "heads", "kv_heads", "head_dim",
         "ffn", "experts", "expert_ffn", "vocab", "rnn", "mlstm_dh",
         "kv_seq", "cohort")
SHAPES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 2, 8), ("pod", "data", "model")))


@settings(max_examples=200, deadline=None)
@given(mode=st.sampled_from(MODES), mesh=st.sampled_from(SHAPES),
       dims=st.lists(st.sampled_from((1, 2, 3, 4, 8, 12, 16, 32, 48, 64,
                                      256, 512, 4096)),
                     min_size=1, max_size=6),
       data=st.data())
def test_mesh_policy_spec_equals_the_reference(mode, mesh, dims, data):
    names = data.draw(st.lists(st.sampled_from(NAMES), min_size=len(dims),
                               max_size=len(dims)))
    sizes, axes = mesh
    r_cfg = ref_configs.get_config("gemma2-2b").with_overrides(
        attn_shard=mode)
    cfg = configs.get_config("gemma2-2b").with_overrides(attn_shard=mode)
    want = ref_sharding.MeshPolicy(AbstractMesh(sizes, axes), r_cfg).spec(
        dims, names)
    got = sharding.MeshPolicy(mesh_lib.MeshShape(sizes, axes), cfg).spec(
        dims, names)
    assert tuple(got) == tuple(want)


def test_to_placements_and_constrain():
    from torch.distributed.tensor import Replicate, Shard
    pm = port_mesh("multi")
    spec = sharding.PartitionSpec(("pod", "data"), None, "model")
    assert sharding.to_placements(spec, pm) == [Shard(0), Shard(0),
                                                Shard(2)]
    assert sharding.to_placements(sharding.PartitionSpec(None, None),
                                  pm) == [Replicate()] * 3
    policy = sharding.MeshPolicy(pm, configs.get_config("minitron-8b"))
    x = torch.zeros((32, 4, 8))
    assert policy.constrain(x, ("batch", None, None)) is x
    meta = torch.empty((32, 4096, 32, 128), device="meta")
    assert policy.constrain(meta, ("batch", "seq", "heads", None)) is meta
    # a plain tensor with values on a model-sharded spec: it should have
    # been a DTensor (a live model axis runs on DTensors)
    with pytest.raises(TypeError, match="DTensor"):
        policy.constrain(torch.zeros((32, 4, 32, 8)),
                         ("batch", None, "heads", None))


@pytest.mark.parametrize("rows", [(4, 2), (3, 2), (1, 2), (5, 4), (7, 3)])
def test_shard_rows_is_torch_chunk(rows):
    n, parts = rows
    chunks = torch.arange(n).chunk(parts)
    got = [list(range(*sharding.shard_rows(n, i, parts)))
           for i in range(parts)]
    assert got == [c.tolist() for c in chunks] + [[]] * (parts - len(chunks))

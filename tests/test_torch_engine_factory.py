"""Port parity of ``aggregate.make_engine`` (with its deprecated loose
form and ``_legacy_spec``), ``engine_attrs`` in both forms, and
``flatten.layout_of``.

``make_engine``'s triple folds a stacked cohort (numpy-seeded, one NaN
client at weight 0, f32 weights) chunk by chunk on the flat engine (f32,
bf16 and int8 wires; SCAFFOLD's cv sum) and the tree engine (f32 and
bf16), for fedhen and decouple, against the reference's ``make_engine``
jitted on the CPU, at rtol 1e-6 / atol 1e-7: the reference's CPU fold
walks leaf slices where the port folds the packed chunk, and its jitted
int8 scales are ``max|g| * f32(1/127)``, which the port computes.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import base as ref_base  # noqa: E402
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.core import flatten as ref_flatten  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import aggregate, comm, flatten  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

Z, CHUNK, BLOCK_N = 6, 2, 512
RTOL, ATOL = 1e-6, 1e-7
IS_SIMPLE = np.array([True, False, True, False, False, True])
# client 3 is NaN and folds at weight 0; the rest carry f32 coefficients
VALID = np.array([1.0, 0.5, 1.0, 0.0, 0.25, 1.0], np.float32)


def case(seed=0):
    """(cohort, mask) as numpy trees: leaves of several shapes (one that
    needs alignment padding, one (2, ...) period-stacked leaf masked by
    period), the period mask a (2, 1, 1) bool array."""
    rng = np.random.default_rng(seed)
    normal = lambda *s: rng.normal(size=(Z,) + s).astype(np.float32)
    cohort = {"a": normal(4, 3), "b": normal(300),
              "c": {"w": normal(3, 130), "v": normal(7)},
              "periods": normal(2, 5, 3)}
    for leaf in jax.tree.leaves(cohort):
        leaf[3] = np.nan
    mask = {"a": True, "b": False, "c": {"w": True, "v": False},
            "periods": np.array([True, False]).reshape(2, 1, 1)}
    return cohort, mask


def ref_run(engine, algorithm, wire, dtype, scaffold=False):
    cohort, mask = case()
    template = jax.tree.map(lambda x: jnp.asarray(x[0]), cohort)
    layout = ref_flatten.layout_of(template, total_multiple=BLOCK_N)
    spec = ref_aggregate.EngineSpec(
        engine=engine, algorithm=algorithm,
        mask=jax.tree.map(jnp.asarray, mask), layout=layout,
        flat_mask=ref_flatten.pack_mask(layout, mask), block_n=BLOCK_N,
        stream_dtype=jnp.dtype(dtype), wire=wire and ref_comm.WireSpec(wire),
        variance_reduction="scaffold" if scaffold else "none")
    init, fold, finalize = ref_aggregate.make_engine(spec)
    cv = np.random.default_rng(1).normal(
        size=(Z, layout.n_flat)).astype(np.float32)

    @jax.jit
    def run(cohort, is_simple, valid, cv):
        state = init(template)
        for lo in range(0, Z, CHUNK):
            sl = slice(lo, lo + CHUNK)
            state = fold(state, jax.tree.map(lambda x: x[sl], cohort),
                         is_simple[sl], valid[sl],
                         **({"cv_chunk": cv[sl]} if scaffold else {}))
        return finalize(state, template=template), state.cv_acc

    return run(jax.tree.map(jnp.asarray, cohort), jnp.asarray(IS_SIMPLE),
               jnp.asarray(VALID), jnp.asarray(cv))


def port_spec(engine, algorithm, wire, dtype, scaffold=False):
    cohort, mask = case()
    cohort = interop.from_reference(cohort)
    mask = tree_map(lambda m: m if isinstance(m, bool)
                    else torch.as_tensor(m), mask)
    template = tree_map(lambda x: x[0], cohort)
    layout = flatten.layout_of(template, total_multiple=BLOCK_N)
    spec = aggregate.EngineSpec(
        engine=engine, algorithm=algorithm, mask=mask, layout=layout,
        flat_mask=flatten.pack_mask(layout, mask), block_n=BLOCK_N,
        stream_dtype=getattr(torch, dtype),
        wire=wire and comm.WireSpec(wire),
        variance_reduction="scaffold" if scaffold else "none")
    return spec, cohort, template


def port_run(engine_fn, cohort, template, n_flat, scaffold=False):
    init, fold, finalize = engine_fn
    cv = torch.from_numpy(np.random.default_rng(1).normal(
        size=(Z, n_flat)).astype(np.float32))
    state = init(template)
    for lo in range(0, Z, CHUNK):
        sl = slice(lo, lo + CHUNK)
        state = fold(state, tree_map(lambda x: x[sl], cohort),
                     torch.as_tensor(IS_SIMPLE[sl]),
                     torch.as_tensor(VALID[sl]),
                     **({"cv_chunk": cv[sl]} if scaffold else {}))
    return finalize(state, template=template), state.cv_acc


CASES = [("flat", None, "float32"), ("flat", "bfloat16", "float32"),
         ("flat", "int8", "float32"), ("flat", None, "bfloat16"),
         ("tree", None, "float32"), ("tree", "bfloat16", "float32")]


@pytest.mark.parametrize("algorithm", ["fedhen", "decouple"])
@pytest.mark.parametrize("engine,wire,dtype", CASES)
def test_make_engine_matches_reference(engine, wire, dtype, algorithm):
    (r_c, r_host), _ = ref_run(engine, algorithm, wire, dtype)
    spec, cohort, template = port_spec(engine, algorithm, wire, dtype)
    (p_c, p_host), _ = port_run(aggregate.make_engine(spec), cohort,
                                template, spec.layout.n_flat)
    pairs = [(p_c, r_c)] + ([(p_host, r_host)] if algorithm == "decouple"
                            else [])
    assert (p_host is None) == (r_host is None)
    for got, want in pairs:
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["flat", "tree"])
def test_make_engine_scaffold_cv_sum_matches_reference(engine):
    _, r_cv = ref_run(engine, "fedhen", None, "float32", scaffold=True)
    spec, cohort, template = port_spec(engine, "fedhen", None, "float32",
                                       scaffold=True)
    _, p_cv = port_run(aggregate.make_engine(spec), cohort, template,
                       spec.layout.n_flat, scaffold=True)
    np.testing.assert_allclose(p_cv.numpy(), np.asarray(r_cv), rtol=RTOL,
                               atol=ATOL)


def _warning_text(fn):
    with pytest.warns(DeprecationWarning) as rec:
        out = fn()
    (w,) = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    return str(w.message), out


@pytest.mark.parametrize("engine,wire,dtype", CASES)
def test_legacy_make_engine_is_the_spec_path_bitwise(engine, wire, dtype):
    spec, cohort, template = port_spec(engine, "decouple", wire, dtype)
    text, legacy = _warning_text(lambda: aggregate.make_engine(
        engine, algorithm="decouple", mask=spec.mask, layout=spec.layout,
        flat_mask=spec.flat_mask, block_n=BLOCK_N,
        stream_dtype=spec.stream_dtype, wire=spec.wire))
    ref_text, _ = _warning_text(lambda: ref_aggregate.make_engine(
        "flat", algorithm="fedhen", mask={}))
    assert text == ref_text == ("make_engine(engine, algorithm=..., "
                                "mask=...) with loose engine kwargs is "
                                "deprecated; pass an EngineSpec")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        modern = aggregate.make_engine(spec)
    n = spec.layout.n_flat
    (a_c, a_host), _ = port_run(legacy, cohort, template, n)
    (b_c, b_host), _ = port_run(modern, cohort, template, n)
    for a, b in zip(tree_leaves([a_c, a_host]), tree_leaves([b_c, b_host])):
        assert torch.equal(a, b)


def test_make_engine_derives_an_unbound_layout_and_mask():
    """A spec with only the mask bound (the launch step's tree spec, the
    legacy form) derives the layout with ``layout_of`` and packs the
    flat mask itself: the same result as the fully bound spec."""
    spec, cohort, template = port_spec("flat", "fedhen", None, "float32")
    bare = aggregate.EngineSpec(algorithm="fedhen", mask=spec.mask,
                                block_n=BLOCK_N)
    (a, _), _ = port_run(aggregate.make_engine(bare), cohort, template,
                         spec.layout.n_flat)
    (b, _), _ = port_run(aggregate.make_engine(spec), cohort, template,
                         spec.layout.n_flat)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    init, fold, finalize = aggregate.make_engine(bare)
    with pytest.raises(ValueError, match="template"):
        finalize(init(template))


SPECS = [dict(), dict(engine="tree", algorithm="decouple", block_n=256),
         dict(wire=("int8", 64), variance_reduction="scaffold"),
         dict(engine="tree", stream_dtype="bfloat16",
              wire=("bfloat16", 128)),
         dict(wire=("int8", 128, 1 / 14, True, True))]


@pytest.mark.parametrize("fields", SPECS)
def test_engine_attrs_equal_the_reference(fields):
    def build(mod, wire_mod, dtype_of):
        kw = dict(fields)
        if "wire" in kw:
            kw["wire"] = wire_mod.WireSpec(*kw["wire"])
        if "stream_dtype" in kw:
            kw["stream_dtype"] = dtype_of(kw["stream_dtype"])
        return mod.EngineSpec(**kw)

    want = ref_aggregate.engine_attrs(build(ref_aggregate, ref_comm,
                                            jnp.dtype))
    got = aggregate.engine_attrs(build(aggregate, comm,
                                       lambda n: getattr(torch, n)))
    assert got == want


def test_loose_engine_attrs_warn_and_equal_the_reference():
    text, got = _warning_text(lambda: aggregate.engine_attrs(
        "tree", algorithm="decouple", block_n=256,
        stream_dtype=torch.bfloat16, wire=comm.WireSpec("bfloat16", 64)))
    ref_text, want = _warning_text(lambda: ref_aggregate.engine_attrs(
        "tree", algorithm="decouple", block_n=256,
        stream_dtype=jnp.bfloat16, wire=ref_comm.WireSpec("bfloat16", 64)))
    assert text == ref_text
    assert got == want
    _, got = _warning_text(lambda: aggregate.engine_attrs(
        "flat", algorithm="fedhen"))
    _, want = _warning_text(lambda: ref_aggregate.engine_attrs(
        "flat", algorithm="fedhen"))
    assert got == want and got["agg_block_n"] == 2048


def _slots(layout):
    return [(s.offset, s.size, s.padded, tuple(s.shape),
             str(s.dtype).replace("torch.", "")) for s in layout.slots]


def _ref_slots(layout):
    return [(s.offset, s.size, s.padded, tuple(s.shape),
             str(jnp.dtype(s.dtype))) for s in layout.slots]


def _trees(which):
    """(reference tree of ShapeDtypeStructs, the port's tree)."""
    if which == "resnet":
        ref = jax.eval_shape(ref_resnet.init_params, jax.random.PRNGKey(0))
        return ref, resnet.init_params(torch.Generator().manual_seed(0))
    kw = dict(n_layers=3, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
              vocab_size=96, exit_layer=1, param_dtype="bfloat16")
    ref_cfg = ref_base.ModelConfig(pattern=(ref_base.LayerSpec("attn"),),
                                   **kw)
    cfg = base.ModelConfig(pattern=(base.LayerSpec("attn"),), **kw)
    ref = jax.eval_shape(lambda k: ref_tfm.init_params(k, ref_cfg),
                         jax.random.PRNGKey(0))
    return ref, tfm.init_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("which", ["resnet", "lm"])
@pytest.mark.parametrize("total_multiple", [0, 2048])
def test_layout_of_matches_reference_and_caches(which, total_multiple):
    ref_tree, tree = _trees(which)
    want = ref_flatten.layout_of(ref_tree, total_multiple=total_multiple)
    got = flatten.layout_of(tree, total_multiple=total_multiple)
    assert _slots(got) == _ref_slots(want)
    assert got.n_flat == want.n_flat
    assert got.signature == want.signature
    # stacked: the cohort axis stripped without allocating, same object
    stacked = tree_map(lambda x: x[None].expand((3,) + x.shape), tree)
    assert flatten.layout_of(stacked, total_multiple=total_multiple,
                             stacked=True) is got
    ref_stacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((3,) + x.shape, x.dtype), ref_tree)
    assert _ref_slots(ref_flatten.layout_of(
        ref_stacked, total_multiple=total_multiple, stacked=True)) == \
        _slots(got)
    # another tree of the same signature (here: on the meta device) hits
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)
    assert flatten.layout_of(meta, total_multiple=total_multiple) is got
    # another signature does not
    assert flatten.layout_of(tree, total_multiple=total_multiple + 128) \
        is not got

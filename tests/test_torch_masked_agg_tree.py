"""Port parity of the one-shot masked fold (K4's plain version and its
wrappers) and of the tree streaming engine.

On the CPU the wrapper ``masked_agg_`` runs the plain version; the CUDA
kernel is held against that plain version on the card (bitwise) by
``chip_smoke.py`` and ``test_torch_kernels_cuda.py``.  Tolerances: the
plain K4 against the reference's ref and its Pallas kernel (interpret
mode) rtol = atol = 1e-6 — all three add the rows in z order; the tree
engine against the reference's 1e-6; the one-shot oracles (which
normalize the weights before the sum, where the streaming engines divide
the sums once) against the engines rtol 2e-5, atol 2e-6, the reference's
own tolerance for that comparison (``tests/test_aggregate.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import masking as ref_masking  # noqa: E402
from repro.kernels.masked_agg import kernel as ref_kernel  # noqa: E402
from repro.kernels.masked_agg import ops as ref_ops  # noqa: E402
from repro.kernels.masked_agg import ref as ref_ref  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregate, flatten, masking  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.masked_agg.ref import masked_agg_ref  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
ORACLE_TOL = dict(rtol=2e-5, atol=2e-6)


def _inputs(z, n, seed):
    """Row 1 is NaN at weight 0; row 2 has weight 0 on both branches;
    row 3 weight 0 inside M only."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(z, n)).astype(np.float32)
    x[1] = np.nan
    mask = rng.random(n) < 0.4
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_m[1] = w_rest[1] = w_m[2] = w_rest[2] = w_m[3] = 0.0
    return x, mask, w_m, w_rest


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,n", [(5, 4096), (4, 1), (6, 2048 + 3),
                                 (5, 3001)])
def test_plain_version_matches_reference_ref_and_pallas(dtype, z, n):
    x, mask, w_m, w_rest = _inputs(z, n, seed=z * n)
    got = masked_agg_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(mask), torch.from_numpy(w_m),
                         torch.from_numpy(w_rest))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    args = (jnp.asarray(x).astype(dtype), jnp.asarray(mask),
            jnp.asarray(w_m), jnp.asarray(w_rest))
    want_ref = np.asarray(ref_ref.masked_agg_ref(*args).astype(jnp.float32))
    want_pallas = np.asarray(ref_kernel.masked_agg_pallas(
        *args, block_n=1024, interpret=True).astype(jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_plain_version_with_every_weight_zero_is_zero():
    x, mask, w_m, w_rest = _inputs(5, 700, seed=9)
    zero = torch.zeros(5)
    got = masked_agg_ref(torch.from_numpy(x), torch.from_numpy(mask), zero,
                         zero)
    want = ref_ref.masked_agg_ref(jnp.asarray(x), jnp.asarray(mask),
                                  jnp.zeros(5), jnp.zeros(5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


def test_wrapper_on_cpu_takes_strided_rows_and_counts_no_launch():
    x, mask, w_m, w_rest = _inputs(5, 777, seed=3)
    buf = torch.zeros((5, 2048))
    buf[:, 256:256 + 777] = torch.from_numpy(x)
    view = buf[:, 256:256 + 777]            # rows 2048 elements apart
    args = (torch.from_numpy(mask), torch.from_numpy(w_m),
            torch.from_numpy(w_rest))
    before = ops.masked_agg_.launches
    got = ops.masked_agg_(view, *args)
    np.testing.assert_array_equal(
        got.numpy(), masked_agg_ref(torch.from_numpy(x), *args).numpy())
    assert ops.masked_agg_.launches == before


@pytest.mark.parametrize("broken", ["x_dtype", "x_rank", "column_stride",
                                    "rows_overlap", "mask_dtype", "w_shape",
                                    "device", "mask_contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(broken):
    x, mask, w_m, w_rest = (torch.from_numpy(a) for a in
                            _inputs(4, 64, seed=1))
    if broken == "x_dtype":
        x = x.half()
    elif broken == "x_rank":
        x = x.reshape(4, 8, 8)
    elif broken == "column_stride":
        x = torch.zeros((4, 128))[:, ::2]
    elif broken == "rows_overlap":
        x = torch.zeros(200).as_strided((4, 64), (32, 1))
    elif broken == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif broken == "w_shape":
        w_m = w_m[:3]
    elif broken == "device":
        x = x.to("meta")
    else:
        mask = torch.zeros(128, dtype=torch.bool)[::2]
    with pytest.raises(ValueError):
        ops.masked_agg_(x, mask, w_m, w_rest)


# ---------------------------------------------------------------------------
# Leaf and tree wrappers, the tree engine and the one-shot oracles
# ---------------------------------------------------------------------------

NARROW = (8, 8, 8, 8)


def _cohort(z, seed, nan_row=None):
    trees = [resnet.init_params(torch.Generator().manual_seed(seed + i), 10,
                                NARROW) for i in range(z)]
    if nan_row is not None:
        trees[nan_row]["stage3"][0]["conv1"][0, 0, 0, 0] = float("nan")
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _assert_trees_close(got, want, tol):
    if want is None:
        assert got is None
        return
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        a = a.float().numpy()
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def test_leaf_and_tree_wrappers_match_reference():
    stacked = _cohort(4, 0, nan_row=1)
    mask = masking.resnet_subnet_mask(tree_map(lambda x: x[0], stacked))
    w_m = torch.tensor([1.0, 0.0, 0.5, 0.0])
    w_rest = torch.tensor([0.0, 0.0, 0.25, 2.0])
    ref_stacked = interop.to_reference(stacked)
    ref_mask = ref_masking.resnet_subnet_mask(
        jax.tree.map(lambda x: x[0], ref_stacked))
    got = ops.masked_agg_tree(stacked, mask, w_m, w_rest)
    want = ref_ops.masked_agg_tree(ref_stacked, ref_mask,
                                   jnp.asarray(w_m.numpy()),
                                   jnp.asarray(w_rest.numpy()))
    _assert_trees_close(got, want, TOL)
    leaf = stacked["stage1"][0]["conv1"]
    got = ops.masked_agg_leaf(leaf, True, w_m, w_rest)
    want = ref_ops.masked_agg_leaf(jnp.asarray(leaf.numpy()),
                                   jnp.asarray(True),
                                   jnp.asarray(w_m.numpy()),
                                   jnp.asarray(w_rest.numpy()))
    assert got.shape == leaf.shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _hard_case():
    """Z = 5: client 1 NaN (validity 0), client 4 a zero-weight slot."""
    stacked = _cohort(5, 20, nan_row=1)
    is_simple = torch.tensor([True, True, False, False, True])
    valid = torch.tensor([True, False, True, True, False])
    return stacked, is_simple, valid


def _port_stream(stacked, is_simple, valid, algorithm, engine, stream,
                 chunk=2):
    template = tree_map(lambda x: x[0], stacked)
    layout = flatten.build_layout(template, total_multiple=2048)
    mask = masking.resnet_subnet_mask(template)
    flat_mask = flatten.pack_mask(layout, mask)
    leaf_masks = flatten.unpack(layout, flat_mask, cast=False)
    dtype = getattr(torch, stream)
    if engine == "tree":
        state = aggregate.tree_streaming_init(template, algorithm, layout)
    else:
        state = aggregate.streaming_init(layout, algorithm, "cpu")
    z = is_simple.shape[0]
    for lo in range(0, z, chunk):
        sl = slice(lo, min(lo + chunk, z))
        xz = flatten.pack_stacked(layout, tree_map(lambda x: x[sl], stacked),
                                  dtype=dtype)
        if engine == "tree":
            state = aggregate.tree_streaming_fold(
                state, xz, layout, flat_mask, is_simple[sl], valid[sl],
                algorithm)
        else:
            state = aggregate.streaming_fold(state, xz, flat_mask,
                                             is_simple[sl], valid[sl],
                                             algorithm)
    if engine == "tree":
        return state, aggregate.tree_streaming_finalize(state, leaf_masks,
                                                        algorithm)
    return state, aggregate.streaming_finalize(state, layout, flat_mask,
                                               algorithm)


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("algorithm", ["fedhen", "noside", "decouple"])
def test_tree_streaming_engine_matches_reference(algorithm, stream):
    stacked, is_simple, valid = _hard_case()
    state, got = _port_stream(stacked, is_simple, valid, algorithm, "tree",
                              stream)
    ref_stacked = interop.to_reference(stacked)
    ref_tmpl = jax.tree.map(lambda x: x[0], ref_stacked)
    spec = ref_aggregate.EngineSpec(
        engine="tree", algorithm=algorithm,
        mask=ref_masking.resnet_subnet_mask(ref_tmpl),
        stream_dtype=jnp.dtype(stream))
    ref_state = ref_aggregate.tree_streaming_init(ref_tmpl, spec)
    for lo in range(0, 5, 2):
        sl = slice(lo, min(lo + 2, 5))
        ref_state = ref_aggregate.tree_streaming_fold(
            ref_state, jax.tree.map(lambda x: x[sl], ref_stacked),
            jnp.asarray(is_simple[sl].numpy()),
            jnp.asarray(valid[sl].numpy()), spec)
    want = ref_aggregate.tree_streaming_finalize(ref_state, spec,
                                                 template=ref_tmpl)
    assert float(state.tot_in) == float(ref_state.tot_in)
    assert float(state.tot_out) == float(ref_state.tot_out)
    _assert_trees_close(state.acc, ref_state.acc, TOL)
    for g, w in zip(got, want):
        _assert_trees_close(g, w, TOL)


@pytest.mark.parametrize("algorithm", ["fedhen", "noside", "decouple"])
def test_flat_vs_tree_vs_oracle(algorithm):
    stacked, is_simple, valid = _hard_case()
    mask = masking.resnet_subnet_mask(tree_map(lambda x: x[0], stacked))
    ref_stacked = interop.to_reference(stacked)
    ref_mask = ref_masking.resnet_subnet_mask(
        jax.tree.map(lambda x: x[0], ref_stacked))
    ref_args = (ref_stacked, jnp.asarray(is_simple.numpy()),
                jnp.asarray(valid.numpy()), ref_mask)
    if algorithm == "decouple":
        host, new = aggregate.decouple_server_update(stacked, is_simple,
                                                     valid, mask)
        want_host, want = ref_aggregate.decouple_server_update(*ref_args)
        oracle, ref_oracle = (new, host), (want, want_host)
    else:
        oracle = (aggregate.fedhen_server_update(stacked, is_simple, valid,
                                                 mask), None)
        ref_oracle = (ref_aggregate.fedhen_server_update(*ref_args), None)
    for mine, theirs in zip(oracle, ref_oracle):
        _assert_trees_close(mine, theirs, TOL)
    for engine in ("flat", "tree"):
        _, got = _port_stream(stacked, is_simple, valid, algorithm, engine,
                              "float32")
        for g, w in zip(got, oracle):
            _assert_trees_close(g, interop.to_reference(w) if w is not None
                                else None, ORACLE_TOL)


def test_masked_cohort_mean_and_where_mask_match_reference():
    stacked = _cohort(3, 40)
    mask = masking.resnet_subnet_mask(tree_map(lambda x: x[0], stacked))
    w_m = torch.tensor([0.5, 0.5, 0.0])
    w_rest = torch.tensor([0.0, 0.25, 0.75])
    ref_stacked = interop.to_reference(stacked)
    ref_mask = ref_masking.resnet_subnet_mask(
        jax.tree.map(lambda x: x[0], ref_stacked))
    got = aggregate.masked_cohort_mean(stacked, w_m, w_rest, mask)
    want = ref_aggregate.masked_cohort_mean(
        ref_stacked, jnp.asarray(w_m.numpy()), jnp.asarray(w_rest.numpy()),
        ref_mask)
    _assert_trees_close(got, want, TOL)

"""Port parity of the masked fold (K1's plain version and its wrapper) and
of the flat streaming engine.

On the CPU the wrapper ``masked_agg_acc_`` runs the plain version; the
CUDA kernel is held against that same plain version on the card by
``chip_smoke.py``.  Tolerance rtol = atol = 1e-6: the plain versions of
both packages add row by row, the Pallas kernel sums the cohort first and
then adds it to ``acc``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import flatten as ref_flatten  # noqa: E402
from repro.core import masking as ref_masking  # noqa: E402
from repro.kernels.masked_agg import kernel as ref_kernel  # noqa: E402
from repro.kernels.masked_agg import ref as ref_ref  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregate, flatten, masking  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.masked_agg.ref import masked_agg_acc_ref  # noqa
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(z, n, seed):
    """Row 1 is NaN at weight 0; row 2 has weight 0 on both branches;
    row 3 weight 0 inside M only."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(z, n)).astype(np.float32)
    x[1] = np.nan
    mask = rng.random(n) < 0.4
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_m[1] = w_rest[1] = 0.0
    w_m[2] = w_rest[2] = 0.0
    w_m[3] = 0.0
    acc = rng.normal(size=n).astype(np.float32)
    return acc, x, mask, w_m, w_rest


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,n", [(5, 4096), (4, 1001), (6, 2048 + 3)])
def test_plain_version_matches_reference_ref_and_pallas(dtype, z, n):
    acc, x, mask, w_m, w_rest = _inputs(z, n, seed=z * n)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    got = masked_agg_acc_ref(torch.from_numpy(acc), xt,
                             torch.from_numpy(mask), torch.from_numpy(w_m),
                             torch.from_numpy(w_rest)).numpy()
    args = (jnp.asarray(acc), xj, jnp.asarray(mask), jnp.asarray(w_m),
            jnp.asarray(w_rest))
    want_ref = np.asarray(ref_ref.masked_agg_acc_ref(*args))
    want_pallas = np.asarray(ref_kernel.masked_agg_acc_pallas(
        *args, block_n=1024, interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_wrapper_on_cpu_updates_in_place_and_counts_no_launch():
    acc, x, mask, w_m, w_rest = _inputs(5, 777, seed=3)
    acc_t = torch.from_numpy(acc.copy())
    want = masked_agg_acc_ref(acc_t.clone(), torch.from_numpy(x),
                              torch.from_numpy(mask), torch.from_numpy(w_m),
                              torch.from_numpy(w_rest))
    before = ops.masked_agg_acc_.launches
    out = ops.masked_agg_acc_(acc_t, torch.from_numpy(x),
                              torch.from_numpy(mask), torch.from_numpy(w_m),
                              torch.from_numpy(w_rest))
    assert out is acc_t
    np.testing.assert_array_equal(acc_t.numpy(), want.numpy())
    assert ops.masked_agg_acc_.launches == before


@pytest.mark.parametrize("broken", ["acc_dtype", "x_dtype", "mask_dtype",
                                    "w_shape", "x_shape", "device",
                                    "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(broken):
    acc, x, mask, w_m, w_rest = (torch.from_numpy(a) for a in
                                 _inputs(4, 64, seed=1))
    if broken == "acc_dtype":
        acc = acc.double()
    elif broken == "x_dtype":
        x = x.half()
    elif broken == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif broken == "w_shape":
        w_m = w_m[:3]
    elif broken == "x_shape":
        x = x[:, :32]
    elif broken == "device":
        acc = acc.to("meta")
    else:
        x = torch.from_numpy(np.asfortranarray(x.numpy()))
    with pytest.raises(ValueError):
        ops.masked_agg_acc_(acc, x, mask, w_m, w_rest)


# ---------------------------------------------------------------------------
# Flat streaming engine against the reference's
# ---------------------------------------------------------------------------

NARROW = (8, 8, 8, 8)


def _cohort(z, seed, nan_row=None):
    trees = [resnet.init_params(torch.Generator().manual_seed(seed + i), 10,
                                NARROW) for i in range(z)]
    if nan_row is not None:
        trees[nan_row]["stage3"][0]["conv1"][0, 0, 0, 0] = float("nan")
    return trees


@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
@pytest.mark.parametrize("algorithm", ["fedhen", "noside", "decouple"])
def test_streaming_engine_matches_reference(algorithm, stream):
    chunks = [(_cohort(3, 0, nan_row=1), [True, True, False],
               [True, False, True]),
              (_cohort(3, 10), [False, False, True], [True, True, True])]
    template = chunks[0][0][0]
    layout = flatten.build_layout(template, total_multiple=2048)
    mask = masking.resnet_subnet_mask(template)
    flat_mask = flatten.pack_mask(layout, mask)
    ref_tmpl = interop.to_reference(template)
    ref_layout = ref_flatten.build_layout(ref_tmpl, total_multiple=2048)
    spec = ref_aggregate.EngineSpec(
        algorithm=algorithm, mask=ref_masking.resnet_subnet_mask(ref_tmpl),
        layout=ref_layout, stream_dtype=jnp.dtype(stream))
    dtype = getattr(torch, stream)

    state = aggregate.streaming_init(layout, algorithm, "cpu")
    ref_state = ref_aggregate.streaming_init(ref_tmpl, spec)
    for trees, is_simple, valid in chunks:
        stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
        xz = flatten.pack_stacked(layout, stacked, dtype=dtype)
        state = aggregate.streaming_fold(
            state, xz, flat_mask, torch.tensor(is_simple),
            torch.tensor(valid), algorithm)
        ref_state = ref_aggregate.streaming_fold(
            ref_state, interop.to_reference(stacked),
            jnp.asarray(is_simple), jnp.asarray(valid), spec)
    got = aggregate.streaming_finalize(state, layout, flat_mask, algorithm)
    want = ref_aggregate.streaming_finalize(ref_state, spec,
                                            template=ref_tmpl)
    assert float(state.tot_in) == float(ref_state.tot_in)
    assert float(state.tot_out) == float(ref_state.tot_out)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        for a, b in zip(tree_leaves(g), jax.tree.leaves(w)):
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_chunk_weights_and_safe_inv_match_reference():
    is_simple = np.array([True, False, True, False])
    valid = np.array([1.0, 0.5, 0.0, 1.0], np.float32)
    for algorithm in ("fedhen", "noside", "decouple"):
        got = aggregate._chunk_weights(torch.tensor(is_simple),
                                       torch.tensor(valid), algorithm)
        want = ref_aggregate._chunk_weights(jnp.asarray(is_simple),
                                            jnp.asarray(valid), algorithm)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for tot in (0.0, 1e-20, 3.0):
        assert float(aggregate._safe_inv(torch.tensor(tot))) == \
            float(ref_aggregate._safe_inv(jnp.asarray(tot, jnp.float32)))


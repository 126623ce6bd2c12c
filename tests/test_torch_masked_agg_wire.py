"""Port parity of the wire's folds: the plain versions of K2
(``masked_agg_acc_deq_ref``) and K3 (``masked_scatter_acc_ref``), their
wrappers on the CPU, and the flat engine's int8 and delta-mode folds.

On the CPU the wrappers run the plain versions; the CUDA kernels are held
against those same plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).  Tolerance
rtol = atol = 1e-6 against the reference's plain versions and its Pallas
kernels in interpret mode: the plain versions add row by row, the Pallas
kernels sum the cohort (or the one-hot contraction) first and then add it
to ``acc``, and the reference's round quantizes inside its jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.core import flatten as ref_flatten  # noqa: E402
from repro.core import masking as ref_masking  # noqa: E402
from repro.kernels.masked_agg import kernel as ref_kernel  # noqa: E402
from repro.kernels.masked_agg import ref as ref_ref  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregate, comm, flatten, masking  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.masked_agg.ref import (  # noqa: E402
    masked_agg_acc_deq_ref, masked_scatter_acc_ref)
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _weights(rng, z):
    """Row 1 weight 0 on both branches (it carries NaNs), row 2 weight 0
    inside M only, the rest ordinary."""
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_m[1] = w_rest[1] = w_m[2] = 0.0
    return w_m, w_rest


def _deq_inputs(z, n, quant_block, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(z, n), dtype=np.int8)
    scales = rng.uniform(0.0, 0.1, size=(z, n // quant_block)).astype(
        np.float32)
    scales[1] = np.nan
    scales[3, 0] = 0.0                    # an all-zero group
    mask = rng.random(n) < 0.4
    acc = rng.normal(size=n).astype(np.float32)
    return (acc, q, scales, mask) + _weights(rng, z)


def _scatter_inputs(z, n, k, dtype, quant_block, seed):
    """Sorted distinct indices per row that collide across rows."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(n, size=k, replace=False))
                    for _ in range(z)]).astype(np.int32)
    idx[:, 0] = 7                         # every row hits position 7
    values = rng.normal(size=(z, k)).astype(np.float32)
    scales = None
    if dtype == "int8":
        values = rng.integers(-127, 128, size=(z, k), dtype=np.int8)
        scales = rng.uniform(0.0, 0.1, size=(z, k // quant_block)).astype(
            np.float32)
        scales[1] = np.nan
    else:
        values[1] = np.nan
    mask = rng.random(n) < 0.4
    acc = rng.normal(size=n).astype(np.float32)
    return (acc, values, scales, idx, mask) + _weights(rng, z)


def _torch(a, dtype=None):
    t = None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if dtype and t is not None else t


def _jax(a, dtype=None):
    j = None if a is None else jnp.asarray(a)
    return j.astype(dtype) if dtype and j is not None else j


@pytest.mark.parametrize("z,n,quant_block", [(5, 4096, 128), (4, 2048, 32),
                                             (4, 1024, 1)])
def test_deq_plain_version_matches_reference_ref_and_pallas(z, n,
                                                            quant_block):
    acc, q, scales, mask, w_m, w_rest = _deq_inputs(z, n, quant_block,
                                                    seed=z * n)
    got = masked_agg_acc_deq_ref(*map(_torch, (acc, q, scales, mask, w_m,
                                               w_rest)),
                                 quant_block=quant_block).numpy()
    args = tuple(map(_jax, (acc, q, scales, mask, w_m, w_rest)))
    want_ref = ref_ref.masked_agg_acc_deq_ref(*args, quant_block=quant_block)
    want_pallas = ref_kernel.masked_agg_acc_deq_pallas(
        *args, quant_block=quant_block, block_n=512, interpret=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("z,n,k", [(4, 4096, 256), (3, 1000, 128)])
def test_scatter_plain_version_matches_reference_ref_and_pallas(dtype, z, n,
                                                                k):
    acc, values, scales, idx, mask, w_m, w_rest = _scatter_inputs(
        z, n, k, dtype, 128, seed=z * n + k)
    vdt = None if dtype == "int8" else dtype
    got = masked_scatter_acc_ref(
        _torch(acc), _torch(values, vdt), _torch(scales), _torch(idx),
        _torch(mask), _torch(w_m), _torch(w_rest), quant_block=128).numpy()
    args = (_jax(acc), _jax(values, vdt), _jax(scales), _jax(idx),
            _jax(mask), _jax(w_m), _jax(w_rest))
    want_ref = ref_ref.masked_scatter_acc_ref(*args, quant_block=128)
    want_pallas = ref_kernel.masked_scatter_acc_pallas(
        *args, quant_block=128, block_n=512, interpret=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


def test_wrappers_on_cpu_update_in_place_and_count_no_launch():
    acc, q, scales, mask, w_m, w_rest = map(
        _torch, _deq_inputs(5, 1024, 32, seed=3))
    want = masked_agg_acc_deq_ref(acc.clone(), q, scales, mask, w_m, w_rest,
                                  quant_block=32)
    before = ops.masked_agg_acc_deq_.launches
    assert ops.masked_agg_acc_deq_(acc, q, scales, mask, w_m, w_rest,
                                   quant_block=32) is acc
    assert torch.equal(acc, want)
    assert ops.masked_agg_acc_deq_.launches == before
    acc, values, scales, idx, mask, w_m, w_rest = map(
        _torch, _scatter_inputs(4, 1024, 128, "int8", 128, seed=3))
    want = masked_scatter_acc_ref(acc.clone(), values, scales, idx, mask,
                                  w_m, w_rest, quant_block=128)
    before = ops.masked_scatter_acc_.launches
    assert ops.masked_scatter_acc_(acc, values, scales, idx, mask, w_m,
                                   w_rest, quant_block=128) is acc
    assert torch.equal(acc, want)
    assert ops.masked_scatter_acc_.launches == before


@pytest.mark.parametrize("broken", ["q_dtype", "scales_shape", "ragged",
                                    "quant_block", "device", "contiguity"])
def test_deq_wrapper_rejects_what_the_kernel_does_not_take(broken):
    acc, q, scales, mask, w_m, w_rest = map(
        _torch, _deq_inputs(4, 256, 32, seed=1))
    qb = 32
    if broken == "q_dtype":
        q = q.to(torch.int16)
    elif broken == "scales_shape":
        scales = scales[:, :4]
    elif broken == "ragged":
        acc, q, mask = acc[:250].contiguous(), q[:, :250].contiguous(), \
            mask[:250].contiguous()
    elif broken == "quant_block":
        qb = 48
    elif broken == "device":
        scales = scales.to("meta")
    else:
        q = torch.from_numpy(np.asfortranarray(q.numpy()))
    with pytest.raises(ValueError):
        ops.masked_agg_acc_deq_(acc, q, scales, mask, w_m, w_rest,
                                quant_block=qb)


@pytest.mark.parametrize("broken", ["values_dtype", "indices_dtype",
                                    "indices_shape", "scales_shape",
                                    "k_ragged", "device"])
def test_scatter_wrapper_rejects_what_the_kernel_does_not_take(broken):
    acc, values, scales, idx, mask, w_m, w_rest = map(
        _torch, _scatter_inputs(4, 1024, 128, "int8", 32, seed=1))
    if broken == "values_dtype":
        values = values.to(torch.int16)
    elif broken == "indices_dtype":
        idx = idx.to(torch.int64)
    elif broken == "indices_shape":
        idx = idx[:3]
    elif broken == "scales_shape":
        scales = scales[:, :2]
    elif broken == "k_ragged":
        values, idx = values[:, :100].contiguous(), idx[:, :100].contiguous()
        scales = None
    else:
        idx = idx.to("meta")
    with pytest.raises(ValueError):
        ops.masked_scatter_acc_(acc, values, scales, idx, mask, w_m, w_rest,
                                quant_block=32)


# ---------------------------------------------------------------------------
# The flat engine's wire folds against the reference's
# ---------------------------------------------------------------------------

NARROW = (8, 8, 8, 8)


def _setup(algorithm, wire_kw):
    trees = [resnet.init_params(torch.Generator().manual_seed(i), 10, NARROW)
             for i in range(4)]
    trees[1]["stage3"][0]["conv1"][0, 0, 0, 0] = float("nan")
    layout = flatten.build_layout(trees[0], total_multiple=2048)
    mask = masking.resnet_subnet_mask(trees[0])
    ref_tmpl = interop.to_reference(trees[0])
    spec = ref_aggregate.EngineSpec(
        algorithm=algorithm, mask=ref_masking.resnet_subnet_mask(ref_tmpl),
        layout=ref_flatten.build_layout(ref_tmpl, total_multiple=2048),
        wire=ref_comm.WireSpec(**wire_kw))
    return trees, layout, flatten.pack_mask(layout, mask), ref_tmpl, spec


def _finalized(state, ref_state, layout, flat_mask, algorithm, spec,
               ref_tmpl):
    got = aggregate.streaming_finalize(state, layout, flat_mask, algorithm)
    want = ref_aggregate.streaming_finalize(ref_state, spec,
                                            template=ref_tmpl)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        for a, b in zip(tree_leaves(g), jax.tree.leaves(w)):
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("algorithm", ["fedhen", "decouple"])
def test_int8_wire_fold_matches_reference(algorithm):
    trees, layout, flat_mask, ref_tmpl, spec = _setup(
        algorithm, dict(dtype="int8", quant_block=32))
    is_simple, valid = [True, False, True, False], [True, False, True, True]
    stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
    state = aggregate.streaming_fold(
        aggregate.streaming_init(layout, algorithm, "cpu"),
        flatten.pack_stacked(layout, stacked), flat_mask,
        torch.tensor(is_simple), torch.tensor(valid), algorithm,
        wire=comm.WireSpec("int8", 32))
    ref_state = ref_aggregate.streaming_fold(
        ref_aggregate.streaming_init(ref_tmpl, spec),
        interop.to_reference(stacked), jnp.asarray(is_simple),
        jnp.asarray(valid), spec)
    _finalized(state, ref_state, layout, flat_mask, algorithm, spec,
               ref_tmpl)


@pytest.mark.parametrize("algorithm", ["fedhen", "decouple"])
@pytest.mark.parametrize("wire_kw", [
    dict(dtype="int8", topk_frac=0.1), dict(dtype="bfloat16", topk_frac=0.1),
    dict(dtype="int8", error_feedback=True),
    dict(dtype="bfloat16", error_feedback=True)])
def test_delta_fold_matches_reference(algorithm, wire_kw):
    """Top-k payloads fold through K1 + K3, dense int8 deltas through
    K1 + K2, dense bf16 deltas through K1 twice — against the reference's
    ``streaming_fold(sparse_chunk=...)`` on the same encoded uploads."""
    trees, layout, flat_mask, ref_tmpl, spec = _setup(algorithm, wire_kw)
    wire = comm.WireSpec(**wire_kw)
    base = flatten.pack(layout, trees[0])
    deltas = flatten.pack_stacked(
        layout, tree_map(lambda *xs: torch.stack(xs), *trees[1:])) - base
    k = comm.topk_count(wire, layout.n_params)
    bufs = [comm.sparse_encode(wire, d, k) if wire.is_sparse
            else comm.encode(wire, d) for d in deltas]
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    sp = aggregate.SparseChunk(base, stack([b.payload for b in bufs]),
                               stack([b.scales for b in bufs]),
                               stack([b.indices for b in bufs])
                               if wire.is_sparse else None)
    is_simple, valid = [True, False, False], [False, True, True]
    state = aggregate.streaming_fold_deltas(
        aggregate.streaming_init(layout, algorithm, "cpu"), sp, flat_mask,
        torch.tensor(is_simple), torch.tensor(valid), algorithm,
        quant_block=wire.quant_block)
    to_j = lambda t: None if t is None else jnp.asarray(
        t.float().numpy()).astype(jnp.bfloat16) \
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
    ref_sp = ref_aggregate.SparseChunk(*map(to_j, sp))
    ref_state = ref_aggregate.streaming_fold(
        ref_aggregate.streaming_init(ref_tmpl, spec), None,
        jnp.asarray(is_simple), jnp.asarray(valid), spec,
        sparse_chunk=ref_sp)
    _finalized(state, ref_state, layout, flat_mask, algorithm, spec,
               ref_tmpl)

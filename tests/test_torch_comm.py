"""Port parity of the wire (``core/comm.py``): encode/decode, stochastic
rounding, top-k and the measured byte counts.

Everything here is held bitwise.  The reference is run jitted, as its
round runs it: inside a jitted program XLA turns ``max|g| / 127`` into a
multiplication by the f32 reciprocal of 127, and the port computes its
scales that way (the eager reference's scales differ from both by an ulp
now and then, which the last test pins).  Inputs are made from a seed with
numpy; random bits come from ``jax.random.bits``, fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import comm as ref_comm  # noqa: E402
from repro.core import flatten as ref_flatten  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import comm, flatten  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _values(n, seed, zero_groups=True):
    """Normal values with the first two 32-groups all zero."""
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 0.05
    if zero_groups:
        x[:64] = 0.0
    return x


def _bits_of(key):
    """A bit source that draws what ``jax.random.bits(key, shape)`` draws."""
    def bits(shape):
        drawn = jax.random.bits(key, tuple(shape), jnp.uint32)
        return torch.from_numpy(np.asarray(drawn).astype(np.int64))
    return bits


def _same(a, b):
    a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("quant_block", [32, 128])
@pytest.mark.parametrize("n", [1, 130, 4096, 1000])
def test_encode_decode_bitwise(dtype, quant_block, n):
    x = _values(n, seed=n)
    spec = comm.WireSpec(dtype, quant_block)
    rspec = ref_comm.WireSpec(dtype, quant_block)
    got = comm.encode(spec, torch.from_numpy(x))
    want = jax.jit(lambda v: ref_comm.encode(rspec, v))(jnp.asarray(x))
    _same(got.payload, want.payload)
    assert (got.scales is None) == (want.scales is None)
    if want.scales is not None:
        _same(got.scales, want.scales)
        assert got.payload.dtype == torch.int8
    _same(comm.decode(spec, got),
          jax.jit(lambda b: ref_comm.decode(rspec, b))(want))


@pytest.mark.parametrize("quant_block", [1, 32, 128])
def test_quantize_dequantize_bitwise(quant_block):
    x = _values(3 * 1024, seed=quant_block).reshape(3, 1024)
    x[1, 5] = 4.0             # one group dominated by a single value
    q, s = comm.quantize(torch.from_numpy(x), quant_block)
    rq, rs = jax.jit(lambda v: ref_comm.quantize(v, quant_block))(
        jnp.asarray(x))
    _same(q, rq)
    _same(s, rs)
    assert not q[0, :64].any() and not s[0, :64 // quant_block].any()
    _same(comm.dequantize(q, s, quant_block),
          ref_comm.dequantize(rq, rs, quant_block))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_stochastic_rounding_bitwise_with_the_reference_bits(dtype):
    x = _values(4096, seed=7)
    key = jax.random.PRNGKey(3)
    spec = comm.WireSpec(dtype, 128, stochastic=True)
    rspec = ref_comm.WireSpec(dtype, 128, stochastic=True)
    got = comm.encode(spec, torch.from_numpy(x), bits=_bits_of(key))
    want = jax.jit(lambda v: ref_comm.encode(rspec, v, key=key))(
        jnp.asarray(x))
    _same(got.payload, want.payload)
    if want.scales is not None:
        _same(got.scales, want.scales)
    # the stochastic encode differs from round-to-nearest somewhere
    nearest = comm.encode(comm.WireSpec(dtype, 128), torch.from_numpy(x))
    assert not torch.equal(got.payload, nearest.payload)


def test_stochastic_round_primitives_on_edge_bits():
    bits = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF, 2**31, 2**32 - 256,
                     2**32 - 129, 2**32 - 1] * 4, np.uint32)
    v = np.repeat(np.array([-127.0, -0.5, 3.999999, 126.9], np.float32), 9)
    x = np.repeat(np.array([1.0, -2.75e-3, 3.4e38, 1.00390625],
                           np.float32), 9)
    bt = torch.from_numpy(bits.astype(np.int64))
    _same(comm.stochastic_round_int(torch.from_numpy(v), bt),
          ref_comm.stochastic_round_int(jnp.asarray(v), jnp.asarray(bits)))
    _same(comm.stochastic_round_bf16(torch.from_numpy(x), bt),
          ref_comm.stochastic_round_bf16(jnp.asarray(x), jnp.asarray(bits)))


@pytest.mark.parametrize("frac", [1.0, 0.3, 1 / 14, 1e-6])
@pytest.mark.parametrize("n", [1, 676_171, 11_173_461])
def test_topk_count_matches_reference(frac, n):
    assert comm.topk_count(comm.WireSpec(topk_frac=frac), n) == \
        ref_comm.topk_count(ref_comm.WireSpec(topk_frac=frac), n)


@pytest.mark.parametrize("dtype,stochastic", [
    ("float32", False), ("bfloat16", False), ("int8", False),
    ("bfloat16", True), ("int8", True)])
def test_sparse_encode_bitwise_with_ties(dtype, stochastic):
    # 1000 entries, 143 nonzero, k = 384: the top-k reaches into the exact
    # zeros, and equal magnitudes of both signs compete
    x = np.zeros(1000, np.float32)
    x[::7] = np.random.default_rng(5).normal(size=143).astype(np.float32)
    x[5], x[12], x[19] = 0.5, -0.5, 0.5
    key = jax.random.PRNGKey(11)
    spec = comm.WireSpec(dtype, 128, topk_frac=0.3, stochastic=stochastic)
    rspec = ref_comm.WireSpec(dtype, 128, topk_frac=0.3,
                              stochastic=stochastic)
    k = comm.topk_count(spec, 1000)
    assert k == 384
    got = comm.sparse_encode(spec, torch.from_numpy(x), k,
                             bits=_bits_of(key))
    want = jax.jit(lambda v: ref_comm.sparse_encode(rspec, v, k, key=key))(
        jnp.asarray(x))
    assert got.indices.dtype == torch.int32
    assert bool((got.indices[1:] > got.indices[:-1]).all())
    _same(got.indices, want.indices)
    _same(got.payload, want.payload)
    if want.scales is not None:
        _same(got.scales, want.scales)
    _same(comm.sparse_decode(spec, got, 1000),
          ref_comm.sparse_decode(rspec, want, 1000))


def test_topk_breaks_ties_toward_the_lower_index():
    x = torch.tensor([0.0, 2.0, -2.0, 1.0, 2.0, 0.0, -1.0, 0.0])
    np.testing.assert_array_equal(comm.topk_indices(x, 4).numpy(),
                                  [1, 2, 3, 4])
    np.testing.assert_array_equal(comm.topk_indices(x, 6).numpy(),
                                  [0, 1, 2, 3, 4, 6])


SPECS = [dict(), dict(dtype="bfloat16"), dict(dtype="int8"),
         dict(dtype="int8", quant_block=32), dict(topk_frac=1 / 14),
         dict(dtype="bfloat16", topk_frac=0.3),
         dict(dtype="int8", topk_frac=1 / 14, stochastic=True,
              error_feedback=True)]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("n", [1, 676_171, 11_173_461])
def test_wire_bytes_match_reference_and_closed_form(kw, n):
    spec, rspec = comm.WireSpec(**kw), ref_comm.WireSpec(**kw)
    down = comm.wire_bytes(spec, n)
    assert down == ref_comm.wire_bytes(rspec, n) == \
        comm.analytic_wire_bytes(spec, n)
    up = comm.wire_bytes_up(spec, n)
    assert up == ref_comm.wire_bytes_up(rspec, n) == \
        comm.analytic_wire_bytes_up(spec, n)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_broadcast_roundtrip_matches_the_reference_round(dtype):
    params = resnet.init_params(torch.Generator().manual_seed(0), 10,
                                (8, 8, 8, 8))
    layout = flatten.build_layout(params, total_multiple=2048)
    spec = comm.WireSpec(dtype)
    got = comm.broadcast_roundtrip(spec, layout, params)
    ref_params = jax.tree.map(jnp.asarray, interop.to_reference(params))
    ref_layout = ref_flatten.build_layout(ref_params, total_multiple=2048)
    want = jax.jit(lambda t: ref_comm.broadcast_roundtrip(
        ref_comm.WireSpec(dtype), ref_layout, t))(ref_params)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        _same(a, b)
    buf = comm.encode_tree(spec, layout, params)
    assert comm.buffer_nbytes(buf) == comm.wire_bytes(spec, layout.n_flat)
    for a, b in zip(tree_leaves(comm.decode_tree(spec, layout, buf)),
                    tree_leaves(got)):
        assert torch.equal(a, b)


def test_eager_reference_scales_within_one_ulp():
    x = _values(128 * 512, seed=1, zero_groups=False)
    _, got = comm.quantize(torch.from_numpy(x), 128)
    _, eager = ref_comm.quantize(jnp.asarray(x), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(eager),
                               rtol=2.0 ** -23, atol=0)

"""Port parity of flash attention (K5's plain version) and the chunked path.

The same seeded numpy q, k, v go through the reference's oracle
(``flash_attention_ref``), its Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it on the CPU), its model path
(``chunked_causal_attention``) and the port's ``ops.flash_attention`` on
CPU tensors (the plain version the CUDA kernel is held against on the
card), over (S, H, Kh, Dh, window, softcap, dtype): GQA and MQA, ragged S,
window >= S, Dh 112 (kimi-k2's, which the kernels pad to 128), and S =
1024 with window 16 and with window 0, so the reference's local and
global chunked branches both run.

Tolerances: f32 at rtol = atol = 1e-5 (summation order).  bf16 at
rtol = atol = 2**-7 where both sides keep probabilities in f32 and round
only the output (at most one bf16 rounding apart, plus f32 order); the
chunked path rounds each probability to bf16 before the PV product
(``_attend``), about 2**-9 relative per term, so K5's contract and the
bf16 chunked path are held at 2e-2 (the reference's own kernel test uses
3e-2 there).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as ref_flash  # noqa: E402
from repro.models.attention import \
    chunked_causal_attention as ref_chunked  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models.attention import chunked_causal_attention  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
BF16_CHUNKED = dict(rtol=2e-2, atol=2e-2)

# (S, H, Kh, Dh, window, softcap, pallas block or 0 for no Pallas run)
CASES = [
    (64, 4, 4, 32, 0, 0.0, 32),
    (64, 4, 2, 64, 16, 0.0, 32),
    (100, 6, 2, 32, 30, 50.0, 50),      # ragged S
    (48, 10, 1, 32, 100, 0.0, 48),      # MQA, window >= S
    (128, 8, 4, 32, 32, 50.0, 64),      # gemma2-like softcap
    (1024, 4, 1, 32, 16, 0.0, 0),       # chunked local branch
    (1024, 2, 2, 32, 0, 50.0, 0),       # chunked global branch
    (96, 8, 2, 112, 0, 0.0, 32),        # kimi-k2's Dh 112, GQA
    (100, 4, 4, 112, 30, 50.0, 50),     # Dh 112, ragged S, window, softcap
]


def _inputs(s, h, kh, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    b = 2
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32) * 2
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32) * 2
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    tx = [interop.from_reference(np.asarray(a)) for a in jx]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kh,dh,window,cap,block", CASES)
def test_plain_flash_matches_reference(s, h, kh, dh, window, cap, block,
                                       dtype):
    jx, tx = _inputs(s, h, kh, dh, dtype, seed=s * h + dh + window)
    got = ops.flash_attention(*tx, window=window, softcap=cap)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    assert ops.flash_attention.launches == 0    # the CPU launches nothing
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(
        _f32(got), _f32(ref_flash(*jx, window=window, softcap=cap)), **tol)
    if block:
        pallas = flash_attention_pallas(*jx, window=window, softcap=cap,
                                        block_q=block, block_k=block,
                                        interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), **tol)
    chunked = ref_chunked(*jx, window=window, softcap_val=cap)
    np.testing.assert_allclose(_f32(got), _f32(chunked),
                               **(F32 if dtype == "float32" else
                                  BF16_CHUNKED))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kh,dh,window,cap,block", CASES)
def test_chunked_attention_matches_reference(s, h, kh, dh, window, cap,
                                             block, dtype):
    jx, tx = _inputs(s, h, kh, dh, dtype, seed=s + h * dh + window)
    got = chunked_causal_attention(*tx, window=window, softcap_val=cap)
    want = ref_chunked(*jx, window=window, softcap_val=cap)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))


def test_chunked_attention_rejects_ragged_long_sequences():
    _, tx = _inputs(600, 2, 1, 32, "float32", seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        chunked_causal_attention(*tx)


def test_plain_version_is_the_ref_module():
    _, tx = _inputs(40, 4, 2, 32, "float32", seed=3)
    assert torch.equal(ops.flash_attention(*tx, window=8, softcap=20.0),
                       flash_attention_ref(*tx, window=8, softcap=20.0))


def test_wrapper_rejects_bad_inputs():
    _, (q, k, v) = _inputs(16, 4, 2, 32, "float32", seed=1)
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=-1)


# a rank's query rows of a sequence split over ranks: (S, H, Kh, Dh, window,
# softcap, q_offset, rows) -- GQA with a window and softcap, MQA, Dh 112,
# the offset's rows crossing the window's edge, a ragged last rank
OFFSET_CASES = [
    (64, 4, 2, 32, 16, 50.0, 32, 32),
    (64, 4, 4, 64, 0, 0.0, 16, 16),
    (100, 10, 1, 32, 30, 0.0, 50, 50),
    (96, 8, 2, 112, 24, 30.0, 40, 33),
    (128, 8, 4, 32, 0, 50.0, 0, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kh,dh,window,cap,o,n", OFFSET_CASES)
def test_plain_flash_query_offset_matches_reference(s, h, kh, dh, window,
                                                    cap, o, n, dtype):
    """K5's plain version on query rows ``o .. o + n - 1`` against the key
    prefix ``k[:, :o + n]`` equals the reference's oracle on the whole
    sequence at those rows; so does the wrapper on CPU tensors, bitwise
    the plain version."""
    jx, tx = _inputs(s, h, kh, dh, dtype, seed=s + o + n + dh)
    q, k, v = tx
    rows = (q[:, o:o + n], k[:, :o + n], v[:, :o + n])
    got = flash_attention_ref(*rows, window=window, softcap=cap, q_offset=o)
    assert got.shape == rows[0].shape and got.dtype == q.dtype
    want = ref_flash(*jx, window=window, softcap=cap)[:, o:o + n]
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))
    wrapped = ops.flash_attention(*(x.contiguous() for x in rows),
                                  window=window, softcap=cap, q_offset=o)
    assert torch.equal(wrapped, got)
    assert ops.flash_attention.launches == 0


def test_query_offset_zero_is_the_whole_sequence_bitwise():
    _, tx = _inputs(48, 4, 2, 32, "float32", seed=5)
    assert torch.equal(flash_attention_ref(*tx, window=8, softcap=20.0),
                       flash_attention_ref(*tx, window=8, softcap=20.0,
                                           q_offset=0))


@pytest.mark.parametrize("window", [0, 1, 7, 40, 200])
def test_causal_pairs_with_an_offset_counts_the_kept_pairs(window):
    """``ops.causal_pairs(n, window, o)`` (the work K5 reports, and the
    bound's pairs) against a count of the mask the plain version keeps."""
    for o, n in ((0, 64), (20, 30), (63, 1), (100, 28)):
        qpos = o + np.arange(n)[:, None]
        kpos = np.arange(o + n)[None, :]
        keep = kpos <= qpos
        if window:
            keep &= qpos - kpos < window
        assert ops.causal_pairs(n, window, o) == int(keep.sum())
    # the smoke's offset rows: 4096 queries after 4096, global and window
    # 4096
    assert ops.causal_pairs(4096, 0, 4096) == 25_167_872
    assert ops.causal_pairs(4096, 4096, 4096) == 16_777_216
    assert ops.causal_pairs(4096, 0) == ops.causal_pairs(4096, 4096) == \
        8_390_656


def test_wrapper_rejects_rows_past_the_keys():
    _, (q, k, v) = _inputs(16, 4, 2, 32, "float32", seed=2)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q[:, 8:], k[:, :12], v[:, :12], q_offset=8)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)
    # rows 8..15 against all 16 keys is the contract
    got = ops.flash_attention(q[:, 8:].contiguous(), k, v, q_offset=8)
    np.testing.assert_array_equal(
        got.numpy(), ops.flash_attention(q, k, v)[:, 8:].numpy())

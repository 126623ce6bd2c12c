"""``models/attention.chunk2d_attention`` against the reference's: the port
of ``tests/test_chunk2d_attention.py``.

Values and gradients (of ``sum(out ** 2)`` with respect to q, k and v) of
the port's chunk2d held to the reference's ``chunk2d_attention`` on the
same numpy-drawn inputs, plain and with a window and a softcap together,
and over a shape whose chunks do not divide S (both fall back to the
chunked path), in f32 at rtol 1e-5 / atol 1e-6, the gradients' atol taken
relative to their largest magnitude (they reach 17-39 here, and the two
frameworks' sums over keys round apart by a few ulps of that: up to 1.4e-5,
8e-7 of the largest); the port's chunk2d against its own chunked path at
the reference test's 3e-5; and the ``seq2d`` branch of the attention layer
(a ``MeshPolicy`` of a ``seq2d`` config) against the reference's
``apply_attention`` under a ``seq2d`` policy: training through chunk2d,
prefill through ``flash_attention`` with values and chunk2d's ops on
``meta``, and a model axis of 2 refused on values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import base as ref_base  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.common import Policy as RefPolicy  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.roofline import torch_walk  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def inputs(b, s, h, kh, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, s, kh, dh), (b, s, kh, dh))]


def both(arrays, q_chunk, k_chunk, **kw):
    """(port out, its grads, reference out, its grads)."""
    r_out, vjp = jax.vjp(lambda q, k, v: ref_attn.chunk2d_attention(
        q, k, v, q_chunk=q_chunk, k_chunk=k_chunk, **kw),
        *[jnp.asarray(a) for a in arrays])
    r_grads = vjp(2.0 * r_out)      # d sum(out ** 2) / d out = 2 out
    p_in = [torch.tensor(a, requires_grad=True) for a in arrays]
    p_out = attention.chunk2d_attention(*p_in, q_chunk=q_chunk,
                                        k_chunk=k_chunk, **kw)
    p_grads = torch.autograd.grad(torch.sum(p_out ** 2), p_in)
    return p_out.detach(), p_grads, r_out, r_grads


def assert_close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def assert_grads_close(port, ref):
    for a, b in zip(port, ref):
        assert_close(a, b, atol=ATOL * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("window, softcap", [(0, 0.0), (24, 30.0)])
def test_chunk2d_matches_reference(window, softcap):
    arrays = inputs(2, 128, 6, 2, 16)
    p_out, p_grads, r_out, r_grads = both(arrays, 16, 32, window=window,
                                          softcap_val=softcap)
    assert_close(p_out, r_out)
    assert_grads_close(p_grads, r_grads)
    # the reference test's own check, on the port: chunk2d = chunked
    want = attention.chunked_causal_attention(
        *[torch.tensor(a) for a in arrays], window=window,
        softcap_val=softcap, q_chunk=32)
    assert_close(p_out, want.numpy(), rtol=3e-5, atol=3e-5)


def test_chunk2d_falls_back_where_chunks_do_not_divide():
    arrays = inputs(1, 96, 4, 2, 8, seed=1)     # 96 % 64: k_chunk 64
    p_out, p_grads, r_out, r_grads = both(arrays, 32, 64, window=40)
    assert_close(p_out, r_out)
    assert_grads_close(p_grads, r_grads)


class RefSeq2d(RefPolicy):
    seq2d = True


@pytest.mark.parametrize("window", [16])
def test_seq2d_branch_matches_reference(window):
    kw = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab_size=64, compute_dtype="float32", attn_shard="seq2d")
    ref_cfg = ref_base.ModelConfig(pattern=(ref_base.LayerSpec("attn"),),
                                   **kw)
    cfg = base.ModelConfig(pattern=(base.LayerSpec("attn"),), **kw)
    # weights drawn by the port, copied to the reference
    pp = attention.init_attention(torch.Generator().manual_seed(0), cfg)
    p = jax.tree.map(jnp.asarray, interop.to_reference(pp))
    h = np.random.default_rng(2).normal(size=(2, 64, 32)).astype(np.float32)
    want = ref_attn.apply_attention(p, jnp.asarray(h), ref_cfg,
                                    window=window, policy=RefSeq2d(),
                                    q_chunk=16)
    # a seq2d MeshPolicy whose model axis has size 1: every constrain is
    # the identity, and the branch is chunk2d's
    policy = sharding.MeshPolicy(mesh_lib.MeshShape((4, 1),
                                                    ("data", "model")), cfg)
    assert policy.seq2d
    got = attention.apply_attention_train(pp, torch.tensor(h), cfg,
                                          window=window, policy=policy,
                                          q_chunk=16)
    assert_close(got.detach(), want)

    # prefill: with values the sequence split is over a size-1 axis, so the
    # function is K5's and flash_attention computes it (its plain version
    # here); on meta (the dry-runs) it walks chunk2d's ops, as the
    # reference lowers them; a model axis of 2 with values raises
    got, counts = torch_walk.walk(attention.apply_attention, pp,
                                  torch.tensor(h), cfg, window=window,
                                  policy=policy, q_chunk=16)
    assert counts["kernels"]["flash_attention"]["calls"] == 1
    assert_close(got, want)
    meta = {k: t.to("meta") for k, t in pp.items()}
    got, counts = torch_walk.walk(attention.apply_attention, meta,
                                  torch.tensor(h, device="meta"), cfg,
                                  window=window, policy=policy, q_chunk=16)
    assert counts["kernels"] == {} and counts["flops"] > 0
    assert got.shape == want.shape and got.is_meta
    # a model axis of 2 with plain tensors (no live mesh): the sequence
    # split would need DTensors, so constrain raises
    wide = sharding.MeshPolicy(mesh_lib.MeshShape((2, 2), ("data", "model")),
                               cfg)
    with pytest.raises(TypeError, match="DTensor"):
        attention.apply_attention(pp, torch.tensor(h), cfg, window=window,
                                  policy=wide, q_chunk=16)

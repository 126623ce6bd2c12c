"""Port parity of the decoder LM's training path.

The reference's ``transformer.forward`` / ``forward_simple``, its
cross-entropy, ``_head_loss``'s chunked branch, ``associative_scan`` and
``chunked_causal_attention`` against the port's, on the same weights
(drawn by the reference, carried with ``interop``) and seeded numpy
tokens, at the configs of ``torch_lm_cases``.  (``LMAdapter``'s three
losses against ``jax.grad`` are in ``test_torch_lm_grads.py``.)

Tolerances: activations and losses in f32 at rtol 1e-4 / atol 1e-5; the
cross-entropy at rtol 1e-6 (f32 logits) and 1e-5 (bf16 logits, whose f32
sums differ only in summation order), its gradient at 1e-5 (f32) and one
bf16 rounding (bf16); the training scan at rtol 1e-5 / atol 1e-6 in
value and gradient.  ``remat=True`` against ``remat=False``, and
checkpointed against unchecked chunked attention, are held bitwise:
recomputation runs the same ops on the same inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from torch_lm_cases import (CASES, config_pair, params_pair,  # noqa
                            port_grads, tokens)

from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.models import attention, common, rglru  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
S = 16


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_forward_simple_match_reference(case):
    ref_cfg, cfg = config_pair(case)
    ref_p, p = params_pair(ref_cfg, seed=1)
    tok = tokens(2, S, cfg.vocab_size, seed=2)[:, :-1]
    want_exit, want_final, _ = jax.jit(ref_tfm.forward, static_argnums=1)(
        ref_p, ref_cfg, jnp.asarray(tok))
    want_simple = jax.jit(ref_tfm.forward_simple, static_argnums=1)(
        ref_p, ref_cfg, jnp.asarray(tok))
    got_exit, got_final, aux = tfm.forward(p, cfg, torch.from_numpy(tok))
    got_simple = tfm.forward_simple(p, cfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got_exit.numpy(), _np(want_exit), **TOL)
    np.testing.assert_allclose(got_final.numpy(), _np(want_final), **TOL)
    np.testing.assert_allclose(got_simple.numpy(), _np(want_simple), **TOL)
    assert float(aux["load_balance"]) == float(aux["router_z"]) == 0.0
    # the exit activation of the complex pass IS the simple model's output
    assert torch.equal(got_exit, got_simple)


def test_loss_simple_gradient_is_zero_outside_the_prefix():
    ref_cfg, cfg = config_pair("gemma2-2b-deep")
    _, p = params_pair(ref_cfg)
    tok = torch.from_numpy(tokens(2, S, cfg.vocab_size))
    leaves = tree_leaves(p)
    for x in leaves:
        x.requires_grad_(True)
    grads = torch.autograd.grad(LMAdapter(cfg).loss_simple(p, {"tokens": tok}),
                                leaves, allow_unused=True)
    by_leaf = dict(zip(map(id, leaves), grads))
    for x in tree_leaves(p["rem"]) + tree_leaves(p["final_norm"]):
        assert by_leaf[id(x)] is None
    for x in tree_leaves(p["periods"]):
        g = by_leaf[id(x)]
        assert g.shape == x.shape
        assert not g[cfg.exit_period:].any() and g[:cfg.exit_period].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 7, 4096)) * 4).astype(np.float32)
    labels = rng.integers(0, 4096, size=(3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    tol = dict(rtol=1e-6 if dtype == "float32" else 1e-5, atol=0)
    for name, args, targs in (
            ("sum", (), ()), ("mean", (), ()),
            ("masked", (jnp.asarray(mask),), (torch.from_numpy(mask),))):
        ref_fn = (ref_common.softmax_cross_entropy_sum if name == "sum"
                  else ref_common.softmax_cross_entropy)
        fn = (common.softmax_cross_entropy_sum if name == "sum"
              else common.softmax_cross_entropy)
        want, want_g = jax.value_and_grad(
            lambda x: ref_fn(x, jnp.asarray(labels), *args))(jl)
        x = tl.clone().requires_grad_(True)
        got = fn(x, torch.from_numpy(labels), *targs)
        (got_g,) = torch.autograd.grad(got, [x])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), **tol)
        assert got_g.dtype == x.dtype
        np.testing.assert_allclose(got_g.float().numpy(), _np(want_g),
                                   rtol=1e-5 if dtype == "float32"
                                   else 2.0 ** -8, atol=1e-7)


@pytest.mark.parametrize("head", ["final", "exit"])
def test_head_loss_chunked_branch_matches_reference(head):
    ref_cfg, cfg = config_pair("gemma2-2b-deep")
    ref_p, p = params_pair(ref_cfg, seed=6)
    rng = np.random.default_rng(7)
    h = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    ref = RefLMAdapter(ref_cfg)
    want, want_g = jax.value_and_grad(
        lambda hh: ref._head_loss(ref_p, hh, jnp.asarray(labels), None,
                                  head, chunk=4))(jnp.asarray(h))
    port = LMAdapter(cfg)
    x = torch.from_numpy(h).requires_grad_(True)
    got = port._head_loss(p, x, torch.from_numpy(labels), head, chunk=4)
    (got_g,) = torch.autograd.grad(got, [x])
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), _np(want_g), **TOL)
    # one piece (chunk too large to split) gives the same mean
    whole = port._head_loss(p, x.detach(), torch.from_numpy(labels), head)
    np.testing.assert_allclose(whole.item(), got.item(), rtol=1e-6)


@pytest.mark.parametrize("case", ["recurrentgemma-2b-deep", "attn4"])
def test_remat_is_bitwise_equal_to_no_remat(case):
    _, cfg = config_pair(case)
    _, p = params_pair(config_pair(case)[0], seed=8)
    batch = {"tokens": torch.from_numpy(tokens(2, S, cfg.vocab_size, 9))}
    loss_a, g_a = port_grads(LMAdapter(cfg, remat=False).loss_side, p, batch)
    loss_b, g_b = port_grads(LMAdapter(cfg, remat=True).loss_side, p, batch)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))


@pytest.mark.parametrize("s", [1, 37, 64])
def test_training_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 5)).astype(np.float32)
    b = rng.normal(size=(2, s, 5)).astype(np.float32)
    ct = rng.normal(size=(2, s, 5)).astype(np.float32)

    def ref_scan(a, b):
        def combine(lhs, rhs):
            return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]
        return jax.lax.associative_scan(combine, (a, b), axis=1)[1]

    want, (want_ga, want_gb) = jax.jit(lambda a, b, ct: (
        ref_scan(a, b), jax.vjp(ref_scan, a, b)[1](ct)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ct))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = rglru.linear_scan(ta, tb)
    ga, gb = torch.autograd.grad(got, [ta, tb], torch.from_numpy(ct),
                                 allow_unused=True)
    ga = torch.zeros_like(ta) if ga is None else ga   # S = 1: y = b
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **tol)
    np.testing.assert_allclose(ga.numpy(), _np(want_ga), **tol)
    np.testing.assert_allclose(gb.numpy(), _np(want_gb), **tol)


@pytest.mark.parametrize("window", [0, 8, 24])
def test_checkpointed_chunked_attention_is_bitwise_unchecked(window,
                                                            monkeypatch):
    """q_chunk 8 over 32 positions: window 8 takes the local branch
    (window + chunk < S), 0 and 24 the chunked-global one.  The unchecked
    run swaps each chunk's checkpoint for the plain chunk body."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.normal(size=(2, 32, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    ct = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    want = ref_attn.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), window=window, softcap_val=5.0,
        q_chunk=8)

    def run():
        ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = attention.chunked_causal_attention(
            *ins, window=window, softcap_val=5.0, q_chunk=8)
        return out, torch.autograd.grad(out, ins, torch.from_numpy(ct))

    o1, g1 = run()
    monkeypatch.setattr(attention, "_attend_remat", attention._attend)
    o2, g2 = run()
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    np.testing.assert_allclose(o1.detach().numpy(), _np(want), **TOL)


def test_training_path_never_reaches_the_prefill_kernels(monkeypatch):
    """Training runs the plain attention and scan itself; K5's and K6's
    wrappers (no backward) still refuse tensors that require grad."""
    def boom(*args, **kwargs):
        raise AssertionError("a prefill kernel wrapper was called")

    ref_cfg, cfg = config_pair("recurrentgemma-2b-deep")
    _, p = params_pair(ref_cfg)
    batch = {"tokens": torch.from_numpy(tokens(2, S, cfg.vocab_size))}
    monkeypatch.setattr(fa_ops, "flash_attention", boom)
    monkeypatch.setattr(attention, "flash_attention", boom)
    monkeypatch.setattr(scan_ops, "lru_scan", boom)
    monkeypatch.setattr(scan_ops, "lru_scan_gated", boom)
    port_grads(LMAdapter(cfg).loss_side, p, batch)
    LMAdapter(cfg).evaluate(p, batch)
    monkeypatch.undo()
    x = torch.ones((1, 4, 2, 8), requires_grad=True)
    with pytest.raises(Exception):
        fa_ops.flash_attention(x, x, x)
    with pytest.raises(Exception):
        scan_ops.lru_scan(torch.ones((1, 4, 3), requires_grad=True),
                          torch.ones((1, 4, 3)))


@functools.lru_cache(maxsize=None)
def _reference_eval():
    """The reference's metrics on the grouped-evaluation test's batch
    (computed once for its three cases)."""
    ref_cfg, _ = config_pair("gemma2-2b-deep")
    ref_p, _ = params_pair(ref_cfg, seed=11)
    tok = tokens(5, S, ref_cfg.vocab_size, seed=12)
    want = RefLMAdapter(ref_cfg).evaluate(ref_p,
                                          {"tokens": jnp.asarray(tok)})
    return {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("rows", [1, 3, 64])
def test_evaluate_in_row_groups_matches_reference(rows, monkeypatch):
    """``LMAdapter.evaluate`` groups the batch's rows to bound its logits;
    any grouping gives the reference's metrics."""
    from repro_torch.core import adapters
    ref_cfg, cfg = config_pair("gemma2-2b-deep")
    _, p = params_pair(ref_cfg, seed=11)
    tok = tokens(5, S, cfg.vocab_size, seed=12)
    want = _reference_eval()
    monkeypatch.setattr(adapters, "EVAL_LOGITS",
                        rows * S * cfg.vocab_size)
    got = LMAdapter(cfg).evaluate(p, {"tokens": torch.from_numpy(tok)})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=0,
                                   atol=1e-5, err_msg=key)

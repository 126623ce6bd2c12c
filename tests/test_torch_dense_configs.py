"""The dense configs gemma3-4b, minitron-8b and starcoder2-15b in the port,
held to the JAX package on the CPU.

Ports of ``tests/test_arch_smoke.py``'s four checks for these archs (a
reduced forward and one FedHeN side-objective SGD step, a reduced decode
step, the full configs' parameter counts, the exit layer on a period
boundary), each also against the reference on the same weights (drawn by
the reference, carried with ``interop``) and seeded numpy tokens; and of
``tests/test_decode_consistency.py::test_dense_gqa`` /
``::test_local_global_softcap`` and ``tests/test_prefill.py::
test_prefill_dense`` / ``::test_prefill_local_window``, with the port's
logits also held to the reference's.  The reduced configs are f32: logits,
losses and gradients at rtol 1e-4 / atol 1e-5; the decode-against-forward
invariants at the reference's own tolerances (2e-3, 3e-3).  gemma3-4b is
the first ported config with ``use_qk_norm`` and starcoder2-15b the first
with the plain two-matrix MLP (``mlp_glu=False``).  The configs' fields
are held to the reference's by ``tests/test_torch_lm_common.py::
test_config_copies_match_reference``, which runs over ``configs.PORTED``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import LayerSpec as RefLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.sgd import sgd_update  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
DENSE = ("gemma3-4b", "minitron-8b", "starcoder2-15b")
# the reference's param_count() of each full config
PARAMS = {"gemma3-4b": 3_879_910_400, "minitron-8b": 8_833_474_560,
          "starcoder2-15b": 15_653_646_336}
# tests/test_arch_smoke.py's published-size bounds, in billions
EXPECTED_PARAMS = {"gemma3-4b": (3.0, 5.0), "minitron-8b": (7.0, 10.0),
                   "starcoder2-15b": (13.0, 17.5)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(ref_cfg, seed=0):
    ref_p = ref_tfm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, interop.from_reference(jax.tree.map(np.asarray, ref_p))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_reduced_forward_and_fedhen_step(name):
    ref_cfg, cfg = ref_configs.get_reduced(name), configs.get_reduced(name)
    assert cfg.n_layers <= 3 and cfg.d_model <= 256
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((2, 17), cfg.vocab_size, seed=1)
    inputs = tok[:, :-1]

    # forward shapes and logits against the reference's
    w_exit, w_final, _ = ref_tfm.forward(ref_p, ref_cfg, jnp.asarray(inputs))
    g_exit, g_final, _ = tfm.forward(p, cfg, torch.from_numpy(inputs))
    assert tuple(g_final.shape) == (2, 16, cfg.d_model)
    assert g_exit.shape == g_final.shape
    np.testing.assert_allclose(_f32(g_final), _f32(w_final), **TOL)
    np.testing.assert_allclose(_f32(g_exit), _f32(w_exit), **TOL)
    logits = tfm.logits_from_hidden(p, cfg, g_final, "final")
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    np.testing.assert_allclose(
        _f32(logits),
        _f32(ref_tfm.logits_from_hidden(ref_p, ref_cfg, w_final, "final")),
        **TOL)

    # one FedHeN side-objective SGD step: loss and gradients against
    # jax.grad of the reference's LMAdapter.loss_side
    ref_loss = RefLMAdapter(ref_cfg).loss_side
    want, want_g = jax.jit(jax.value_and_grad(ref_loss))(
        ref_p, {"tokens": jnp.asarray(tok)})
    leaves, treedef = tree_flatten(p)
    for x in leaves:
        x.requires_grad_(True)
    adapter = LMAdapter(cfg)
    loss = adapter.loss_side(p, {"tokens": torch.from_numpy(tok)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    new_p = sgd_update(p, tree_unflatten(treedef, grads), 0.1,
                       clip_norm=10.0)
    for x in tree_leaves(new_p):
        assert not bool(torch.isnan(x).any())
    loss2 = adapter.loss_side(new_p, {"tokens": torch.from_numpy(tok)})
    assert np.isfinite(loss2.item())


@pytest.mark.parametrize("name", DENSE)
def test_reduced_decode_step(name):
    ref_cfg, cfg = ref_configs.get_reduced(name), configs.get_reduced(name)
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((2, 1), cfg.vocab_size, seed=2)
    want, ref_cache = ref_tfm.decode_step(ref_p, ref_tfm.init_cache(
        ref_cfg, 2, 32), ref_cfg, jnp.asarray(tok), jnp.int32(0))
    cache = tfm.init_cache(cfg, 2, 32)
    got, new_cache = tfm.decode_step(p, cache, cfg, torch.from_numpy(tok), 0)
    assert not bool(torch.isnan(got).any())
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    ref_leaves = jax.tree.leaves(ref_cache)
    got_leaves = tree_leaves(new_cache)
    assert [tuple(x.shape) for x in got_leaves] == [x.shape
                                                    for x in ref_leaves]
    for g, w in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


@pytest.mark.parametrize("name", DENSE)
def test_full_config_param_counts(name):
    cfg = configs.get_config(name)
    assert cfg.param_count() == PARAMS[name] == \
        ref_configs.get_config(name).param_count()
    lo, hi = EXPECTED_PARAMS[name]
    assert lo <= cfg.param_count() / 1e9 <= hi
    # the FedHeN subnet is a strict, nontrivial sub-network
    s = cfg.simple_param_count()
    assert s == ref_configs.get_config(name).simple_param_count()
    assert 0 < s < cfg.param_count()


@pytest.mark.parametrize("name", DENSE)
def test_exit_layer_on_period_boundary(name):
    for cfg in (configs.get_config(name), configs.get_reduced(name)):
        k = cfg.resolved_exit_layer
        assert k % cfg.period == 0
        assert cfg.period <= k <= cfg.n_layers
    if name == "gemma3-4b":     # 5 periods of 6 and 4 remainder layers
        cfg = configs.get_config(name)
        assert (cfg.resolved_exit_layer, cfg.n_periods,
                cfg.n_remainder) == (12, 5, 4)


# -- tests/test_decode_consistency.py and tests/test_prefill.py -------------

def _both(**kw):
    """The reference's and the port's ModelConfig of the same fields."""
    pattern = kw.pop("pattern")
    return (RefModelConfig(pattern=tuple(RefLayerSpec(*s) for s in pattern),
                           **kw),
            ModelConfig(pattern=tuple(LayerSpec(*s) for s in pattern), **kw))


def _roundtrip(ref_cfg, cfg, tol, b=2, s=16):
    """The port's decode, token by token, against its own forward (the
    reference test's invariant and tolerance), and both against the
    reference's forward logits at TOL."""
    ref_p, p = _pair(ref_cfg)
    tokens = _tokens((b, s), cfg.vocab_size, seed=1)
    _, w_final, _ = ref_tfm.forward(ref_p, ref_cfg, jnp.asarray(tokens))
    want = _f32(ref_tfm.logits_from_hidden(ref_p, ref_cfg, w_final, "final"))
    toks = torch.from_numpy(tokens)
    _, final_h, _ = tfm.forward(p, cfg, toks)
    ref = _f32(tfm.logits_from_hidden(p, cfg, final_h, "final"))
    np.testing.assert_allclose(ref, want, **TOL)
    cache = tfm.init_cache(cfg, b, s)
    outs = []
    for t in range(s):
        lg, cache = tfm.decode_step(p, cache, cfg, toks[:, t:t + 1], t)
        outs.append(_f32(lg))
    dec = np.concatenate(outs, axis=1)
    assert float(np.abs(dec - ref).max()) < tol
    assert not np.isnan(dec).any()
    np.testing.assert_allclose(dec, want, **TOL)


def test_dense_gqa():
    _roundtrip(*_both(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=97, pattern=(("attn",),),
                      exit_layer=2, compute_dtype="float32"), 2e-3)


def test_local_global_softcap():
    _roundtrip(*_both(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab_size=97, window=6,
                      attn_logit_softcap=50.0, final_logit_softcap=30.0,
                      pattern=(("local_attn",), ("attn",)),
                      exit_layer=2, compute_dtype="float32"), 2e-3)


def _prefill_check(ref_cfg, cfg, tol=3e-3, s=12, t=4, b=2):
    """Prefill of S tokens then T decode steps against the port's forward
    over S + T (the reference test's invariant and tolerance), and the
    prefill and decode logits against the reference's prefill and decode
    at TOL."""
    ref_p, p = _pair(ref_cfg)
    total = s + t
    tokens = _tokens((b, total), cfg.vocab_size, seed=1)
    toks = torch.from_numpy(tokens)
    _, final_h, _ = tfm.forward(p, cfg, toks)
    ref = _f32(tfm.logits_from_hidden(p, cfg, final_h, "final"))
    want_p, ref_cache = ref_tfm.prefill(ref_p, ref_cfg,
                                        jnp.asarray(tokens[:, :s]),
                                        cache_len=total)
    logits_p, cache = tfm.prefill(p, cfg, toks[:, :s], cache_len=total)
    np.testing.assert_allclose(_f32(logits_p), ref[:, :s], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_f32(logits_p), _f32(want_p), **TOL)
    for i in range(s, total):
        want, ref_cache = ref_tfm.decode_step(
            ref_p, ref_cache, ref_cfg, jnp.asarray(tokens[:, i:i + 1]),
            jnp.int32(i))
        lg, cache = tfm.decode_step(p, cache, cfg, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_f32(lg), ref[:, i:i + 1], rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(_f32(lg), _f32(want), **TOL)


def test_prefill_dense():
    _prefill_check(*_both(n_layers=3, d_model=48, n_heads=4, n_kv_heads=2,
                          d_ff=96, vocab_size=61, pattern=(("attn",),),
                          exit_layer=1, compute_dtype="float32"))


def test_prefill_local_window():
    _prefill_check(*_both(n_layers=2, d_model=48, n_heads=2, n_kv_heads=2,
                          d_ff=96, vocab_size=61, window=5,
                          pattern=(("local_attn",),),
                          exit_layer=1, compute_dtype="float32"))


@pytest.mark.parametrize("name", DENSE)
def test_reduced_prefill_and_decode_against_forward(name):
    """The same prefill invariant on each reduced dense config, past
    gemma3-4b's window of 16."""
    ref_cfg, cfg = ref_configs.get_reduced(name), configs.get_reduced(name)
    _prefill_check(ref_cfg, cfg, s=24, t=4)

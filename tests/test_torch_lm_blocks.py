"""Port parity of the attention and RG-LRU blocks, prefill and decode.

Reference weights (``repro.models.attention.init_attention``,
``repro.models.rglru.init_rglru``) are carried across with ``interop``;
inputs are seeded numpy.  Prefill attention in the port goes through
``ops.flash_attention`` (on the CPU its plain version), the reference's
through ``chunked_causal_attention``: the same function, held at f32
rtol 1e-4 / atol 1e-5.  The caches are compared exactly where they are
copies (K/V ring-buffer layout, the RG-LRU conv history) and at the float
tolerance where they are computed.  The port's decode updates its cache
in place; the reference returns a new one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import attention, rglru  # noqa: E402
from test_torch_lru_scan_gated import (  # noqa: E402
    assert_within_gate_bound, scan_gate_bound)

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _pair(tree):
    return interop.from_reference(jax.tree.map(np.asarray, tree))


def _attn_setup(arch, s, seed):
    ref_cfg, cfg = ref_reduced(arch), configs.get_reduced(arch)
    ref_p = ref_attn.init_attention(jax.random.PRNGKey(seed), ref_cfg)
    h = np.random.default_rng(seed).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, ref_p, _pair(ref_p), h


@pytest.mark.parametrize("arch,window", [("gemma2-2b", 16),
                                         ("gemma2-2b", 0),
                                         ("recurrentgemma-2b", 16),
                                         ("recurrentgemma-2b", 64),
                                         # use_qk_norm (gemma3-4b)
                                         ("gemma3-4b", 16),
                                         ("gemma3-4b", 0)])
@pytest.mark.parametrize("s", [40, 24])
def test_attention_prefill_and_kv_cache(arch, window, s):
    ref_cfg, cfg, ref_p, p, h = _attn_setup(arch, s, seed=s + window)
    want, wk, wv = ref_attn.apply_attention(ref_p, jnp.asarray(h), ref_cfg,
                                            window=window, return_kv=True)
    got, k, v = attention.apply_attention(p, torch.from_numpy(h), cfg,
                                          window=window, return_kv=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(k.numpy(), _np(wk), **TOL)
    np.testing.assert_allclose(v.numpy(), _np(wv), **TOL)
    # window < S (a wrapped ring) and window >= S, with and without room
    for cache_len in (None, s + 8):
        want_c = ref_attn.kv_to_cache(wk, wv, ref_cfg, window=window,
                                      cache_len=cache_len)
        got_c = attention.kv_to_cache(interop.from_reference(_np(wk)),
                                      interop.from_reference(_np(wv)), cfg,
                                      window=window, cache_len=cache_len)
        for key in ("k", "v"):
            np.testing.assert_array_equal(got_c[key].numpy(),
                                          _np(want_c[key]))


@pytest.mark.parametrize("arch,window", [("gemma2-2b", 16),
                                         ("gemma2-2b", 0),
                                         ("recurrentgemma-2b", 16),
                                         ("gemma3-4b", 16)])
def test_attention_decode_steps_from_prefill_cache(arch, window):
    s, steps = 20, 6
    ref_cfg, cfg, ref_p, p, h = _attn_setup(arch, s + steps, seed=3)
    _, wk, wv = ref_attn.apply_attention(ref_p, jnp.asarray(h[:, :s]),
                                         ref_cfg, window=window,
                                         return_kv=True)
    ref_cache = ref_attn.kv_to_cache(wk, wv, ref_cfg, window=window,
                                     cache_len=s + steps)
    cache = interop.from_reference(jax.tree.map(np.asarray, ref_cache))
    for t in range(s, s + steps):
        x = h[:, t:t + 1]
        want, ref_cache = ref_attn.apply_attention_decode(
            ref_p, jnp.asarray(x), ref_cache, jnp.int32(t), ref_cfg,
            window=window)
        got, cache = attention.apply_attention_decode(
            p, torch.from_numpy(x), cache, t, cfg, window=window)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       _np(ref_cache[key]), **TOL)


def test_attention_prefill_rejects_what_the_reference_rejects():
    ref_cfg, cfg, ref_p, p, h = _attn_setup("gemma2-2b", 520, seed=1)
    with pytest.raises(ValueError, match="not divisible"):
        ref_attn.apply_attention(ref_p, jnp.asarray(h), ref_cfg)
    with pytest.raises(ValueError, match="not divisible"):
        attention.apply_attention(p, torch.from_numpy(h), cfg)


def test_attention_decode_past_the_global_cache_raises():
    _, cfg, _, p, h = _attn_setup("gemma2-2b", 1, seed=1)
    cache = attention.init_kv_cache(cfg, 2, 4)
    with pytest.raises(ValueError, match="beyond"):
        attention.apply_attention_decode(p, torch.from_numpy(h), cache, 4,
                                         cfg)


def test_init_kv_cache_shapes_match_reference():
    ref_cfg, cfg = ref_reduced("gemma2-2b"), configs.get_reduced("gemma2-2b")
    for window in (0, 16, 64):
        want = ref_attn.init_kv_cache(ref_cfg, 3, 40, window=window)
        got = attention.init_kv_cache(cfg, 3, 40, window=window)
        assert tuple(got["k"].shape) == want["k"].shape
        assert got["k"].dtype == getattr(torch, str(want["k"].dtype))


def _rglru_setup(s, seed):
    ref_cfg = ref_reduced("recurrentgemma-2b")
    cfg = configs.get_reduced("recurrentgemma-2b")
    rng = np.random.default_rng(seed)
    ref_p = ref_rglru.init_rglru(jax.random.PRNGKey(seed), ref_cfg)
    dr = cfg.resolved_d_rnn
    # gates away from their zero init so they depend on x
    ref_p = dict(ref_p, **{k: jnp.asarray(rng.normal(size=dr) * 0.5,
                                          jnp.float32)
                           for k in ("w_r", "b_r", "w_i", "b_i")})
    h = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, ref_p, _pair(ref_p), h


@pytest.mark.parametrize("s", [2, 37])
def test_rglru_prefill_and_state_handoff(s):
    ref_cfg, cfg, ref_p, p, h = _rglru_setup(s, seed=s)
    want, ref_state = ref_rglru.apply_rglru(ref_p, jnp.asarray(h), ref_cfg,
                                            return_state=True)
    got, state = rglru.apply_rglru(p, torch.from_numpy(h), cfg,
                                   return_state=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # y[:, -1] in f32, held to the bound the gates' one-ulp exp
    # differences allow where a -> 1 (tests/test_torch_lru_scan_gated.py);
    # the conv history is the PRE-conv input
    xc = ref_rglru._causal_conv(ref_p, jnp.einsum(
        "bsd,dr->bsr", jnp.asarray(h), ref_p["w_in"]))
    bound = scan_gate_bound(ref_p, np.asarray(xc))[:, -1]
    assert_within_gate_bound(state["y"].numpy(), _np(ref_state["y"]),
                             bound, TOL)
    np.testing.assert_allclose(state["conv"].numpy(),
                               _np(ref_state["conv"]), **TOL)
    assert state["y"].dtype == torch.float32


def test_rglru_decode_continues_prefill():
    s, steps = 30, 6
    ref_cfg, cfg, ref_p, p, h = _rglru_setup(s + steps, seed=4)
    _, ref_cache = ref_rglru.apply_rglru(ref_p, jnp.asarray(h[:, :s]),
                                         ref_cfg, return_state=True)
    _, cache = rglru.apply_rglru(p, torch.from_numpy(h[:, :s]), cfg,
                                 return_state=True)
    full, _ = rglru.apply_rglru(p, torch.from_numpy(h), cfg,
                                return_state=True)
    for t in range(s, s + steps):
        x = h[:, t:t + 1]
        want, ref_cache = ref_rglru.apply_rglru_decode(
            ref_p, jnp.asarray(x), ref_cache, ref_cfg)
        got, cache = rglru.apply_rglru_decode(p, torch.from_numpy(x), cache,
                                              cfg)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        # the port's decode continues its own prefill of the longer prompt
        np.testing.assert_allclose(got.numpy(), full[:, t:t + 1].numpy(),
                                   **TOL)
        for key in ("y", "conv"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       _np(ref_cache[key]), **TOL)


def test_rglru_cache_shapes_match_reference():
    ref_cfg = ref_reduced("recurrentgemma-2b")
    want = ref_rglru.init_rglru_cache(ref_cfg, 3)
    got = rglru.init_rglru_cache(configs.get_reduced("recurrentgemma-2b"), 3)
    for key in ("y", "conv"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == getattr(torch, str(want[key].dtype))

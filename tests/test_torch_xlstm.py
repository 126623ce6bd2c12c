"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``) on the CPU.

Ports of ``tests/test_models_units.py::test_mlstm_chunked_matches_recurrent``
(chunks 1, 4, 8, 16) and ``::test_mlstm_chunked_carries_state``, each held
against the reference's chunked form as well as the port's own recurrent
form, and of ``tests/test_slstm_vjp.py``'s two tests, where the port's
sLSTM block (plain autograd over the steps) is held to the reference's
custom-VJP ``slstm_block``.  Inputs come from seeded numpy; every
comparison states its tolerance:

- f32 port against reference, same inputs: rtol 1e-4 / atol 1e-5 (TOL);
  the sLSTM block and its gradients at 2e-5;
- the chunked form against the recurrent one, the reference test's own
  tolerances (2e-4 on h; 2e-3 on C and n, 1e-4 on m);
- what ``_slstm_out`` computes after its bf16 cast: bf16 rounding, 2^-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.models import xlstm as ref_x  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
SLSTM_TOL = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _mlstm_inputs(b, s, nh, dh, seed, i_scale=2.0, f_shift=2.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, nh, dh)).astype(np.float32)
               for _ in range(3))
    i_raw = (rng.normal(size=(b, s, nh)) * i_scale).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.normal(size=(b, s, nh)).astype(np.float32) + f_shift)))
    return q, k, v, i_raw, log_f


def test_log_sigmoid_and_swish_are_the_references():
    """Within two f32 ulps: the frameworks' exp and log1p differ in the
    last bit on some inputs."""
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    np.testing.assert_array_max_ulp(
        xlstm.log_sigmoid(_t(x)).numpy(),
        np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))), maxulp=2)
    np.testing.assert_allclose(xlstm.swish(_t(x)).numpy(),
                               np.asarray(jax.nn.swish(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
def test_mlstm_chunked_matches_recurrent(chunk):
    b, s, nh, dh = 2, 16, 3, 8
    args = _mlstm_inputs(b, s, nh, dh, seed=0)
    targs = [_t(a) for a in args]
    h_rec, st_rec = xlstm.mlstm_recurrent(*targs)
    h_chk, st_chk = xlstm.mlstm_chunked(*targs, chunk=chunk)
    # the port's two forms, at the reference test's tolerances
    np.testing.assert_allclose(h_chk.numpy(), h_rec.numpy(), rtol=2e-4,
                               atol=2e-4)
    for key, tol in (("C", 2e-3), ("n", 2e-3), ("m", 1e-4)):
        np.testing.assert_allclose(st_chk[key].numpy(), st_rec[key].numpy(),
                                   rtol=tol, atol=tol)
    # each against the reference's own form
    jargs = [jnp.asarray(a) for a in args]
    wh_chk, wst_chk = ref_x.mlstm_chunked(*jargs, chunk=chunk)
    wh_rec, wst_rec = ref_x.mlstm_recurrent(*jargs)
    np.testing.assert_allclose(h_chk.numpy(), _np(wh_chk), **TOL)
    np.testing.assert_allclose(h_rec.numpy(), _np(wh_rec), **TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(st_chk[key].numpy(), _np(wst_chk[key]),
                                   **TOL)
        np.testing.assert_allclose(st_rec[key].numpy(), _np(wst_rec[key]),
                                   **TOL)


def test_mlstm_chunked_carries_state():
    """Two half-sequence chunked calls equal one full call (the reference
    test's 1e-4), and the carried halves equal the reference's."""
    args = _mlstm_inputs(1, 16, 2, 4, seed=1, i_scale=1.0, f_shift=1.0)
    t = [_t(a) for a in args]
    h_full, _ = xlstm.mlstm_chunked(*t, chunk=4)
    h1, st = xlstm.mlstm_chunked(*[a[:, :8] for a in t], chunk=4)
    h2, _ = xlstm.mlstm_chunked(*[a[:, 8:] for a in t], chunk=4, state=st)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(),
                               h_full.numpy(), rtol=1e-4, atol=1e-4)
    j = [jnp.asarray(a) for a in args]
    w1, wst = ref_x.mlstm_chunked(*[a[:, :8] for a in j], chunk=4)
    w2, _ = ref_x.mlstm_chunked(*[a[:, 8:] for a in j], chunk=4, state=wst)
    np.testing.assert_allclose(h1.numpy(), _np(w1), **TOL)
    np.testing.assert_allclose(h2.numpy(), _np(w2), **TOL)


def test_mlstm_chunked_refuses_a_ragged_sequence():
    t = [_t(a) for a in _mlstm_inputs(1, 12, 2, 4, seed=2)]
    with pytest.raises(ValueError, match="% chunk"):
        xlstm.mlstm_chunked(*t, chunk=8)
    with pytest.raises(ValueError, match="% chunk"):
        ref_x.mlstm_chunked(*[jnp.asarray(a.numpy()) for a in t], chunk=8)


def test_mlstm_chunked_grads_match_reference():
    """Gradients through the chunked form (each chunk recomputed in the
    backward pass) against jax.grad of the reference's."""
    args = _mlstm_inputs(2, 16, 2, 8, seed=3)
    t = [_t(a).requires_grad_() for a in args]
    h, st = xlstm.mlstm_chunked(*t, chunk=8)
    loss = torch.sum(h ** 2) + torch.sum(st["C"]) + torch.sum(st["n"])
    grads = torch.autograd.grad(loss, t)

    def f(*a):
        h, st = ref_x.mlstm_chunked(*a, chunk=8)
        return jnp.sum(h ** 2) + jnp.sum(st["C"]) + jnp.sum(st["n"])

    want = jax.grad(f, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in args])
    # rtol 1e-4, atol 1e-5 of each gradient's largest element: the
    # gradients reach ~400 and cancel to ~0.1 in places
    for g, w in zip(grads, want):
        w = _np(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


# -- sLSTM: tests/test_slstm_vjp.py ---------------------------------------

def _slstm_case(seed=0, b=2, t=8, nh=3, dh=4):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(b, t, 4, nh, dh)).astype(np.float32)
    r = (rng.normal(size=(4, nh, dh, dh)) * 0.3).astype(np.float32)
    state = {"c": np.zeros((b, nh, dh), np.float32),
             "n": np.zeros((b, nh, dh), np.float32) + np.float32(1e-6),
             "h": (rng.normal(size=(b, nh, dh)) * 0.1).astype(np.float32),
             "m": np.zeros((b, nh, dh), np.float32)}
    return xg, r, state


def test_slstm_block_forward_and_grads():
    """The port's block (plain autograd over the steps) against the
    reference's custom-VJP ``slstm_block``: forward and the gradients of
    xg, r and every state leaf, at 2e-5."""
    xg, r, state = _slstm_case()
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    whs, wst = ref_x.slstm_block(jnp.asarray(xg), jnp.asarray(r), jst)
    txg, tr = _t(xg).requires_grad_(), _t(r).requires_grad_()
    tst = {k: _t(v).requires_grad_() for k, v in state.items()}
    hs, st = xlstm.slstm_block(txg, tr, tst)
    np.testing.assert_allclose(hs.detach().numpy(), _np(whs), **SLSTM_TOL)
    for k in wst:
        np.testing.assert_allclose(st[k].detach().numpy(), _np(wst[k]),
                                   **SLSTM_TOL)

    def ref_loss(xg, r, state):
        hs, st = ref_x.slstm_block(xg, r, state)
        return jnp.sum(hs ** 2) + jnp.sum(st["c"] ** 2) \
            + jnp.sum(st["h"] * 0.3) + jnp.sum(st["n"]) \
            + 0.1 * jnp.sum(st["m"])

    loss = torch.sum(hs ** 2) + torch.sum(st["c"] ** 2) \
        + torch.sum(st["h"] * 0.3) + torch.sum(st["n"]) \
        + 0.1 * torch.sum(st["m"])
    keys = sorted(tst)
    got = torch.autograd.grad(loss, [txg, tr] + [tst[k] for k in keys])
    w_xg, w_r, w_st = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(xg), jnp.asarray(r), jst)
    for g, w in zip(got, [w_xg, w_r] + [w_st[k] for k in keys]):
        np.testing.assert_allclose(g.numpy(), _np(w), **SLSTM_TOL)


def test_slstm_cell_step_is_the_references():
    xg, r, state = _slstm_case(seed=4)
    want = ref_x.slstm_cell_step(jnp.asarray(xg[:, 0]), jnp.asarray(r),
                                 {k: jnp.asarray(v) for k, v in state.items()})
    got = xlstm.slstm_cell_step(_t(xg[:, 0]), _t(r),
                                {k: _t(v) for k, v in state.items()})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]), **SLSTM_TOL)


def _layer_cfgs():
    kw = dict(d_model=24, n_heads=2, n_kv_heads=2, compute_dtype="float32")
    return RefModelConfig(**kw), ModelConfig(**kw)


def test_slstm_layer_end_to_end_grads():
    """Through the whole sLSTM layer: every gradient finite, r's non-zero
    (the reference test's checks), and each against jax.grad of the
    reference's layer, at bf16 rounding: the layer's FFN runs in bf16
    after ``_slstm_out``'s cast."""
    ref_cfg, cfg = _layer_cfgs()
    ref_p = ref_x.init_slstm(jax.random.PRNGKey(1), ref_cfg)
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    h = np.random.default_rng(2).normal(size=(2, 12, 24)).astype(np.float32)
    leaves = {k: v.requires_grad_() for k, v in p.items()
              if isinstance(v, torch.Tensor)}
    out = xlstm.apply_slstm(p, _t(h), cfg)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(torch.sum(out ** 2), list(leaves.values()))
    for g in got:
        assert torch.isfinite(g).all()
    assert float(got[list(leaves).index("r")].abs().max()) > 0
    want = jax.grad(lambda p, h: jnp.sum(ref_x.apply_slstm(p, h, ref_cfg)
                                         ** 2))(ref_p, jnp.asarray(h))
    for name, g in zip(leaves, got):
        w = _np(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-2,
                                   atol=2e-2 * float(np.abs(w).max()),
                                   err_msg=name)


def test_slstm_out_casts_to_bf16_in_an_f32_config():
    """``_slstm_out`` rounds the cell output to bf16 before its norm even
    in an f32 config (reference xlstm.py:435): the port's output is bf16
    and within bf16 rounding of the reference's on the same hs, where the
    same layer kept in f32 parts from it by more than TOL."""
    ref_cfg, cfg = _layer_cfgs()
    ref_p = ref_x.init_slstm(jax.random.PRNGKey(3), ref_cfg)
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    hs = np.random.default_rng(4).normal(size=(2, 5, 2, 12)).astype(
        np.float32)
    want = _np(ref_x._slstm_out(ref_p, jnp.asarray(hs), ref_cfg))
    got = xlstm._slstm_out(p, _t(hs), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16)
    # the same layer without the cast
    from repro_torch.models import common
    from repro_torch.models.mlp import gelu
    h = common.apply_rmsnorm(p["norm"], _t(hs), cfg.norm_eps).reshape(2, 5, 24)
    f32 = torch.matmul(gelu(torch.matmul(h, p["ff_gate"])), p["ff_down"])
    assert not np.allclose(f32.numpy(), want, **TOL)


def test_k_scale_is_sqrt_dh_rounded_to_k_dtype():
    """``k / jnp.asarray(dh ** 0.5, k.dtype)``: in bf16 at the reduced
    config's Dh 128 the divisor is 11.3125, not 11.3137.  With wk = wq, k
    before the scale is q on each side, so each side's k is its q divided
    by that bf16 divisor, bitwise, where the unrounded divisor gives
    another k."""
    ref_cfg = ref_reduced("xlstm-1.3b").with_overrides(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = configs.get_reduced("xlstm-1.3b").with_overrides(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_p = ref_x.init_mlstm(jax.random.PRNGKey(5), ref_cfg)
    ref_p = dict(ref_p, wk=ref_p["wq"])
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    h = np.random.default_rng(6).normal(size=(2, 8, 128)).astype(np.float32)
    _, dh = xlstm._mlstm_dims(cfg)[1:]
    assert dh == 128
    rounded = torch.tensor(11.3125, dtype=torch.bfloat16)
    assert torch.tensor(dh ** 0.5).to(torch.bfloat16) == rounded
    _, _, q, k, _, _, _ = xlstm._mlstm_qkv_gates(
        p, _t(h).to(torch.bfloat16), cfg)
    assert torch.equal(k, q / rounded)
    assert not torch.equal(k, q / dh ** 0.5)
    _, _, wq, wk, _, _, _ = ref_x._mlstm_qkv_gates(
        ref_p, jnp.asarray(h).astype(jnp.bfloat16), ref_cfg)
    assert bool(jnp.all(wk == wq / jnp.asarray(11.3125, jnp.bfloat16)))


# -- the blocks: prefill state handoff and decode --------------------------

def _block_pair(kind, seed, bf16=False):
    ref_cfg = ref_reduced("xlstm-1.3b")
    cfg = configs.get_reduced("xlstm-1.3b")
    init = ref_x.init_mlstm if kind == "mlstm" else ref_x.init_slstm
    ref_p = init(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, ref_p, interop.from_reference(
        jax.tree.map(np.asarray, ref_p))


@pytest.mark.parametrize("s", [8, 24])
def test_mlstm_prefill_state_and_decode_match_reference(s):
    """The mLSTM layer's prefill (chunked, chunk 8) and its decode cache,
    then four decode steps, against the reference's; the cache's conv is
    the PRE-conv x."""
    ref_cfg, cfg, ref_p, p = _block_pair("mlstm", seed=s)
    rng = np.random.default_rng(s)
    h = rng.normal(size=(2, s + 4, 128)).astype(np.float32)
    want, wst = ref_x.apply_mlstm(ref_p, jnp.asarray(h[:, :s]), ref_cfg,
                                  return_state=True)
    got, st = xlstm.apply_mlstm(p, _t(h[:, :s]), cfg, return_state=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert sorted(st) == sorted(wst)
    for key in wst:
        assert st[key].dtype == getattr(torch, str(wst[key].dtype))
        np.testing.assert_allclose(st[key].numpy(), _np(wst[key]), **TOL)
    for t in range(s, s + 4):
        want, wst = ref_x.apply_mlstm_decode(
            ref_p, jnp.asarray(h[:, t:t + 1]), wst, ref_cfg)
        got, st = xlstm.apply_mlstm_decode(p, _t(h[:, t:t + 1]), st, cfg)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        for key in wst:
            np.testing.assert_allclose(st[key].numpy(), _np(wst[key]),
                                       **TOL)


def test_slstm_prefill_state_and_decode_match_reference():
    """The sLSTM layer's state after a prefill and after each decode step
    at TOL (f32 throughout); its output, after the bf16 cast, at bf16
    rounding."""
    ref_cfg, cfg, ref_p, p = _block_pair("slstm", seed=7)
    h = np.random.default_rng(7).normal(size=(2, 13, 128)).astype(np.float32)
    want, wst = ref_x.apply_slstm(ref_p, jnp.asarray(h[:, :10]), ref_cfg,
                                  return_state=True)
    got, st = xlstm.apply_slstm(p, _t(h[:, :10]), cfg, return_state=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=BF16["rtol"],
                               atol=BF16["atol"] * float(np.abs(
                                   _np(want)).max()))
    for key in wst:
        np.testing.assert_allclose(st[key].numpy(), _np(wst[key]), **TOL)
    for t in range(10, 13):
        want, wst = ref_x.apply_slstm_decode(
            ref_p, jnp.asarray(h[:, t:t + 1]), wst, ref_cfg)
        got, st = xlstm.apply_slstm_decode(p, _t(h[:, t:t + 1]), st, cfg)
        for key in wst:
            np.testing.assert_allclose(st[key].numpy(), _np(wst[key]),
                                       **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_caches_and_states_match_reference(kind):
    ref_cfg, cfg = ref_reduced("xlstm-1.3b"), configs.get_reduced(
        "xlstm-1.3b")
    if kind == "mlstm":
        want, got = ref_x.init_mlstm_cache(ref_cfg, 3), \
            xlstm.init_mlstm_cache(cfg, 3)
    else:
        want, got = ref_x.init_slstm_cache(ref_cfg, 3), \
            xlstm.init_slstm_cache(cfg, 3)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == getattr(torch, str(want[key].dtype))
        np.testing.assert_array_equal(got[key].numpy(), _np(want[key]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_matches_reference_shapes_dtypes_and_biases(kind):
    ref_cfg, cfg = ref_reduced("xlstm-1.3b").with_overrides(
        param_dtype="bfloat16"), configs.get_reduced(
        "xlstm-1.3b").with_overrides(param_dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    if kind == "mlstm":
        want = ref_x.init_mlstm(jax.random.PRNGKey(0), ref_cfg)
        got = xlstm.init_mlstm(g, cfg)
        exact = ("b_if",)
    else:
        want = ref_x.init_slstm(jax.random.PRNGKey(0), ref_cfg)
        got = xlstm.init_slstm(g, cfg)
        exact = ("b",)
    assert sorted(got) == sorted(want)
    for key in want:
        w = jax.tree.leaves(want[key])[0]
        x = [v for v in (got[key] if isinstance(got[key], dict)
                         else {"": got[key]}).values()][0]
        assert tuple(x.shape) == w.shape, key
        assert x.dtype == getattr(torch, str(w.dtype)), key
    for key in exact:
        np.testing.assert_array_equal(got[key].numpy(), _np(want[key]))

"""xlstm-1.3b in the port, held to the JAX package on the CPU.

Ports of ``tests/test_arch_smoke.py``'s checks for xlstm-1.3b (a reduced
forward and one FedHeN side-objective SGD step, a reduced decode step, the
full config's parameter count), ``tests/test_prefill.py::
test_prefill_xlstm`` and ``tests/test_decode_consistency.py::test_xlstm``,
each also against the reference's logits on the same weights (drawn by
the reference, carried with ``interop``) and seeded numpy tokens, and one
reduced fedhen round against the reference's.

Tolerances.  The sLSTM layer rounds its cell output ``hs`` to bf16 before
its norm even in an f32 config (``_slstm_out``), so an f32 difference of
one ulp between the frameworks can flip a bf16 rounding there: one bf16
ulp of ``hs`` (2^-8 relative) then reaches the logits.  So:

- ``hs`` before that cast, recorded on both sides: rtol 1e-4 / atol 1e-5
  (TOL), the port's f32 rule;
- logits, port against reference: the reference tests' own tolerances
  (6e-3 prefill, 5e-3 decode), the size of such a flip;
- the decode-against-forward invariants: those tolerances too;
- the round: with both packages' ``_slstm_out`` kept in f32, the LM
  rounds' rules (``assert_lm_round_matches``: parameters at rtol 1e-4 /
  atol 1e-5); as the configs run it, losses at rtol 1e-4 and each
  parameter's update at bf16 rounding (2^-7 of its scale).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models import xlstm as ref_x  # noqa: E402

from test_torch_dense_configs import _both, _f32, _pair, _tokens  # noqa
from test_torch_round_lm import ROUND, assert_lm_round_matches  # noqa: E402
from test_torch_round_lm import lm_shards  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.optim.sgd import sgd_update  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = 2.0 ** -7
ARCH = "xlstm-1.3b"
PARAMS = 1_882_968_064          # the reference's param_count()


@contextlib.contextmanager
def recorded_hs():
    """Record the cell output each ``_slstm_out`` call gets, before its
    bf16 cast, in both packages: ``(port, reference)`` lists of f32
    arrays.  The reference runs un-jitted so its values are concrete."""
    port, ref = [], []
    p_out, r_out = xlstm._slstm_out, ref_x._slstm_out

    def p_rec(p, hs, cfg):
        port.append(_f32(hs))
        return p_out(p, hs, cfg)

    def r_rec(p, hs, cfg):
        ref.append(_f32(hs))
        return r_out(p, hs, cfg)

    xlstm._slstm_out, ref_x._slstm_out = p_rec, r_rec
    try:
        with jax.disable_jit():
            yield port, ref
    finally:
        xlstm._slstm_out, ref_x._slstm_out = p_out, r_out


def _assert_hs_match(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **TOL)


def test_config_and_param_count():
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == PARAMS == \
        ref_configs.get_config(ARCH).param_count()
    assert 1.0 <= cfg.param_count() / 1e9 <= 2.0   # test_arch_smoke's bound
    s = cfg.simple_param_count()
    assert s == ref_configs.get_config(ARCH).simple_param_count()
    assert 0 < s < cfg.param_count()
    assert (cfg.n_periods, cfg.period, cfg.mlstm_chunk) == (6, 8, 1024)
    for c in (cfg, configs.get_reduced(ARCH)):
        assert c.resolved_exit_layer % c.period == 0


def test_reduced_forward_and_fedhen_step():
    ref_cfg, cfg = ref_configs.get_reduced(ARCH), configs.get_reduced(ARCH)
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((2, 17), cfg.vocab_size, seed=1)
    inputs = tok[:, :-1]
    with recorded_hs() as (port_hs, ref_hs):
        w_exit, w_final, _ = ref_tfm.forward(ref_p, ref_cfg,
                                             jnp.asarray(inputs))
        g_exit, g_final, _ = tfm.forward(p, cfg, torch.from_numpy(inputs))
    _assert_hs_match(port_hs, ref_hs)
    assert tuple(g_final.shape) == (2, 16, cfg.d_model)
    logits = tfm.logits_from_hidden(p, cfg, g_final, "final")
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    want = _f32(ref_tfm.logits_from_hidden(ref_p, ref_cfg, w_final, "final"))
    np.testing.assert_allclose(_f32(logits), want, rtol=6e-3, atol=6e-3)

    # one FedHeN side-objective SGD step: loss and gradients against
    # jax.grad of the reference's LMAdapter.loss_side
    ref_loss = RefLMAdapter(ref_cfg).loss_side
    w_loss, w_g = jax.jit(jax.value_and_grad(ref_loss))(
        ref_p, {"tokens": jnp.asarray(tok)})
    leaves, treedef = tree_flatten(p)
    for x in leaves:
        x.requires_grad_(True)
    adapter = LMAdapter(cfg)
    loss = adapter.loss_side(p, {"tokens": torch.from_numpy(tok)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(w_loss), rtol=1e-4)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    # the gradients flow back through the sLSTM's bf16 FFN on both sides:
    # bf16 rounding of each leaf's scale
    for g, w in zip(grads, jax.tree.leaves(w_g)):
        assert tuple(g.shape) == w.shape
        w = _f32(w)
        np.testing.assert_allclose(_f32(g), w, rtol=BF16,
                                   atol=BF16 * float(np.abs(w).max()))
    new_p = sgd_update(p, tree_unflatten(treedef, grads), 0.1,
                       clip_norm=10.0)
    for x in tree_leaves(new_p):
        assert not bool(torch.isnan(x).any())
    assert np.isfinite(adapter.loss_side(
        new_p, {"tokens": torch.from_numpy(tok)}).item())


def test_reduced_decode_step():
    ref_cfg, cfg = ref_configs.get_reduced(ARCH), configs.get_reduced(ARCH)
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((2, 1), cfg.vocab_size, seed=2)
    want, ref_cache = ref_tfm.decode_step(ref_p, ref_tfm.init_cache(
        ref_cfg, 2, 32), ref_cfg, jnp.asarray(tok), jnp.int32(0))
    got, cache = tfm.decode_step(p, tfm.init_cache(cfg, 2, 32), cfg,
                                 torch.from_numpy(tok), 0)
    assert not bool(torch.isnan(got).any())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=5e-3, atol=5e-3)
    ref_leaves, got_leaves = jax.tree.leaves(ref_cache), tree_leaves(cache)
    assert [tuple(x.shape) for x in got_leaves] == [x.shape
                                                    for x in ref_leaves]
    for g, w in zip(got_leaves, ref_leaves):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def test_prefill_xlstm():
    """``test_prefill.py::test_prefill_xlstm``: prefill 12 tokens, decode
    4, against the port's forward over 16 at the reference test's 6e-3;
    prefill and decode logits against the reference's at 6e-3, and the
    sLSTM cell outputs of the prefill at TOL."""
    ref_cfg, cfg = _both(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                         d_ff=0, vocab_size=61, mlstm_chunk=4,
                         pattern=(("mlstm", "none"), ("slstm", "none")),
                         exit_layer=2, compute_dtype="float32")
    tol = 6e-3
    s, t, b = 12, 4, 2
    ref_p, p = _pair(ref_cfg)
    tokens = _tokens((b, s + t), cfg.vocab_size, seed=1)
    toks = torch.from_numpy(tokens)
    _, final_h, _ = tfm.forward(p, cfg, toks)
    own = _f32(tfm.logits_from_hidden(p, cfg, final_h, "final"))
    with recorded_hs() as (port_hs, ref_hs):
        want_p, ref_cache = ref_tfm.prefill(
            ref_p, ref_cfg, jnp.asarray(tokens[:, :s]), cache_len=s + t)
        logits_p, cache = tfm.prefill(p, cfg, toks[:, :s], cache_len=s + t)
    _assert_hs_match(port_hs, ref_hs)
    np.testing.assert_allclose(_f32(logits_p), own[:, :s], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_f32(logits_p), _f32(want_p), rtol=tol,
                               atol=tol)
    for i in range(s, s + t):
        want, ref_cache = ref_tfm.decode_step(
            ref_p, ref_cache, ref_cfg, jnp.asarray(tokens[:, i:i + 1]),
            jnp.int32(i))
        lg, cache = tfm.decode_step(p, cache, cfg, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_f32(lg), own[:, i:i + 1], rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(_f32(lg), _f32(want), rtol=tol, atol=tol)


def test_xlstm_decode_roundtrip():
    """``test_decode_consistency.py::test_xlstm``: 16 decode steps from an
    empty cache against the port's forward (the reference test's 5e-3),
    and both against the reference's forward logits at 5e-3."""
    ref_cfg, cfg = _both(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=0, vocab_size=97, mlstm_chunk=4,
                         pattern=(("mlstm", "none"),) * 3
                         + (("slstm", "none"),),
                         exit_layer=4, compute_dtype="float32")
    tol, b, s = 5e-3, 2, 16
    ref_p, p = _pair(ref_cfg)
    tokens = _tokens((b, s), cfg.vocab_size, seed=1)
    toks = torch.from_numpy(tokens)
    with recorded_hs() as (port_hs, ref_hs):
        _, w_final, _ = ref_tfm.forward(ref_p, ref_cfg, jnp.asarray(tokens))
        _, final_h, _ = tfm.forward(p, cfg, toks)
    _assert_hs_match(port_hs, ref_hs)
    want = _f32(ref_tfm.logits_from_hidden(ref_p, ref_cfg, w_final, "final"))
    own = _f32(tfm.logits_from_hidden(p, cfg, final_h, "final"))
    np.testing.assert_allclose(own, want, rtol=tol, atol=tol)
    cache = tfm.init_cache(cfg, b, s)
    outs = []
    for i in range(s):
        lg, cache = tfm.decode_step(p, cache, cfg, toks[:, i:i + 1], i)
        outs.append(_f32(lg))
    dec = np.concatenate(outs, axis=1)
    assert float(np.abs(dec - own).max()) < tol
    assert not np.isnan(dec).any()
    np.testing.assert_allclose(dec, want, rtol=tol, atol=tol)


def test_ragged_sequence_raises_the_references_error():
    """A sequence the mLSTM chunk does not divide raises ValueError in
    both packages (never padded away): reduced chunk 8, 12 tokens."""
    ref_cfg, cfg = ref_configs.get_reduced(ARCH), configs.get_reduced(ARCH)
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((1, 12), cfg.vocab_size, seed=3)
    with pytest.raises(ValueError, match="% chunk"):
        ref_tfm.prefill(ref_p, ref_cfg, jnp.asarray(tok))
    with pytest.raises(ValueError, match="% chunk"):
        tfm.prefill(p, cfg, torch.from_numpy(tok))
    with pytest.raises(ValueError, match="% chunk"):
        LMAdapter(cfg).loss_side(p, {"tokens": torch.from_numpy(
            _tokens((1, 13), cfg.vocab_size, seed=3))})


@contextlib.contextmanager
def f32_slstm_out():
    """Both packages' ``_slstm_out`` without its bf16 cast: the reference's
    lines (xlstm.py:433-438) and the port's, with the norm and the FFN in
    the cell output's own dtype (f32 in the reduced config).  Patched
    before the reference's round is traced."""
    from repro.models import common as ref_common
    from repro_torch.models import common
    from repro_torch.models.mlp import gelu

    def ref_out(p, hs, cfg):
        b, s, nh, dh = hs.shape
        h = ref_common.apply_rmsnorm(p["norm"], hs, cfg.norm_eps).reshape(
            b, s, nh * dh)
        g = jnp.einsum("bsd,df->bsf", h, p["ff_gate"].astype(h.dtype))
        return jnp.einsum("bsf,fd->bsd", jax.nn.gelu(g),
                          p["ff_down"].astype(h.dtype))

    def port_out(p, hs, cfg):
        b, s, nh, dh = hs.shape
        h = common.apply_rmsnorm(p["norm"], hs, cfg.norm_eps).reshape(
            b, s, nh * dh)
        g = torch.matmul(h, p["ff_gate"].to(h.dtype))
        return torch.matmul(gelu(g), p["ff_down"].to(h.dtype))

    saved = xlstm._slstm_out, ref_x._slstm_out
    xlstm._slstm_out, ref_x._slstm_out = port_out, ref_out
    try:
        yield
    finally:
        xlstm._slstm_out, ref_x._slstm_out = saved


def _round_pair():
    ref_cfg, cfg = ref_configs.get_reduced(ARCH), configs.get_reduced(ARCH)
    kw = dict(algorithm="fedhen", **ROUND)
    shards = lm_shards(cfg.vocab_size)
    port = FederatedTrainer(LMAdapter(cfg), FedConfig(**kw), shards,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            schedule=ReferenceSchedule(0, kw["local_epochs"]))
    start = interop.to_reference(port.server.complex)

    class SameStart(RefLMAdapter):
        def init(self, key):
            return jax.tree.map(jnp.asarray, start)

    ref = RefTrainer(SameStart(ref_cfg), RefFedConfig(**kw),
                     [{k: jnp.asarray(v) for k, v in s.items()}
                      for s in shards])
    test = {"tokens": synthetic_lm(8, 16, cfg.vocab_size, seed=999)[
        "tokens"]}
    assert port.flat_mask.sum() < port.layout.n_params
    return port, ref, test


def test_one_xlstm_round_matches_reference():
    """One fedhen round of reduced xlstm-1.3b, port against reference,
    with both packages' sLSTM FFN kept in f32 (``f32_slstm_out``): losses
    and evaluation at 1e-5, both servers' parameters at rtol 1e-4 / atol
    1e-5 (``assert_lm_round_matches``).  Every other line of the round is
    the packages' own."""
    with f32_slstm_out():
        port, ref, test = _round_pair()
        assert_lm_round_matches(port, ref, test)


def test_one_xlstm_round_with_the_bf16_cast():
    """The same round as the configs run it, the bf16 cast in place: a
    one-ulp f32 difference flips some bf16 roundings of the sLSTM cell
    output, and the FFN's backward runs in bf16.  Losses and evaluation
    losses at rtol 1e-4; each leaf's update (after - before) at bf16
    rounding of its scale; accuracy within one token's argmax."""
    port, ref, test = _round_pair()
    before = [x.clone() for x in tree_leaves(port.server.complex)]
    pm, rm = port.run_round(), ref.run_round()
    for key in ("loss_simple", "loss_complex"):
        np.testing.assert_allclose(pm[key], rm[key], rtol=1e-4)
    assert pm["n_valid"] == rm["n_valid"]
    for x0, a, b in zip(before, tree_leaves(port.server.complex),
                        jax.tree.leaves(ref.server.complex)):
        want = np.asarray(b) - x0.numpy()
        np.testing.assert_allclose(a.numpy() - x0.numpy(), want, rtol=BF16,
                                   atol=BF16 * float(np.abs(want).max()))
    got = port.evaluate(test)
    want = ref.evaluate({"tokens": jnp.asarray(test["tokens"])})
    assert sorted(got) == sorted(want)
    one_token = 1.0 / test["tokens"][:, 1:].size
    for key in want:
        if key.startswith("acc"):
            assert abs(got[key] - want[key]) <= one_token, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=key)


def test_entry_points_run_on_the_cpu_and_otherwise_need_the_card(
        monkeypatch, capsys):
    """``launch/serve.py`` and ``launch/train.py`` take xlstm-1.3b (the
    reduced config) with ``--device cpu``; without it and without a card
    they raise, as for every arch."""
    from repro_torch.launch import serve, train
    stats = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len",
                        "16", "--gen", "4", "--device", "cpu"])
    assert set(stats) == {"exit_agreement", "exit_confident_frac"}
    args = ["--model", "lm", "--arch", ARCH, "--reduced", "--rounds", "1",
            "--clients", "4", "--participation", "0.5", "--data-points",
            "16", "--seq-len", "16", "--batch-size", "4", "--local-epochs",
            "1", "--eval-every", "1"]
    history = train.main(args + ["--device", "cpu"])
    assert len(history) == 1 and np.isfinite(history[0]["loss_complex"])
    assert "tok/s on CPU" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)

"""musicgen-large in the port (four parallel codebooks, audio conditioning
prepended), held to the JAX package on the CPU.

Weights are drawn by the reference and carried with ``interop``; tokens
``(B, S, n_codebooks)`` and conditioning embeddings are seeded numpy.
Tolerances, each stated where it is used:

* the codebook embedding (each codebook's rows summed in the tables'
  dtype, codebook 0 first, times sqrt(d_model) rounded to that dtype):
  bitwise, in f32 and in bf16 (XLA on the CPU rounds each bf16 add, as
  PyTorch does);
* logits, hidden states, caches, losses and gradients in f32 at rtol 1e-4
  / atol 1e-5 (the two frameworks' reductions differ in order);
* the ports of ``tests/test_decode_consistency.py::test_musicgen_codebooks``
  (decode against the forward, 2e-3) and of ``tests/test_arch_smoke.py``'s
  checks for the name;
* ``generate`` (greedy, and sampled on the reference's Gumbel noise):
  tokens and statistics equal; the adaptive mode with codebooks refused
  by the port and failing in the reference;
* one reduced fedhen round against the reference's, at
  ``assert_round_matches``' tolerances.

The full configs' parameter counts are held here for both configs of this
slice (musicgen-large and llava-next-34b), with the port's tree built on
fake tensors.  The frontend alone is ``tests/test_torch_frontend.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import LayerSpec as RefLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import StubFrontend as RefStubFrontend  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from test_torch_dense_configs import _f32, _pair  # noqa: E402
from test_torch_round_lm import ROUND, assert_lm_round_matches  # noqa
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from test_torch_serve import _reference_gumbel  # noqa: E402
from torch_lm_cases import port_grads  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import FedConfig, LayerSpec  # noqa: E402
from repro_torch.configs.base import ModelConfig, StubFrontend  # noqa
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.sgd import sgd_update  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

NAME = "musicgen-large"
TOL = dict(rtol=1e-4, atol=1e-5)
# the reference's param_count() of each full config of this slice; the
# tree holds exactly as many parameters
PARAMS = {"musicgen-large": 2_434_994_176, "llava-next-34b": 33_938_429_952}
SIMPLE = {"musicgen-large": 1_226_934_272, "llava-next-34b": 17_202_719_744}


def reduced(**over):
    """(reference, port) reduced musicgen-large with ``over``."""
    return (ref_configs.get_reduced(NAME).with_overrides(**over),
            configs.get_reduced(NAME).with_overrides(**over))


def codes(shape, cfg, seed):
    """Seeded int32 tokens of ``shape + (n_codebooks,)``."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=tuple(shape) + (cfg.n_codebooks,)
    ).astype(np.int32)


def conditioning(cfg, b, seed):
    """Seeded f32 frontend embeddings (b, n_tokens, d_in)."""
    f = cfg.frontend
    return np.random.default_rng(seed).normal(
        0.0, 0.5, size=(b, f.n_tokens, f.d_in)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_full_config_param_count_equals_the_tree(name, monkeypatch):
    """The full config's count, the reference's, and the port's tree at
    full width (built on fake tensors: no memory), leaf for leaf the
    shapes and dtypes of ``jax.eval_shape`` of the reference's
    ``init_params``; the FedHeN subnet is a strict part of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    assert cfg.param_count() == ref_cfg.param_count() == PARAMS[name]
    assert cfg.simple_param_count() == ref_cfg.simple_param_count() \
        == SIMPLE[name]
    assert cfg.resolved_exit_layer == cfg.n_layers // 2
    # trunc_normal_ reads its draws back (a data-dependent op fake
    # tensors cannot run); the shapes do not depend on it
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **k: t)
    with FakeTensorMode():
        got = [(tuple(x.shape), x.dtype) for x in tree_leaves(
            tfm.init_params(torch.Generator(), cfg))]
    want = jax.tree.leaves(jax.eval_shape(
        lambda: ref_tfm.init_params(jax.random.PRNGKey(0), ref_cfg)))
    assert [s for s, _ in got] == [x.shape for x in want]
    assert all(d == torch.bfloat16 for _, d in got)
    assert sum(int(np.prod(s)) for s, _ in got) == PARAMS[name]


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_codebook_embedding_is_bitwise_the_reference(dtypes):
    """Four codebooks summed in the tables' dtype, codebook 0 first, times
    sqrt(128) rounded to that dtype (11.3125 in bf16), then cast to the
    compute dtype: bitwise, tables of a wide spread so that the bf16 adds
    round."""
    param, compute = dtypes
    ref_cfg, cfg = reduced(n_codebooks=4, param_dtype=param,
                           compute_dtype=compute)
    tables = np.random.default_rng(1).normal(
        0.0, 3.0, size=(4, cfg.vocab_size, cfg.d_model)).astype(np.float32)
    ref_tab = jnp.asarray(tables).astype(param)
    tok = codes((2, 9), cfg, seed=2)
    want = ref_tfm.embed_inputs({"embed": {"tables": ref_tab}}, ref_cfg,
                                jnp.asarray(tok))
    got = tfm.embed_inputs(
        {"embed": {"tables": interop.from_reference(np.asarray(ref_tab))}},
        cfg, torch.from_numpy(tok))
    assert got.dtype == getattr(torch, compute)
    assert tuple(got.shape) == (2, 9, cfg.d_model)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_codebook_logits_match_reference():
    """One head per codebook over the tied tables: (B, S, NC, V), f32 at
    rtol 1e-4 / atol 1e-5, both heads."""
    ref_cfg, cfg = reduced(n_codebooks=4)
    ref_p, p = _pair(ref_cfg)
    h = np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)).astype(
        np.float32)
    for head in ("final", "exit"):
        want = ref_tfm.logits_from_hidden(ref_p, ref_cfg, jnp.asarray(h),
                                          head)
        got = tfm.logits_from_hidden(p, cfg, torch.from_numpy(h), head)
        assert tuple(got.shape) == (2, 7, 4, cfg.vocab_size)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def test_forward_simple_and_prefill_with_conditioning_match_reference():
    """The conditioning's 4 positions prepended: exit and final hidden
    states, the simple forward, prefill logits and caches, f32 at rtol
    1e-4 / atol 1e-5."""
    ref_cfg, cfg = reduced(n_layers=3, exit_layer=1)
    ref_p, p = _pair(ref_cfg)
    tok, ex = codes((2, 11), cfg, seed=4), conditioning(cfg, 2, seed=5)
    n = cfg.frontend.n_tokens + 11
    w_exit, w_final, _ = ref_tfm.forward(ref_p, ref_cfg, jnp.asarray(tok),
                                         extra_embeds=jnp.asarray(ex))
    g_exit, g_final, _ = tfm.forward(p, cfg, torch.from_numpy(tok),
                                     extra_embeds=torch.from_numpy(ex))
    assert tuple(g_final.shape) == (2, n, cfg.d_model)
    np.testing.assert_allclose(_f32(g_final), _f32(w_final), **TOL)
    np.testing.assert_allclose(_f32(g_exit), _f32(w_exit), **TOL)
    np.testing.assert_allclose(
        _f32(tfm.forward_simple(p, cfg, torch.from_numpy(tok),
                                extra_embeds=torch.from_numpy(ex))),
        _f32(ref_tfm.forward_simple(ref_p, ref_cfg, jnp.asarray(tok),
                                    extra_embeds=jnp.asarray(ex))), **TOL)
    want, ref_cache = ref_tfm.prefill(ref_p, ref_cfg, jnp.asarray(tok),
                                      extra_embeds=jnp.asarray(ex),
                                      cache_len=n + 3)
    got, cache = tfm.prefill(p, cfg, torch.from_numpy(tok),
                             extra_embeds=torch.from_numpy(ex),
                             cache_len=n + 3)
    assert tuple(got.shape) == (2, n, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    ref_leaves = jax.tree.leaves(ref_cache)
    got_leaves = tree_leaves(cache)
    assert [tuple(x.shape) for x in got_leaves] == [x.shape
                                                    for x in ref_leaves]
    for g, w in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


@pytest.mark.parametrize("loss", ["loss_complex", "loss_simple",
                                  "loss_side"])
@pytest.mark.parametrize("seq,n_cond", [(12, 4), (768, 256)])
def test_losses_and_gradients_match_reference(loss, seq, n_cond):
    """Each loss and its gradients against ``jax.grad`` of the
    reference's, with ``n_cond`` conditioning positions in the batch, f32
    at rtol 1e-4 / atol 1e-5: 12 tokens in one piece, and 768 (> 512, a
    multiple of 256) through the chunked CE, where each chunk's sum is the
    codebooks' CE sums divided by their count (256 conditioning positions
    make 1024 in all, which the reference's chunked attention needs: a
    multiple of its 512-query chunk)."""
    ref_cfg, cfg = reduced()
    ref_cfg = ref_cfg.with_overrides(frontend=RefStubFrontend(
        kind="audio_conditioning", n_tokens=n_cond, d_in=32))
    cfg = cfg.with_overrides(frontend=StubFrontend(
        kind="audio_conditioning", n_tokens=n_cond, d_in=32))
    ref_p, p = _pair(ref_cfg)
    b = 2 if seq < 256 else 1
    tok, ex = codes((b, seq + 1), cfg, seed=6), conditioning(cfg, b, seed=7)
    want, want_g = jax.jit(jax.value_and_grad(
        getattr(RefLMAdapter(ref_cfg), loss)))(
        ref_p, {"tokens": jnp.asarray(tok), "extra_embeds": jnp.asarray(ex)})
    got, grads = port_grads(getattr(LMAdapter(cfg), loss), p,
                            {"tokens": torch.from_numpy(tok),
                             "extra_embeds": torch.from_numpy(ex)})
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def test_evaluate_reads_codebook_zero_at_the_token_positions():
    """Both heads' accuracy and CE against the reference's (atol 1e-5),
    from codebook 0 at the token positions only: moving the other
    codebooks' last labels (which no input reads) leaves every metric as
    it was."""
    ref_cfg, cfg = reduced(n_codebooks=3)
    ref_p, p = _pair(ref_cfg)
    tok, ex = codes((3, 10), cfg, seed=8), conditioning(cfg, 3, seed=9)
    want = RefLMAdapter(ref_cfg).evaluate(
        ref_p, {"tokens": jnp.asarray(tok), "extra_embeds": jnp.asarray(ex)})
    adapter = LMAdapter(cfg)
    got = adapter.evaluate(p, {"tokens": torch.from_numpy(tok),
                               "extra_embeds": torch.from_numpy(ex)})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    moved = tok.copy()
    moved[:, -1, 1:] = (moved[:, -1, 1:] + 1) % cfg.vocab_size
    again = adapter.evaluate(p, {"tokens": torch.from_numpy(moved),
                                 "extra_embeds": torch.from_numpy(ex)})
    assert {k: float(v) for k, v in again.items()} == \
        {k: float(v) for k, v in got.items()}


# -- tests/test_decode_consistency.py and tests/test_arch_smoke.py ----------

def test_musicgen_codebooks():
    """The port of ``test_decode_consistency.py::test_musicgen_codebooks``:
    decoding (B, 1, 4) tokens one by one gives the forward's logits within
    the reference test's 2e-3, and both equal the reference's forward
    logits at rtol 1e-4 / atol 1e-5."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
              vocab_size=32, n_codebooks=4, exit_layer=1,
              compute_dtype="float32")
    ref_cfg = RefModelConfig(pattern=(RefLayerSpec("attn"),), **kw)
    cfg = ModelConfig(pattern=(LayerSpec("attn"),), **kw)
    ref_p, p = _pair(ref_cfg)
    b, s = 2, 16
    tokens = codes((b, s), cfg, seed=1)
    _, w_final, _ = ref_tfm.forward(ref_p, ref_cfg, jnp.asarray(tokens))
    want = _f32(ref_tfm.logits_from_hidden(ref_p, ref_cfg, w_final, "final"))
    toks = torch.from_numpy(tokens)
    _, final_h, _ = tfm.forward(p, cfg, toks)
    full = _f32(tfm.logits_from_hidden(p, cfg, final_h, "final"))
    np.testing.assert_allclose(full, want, **TOL)
    cache = tfm.init_cache(cfg, b, s)
    outs = []
    for t in range(s):
        lg, cache = tfm.decode_step(p, cache, cfg, toks[:, t:t + 1], t)
        assert tuple(lg.shape) == (b, 1, 4, 32)
        outs.append(_f32(lg))
    dec = np.concatenate(outs, axis=1)
    assert not np.isnan(dec).any()
    assert float(np.abs(dec - full).max()) < 2e-3
    np.testing.assert_allclose(dec, want, **TOL)


def test_reduced_forward_and_fedhen_step():
    """The port of ``test_arch_smoke.py``'s forward and side step for the
    name (16 positions: 4 of conditioning, 12 of tokens): shapes, no NaN,
    the loss and every gradient against ``jax.grad`` of the reference's
    ``loss_side`` at rtol 1e-4 / atol 1e-5, then an SGD step and a finite
    loss."""
    ref_cfg, cfg = reduced()
    assert cfg.n_layers <= 3 and cfg.d_model <= 256
    ref_p, p = _pair(ref_cfg)
    n_tok = 16 - cfg.frontend.n_tokens
    tok, ex = codes((2, n_tok + 1), cfg, seed=0), conditioning(cfg, 2, 1)
    batch = {"tokens": torch.from_numpy(tok),
             "extra_embeds": torch.from_numpy(ex)}
    exit_h, final_h, _ = tfm.forward(p, cfg, batch["tokens"][:, :-1],
                                     extra_embeds=batch["extra_embeds"])
    assert tuple(final_h.shape) == (2, 16, cfg.d_model)
    assert exit_h.shape == final_h.shape
    logits = tfm.logits_from_hidden(p, cfg, final_h, "final")
    assert tuple(logits.shape) == (2, 16, cfg.n_codebooks, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    want, want_g = jax.jit(jax.value_and_grad(
        RefLMAdapter(ref_cfg).loss_side))(
        ref_p, {"tokens": jnp.asarray(tok), "extra_embeds": jnp.asarray(ex)})
    adapter = LMAdapter(cfg)
    loss, grads = port_grads(adapter.loss_side, p, batch)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    _, treedef = tree_flatten(p)
    new_p = sgd_update(p, tree_unflatten(treedef, grads), 0.1,
                       clip_norm=10.0)
    assert not any(bool(torch.isnan(x).any()) for x in tree_leaves(new_p))
    assert np.isfinite(adapter.loss_side(new_p, batch).item())


def test_reduced_decode_step():
    """One (2, 1, NC) decode step from an empty cache against the
    reference's: logits and the new cache at rtol 1e-4 / atol 1e-5."""
    ref_cfg, cfg = reduced()
    ref_p, p = _pair(ref_cfg)
    tok = codes((2, 1), cfg, seed=2)
    want, ref_cache = ref_tfm.decode_step(
        ref_p, ref_tfm.init_cache(ref_cfg, 2, 32), ref_cfg, jnp.asarray(tok),
        jnp.int32(0))
    got, cache = tfm.decode_step(p, tfm.init_cache(cfg, 2, 32), cfg,
                                 torch.from_numpy(tok), 0)
    assert tuple(got.shape) == (2, 1, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    for g, w in zip(tree_leaves(cache), jax.tree.leaves(ref_cache)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


# -- serving ----------------------------------------------------------------

DEEP = dict(n_layers=5, exit_layer=2)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference(temperature):
    """``generate`` on (B, S, NC) prompts of the deepened config (the exit
    head before the last layer), greedy and sampled on the reference's
    own Gumbel noise: the same (B, S + gen, NC) tokens and the same exit
    statistics (agreement over every codebook's token)."""
    ref_cfg, cfg = reduced(**DEEP)
    ref_p, p = _pair(ref_cfg, seed=1)
    prompts, gen = codes((2, 12), cfg, seed=3), 6
    rng = jax.random.PRNGKey(3)
    want_tok, want_stats = ref_serve.generate(
        ref_p, ref_cfg, jnp.asarray(prompts), gen, temperature=temperature,
        rng=rng)
    got_tok, got_stats = serve.generate(
        p, cfg, torch.from_numpy(prompts).long(), gen,
        temperature=temperature,
        noise=_reference_gumbel(rng, gen) if temperature else None)
    assert tuple(got_tok.shape) == (2, 12 + gen, cfg.n_codebooks)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_stats == want_stats
    if temperature:
        greedy, _ = serve.generate(p, cfg, torch.from_numpy(prompts).long(),
                                   gen)
        assert not torch.equal(got_tok, greedy)  # the noise decided tokens


def test_adaptive_mode_with_codebooks_is_refused_as_the_reference_fails():
    """The reference's adaptive mode broadcasts its (B, NC) confident mask
    to (B, NC, NC) tokens and its next decode step raises; the port
    refuses the call up front."""
    ref_cfg, cfg = reduced()
    ref_p, p = _pair(ref_cfg)
    prompts = codes((2, 8), cfg, seed=4)
    with pytest.raises(ValueError, match="Einstein sum"):
        ref_serve.generate(ref_p, ref_cfg, jnp.asarray(prompts), 4,
                           adaptive_threshold=0.01)
    with pytest.raises(ValueError, match="codebooks"):
        serve.generate(p, cfg, torch.from_numpy(prompts).long(), 4,
                       adaptive_threshold=0.01)


def test_serve_main_runs_musicgen_on_the_cpu(capsys):
    stats = serve.main(["--arch", NAME, "--batch", "2", "--prompt-len",
                        "12", "--gen", "4", "--device", "cpu"])
    assert set(stats) == {"exit_agreement", "exit_confident_frac"}
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "sample tokens" in out


# -- training ---------------------------------------------------------------

def round_pair(ref_cfg, cfg, shards, **kw):
    """(port trainer, reference trainer) from the same weights and
    minibatch order; ``shards`` are numpy dicts, every key sliced by both
    trainers."""
    kw = dict(algorithm="fedhen", **ROUND, **kw)
    port = FederatedTrainer(LMAdapter(cfg), FedConfig(**kw),
                            [{k: torch.from_numpy(v) for k, v in s.items()}
                             for s in shards], device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            schedule=ReferenceSchedule(0, kw["local_epochs"]))
    start = interop.to_reference(port.server.complex)

    class SameStart(RefLMAdapter):
        def init(self, key):
            return jax.tree.map(jnp.asarray, start)

    ref = RefTrainer(SameStart(ref_cfg), RefFedConfig(**kw),
                     [{k: jnp.asarray(v) for k, v in s.items()}
                      for s in shards])
    return port, ref


def test_one_musicgen_round_matches_reference():
    """One fedhen round of reduced musicgen-large on ``synthetic_lm``'s
    codebook streams (as the training CLI draws them), port against
    reference at ``assert_round_matches``' tolerances; evaluation at atol
    1e-5."""
    ref_cfg, cfg = reduced()
    data = synthetic_lm(32, 16, cfg.vocab_size, seed=0,
                        n_codebooks=cfg.n_codebooks)
    shards = [{"tokens": s["tokens"]} for s in iid_split(data, 4, seed=1)]
    port, ref = round_pair(ref_cfg, cfg, shards)
    assert port.flat_mask.sum() < port.layout.n_params
    test = {"tokens": synthetic_lm(8, 16, cfg.vocab_size, seed=999,
                                   n_codebooks=cfg.n_codebooks)["tokens"]}
    assert test["tokens"].shape == (8, 17, cfg.n_codebooks)
    assert_lm_round_matches(port, ref, test)

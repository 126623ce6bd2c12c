"""Port parity of the serving path: prefill, decode with both heads, generate.

Reference weights (``repro.models.transformer.init_params``) are carried
across with ``interop``; prompts are seeded numpy.  Each arch runs as its
reduced config and deepened, so the stack has two or more periods, a
remainder, and an exit head before the last layer, with a prompt longer
than the window (40 against 16): the prefill then wraps the local layers'
ring buffers.  f32 at rtol 1e-4 / atol 1e-5: the reference's chunked
attention and associative scan against the port's plain K5 and K6 differ
only in summation order.

The bf16 variant (params and compute in bf16) is held at a looser
tolerance, stated below: the reference's ``_attend`` rounds each softmax
probability to bf16 before the PV product, while the port's prefill keeps
probabilities in f32 (K5's contract, which the reference's own
``ops.flash_attention`` declares equal to the chunked path); every layer
then rounds its own activations to bf16, so the two drift by a few bf16
ulps per layer.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import StubFrontend  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
S, STEPS, B = 40, 8, 2

# (arch, overrides): the reduced configs, and deepened ones whose exit head
# sits before the last layer (2+ periods, a remainder)
ARCHS = [("recurrentgemma-2b", {}),
         ("recurrentgemma-2b", dict(n_layers=8, exit_layer=3)),
         ("gemma2-2b", {}),
         ("gemma2-2b", dict(n_layers=5, exit_layer=2))]


# the dense configs, reduced as they are: gemma3-4b (qk-norm, window 16
# against the 40-token prompt), minitron-8b, starcoder2-15b (the plain MLP)
DENSE = [("gemma3-4b", {}), ("minitron-8b", {}), ("starcoder2-15b", {})]


def _configs(arch, overrides):
    return (ref_reduced(arch).with_overrides(**overrides),
            configs.get_reduced(arch).with_overrides(**overrides))


def _setup(arch, overrides, seed=0):
    ref_cfg, cfg = _configs(arch, overrides)
    ref_params = ref_tfm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = interop.from_reference(jax.tree.map(np.asarray, ref_params))
    codebooks = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S + STEPS) + codebooks).astype(np.int32)
    return ref_cfg, cfg, ref_params, params, tokens


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cache_leaves(cache):
    return [_f32(x) for x in tree_leaves(cache)]


@pytest.mark.parametrize("arch,overrides", ARCHS + DENSE)
def test_prefill_and_teacher_forced_decode_match_reference(arch, overrides):
    ref_cfg, cfg, ref_params, params, tokens = _setup(arch, overrides)
    assert cfg.n_layers == ref_cfg.n_layers
    want, ref_cache = ref_tfm.prefill(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, :S]),
                                      cache_len=S + STEPS)
    got, cache = tfm.prefill(params, cfg, torch.from_numpy(tokens[:, :S]),
                             cache_len=S + STEPS)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    ref_leaves = [_f32(x) for x in jax.tree.leaves(ref_cache)]
    got_leaves = _cache_leaves(cache)
    assert [x.shape for x in got_leaves] == [x.shape for x in ref_leaves]
    for g, w in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(g, w, **TOL)

    step = jax.jit(lambda c, t, p: ref_tfm.decode_step(
        ref_params, c, ref_cfg, t, p, with_exit_head=True))
    for t in range(S, S + STEPS):
        tok = tokens[:, t:t + 1]
        want, ref_cache, want_exit = step(ref_cache, jnp.asarray(tok),
                                          jnp.int32(t))
        got, cache, got_exit = tfm.decode_step(
            params, cache, cfg, torch.from_numpy(tok), t,
            with_exit_head=True)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
        np.testing.assert_allclose(_f32(got_exit), _f32(want_exit), **TOL)
    for g, w in zip(_cache_leaves(cache),
                    [_f32(x) for x in jax.tree.leaves(ref_cache)]):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("arch,overrides", ARCHS)
@pytest.mark.parametrize("threshold", [0.0, 0.004])
def test_greedy_generate_matches_reference(arch, overrides, threshold):
    ref_cfg, cfg, ref_params, params, tokens = _setup(arch, overrides,
                                                      seed=1)
    want_tok, want_stats = ref_serve.generate(
        ref_params, ref_cfg, jnp.asarray(tokens[:, :S]), STEPS,
        adaptive_threshold=threshold)
    got_tok, got_stats = serve.generate(
        params, cfg, torch.from_numpy(tokens[:, :S]).long(), STEPS,
        adaptive_threshold=threshold)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_stats == want_stats


def test_generate_statistics_are_exercised():
    """At this threshold the deepened model's exit head is confident on
    some tokens and not on others, and disagrees with the full head on
    some, so the statistics above compare real counts."""
    ref_cfg, cfg, ref_params, params, tokens = _setup(
        "recurrentgemma-2b", dict(n_layers=8, exit_layer=3), seed=1)
    _, stats = serve.generate(params, cfg,
                              torch.from_numpy(tokens[:, :S]).long(), STEPS,
                              adaptive_threshold=0.004)
    assert 0.0 < stats["exit_confident_frac"] < 1.0
    assert 0.0 < stats["exit_agreement"] < 1.0


def test_sampled_generate_is_seeded_and_shares_noise_across_heads():
    _, cfg, _, params, tokens = _setup("gemma2-2b",
                                       dict(n_layers=5, exit_layer=2))
    prompts = torch.from_numpy(tokens[:, :S]).long()
    runs = [serve.generate(params, cfg, prompts, STEPS, temperature=0.8,
                           noise=serve.SeededGumbel(
                               torch.Generator().manual_seed(5)))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    greedy, _ = serve.generate(params, cfg, prompts, STEPS)
    assert not torch.equal(runs[0][0], greedy)


def _reference_gumbel(rng, gen):
    """A noise provider that draws what the reference's ``generate`` draws
    inside ``jax.random.categorical``: Gumbel noise of the logits' shape
    and dtype on the unsplit ``rng`` for the first token, then on the key
    of one split per decode step."""
    keys = [rng]
    for _ in range(gen - 1):
        rng, key = jax.random.split(rng)
        keys.append(key)

    def noise(step, shape, dtype):
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        g = jax.random.gumbel(keys[step], shape, jdt)
        return torch.from_numpy(np.array(g.astype(jnp.float32))).to(dtype)
    return noise


@pytest.mark.parametrize("arch,overrides", [ARCHS[1], ARCHS[3]])
def test_sampled_generate_matches_reference(arch, overrides):
    """Temperature 0.8 with the reference's own noise: the same tokens and
    the same exit statistics as the reference's ``generate``."""
    ref_cfg, cfg, ref_params, params, tokens = _setup(arch, overrides,
                                                      seed=1)
    rng = jax.random.PRNGKey(3)
    want_tok, want_stats = ref_serve.generate(
        ref_params, ref_cfg, jnp.asarray(tokens[:, :S]), STEPS,
        adaptive_threshold=0.004, temperature=0.8, rng=rng)
    prompts = torch.from_numpy(tokens[:, :S]).long()
    got_tok, got_stats = serve.generate(
        params, cfg, prompts, STEPS, adaptive_threshold=0.004,
        temperature=0.8, noise=_reference_gumbel(rng, STEPS))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_stats == want_stats
    greedy, _ = serve.generate(params, cfg, prompts, STEPS,
                               adaptive_threshold=0.004)
    assert not torch.equal(got_tok, greedy)     # the noise decided tokens


# the MoE archs' bf16 case, where a near-tie's routing can flip on a
# bf16 ulp of the activations, is in tests/test_torch_moe_configs.py
@pytest.mark.parametrize("arch", [a for a in configs.PORTED
                                  if configs.get_reduced(a).moe is None])
def test_bf16_prefill_and_decode_match_reference(arch):
    overrides = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_cfg, cfg, ref_params, params, tokens = _setup(arch, overrides)
    want, ref_cache = ref_tfm.prefill(ref_params, ref_cfg,
                                      jnp.asarray(tokens[:, :S]),
                                      cache_len=S + STEPS)
    got, cache = tfm.prefill(params, cfg, torch.from_numpy(tokens[:, :S]),
                             cache_len=S + STEPS)
    assert got.dtype == torch.bfloat16
    # logits of a few bf16 layers drift apart by some bf16 ulps of the
    # largest logit (2**-8 relative each), from the probability rounding
    # above and each package's own bf16 rounding of the activations:
    # measured 1.25% (recurrentgemma) and 0.83% (gemma2) of max|logit| on
    # these inputs, held at 5%
    bf16 = dict(rtol=0.0, atol=0.05 * float(np.abs(_f32(want)).max()))
    np.testing.assert_allclose(_f32(got), _f32(want), **bf16)
    step = jax.jit(lambda c, t, p: ref_tfm.decode_step(
        ref_params, c, ref_cfg, t, p, with_exit_head=True))
    for t in range(S, S + STEPS):
        tok = tokens[:, t:t + 1]
        want, ref_cache, want_exit = step(ref_cache, jnp.asarray(tok),
                                          jnp.int32(t))
        got, cache, got_exit = tfm.decode_step(
            params, cache, cfg, torch.from_numpy(tok), t,
            with_exit_head=True)
        np.testing.assert_allclose(_f32(got), _f32(want), **bf16)
        np.testing.assert_allclose(_f32(got_exit), _f32(want_exit), **bf16)


@pytest.mark.parametrize("arch,overrides", ARCHS)
def test_decode_reproduces_prefill(arch, overrides):
    """The port's own serving invariant (the counterpart of
    tests/test_decode_consistency.py): decoding token by token, from an
    empty cache or from a prefill of the first half, gives the logits
    the prefill of the whole sequence gives, position by position."""
    _, cfg, _, params, tokens = _setup(arch, overrides, seed=2)
    n = S + STEPS
    toks = torch.from_numpy(tokens).long()
    full, _ = tfm.prefill(params, cfg, toks)
    cache = tfm.init_cache(cfg, B, n)
    for t in range(n):
        got, cache = tfm.decode_step(params, cache, cfg, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_f32(got[:, 0]), _f32(full[:, t]), **TOL)
    half, cache = tfm.prefill(params, cfg, toks[:, :S], cache_len=n)
    np.testing.assert_allclose(_f32(half), _f32(full[:, :S]), **TOL)
    for t in range(S, n):
        got, cache = tfm.decode_step(params, cache, cfg, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_f32(got[:, 0]), _f32(full[:, t]), **TOL)


def test_init_cache_matches_reference_layout():
    ref_cfg, cfg = _configs("recurrentgemma-2b", dict(n_layers=8))
    want = jax.tree.leaves(ref_tfm.init_cache(ref_cfg, 3, 50))
    got = tree_leaves(tfm.init_cache(cfg, 3, 50))
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]


def test_init_params_matches_reference_tree():
    for arch, overrides in ARCHS:
        ref_cfg, cfg = _configs(arch, overrides)
        want = jax.tree.leaves(ref_tfm.init_params(jax.random.PRNGKey(0),
                                                   ref_cfg))
        got = tree_leaves(tfm.init_params(torch.Generator().manual_seed(0),
                                          cfg))
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        assert [str(x.dtype).replace("torch.", "") for x in got] == \
            [str(x.dtype) for x in want]
        assert sum(x.numel() for x in got) == sum(x.size for x in want)


def test_codebook_and_frontend_configs_initialise_and_match_reference():
    """Codebooks and a frontend on reduced gemma2-2b (local and global
    layers, softcaps): the port's own init gives the reference's leaf
    shapes, and on the reference's weights ``forward`` and
    ``forward_simple`` match the reference's at rtol 1e-4 / atol 1e-5."""
    from repro.configs.base import StubFrontend as RefStubFrontend
    ref_cfg, cfg = _configs("gemma2-2b", {})
    for over, ref_over, nc in (
            (dict(n_codebooks=2), dict(n_codebooks=2), 2),
            (dict(frontend=StubFrontend(kind="vision", n_tokens=8,
                                        d_in=48)),
             dict(frontend=RefStubFrontend(kind="vision", n_tokens=8,
                                           d_in=48)), 1)):
        c, rc = cfg.with_overrides(**over), ref_cfg.with_overrides(**ref_over)
        want = jax.tree.leaves(ref_tfm.init_params(jax.random.PRNGKey(0), rc))
        mine = tree_leaves(tfm.init_params(torch.Generator().manual_seed(0),
                                           c))
        assert [tuple(x.shape) for x in mine] == [x.shape for x in want]
        ref_params = ref_tfm.init_params(jax.random.PRNGKey(1), rc)
        params = interop.from_reference(jax.tree.map(np.asarray, ref_params))
        rng = np.random.default_rng(2)
        tokens = rng.integers(0, c.vocab_size, size=(2, 12) + (
            (nc,) if nc > 1 else ())).astype(np.int32)
        extra = (rng.normal(size=(2, 8, 48)).astype(np.float32)
                 if c.frontend is not None else None)
        kw = ({} if extra is None else dict(extra_embeds=extra))
        w_exit, w_final, _ = ref_tfm.forward(
            ref_params, rc, jnp.asarray(tokens),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        g_exit, g_final, _ = tfm.forward(
            params, c, torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(_f32(g_final), _f32(w_final), **TOL)
        np.testing.assert_allclose(_f32(g_exit), _f32(w_exit), **TOL)
        np.testing.assert_allclose(
            _f32(tfm.forward_simple(
                params, c, torch.from_numpy(tokens),
                **{k: torch.from_numpy(v) for k, v in kw.items()})),
            _f32(ref_tfm.forward_simple(
                ref_params, rc, jnp.asarray(tokens),
                **{k: jnp.asarray(v) for k, v in kw.items()})), **TOL)


def test_serve_main_runs_on_the_cpu(capsys):
    stats = serve.main(["--arch", "recurrentgemma-2b", "--batch", "2",
                        "--prompt-len", "24", "--gen", "4",
                        "--adaptive-threshold", "0.5", "--device", "cpu"])
    assert set(stats) == {"exit_agreement", "exit_confident_frac"}
    out = capsys.readouterr().out
    assert "tok/s on CPU" in out and "sample tokens" in out


def test_serve_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "2"])
    with pytest.raises(FileNotFoundError):
        serve.main(["--checkpoint", "missing.npz", "--device", "cpu"])

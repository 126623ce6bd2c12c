"""llava-next-34b in the port (the VLM: projected patch embeddings
prepended to the text), held to the JAX package on the CPU.

Weights are drawn by the reference and carried with ``interop``; tokens
and patch embeddings are seeded numpy (``synthetic_frontend_embeds``, the
port's copy, array-equal to the reference's).  Tolerances, each stated
where it is used:

* the frontend projection: f32 at rtol = atol = 1e-6; bf16 within one
  bf16 rounding (2**-8 relative and absolute), the two frameworks' bf16
  products rounding their f32 sums apart; the text positions bitwise;
* logits, hidden states, caches, losses and gradients in f32 at rtol 1e-4
  / atol 1e-5;
* prefill with the frontend, then decode steps: against the reference's
  decode at rtol 1e-4 / atol 1e-5 and against the port's own forward over
  the whole sequence within ``tests/test_prefill.py``'s 3e-3;
* one reduced fedhen round with patch embeddings in the shards (each
  trainer slices every key of a shard) against the reference's, at
  ``assert_round_matches``' tolerances.

The full config's parameter count is held in
``tests/test_torch_codebooks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from test_torch_codebooks import round_pair  # noqa: E402
from test_torch_dense_configs import _f32, _pair, _tokens  # noqa: E402
from test_torch_round import assert_round_matches  # noqa: E402
from torch_lm_cases import port_grads  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_frontend_embeds  # noqa
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.sgd import sgd_update  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402

NAME = "llava-next-34b"
TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2.0 ** -8, atol=2.0 ** -8)


def reduced(**over):
    """(reference, port) reduced llava-next-34b with ``over``."""
    return (ref_configs.get_reduced(NAME).with_overrides(**over),
            configs.get_reduced(NAME).with_overrides(**over))


def patches(cfg, b, seed):
    f = cfg.frontend
    return synthetic_frontend_embeds(b, f.n_tokens, f.d_in, seed=seed)


@pytest.mark.parametrize("shape,seed", [((3, 8, 48), 0), ((1, 2880, 1152), 7),
                                        ((2, 64, 1024), 3)])
def test_synthetic_frontend_embeds_equal_the_reference(shape, seed):
    got = synthetic_frontend_embeds(*shape, seed=seed)
    want = ref_synthetic.synthetic_frontend_embeds(*shape, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontend_projection_matches_reference(dtype):
    """The patches projected by ``frontend_proj`` in the compute dtype and
    prepended: f32 at 1e-6, bf16 within one bf16 rounding; the text
    positions after them bitwise."""
    ref_cfg, cfg = reduced(param_dtype=dtype, compute_dtype=dtype)
    ref_p, p = _pair(ref_cfg)
    tok, ex = _tokens((2, 5), cfg.vocab_size, seed=1), patches(cfg, 2, 2)
    want = ref_tfm.embed_inputs(ref_p, ref_cfg, jnp.asarray(tok),
                                jnp.asarray(ex))
    got = tfm.embed_inputs(p, cfg, torch.from_numpy(tok),
                           torch.from_numpy(ex))
    n = cfg.frontend.n_tokens
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, n + 5, cfg.d_model)
    np.testing.assert_allclose(
        _f32(got[:, :n]), _f32(want[:, :n]),
        **(dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else BF16))
    np.testing.assert_array_equal(_f32(got[:, n:]), _f32(want[:, n:]))


def test_forward_simple_and_prefill_with_patches_match_reference():
    """8 patch positions prepended to 12 text tokens: exit and final
    hidden states, the simple forward, prefill logits and caches, f32 at
    rtol 1e-4 / atol 1e-5."""
    ref_cfg, cfg = reduced(n_layers=3, exit_layer=1)
    ref_p, p = _pair(ref_cfg)
    tok, ex = _tokens((2, 12), cfg.vocab_size, seed=3), patches(cfg, 2, 4)
    n = cfg.frontend.n_tokens + 12
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
                                      cache_len=n + 4)
    got, cache = tfm.prefill(p, cfg, torch.from_numpy(tok),
                             extra_embeds=torch.from_numpy(ex),
                             cache_len=n + 4)
    assert tuple(got.shape) == (2, n, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    ref_leaves = jax.tree.leaves(ref_cache)
    got_leaves = tree_leaves(cache)
    assert [tuple(x.shape) for x in got_leaves] == [x.shape
                                                    for x in ref_leaves]
    for g, w in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def test_prefill_with_patches_then_decode():
    """Prefill of 8 patch positions and 12 tokens, then 4 decode steps
    (both heads) from position 20: against the reference's decode at rtol
    1e-4 / atol 1e-5, and the final head against the port's own forward
    over patches and all 16 tokens within 3e-3 (``tests/test_prefill.py``'s
    invariant and tolerance)."""
    ref_cfg, cfg = reduced(n_layers=3, exit_layer=1)
    ref_p, p = _pair(ref_cfg)
    s, t = 12, 4
    tok, ex = _tokens((2, s + t), cfg.vocab_size, seed=5), patches(cfg, 2, 6)
    n = cfg.frontend.n_tokens
    toks, ext = torch.from_numpy(tok), torch.from_numpy(ex)
    _, final_h, _ = tfm.forward(p, cfg, toks, extra_embeds=ext)
    full = _f32(tfm.logits_from_hidden(p, cfg, final_h, "final"))
    _, ref_cache = ref_tfm.prefill(ref_p, ref_cfg, jnp.asarray(tok[:, :s]),
                                   extra_embeds=jnp.asarray(ex),
                                   cache_len=n + s + t)
    logits, cache = tfm.prefill(p, cfg, toks[:, :s], extra_embeds=ext,
                                cache_len=n + s + t)
    np.testing.assert_allclose(_f32(logits), full[:, :n + s], rtol=3e-3,
                               atol=3e-3)
    step = jax.jit(lambda c, tk, pos: ref_tfm.decode_step(
        ref_p, c, ref_cfg, tk, pos, with_exit_head=True))
    for i in range(s, s + t):
        want, ref_cache, want_exit = step(
            ref_cache, jnp.asarray(tok[:, i:i + 1]), jnp.int32(n + i))
        got, cache, got_exit = tfm.decode_step(
            p, cache, cfg, toks[:, i:i + 1], n + i, with_exit_head=True)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
        np.testing.assert_allclose(_f32(got_exit), _f32(want_exit), **TOL)
        np.testing.assert_allclose(_f32(got), full[:, n + i:n + i + 1],
                                   rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("loss", ["loss_complex", "loss_simple",
                                  "loss_side"])
@pytest.mark.parametrize("seq,n_patches", [(12, 8), (768, 256)])
def test_losses_and_gradients_match_reference(loss, seq, n_patches):
    """Each loss and its gradients against ``jax.grad`` of the
    reference's, f32 at rtol 1e-4 / atol 1e-5, the CE over the text
    positions only: 12 tokens after 8 patches in one piece; 768 (> 512, a
    multiple of 256) after 256 patches through the chunked CE (1024
    positions in all, a multiple of the reference's 512-query attention
    chunk)."""
    from repro.configs.base import StubFrontend as RefStubFrontend
    from repro_torch.configs.base import StubFrontend
    ref_cfg, cfg = reduced()
    ref_cfg = ref_cfg.with_overrides(frontend=RefStubFrontend(
        kind="vision", n_tokens=n_patches, d_in=48))
    cfg = cfg.with_overrides(frontend=StubFrontend(
        kind="vision", n_tokens=n_patches, d_in=48))
    ref_p, p = _pair(ref_cfg)
    b = 2 if seq < 256 else 1
    tok, ex = _tokens((b, seq + 1), cfg.vocab_size, seed=7), \
        patches(cfg, b, 8)
    want, want_g = jax.jit(jax.value_and_grad(
        getattr(RefLMAdapter(ref_cfg), loss)))(
        ref_p, {"tokens": jnp.asarray(tok), "extra_embeds": jnp.asarray(ex)})
    got, grads = port_grads(getattr(LMAdapter(cfg), loss), p,
                            {"tokens": torch.from_numpy(tok),
                             "extra_embeds": torch.from_numpy(ex)})
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def test_evaluate_counts_the_text_positions():
    """Both heads' accuracy and CE against the reference's (atol 1e-5),
    over the text positions; in groups of rows when ``EVAL_LOGITS`` is
    small, the same metrics."""
    from repro_torch.core import adapters
    ref_cfg, cfg = reduced()
    ref_p, p = _pair(ref_cfg)
    tok, ex = _tokens((3, 11), cfg.vocab_size, seed=9), patches(cfg, 3, 10)
    want = RefLMAdapter(ref_cfg).evaluate(
        ref_p, {"tokens": jnp.asarray(tok), "extra_embeds": jnp.asarray(ex)})
    batch = {"tokens": torch.from_numpy(tok),
             "extra_embeds": torch.from_numpy(ex)}
    got = LMAdapter(cfg).evaluate(p, batch)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    old = adapters.EVAL_LOGITS
    adapters.EVAL_LOGITS = 10 * cfg.vocab_size      # one row a group
    try:
        grouped = LMAdapter(cfg).evaluate(p, batch)
    finally:
        adapters.EVAL_LOGITS = old
    for key in want:
        np.testing.assert_allclose(float(grouped[key]), float(got[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


# -- tests/test_arch_smoke.py ------------------------------------------------

def test_reduced_forward_and_fedhen_step():
    """The port of ``test_arch_smoke.py``'s forward and side step for the
    name (16 positions: 8 patches, 8 text tokens): shapes, no NaN, the
    loss and every gradient against ``jax.grad`` of the reference's
    ``loss_side`` at rtol 1e-4 / atol 1e-5, then an SGD step and a finite
    loss."""
    ref_cfg, cfg = reduced()
    assert cfg.n_layers <= 3 and cfg.d_model <= 256
    ref_p, p = _pair(ref_cfg)
    n_tok = 16 - cfg.frontend.n_tokens
    tok, ex = _tokens((2, n_tok + 1), cfg.vocab_size, seed=0), \
        patches(cfg, 2, 1)
    batch = {"tokens": torch.from_numpy(tok),
             "extra_embeds": torch.from_numpy(ex)}
    exit_h, final_h, _ = tfm.forward(p, cfg, batch["tokens"][:, :-1],
                                     extra_embeds=batch["extra_embeds"])
    assert tuple(final_h.shape) == (2, 16, cfg.d_model)
    assert exit_h.shape == final_h.shape
    logits = tfm.logits_from_hidden(p, cfg, final_h, "final")
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
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
    """One text-token decode step from an empty cache against the
    reference's (decode takes no frontend): logits and the new cache at
    rtol 1e-4 / atol 1e-5."""
    ref_cfg, cfg = reduced()
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((2, 1), cfg.vocab_size, seed=2)
    want, ref_cache = ref_tfm.decode_step(
        ref_p, ref_tfm.init_cache(ref_cfg, 2, 32), ref_cfg, jnp.asarray(tok),
        jnp.int32(0))
    got, cache = tfm.decode_step(p, tfm.init_cache(cfg, 2, 32), cfg,
                                 torch.from_numpy(tok), 0)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    for g, w in zip(tree_leaves(cache), jax.tree.leaves(ref_cache)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def test_serve_main_runs_llava_text_only_on_the_cpu(capsys):
    """``serve.main`` passes no patches, as the reference's does."""
    stats = serve.main(["--arch", NAME, "--batch", "2", "--prompt-len",
                        "12", "--gen", "4", "--device", "cpu"])
    assert set(stats) == {"exit_agreement", "exit_confident_frac"}
    assert "tok/s on CPU" in capsys.readouterr().out


def test_train_cli_runs_llava_text_only_on_the_cpu():
    """``--arch llava-next-34b --reduced`` trains on text alone, as the
    reference's CLI does (its shards carry no patches)."""
    from repro_torch.launch import train
    history = train.main(["--model", "lm", "--arch", NAME, "--reduced",
                          "--device", "cpu", "--rounds", "1", "--clients",
                          "4", "--participation", "0.5", "--data-points",
                          "16", "--seq-len", "16", "--batch-size", "4",
                          "--local-epochs", "1", "--eval-every", "1"])
    assert len(history) == 1 and np.isfinite(history[0]["loss_complex"])


def test_one_llava_round_with_patches_matches_reference():
    """One fedhen round of reduced llava-next-34b with each client's
    sequences carrying their patch embeddings, port against reference at
    ``assert_round_matches``' tolerances; evaluation with patches at atol
    1e-5."""
    ref_cfg, cfg = reduced()
    f = cfg.frontend
    data = synthetic_lm(32, 16, cfg.vocab_size, seed=0)
    data["extra_embeds"] = synthetic_frontend_embeds(32, f.n_tokens, f.d_in,
                                                     seed=0)
    shards = [{k: v for k, v in s.items() if k != "labels"}
              for s in iid_split(data, 4, seed=1)]
    assert sorted(shards[0]) == ["extra_embeds", "tokens"]
    port, ref = round_pair(ref_cfg, cfg, shards)
    assert_round_matches(port, ref, port.run_round(), ref.run_round())
    test = {"tokens": synthetic_lm(8, 16, cfg.vocab_size, seed=999)[
        "tokens"], "extra_embeds": synthetic_frontend_embeds(
            8, f.n_tokens, f.d_in, seed=999)}
    got = port.evaluate(test)
    want = ref.evaluate({k: jnp.asarray(v) for k, v in test.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)

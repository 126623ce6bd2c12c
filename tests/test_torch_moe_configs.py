"""The Mixture-of-Experts configs qwen2-moe-a2.7b and kimi-k2-1t-a32b in
the port, held to the JAX package on the CPU.

Each check runs on weights the reference draws (carried with ``interop``)
and seeded numpy tokens, in f32 at rtol 1e-4 / atol 1e-5:

* the reduced configs' forward (exit and final hidden states, logits and
  the summed aux losses) and one FedHeN side-objective SGD step (the loss
  with the aux terms, and every gradient against ``jax.grad`` of the
  reference's ``LMAdapter.loss_side``), and ``loss_complex`` (with the
  aux terms) and ``loss_simple`` (without) with their gradients;
* their prefill and teacher-forced decode with both heads against the
  reference's, kimi-k2 also at its published head dim 112 (decode routes
  the batch as one group at capacity 1, so it drops pairs that prefill
  keeps: held to the reference, not to the forward);
* their bf16 prefill and decode, routed from the reference's router
  logits (recorded from its jitted steps by an ordered
  ``jax.debug.callback``), at ``tests/test_torch_serve.py``'s bf16 rule
  (the test's docstring says why);
* kimi-k2 cut to one layer, where the exit layer resolves to the last
  one and both heads read the same hidden state, as it is served at
  published widths on the card;
* the port of ``tests/test_decode_consistency.py::test_moe_no_drop``
  (capacity factor 64: decode token by token equals the forward within
  the reference's 2e-3), also against the reference's logits;
* the full configs' parameter counts (14,004,424,704 and
  1,042,679,042,048) and the exit layer on a period boundary;
* both command lines on the CPU, and their refusal without a card;
* one narrow fedhen round of reduced qwen2-moe-a2.7b through
  ``FederatedTrainer`` against the reference's round, at
  ``assert_round_matches``' tolerances.

The configs' fields are held to the reference's by
``tests/test_torch_lm_common.py::test_config_copies_match_reference``,
which runs over ``configs.PORTED``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from test_torch_dense_configs import _both, _pair, _roundtrip  # noqa: E402
from test_torch_dense_configs import _f32, _tokens  # noqa: E402
from test_torch_round_lm import ROUND, assert_lm_round_matches  # noqa
from test_torch_round_lm import lm_shards  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import FedConfig, MoEConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
MOE = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
# the reference's param_count() of each full config
PARAMS = {"qwen2-moe-a2.7b": 14_004_424_704,
          "kimi-k2-1t-a32b": 1_042_679_042_048}


def _reduced(name, **over):
    return (ref_configs.get_reduced(name).with_overrides(**over),
            configs.get_reduced(name).with_overrides(**over))


@pytest.mark.parametrize("name", MOE)
def test_reduced_forward_and_fedhen_step(name):
    ref_cfg, cfg = _reduced(name)
    ref_p, p = _pair(ref_cfg)
    tok = _tokens((2, 17), cfg.vocab_size, seed=1)
    inputs = tok[:, :-1]

    w_exit, w_final, w_aux = ref_tfm.forward(ref_p, ref_cfg,
                                             jnp.asarray(inputs))
    g_exit, g_final, aux = tfm.forward(p, cfg, torch.from_numpy(inputs))
    np.testing.assert_allclose(_f32(g_final), _f32(w_final), **TOL)
    np.testing.assert_allclose(_f32(g_exit), _f32(w_exit), **TOL)
    np.testing.assert_allclose(
        _f32(tfm.logits_from_hidden(p, cfg, g_final, "final")),
        _f32(ref_tfm.logits_from_hidden(ref_p, ref_cfg, w_final, "final")),
        **TOL)
    # both MoE layers' aux losses, summed over the stack
    for k in ("load_balance", "router_z"):
        assert float(aux[k]) > 0
        np.testing.assert_allclose(float(aux[k]), float(w_aux[k]),
                                   rtol=1e-6)
    np.testing.assert_array_equal(
        _f32(tfm.forward_simple(p, cfg, torch.from_numpy(inputs))),
        _f32(g_exit))

    # one FedHeN side-objective step: the loss includes the aux terms
    want, want_g = jax.jit(jax.value_and_grad(RefLMAdapter(ref_cfg).loss_side)
                           )(ref_p, {"tokens": jnp.asarray(tok)})
    leaves, _ = tree_flatten(p)
    for x in leaves:
        x.requires_grad_(True)
    loss = LMAdapter(cfg).loss_side(p, {"tokens": torch.from_numpy(tok)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        g = torch.zeros(w.shape) if g is None else g
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


@pytest.mark.parametrize("loss", ["loss_complex", "loss_simple"])
@pytest.mark.parametrize("name", MOE)
def test_reduced_losses_and_grads_match_reference(name, loss):
    """``LMAdapter``'s other two losses: the complex one adds the aux
    terms, the simple one (the exit head over the prefix) drops them, as
    the reference's do; values and gradients against ``jax.grad``."""
    ref_cfg, cfg = _reduced(name)
    ref_p, p = _pair(ref_cfg, seed=3)
    tok = _tokens((2, 17), cfg.vocab_size, seed=4)
    want, want_g = jax.jit(jax.value_and_grad(getattr(
        RefLMAdapter(ref_cfg), loss)))(ref_p, {"tokens": jnp.asarray(tok)})
    leaves, _ = tree_flatten(p)
    for x in leaves:
        x.requires_grad_(True)
    got = getattr(LMAdapter(cfg), loss)(p, {"tokens": torch.from_numpy(tok)})
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(want_g)):
        g = torch.zeros(w.shape) if g is None else g
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)


def _serve_against_reference(ref_cfg, cfg, s=12, t=4, b=2):
    """Prefill of S tokens, then T teacher-forced decode steps with both
    heads, port against reference at TOL."""
    ref_p, p = _pair(ref_cfg)
    tokens = _tokens((b, s + t), cfg.vocab_size, seed=1)
    toks = torch.from_numpy(tokens)
    prefill = jax.jit(lambda p, x: ref_tfm.prefill(p, ref_cfg, x,
                                                   cache_len=s + t))
    decode = jax.jit(lambda p, c, x, i: ref_tfm.decode_step(
        p, c, ref_cfg, x, i, with_exit_head=True))
    want, ref_cache = prefill(ref_p, jnp.asarray(tokens[:, :s]))
    got, cache = tfm.prefill(p, cfg, toks[:, :s], cache_len=s + t)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    for i in range(s, s + t):
        want, ref_cache, want_exit = decode(
            ref_p, ref_cache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i))
        got, cache, got_exit = tfm.decode_step(
            p, cache, cfg, toks[:, i:i + 1], i, with_exit_head=True)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
        np.testing.assert_allclose(_f32(got_exit), _f32(want_exit), **TOL)
    return p, toks


@pytest.mark.parametrize("name,over", [(n, {}) for n in MOE] + [
    ("kimi-k2-1t-a32b", dict(head_dim=112))])     # the published Dh
def test_reduced_prefill_and_decode_match_reference(name, over):
    _serve_against_reference(*_reduced(name, **over))


@pytest.mark.parametrize("name", MOE)
def test_bf16_prefill_and_decode_match_reference(name, monkeypatch):
    """tests/test_torch_serve.py's bf16 case (params and compute in bf16,
    prompt 40, 8 teacher-forced decode steps with both heads, batch 2) for
    the MoE archs.  The two packages' bf16 activations part by bf16 ulps
    (the port's K5 keeps its probabilities f32 where the reference's
    ``_attend`` rounds them), which moves a router logit by about 1e-3
    and flips the routing of a near-tie: on these inputs the reduced
    qwen2-moe's first layer routes one token differently, at a margin of
    4.2e-5 between its second and third probabilities, and its logits then
    part by 0.47 against the rule's 0.059.  So the port routes from the
    reference's own router logits at every MoE call, and its routing from
    them must equal the reference's exactly; the logits are held at that
    test's bf16 rule, 5 % of max|logit|."""
    ref_cfg, cfg = _reduced(name, param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    ref_p, p = _pair(ref_cfg)
    s, steps = 40, 8
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, s + steps)).astype(np.int32)
    logs, ref_route = [], ref_mlp.route_topk

    def keep(router_logits, slot_idx):
        logs.append((np.asarray(router_logits), np.asarray(slot_idx)))

    def record(router_logits, moe, capacity, e_pad=0):
        out = ref_route(router_logits, moe, capacity, e_pad=e_pad)
        jax.debug.callback(keep, router_logits, out[0], ordered=True)
        return out
    monkeypatch.setattr(ref_mlp, "route_topk", record)
    # the reference stays compiled; its router logits leave the scan
    # through an ordered callback, so no trace cached without it may serve
    jax.clear_caches()
    try:
        prefill = jax.jit(lambda p, t: ref_tfm.prefill(
            p, ref_cfg, t, cache_len=s + steps))
        decode = jax.jit(lambda p, c, t, i: ref_tfm.decode_step(
            p, c, ref_cfg, t, i, with_exit_head=True))
        want, ref_cache = prefill(ref_p, jnp.asarray(tokens[:, :s]))
        wants = [want]
        for t in range(s, s + steps):
            want, ref_cache, want_exit = decode(
                ref_p, ref_cache, jnp.asarray(tokens[:, t:t + 1]),
                jnp.int32(t))
            wants += [want, want_exit]
        jax.effects_barrier()
    finally:
        jax.clear_caches()

    calls, route = iter(logs), mlp._route

    def replay(router_logits, moe, capacity, e_pad=0, group=None):
        ref_logits, ref_slots = next(calls)
        assert tuple(router_logits.shape) == ref_logits.shape
        r = route(torch.tensor(ref_logits), moe, capacity, e_pad, group)
        np.testing.assert_array_equal(r.slot_idx.numpy(), ref_slots)
        return r
    monkeypatch.setattr(mlp, "_route", replay)
    toks = torch.from_numpy(tokens)
    got, cache = tfm.prefill(p, cfg, toks[:, :s], cache_len=s + steps)
    assert got.dtype == torch.bfloat16
    gots = [got]
    for t in range(s, s + steps):
        got, cache, got_exit = tfm.decode_step(p, cache, cfg,
                                               toks[:, t:t + 1], t,
                                               with_exit_head=True)
        gots += [got, got_exit]
    assert next(calls, None) is None          # every call was replayed
    assert len(logs) == cfg.n_layers * (1 + steps)
    bf16 = dict(rtol=0.0, atol=0.05 * float(np.abs(_f32(wants[0])).max()))
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(_f32(g), _f32(w), **bf16)


def test_one_layer_kimi_serves_both_heads_from_the_last_layer():
    """kimi-k2 at depth 1 (as phase 15 serves it at published widths):
    the exit layer resolves to 1 = n_layers, so the exit head reads the
    final hidden state through its own norm."""
    ref_cfg, cfg = _reduced("kimi-k2-1t-a32b", n_layers=1, exit_layer=0)
    assert cfg.resolved_exit_layer == ref_cfg.resolved_exit_layer == 1
    assert configs.get_config("kimi-k2-1t-a32b").with_overrides(
        n_layers=1).resolved_exit_layer == 1
    p, toks = _serve_against_reference(ref_cfg, cfg)
    exit_h, final_h, _ = tfm.forward(p, cfg, toks)
    assert torch.equal(exit_h, final_h)


def test_moe_no_drop():
    """tests/test_decode_consistency.py::test_moe_no_drop: capacity factor
    64, so no pair is dropped in either grouping."""
    moe = dict(n_experts=4, top_k=2, n_shared=1, d_expert=64,
               capacity_factor=64.0)
    ref_cfg, cfg = _both(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=97,
                         pattern=(("attn", "moe"),), exit_layer=2,
                         compute_dtype="float32")
    _roundtrip(ref_cfg.with_overrides(moe=RefMoEConfig(**moe)),
               cfg.with_overrides(moe=MoEConfig(**moe)), 2e-3)


@pytest.mark.parametrize("name", MOE)
def test_full_config_param_counts(name):
    cfg, ref = configs.get_config(name), ref_configs.get_config(name)
    assert cfg.param_count() == PARAMS[name] == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    s = cfg.simple_param_count()
    assert s == ref.simple_param_count()
    assert 0 < s < cfg.param_count()
    for c in (cfg, configs.get_reduced(name)):
        k = c.resolved_exit_layer
        assert k % c.period == 0 and c.period <= k <= c.n_layers


def test_one_qwen_moe_round_matches_reference():
    """One fedhen round of reduced qwen2-moe-a2.7b (its f32 router beside
    f32 experts and a shared expert), port against reference."""
    ref_cfg, cfg = _reduced("qwen2-moe-a2.7b")
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
    assert_lm_round_matches(port, ref, test)


@pytest.mark.parametrize("name", MOE)
def test_entry_points_run_on_the_cpu_and_otherwise_need_the_card(
        name, monkeypatch, capsys):
    """``launch/serve.py`` and ``launch/train.py`` take the MoE archs (the
    reduced configs) with ``--device cpu``; without it and without a card
    they raise, as for every arch."""
    from repro_torch.launch import serve, train
    stats = serve.main(["--arch", name, "--batch", "2", "--prompt-len",
                        "16", "--gen", "4", "--device", "cpu"])
    assert set(stats) == {"exit_agreement", "exit_confident_frac"}
    args = ["--model", "lm", "--arch", name, "--reduced", "--rounds", "1",
            "--clients", "4", "--participation", "0.5", "--data-points",
            "16", "--seq-len", "16", "--batch-size", "4", "--local-epochs",
            "1", "--eval-every", "1"]
    history = train.main(args + ["--device", "cpu"])
    assert len(history) == 1 and np.isfinite(history[0]["loss_complex"])
    assert "tok/s on CPU" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", name, "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)

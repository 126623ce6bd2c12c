"""Port parity of the Mixture-of-Experts layer (``repro_torch.models.mlp``).

The same seeded numpy router logits and activations, and the weights the
reference draws (carried with ``interop``), go through
``repro.models.mlp`` and its port:

* ``_capacity`` over a grid of (top_k, tokens, capacity_factor,
  n_experts): equal;
* ``route_topk`` at a capacity that drops pairs and at one that does not,
  with and without ``pad_to``: ``slot_idx`` and ``token_expert`` bitwise,
  ``slot_gate`` zero where the reference's is and within rtol 1e-6 (a
  few f32 ulps) elsewhere, not bitwise: the gates are softmax
  probabilities, the two frameworks' f32 ``exp`` differ in the last bit
  on about 7 % of inputs (measured on this CPU), and their sums over 60
  or 384 experts add in different orders (4 ulps measured at qwen2-moe's
  width); aux at rtol 1e-6;
* ``route_topk`` at the full configs' prefill shapes (one 4096-token
  group, 60 experts top-4 and 384 top-8), where capacity drops pairs:
  the same slots;
* a tie (two equal router columns) goes to the lower expert index;
* ``apply_moe`` and its gradient (``jax.grad`` against autograd) at rtol
  1e-4 / atol 1e-5 in f32; in bf16 the combine (gate product and adds in
  y's dtype) bitwise against the reference's own combine lines on the
  same inputs;
* the ports of ``tests/test_moe_padding.py``'s two tests and of
  ``tests/test_arch_smoke.py::test_moe_active_params``.

``test_decode_consistency.py::test_moe_no_drop``'s port is in
``tests/test_torch_moe_configs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import LayerSpec as RefLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
GATE = dict(rtol=1e-6, atol=0.0)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(capacity_factor=1.25, pad_to=0, dtype="float32", n_experts=6,
          top_k=2, d=32, de=48):
    """The reference's and the port's config of test_moe_padding's
    layer."""
    moe = dict(n_experts=n_experts, top_k=top_k, n_shared=1, d_expert=de,
               capacity_factor=capacity_factor, pad_to=pad_to)
    kw = dict(n_layers=2, d_model=d, n_heads=2, n_kv_heads=2, d_ff=de,
              vocab_size=64, exit_layer=1, param_dtype=dtype,
              compute_dtype=dtype)
    return (RefModelConfig(pattern=(RefLayerSpec("attn", "moe"),),
                           moe=RefMoEConfig(**moe), **kw),
            ModelConfig(pattern=(LayerSpec("attn", "moe"),),
                        moe=MoEConfig(**moe), **kw))


def _pair(ref_cfg, seed=0):
    ref_p = ref_mlp.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, interop.from_reference(jax.tree.map(np.asarray, ref_p))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# -- _capacity ---------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25, 2.0, 64.0])
def test_capacity_matches_reference(capacity_factor):
    for top_k in (1, 2, 4, 8):
        for n_experts in (4, 6, 60, 384):
            for tokens in (1, 2, 3, 7, 16, 40, 341, 1000, 4096, 8192):
                kw = dict(n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor)
                assert mlp._capacity(MoEConfig(**kw), tokens) == \
                    ref_mlp._capacity(RefMoEConfig(**kw), tokens)


def test_capacity_of_the_served_configs():
    """Prefill at 4096 (each sequence a group) and batch-1 decode (one
    token a group) for the two full MoE configs."""
    qwen = configs.get_config("qwen2-moe-a2.7b").moe
    kimi = configs.get_config("kimi-k2-1t-a32b").moe
    assert (mlp._capacity(qwen, 4096), mlp._capacity(kimi, 4096)) == (341,
                                                                      106)
    assert mlp._capacity(qwen, 1) == mlp._capacity(kimi, 1) == 1


# -- route_topk ----------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor,capacity", [(0.5, 2), (8.0, 16)])
@pytest.mark.parametrize("pad_to", [0, 8])
def test_route_topk_matches_reference(capacity_factor, capacity, pad_to):
    ref_cfg, cfg = _cfgs(capacity_factor, pad_to)
    s = 16
    assert mlp._capacity(cfg.moe, s) == capacity
    e_pad = mlp.padded_experts(cfg.moe)
    logits = _normal((3, s, cfg.moe.n_experts), seed=capacity + pad_to,
                     scale=2.0)
    want = ref_mlp.route_topk(jnp.asarray(logits), ref_cfg.moe, capacity,
                              e_pad=e_pad)
    got = mlp.route_topk(torch.from_numpy(logits), cfg.moe, capacity,
                         e_pad=e_pad)
    slot_idx, slot_gate, token_expert, aux = got
    assert tuple(slot_idx.shape) == (3, e_pad, capacity)
    np.testing.assert_array_equal(slot_idx.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(token_expert.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(slot_gate.numpy() == 0,
                                  np.asarray(want[1]) == 0)
    np.testing.assert_allclose(slot_gate.numpy(), np.asarray(want[1]),
                               **GATE)
    assert sorted(aux) == sorted(want[3])
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want[3][k]),
                                   rtol=1e-6)
    # the dropping capacity really drops: fewer kept slots than pairs
    kept = int((slot_idx < s).sum())
    if capacity < s:
        assert kept < 3 * s * cfg.moe.top_k
    else:
        assert kept == 3 * s * cfg.moe.top_k
    # pad experts never receive a token
    assert bool((slot_idx[:, cfg.moe.n_experts:] == s).all())


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
def test_route_topk_at_the_served_prefill_shapes(name):
    """A 4096-token group at the full configs' routing (60 experts top-4
    at capacity 341; 384 top-8 at 106): the same pairs dropped, slot for
    slot."""
    moe = configs.get_config(name).moe
    ref_moe = ref_configs.get_config(name).moe
    capacity = mlp._capacity(moe, 4096)
    # a router that prefers the later experts, as a trained one prefers
    # some: their demand passes the capacity
    logits = _normal((1, 4096, moe.n_experts), seed=moe.n_experts,
                     scale=1.5) + np.linspace(0, 1, moe.n_experts,
                                              dtype=np.float32)
    want = ref_mlp.route_topk(jnp.asarray(logits), ref_moe, capacity)
    got = mlp.route_topk(torch.from_numpy(logits), moe, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **GATE)
    kept = int((got[0] < 4096).sum())
    assert 0 < 4096 * moe.top_k - kept       # capacity drops pairs here


def test_route_topk_breaks_ties_toward_the_lower_index():
    """Router columns 1 and 4 equal and on top for every token: each
    token's first choice is expert 1 and its second expert 4, as
    ``lax.top_k`` orders them; columns 0 and 3 tie below them and never
    win."""
    ref_cfg, cfg = _cfgs(8.0)
    logits = _normal((2, 16, 6), seed=5, scale=0.1)
    logits[..., 1] = logits[..., 4] = 3.0
    logits[..., 0] = logits[..., 3] = 2.0
    capacity = mlp._capacity(cfg.moe, 16)
    want = ref_mlp.route_topk(jnp.asarray(logits), ref_cfg.moe, capacity)
    got = mlp.route_topk(torch.from_numpy(logits), cfg.moe, capacity)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool((got[2][..., 0] == 1).all() and (got[2][..., 1] == 4).all())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # equal probabilities: each chosen pair's gate is exactly one half
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -- apply_moe ------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
@pytest.mark.parametrize("pad_to", [0, 8])
def test_apply_moe_and_grads_match_reference(capacity_factor, pad_to):
    ref_cfg, cfg = _cfgs(capacity_factor, pad_to)
    ref_p, p = _pair(ref_cfg)
    x = _normal((2, 16, 32), seed=1)

    def ref_loss(params, xx):
        y, aux = ref_mlp.apply_moe(params, xx, ref_cfg)
        return jnp.sum(y ** 2) + aux["load_balance"] + aux["router_z"]

    want_y, want_aux = ref_mlp.apply_moe(ref_p, jnp.asarray(x), ref_cfg)
    want_gp, want_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p,
                                                          jnp.asarray(x))
    leaves, _ = tree_flatten(p)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = mlp.apply_moe(p, xt, cfg)
    np.testing.assert_allclose(_f32(y), _f32(want_y), **TOL)
    for k in want_aux:
        np.testing.assert_allclose(_f32(aux[k]), float(want_aux[k]),
                                   rtol=1e-6)
    loss = torch.sum(y ** 2) + aux["load_balance"] + aux["router_z"]
    grads = torch.autograd.grad(loss, leaves + [xt])
    for g, w in zip(grads[:-1], jax.tree.leaves(want_gp)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    np.testing.assert_allclose(_f32(grads[-1]), _f32(want_gx), **TOL)


def _ref_combine(y, slot_idx, slot_gate, s):
    """The reference's combine, ``src/repro/models/mlp.py`` lines 177-188
    (gate product and scatter-add in y's dtype), on given inputs."""
    b, e, c, d = y.shape
    y = y * slot_gate[..., None].astype(y.dtype)
    flat_y = y.reshape(b, e * c, d)
    flat_i = slot_idx.reshape(b, -1)

    def combine_one(buf, idx, vals):
        return buf.at[idx].add(vals, mode="drop")

    return jax.vmap(combine_one)(jnp.zeros((b, s, d), y.dtype), flat_i,
                                 flat_y)


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_bf16_combine_rounds_as_the_reference(capacity_factor):
    """The same bf16 expert outputs, gates and slots through the
    reference's combine and the port's: bitwise.  Top-4 of 6 experts, so
    a token adds up to four rows, each add rounded to bf16."""
    ref_cfg, cfg = _cfgs(capacity_factor, top_k=4)
    s = 16
    capacity = mlp._capacity(cfg.moe, s)
    logits = _normal((2, s, 6), seed=7, scale=2.0)
    r = mlp._route(torch.from_numpy(logits), cfg.moe, capacity)
    y = _normal((2, 6, capacity, 32), seed=8, scale=3.0)
    yj = jnp.asarray(y).astype(jnp.bfloat16)
    yt = interop.from_reference(np.asarray(yj))
    want = _ref_combine(yj, jnp.asarray(r.slot_idx.numpy()),
                        jnp.asarray(r.slot_gate.numpy()), s)
    got = mlp._combine(yt * r.slot_gate[..., None].to(torch.bfloat16),
                       r.token_slot)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        interop.to_reference(got).view(np.uint16),
        np.asarray(want).view(np.uint16))
    # the sums really round: adding in f32 and rounding once differs
    once = _ref_combine(jnp.asarray(y), jnp.asarray(r.slot_idx.numpy()),
                        jnp.asarray(r.slot_gate.numpy()), s)
    assert not np.array_equal(_f32(want), _f32(once.astype(jnp.bfloat16)))


def test_bf16_apply_moe_matches_reference():
    """A bf16 layer end to end: routing equal (the router runs in f32 on
    bf16 activations), outputs within the bf16 products' rounding."""
    ref_cfg, cfg = _cfgs(1.25, dtype="bfloat16")
    ref_p, p = _pair(ref_cfg)
    xj = jnp.asarray(_normal((2, 16, 32), seed=3)).astype(jnp.bfloat16)
    want, want_aux = ref_mlp.apply_moe(ref_p, xj, ref_cfg)
    got, aux = mlp.apply_moe(p, interop.from_reference(np.asarray(xj)), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)
    for k in want_aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-6)


# -- tests/test_moe_padding.py ----------------------------------------------------

def test_padded_moe_matches_unpadded():
    ref_cfg0, cfg0 = _cfgs(8.0)
    _, cfg1 = _cfgs(8.0, pad_to=8)
    _, p0 = _pair(ref_cfg0)
    p1 = mlp.init_moe(torch.Generator().manual_seed(0), cfg1)
    assert tuple(p1["experts"]["gate"].shape) == (8, 32, 48)
    assert tuple(p1["router"].shape) == (32, 6)
    # graft the real experts' weights so both compute the same function
    p1["router"] = p0["router"]
    for k in p1["experts"]:
        p1["experts"][k][:6] = p0["experts"][k]
    p1["shared"] = p0["shared"]
    x = torch.from_numpy(_normal((2, 16, 32), seed=1))
    y0, aux0 = mlp.apply_moe(p0, x, cfg0)
    y1, aux1 = mlp.apply_moe(p1, x, cfg1)
    np.testing.assert_allclose(_f32(y1), _f32(y0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux1["load_balance"]),
                               float(aux0["load_balance"]), rtol=1e-6)


def test_pad_experts_receive_no_tokens_and_no_grads():
    _, cfg = _cfgs(8.0, pad_to=8)
    p = mlp.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_normal((2, 16, 32), seed=1))
    for name in ("gate", "up", "down"):
        p["experts"][name].requires_grad_(True)
    y, _ = mlp.apply_moe(p, x, cfg)
    grads = torch.autograd.grad(torch.sum(y ** 2), [
        p["experts"][n] for n in ("gate", "up", "down")])
    for name, g in zip(("gate", "up", "down"), grads):
        assert float(g[cfg.moe.n_experts:].abs().max()) == 0.0, name
        assert float(g[:cfg.moe.n_experts].abs().max()) > 0.0, name


# -- tests/test_arch_smoke.py::test_moe_active_params ---------------------------

def test_moe_active_params():
    cfg = configs.get_config("kimi-k2-1t-a32b")
    active = cfg.active_param_count() / 1e9
    assert 25.0 <= active <= 45.0, active   # A32B
    qwen = configs.get_config("qwen2-moe-a2.7b")
    assert 1.8 <= qwen.active_param_count() / 1e9 <= 3.8
    for name in ("kimi-k2-1t-a32b", "qwen2-moe-a2.7b"):
        assert configs.get_config(name).active_param_count() == \
            ref_configs.get_config(name).active_param_count()


def test_init_moe_matches_reference_tree():
    """Leaf shapes and dtypes in the reference's order: the router in f32
    over the real experts in every config, the experts padded."""
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = _cfgs(pad_to=8, dtype=dtype)
        want = jax.tree.leaves(ref_mlp.init_moe(jax.random.PRNGKey(0),
                                                ref_cfg))
        got = tree_leaves(mlp.init_moe(torch.Generator().manual_seed(0),
                                       cfg))
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        assert [str(x.dtype).replace("torch.", "") for x in got] == \
            [str(x.dtype) for x in want]
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(ref_cfg.moe)

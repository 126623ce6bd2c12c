"""Port parity of the launch-side step functions (``launch/steps.py``).

The round step against the reference's own ``make_fed_round_step``
(jitted on the CPU) on ``tests/test_fedround.py``'s tiny config: the flat
f32 engine at ``cohort_chunk`` 1, 2 and 4, the int8 wire, and ``B <
local_steps`` (the reference's clamped index); the
simple client's reported loss; an ``expand``-ed cohort left untouched;
the deprecation and ``ValueError`` shims and the ``round_step_build``
ledger; ``make_train_step`` with and without the side objective,
``make_prefill_step``, ``make_serve_step`` and ``step_for_shape``.  The
tree engine, decouple, the async staleness seam, pad slots and a NaN
client are in ``test_torch_steps_seams.py`` (each file stays near 30 s:
a reference round's jit takes about 5 s to compile on the CPU).

The reference's cohort is ``broadcast_to`` one model, the port's the
same model ``expand``-ed to K; tokens are drawn with numpy from a seed,
weights by the reference and carried across with ``interop``.  Params and
loss are held at rtol 1e-4 / atol 1e-5 (the round tests' rule); the int8
wire under ``repro_torch.parity``'s rules.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import base as ref_base  # noqa: E402
from repro.core import adapters as ref_adapters  # noqa: E402
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402
from repro.obs import telemetry as ref_obs  # noqa: E402

from repro_torch import interop, parity  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import adapters, aggregate, comm, flatten  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.obs import telemetry as obs  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=64, exit_layer=1, compute_dtype="float32")
REF_CFG = ref_base.ModelConfig(pattern=(ref_base.LayerSpec("attn"),), **TINY)
CFG = base.ModelConfig(pattern=(base.LayerSpec("attn"),), **TINY)
K, B, STEPS, SEQ = 4, 2, 2, 16
IS_SIMPLE = np.array([True, True, False, False])
RTOL, ATOL = 1e-4, 1e-5
MAX_SHARE = 1e-3


@functools.lru_cache(maxsize=None)
def ref_params():
    return ref_tfm.init_params(jax.random.PRNGKey(0), REF_CFG)


def port_params():
    return interop.from_reference(jax.tree.map(np.asarray, ref_params()))


def tokens(k=K, b=B, steps_=STEPS, seed=1):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(k, b, steps_, SEQ + 1)).astype(np.int32)


def ref_cohort(k=K):
    return jax.tree.map(lambda x: jnp.broadcast_to(x[None], (k,) + x.shape),
                        ref_params())


def port_cohort(params, k=K):
    return tree_map(lambda x: x[None].expand((k,) + x.shape), params)


def ref_round(data, simple=IS_SIMPLE, *args, **kw):
    """The reference's jitted round on its broadcast cohort."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        step = ref_steps.make_fed_round_step(REF_CFG, NO_POLICY, **kw)
    return jax.jit(step)(ref_cohort(data.shape[0]), jnp.asarray(data),
                         jnp.asarray(simple), *args)


def port_round(data, simple=IS_SIMPLE, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        step = steps.make_fed_round_step(CFG, **kw)
    return step(port_cohort(port_params(), data.shape[0]),
                torch.as_tensor(data), torch.as_tensor(simple), *args)


def assert_tree_close(port, ref, rtol=RTOL, atol=ATOL):
    ref_leaves = jax.tree.leaves(ref)
    assert len(tree_leaves(port)) == len(ref_leaves)
    for a, b in zip(tree_leaves(port), ref_leaves):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, rtol=rtol,
                                   atol=atol)


def assert_round_matches(port, ref):
    (p_c, p_loss), (r_c, r_loss) = port, ref
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=RTOL,
                               atol=ATOL)
    assert_tree_close(p_c, r_c)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_flat_round_matches_reference(chunk):
    data = tokens()
    got = port_round(data, local_steps=STEPS, cohort_chunk=chunk)
    assert_round_matches(got, ref_round(data, local_steps=STEPS,
                                        cohort_chunk=chunk))
    # test_round_step_tiny's checks: finite, and the model moved
    new_c, loss = got
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(x).all() for x in tree_leaves(new_c))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new_c), tree_leaves(port_params())))


def test_int8_round_matches_reference_and_f32():
    """The int8 wire's round against the reference's under the lossy-wire
    rules (the uploads' int8 step), and against the port's f32 round by
    ``test_round_step_int8_wire_matches_f32``'s rule on that test's
    tokens: the loss equal at rtol 1e-5, every leaf within ``max|f32
    leaf| / 100``."""
    data = tokens()
    q_c, q_loss = port_round(data, local_steps=STEPS, cohort_chunk=2,
                             comm_dtype="int8")
    r_c, r_loss = ref_round(data, local_steps=STEPS, cohort_chunk=2,
                            comm_dtype="int8")
    np.testing.assert_allclose(float(q_loss), float(r_loss), rtol=RTOL,
                               atol=ATOL)
    layout = flatten.build_layout(port_params(), total_multiple=2048)
    spec = comm.WireSpec("int8", 128)
    a = flatten.pack(layout, q_c)
    b = flatten.pack(layout, interop.from_reference(
        jax.tree.map(np.asarray, r_c)))
    step = torch.maximum(parity.wire_step(spec, flatten.pack(
        layout, port_params())), parity.wire_step(spec, b))
    res = parity.lossy_compare(a, b, step)
    assert res["share"] <= MAX_SHARE and res["worst"] <= 1.0, res

    # the reference test's own tokens: on the numpy-drawn ones above the
    # reference's int8 round breaks its own rule, at a zero-initialised
    # norm scale whose clients moved apart (9.2e-6 against 7.5e-6; the
    # port's round does the same)
    data = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (K, B, STEPS, SEQ + 1), 0, 64))
    q_c, q_loss = port_round(data, local_steps=STEPS, cohort_chunk=2,
                             comm_dtype="int8")
    f_c, f_loss = port_round(data, local_steps=STEPS, cohort_chunk=2)
    np.testing.assert_allclose(float(q_loss), float(f_loss), rtol=1e-5)
    for q, f in zip(tree_leaves(q_c), tree_leaves(f_c)):
        amax = float(f.abs().max()) + 1e-12
        assert float((q - f).abs().max()) <= amax / 100.0


def test_batch_index_clamps_when_b_is_below_local_steps():
    """Local step ``i`` trains on batch row ``min(i, B - 1)``: the
    reference's ``data[:, i]`` on the transposed block, which JAX clamps.
    Three steps on B = 1 match the reference's round, and each step's batch
    is the client's ``local_steps`` rows at batch index 0."""
    data = tokens(b=1, steps_=3, seed=5)
    assert_round_matches(
        port_round(data, local_steps=3, cohort_chunk=2),
        ref_round(data, local_steps=3, cohort_chunk=2))
    # a step takes every local_steps row of one batch index
    seen = []
    step = steps.make_fed_round_step(CFG, local_steps=3)
    loss_side = adapters.LMAdapter.loss_side

    def spy(self, params, batch):
        seen.append(batch["tokens"].clone())
        return loss_side(self, params, batch)

    adapters.LMAdapter.loss_side = spy
    try:
        step(port_cohort(port_params(), 1), torch.as_tensor(data[:1]),
             torch.tensor([False]))
    finally:
        adapters.LMAdapter.loss_side = loss_side
    assert len(seen) == 3
    for got in seen:
        np.testing.assert_array_equal(got.numpy(), data[0, 0])


def test_simple_client_reports_its_side_loss():
    """A simple client steps on ``loss_simple``'s gradient, yet reports
    ``loss_side`` of its last step, as the reference does."""
    data = tokens(k=1, steps_=1, seed=7)
    step = steps.make_fed_round_step(CFG, local_steps=1)
    new_c, loss = step(port_cohort(port_params(), 1),
                       torch.as_tensor(data), torch.tensor([True]))
    batch = {"tokens": jnp.asarray(data[0, 0])}
    adapter = ref_adapters.LMAdapter(REF_CFG, remat=True)
    side = float(adapter.loss_side(ref_params(), batch))
    simple = float(adapter.loss_simple(ref_params(), batch))
    np.testing.assert_allclose(float(loss), side, rtol=1e-5)
    assert abs(side - simple) > 1e-3
    # and it trained on loss_simple: the leaves outside M did not move
    for path in ("final_norm",):
        np.testing.assert_array_equal(
            new_c[path]["scale"].numpy(),
            np.asarray(ref_params()[path]["scale"]))


def test_expanded_cohort_is_left_untouched():
    params = port_params()
    before = [x.clone() for x in tree_leaves(params)]
    cohort = port_cohort(params)
    new_c, _ = steps.make_fed_round_step(CFG, local_steps=STEPS)(
        cohort, torch.as_tensor(tokens()), torch.as_tensor(IS_SIMPLE))
    for x, y in zip(tree_leaves(params), before):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(cohort), before):
        assert torch.equal(x[3], y)
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(new_c), before))


def test_engine_shims_warn_raise_and_match_the_spec():
    spec = aggregate.EngineSpec(algorithm="fedhen", block_n=512,
                                wire=comm.WireSpec("float32", 128))
    steps.make_fed_round_step(CFG, local_steps=1, engine=spec)
    with pytest.warns(DeprecationWarning, match="make_fed_round_step"):
        legacy = steps.make_fed_round_step(CFG, local_steps=STEPS,
                                           agg_engine="flat",
                                           agg_block_n=512)
    with pytest.raises(ValueError, match="either"):
        steps.make_fed_round_step(CFG, local_steps=1, engine=spec,
                                  agg_engine="flat")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        modern = steps.make_fed_round_step(CFG, local_steps=STEPS,
                                           engine=spec)
    data = torch.as_tensor(tokens())
    a = legacy(port_cohort(port_params()), data, torch.as_tensor(IS_SIMPLE))
    b = modern(port_cohort(port_params()), data, torch.as_tensor(IS_SIMPLE))
    assert torch.equal(a[1], b[1])
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)


def test_cohort_chunk_must_divide_the_cohort():
    step = steps.make_fed_round_step(CFG, local_steps=1, cohort_chunk=3)
    with pytest.raises(ValueError, match="does not divide"):
        step(port_cohort(port_params()), torch.as_tensor(tokens()),
             torch.as_tensor(IS_SIMPLE))


@pytest.mark.parametrize("engine", ["flat-int8", "tree-bfloat16"])
def test_round_step_build_ledger_matches_reference(engine):
    kind, dtype = engine.split("-")
    ref_sink, sink = ref_obs.MemorySink(), obs.MemorySink()
    kw = dict(local_steps=3, lr=0.05, clip_norm=5.0, cohort_chunk=2,
              staleness_scheme="poly", staleness_decay=0.25)
    ref_steps.make_fed_round_step(
        REF_CFG, NO_POLICY, telemetry=ref_obs.Telemetry([ref_sink]),
        engine=ref_aggregate.EngineSpec(
            engine=kind, wire=ref_comm.WireSpec(dtype, 64)), **kw)
    steps.make_fed_round_step(
        CFG, telemetry=obs.Telemetry([sink]),
        engine=aggregate.EngineSpec(
            engine=kind, wire=comm.WireSpec(dtype, 64)), **kw)
    (got,), (want,) = sink.events, ref_sink.events
    assert got["kind"] == want["kind"] == "ledger"
    assert got["name"] == want["name"] == "round_step_build"
    assert got["values"] == want["values"]


@pytest.mark.parametrize("side_objective", [True, False])
def test_train_step_matches_reference(side_objective):
    data = tokens(k=1, b=3, steps_=1, seed=11)[0, :, 0]
    ref_new, ref_m = jax.jit(ref_steps.make_train_step(
        REF_CFG, NO_POLICY, side_objective=side_objective))(
        ref_params(), {"tokens": jnp.asarray(data)})
    params = port_params()
    before = [x.clone() for x in tree_leaves(params)]
    new, m = steps.make_train_step(CFG, side_objective=side_objective)(
        params, {"tokens": torch.as_tensor(data)})
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=RTOL, atol=ATOL)
    assert_tree_close(new, ref_new)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(params), before))
    assert not any(x.requires_grad for x in tree_leaves(new))


def test_prefill_and_serve_steps_match_reference():
    prompt = np.random.default_rng(13).integers(
        0, TINY["vocab_size"], size=(2, 8)).astype(np.int32)
    nxt = np.random.default_rng(14).integers(
        0, TINY["vocab_size"], size=(2, 1)).astype(np.int32)
    r_logits, r_cache = ref_steps.make_prefill_step(
        REF_CFG, NO_POLICY, cache_len=12)(ref_params(),
                                          {"tokens": jnp.asarray(prompt)})
    r_step = ref_steps.make_serve_step(REF_CFG, NO_POLICY,
                                       with_exit_head=True)(
        ref_params(), r_cache, {"tokens": jnp.asarray(nxt)}, 8)
    params = port_params()
    logits, cache = steps.make_prefill_step(CFG, cache_len=12)(
        params, {"tokens": torch.as_tensor(prompt)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=RTOL, atol=ATOL)
    assert_tree_close(cache, r_cache)
    got = steps.make_serve_step(CFG, with_exit_head=True)(
        params, cache, {"tokens": torch.as_tensor(nxt)}, 8)
    assert len(got) == len(r_step) == 3
    for a, b in zip((got[0], got[2]), (r_step[0], r_step[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    assert_tree_close(got[1], r_step[1])


@pytest.mark.parametrize("shape", list(ref_base.INPUT_SHAPES))
def test_step_for_shape_picks_the_reference_step(shape):
    want = ref_steps.step_for_shape(REF_CFG, ref_base.INPUT_SHAPES[shape])
    got = steps.step_for_shape(CFG, base.INPUT_SHAPES[shape])
    assert got.__name__ == want.__name__

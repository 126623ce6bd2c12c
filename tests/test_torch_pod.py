"""A live pod axis: ``make_device_mesh(..., n_pod=...)``'s ("pod", "data",
"model") meshes, ``MeshPolicy.data_group`` / ``data_coordinate`` /
``data_rows`` over pod x data, and the steps on such a mesh against the
JAX reference's unsharded steps (``NO_POLICY``, each jitted once).

* One gloo spawn at world size 4 (``tests/torch_split_cases.
  pod_rank_main``, a ``FileStore``, joined within 120 s) while the
  reference's steps run here:

  - a (2, 2, 1) pod x data mesh: the round step of
    ``tests/test_fedround.py``'s tiny config on the flat f32, flat int8
    and tree engines at K = 6 (uneven: 2, 1, 2, 1 rows a rank, nested as
    DTensor places a cohort over pod then data) and K = 8, each rank
    training exactly the rows ``distribute_tensor`` places on it under
    ``cohort_specs``, every client once; the data group is all four
    ranks and the coordinate pod major;
  - a (2, 1, 2) pod x model mesh: reduced gemma2-2b's train step (its
    batch over pod), its three rounds (a client a pod, each over the
    model group), its prefill then 6 serve steps with the exit head (the
    caches' batch over pod); reduced qwen2-moe's train step (the
    ``load_balance`` batch means over pod); reduced recurrentgemma-2b
    under seq2d (the batch over pod, the sequence over model: train, the
    f32 round, prefill and serve, all-reduces only).

  Every rank's ``full_tensor()``s bitwise equal; params, losses, logits
  and caches at rtol 1e-4 / atol 1e-5, the int8 rounds under
  ``repro_torch.parity``'s lossy-wire rules.
* ``make_device_mesh``'s refusals with a pod axis (world size 1, here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
import torch_split_cases as split  # noqa: E402
from test_torch_tp import (_int8_round_close, assert_close,  # noqa: E402
                           assert_leaves, assert_ranks_equal, ref_config,
                           ref_decode, ref_params)
from repro_torch import interop, parity  # noqa: E402
from repro_torch.core import comm, flatten  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402

JOIN_S = 120
WORLD = 4
REF_TINY = ref_base.ModelConfig(pattern=(ref_base.LayerSpec("attn"),),
                                **cases.TINY)


def _spec(engine):
    return None if engine != "flat int8" else ref_aggregate.EngineSpec(
        wire=ref_comm.WireSpec("int8", 128))


@functools.lru_cache(maxsize=None)
def _tiny_ref_params():
    return jax.tree.map(jnp.asarray, interop.to_reference(
        split.tiny_params()))


def _ref_tiny_round(k, engine):
    step = ref_steps.make_fed_round_step(REF_TINY, NO_POLICY,
                                         local_steps=cases.STEPS,
                                         engine=_spec(engine))
    cohort = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (k,) + x.shape),
                          _tiny_ref_params())
    return jax.jit(step)(cohort, jnp.asarray(cases.tokens(k)),
                         jnp.asarray(cases.is_simple(k)))


def _ref_train(arch):
    train = ref_steps.make_train_step(ref_config(arch), NO_POLICY)
    return jax.jit(train)(ref_params(arch), {
        k: jnp.asarray(v) for k, v in split.train_batch(arch).items()})


def _ref_round(arch, engine):
    step = ref_steps.make_fed_round_step(ref_config(arch), NO_POLICY,
                                         local_steps=1, engine=_spec(engine))
    data, simple = split.round_inputs(arch)
    cohort = jax.tree.map(lambda x: jnp.broadcast_to(
        x[None], (split.K,) + x.shape), ref_params(arch))
    return jax.jit(step)(cohort, jnp.asarray(data), jnp.asarray(simple))


def references():
    out = {}
    for k in split.POD_KS:
        for engine in ("flat f32", "flat int8"):
            out[("round", k, engine)] = _ref_tiny_round(k, engine)
        out[("round", k, "tree")] = out[("round", k, "flat f32")]
    rg = split.POD_SPLIT.partition(":")[0]
    for arch in (split.POD_ARCH, split.POD_MOE, rg):
        out[("train", arch)] = _ref_train(arch)
    for engine in ("flat f32", "flat int8"):
        out[(engine, split.POD_ARCH)] = _ref_round(split.POD_ARCH, engine)
    out[("tree", split.POD_ARCH)] = out[("flat f32", split.POD_ARCH)]
    out[("flat f32", rg)] = _ref_round(rg, "flat f32")
    out[("decode", split.POD_ARCH)] = ref_decode(split.POD_ARCH,
                                                 *split.POD_DECODE)
    out[("decode", rg)] = ref_decode(rg, split.B, split.PROMPT,
                                     split.CACHE_LEN)
    return out


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    """The four ranks' results and the reference's, computed while the
    ranks run."""
    d = tmp_path_factory.mktemp("pod")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=split.pod_rank_main, args=(
        r, WORLD, str(d / "store"), str(d))) for r in range(WORLD)]
    for p in procs:
        p.start()
    refs = references()
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errors = [f.read_text() for f in sorted(d.glob("*.err"))]
    assert not hung, f"{len(hung)} rank(s) hung past {JOIN_S} s"
    assert not errors, errors
    assert all(p.exitcode == 0 for p in procs)
    return [torch.load(str(d / f"pod_rank{r}.pt"))
            for r in range(WORLD)], refs


ROUNDS = [(k, e) for k in split.POD_KS for e in cases.TP_ENGINES]
WIDE = ("train", *cases.TP_ENGINES, "decode", "moe train", "split train",
        "split flat f32", "split decode")


@pytest.mark.parametrize("k,engine", ROUNDS)
def test_pod_data_round_matches_reference(pod_runs, k, engine):
    """The (2, 2, 1) round: each rank folds its rows, the fold all-reduced
    over the pod x data group; every rank's new model bitwise equal, held
    to the reference's unsharded round (its flat f32 round for the tree
    engine; int8 under the lossy-wire rules)."""
    ranks, refs = pod_runs
    key = f"round K{k} {engine}"
    assert_ranks_equal([{key: (r[key]["params"], r[key]["loss"])}
                        for r in ranks], key)
    got = ranks[0][key]
    want_c, want_loss = refs[("round", k, engine)]
    assert_close(got["loss"], want_loss)
    if engine != "flat int8":
        assert_leaves(got["params"], want_c)
        return
    layout = flatten.build_layout(split.tiny_params(), total_multiple=2048)
    spec = comm.WireSpec("int8", 128)
    a = flatten.pack(layout, got["params"])
    b = flatten.pack(layout, interop.from_reference(
        jax.tree.map(np.asarray, want_c)))
    step = torch.maximum(parity.wire_step(spec, flatten.pack(
        layout, split.tiny_params())), parity.wire_step(spec, b))
    res = parity.lossy_compare(a, b, step)
    assert res["share"] <= 1e-3 and res["worst"] <= 1.0, res


@pytest.mark.parametrize("k", split.POD_KS)
def test_each_rank_trains_the_rows_distribute_cohort_places(pod_runs, k):
    """Over pod then data DTensor nests the client axis's split (K = 6:
    2, 1, 2, 1 rows, where the flattened coordinate would give 2, 2, 2,
    0): each rank trains exactly those rows, every client once."""
    rows = [r[f"round K{k} flat f32"]["rows"] for r in pod_runs[0]]
    assert rows == [r[f"round K{k} flat f32"]["placed"]
                    for r in pod_runs[0]]
    assert sorted(z for part in rows for z in part) == list(range(k))
    if k == 6:
        assert [len(part) for part in rows] == [2, 1, 2, 1]


def test_data_group_spans_pod_and_data(pod_runs):
    """``data_group()`` is the pod x data group of this rank's model
    coordinate, and ``data_coordinate()`` is pod major: (2, 2, 1) ranks
    0-3 at 0-3 of 4; (2, 1, 2) ranks 0, 1 | 2, 3 at pods 0 | 1 of 2."""
    assert [r["group"] for r in pod_runs[0]] == [(4, (i, 4))
                                                 for i in range(4)]
    assert [r["wide group"] for r in pod_runs[0]] == [
        (2, (0, 2)), (2, (0, 2)), (2, (1, 2)), (2, (1, 2))]


@pytest.mark.parametrize("key", WIDE)
def test_pod_model_ranks_hold_bitwise_equal_full_tensors(pod_runs, key):
    assert_ranks_equal(pod_runs[0], key)


def test_pod_model_train_step_matches_reference(pod_runs):
    got = pod_runs[0][0]["train"]
    want_p, want_m = pod_runs[1][("train", split.POD_ARCH)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("engine", cases.TP_ENGINES)
def test_pod_model_round_matches_reference(pod_runs, engine):
    got = pod_runs[0][0][engine]
    want_c, want_loss = pod_runs[1][(engine, split.POD_ARCH)]
    assert_close(got["loss"], want_loss)
    if engine == "flat int8":
        _int8_round_close(got, want_c, split.POD_ARCH)
    else:
        assert_leaves(got["params"], want_c)


@pytest.mark.parametrize("what", ["prefill", "logits", "exit", "cache"])
@pytest.mark.parametrize("case", ["decode", "split decode"])
def test_pod_model_prefill_and_serve_match_reference(pod_runs, case, what):
    """gemma2 narrow (the caches' batch over pod, their rows over model)
    and recurrentgemma narrow under seq2d (the batch over pod, the
    sequence over model in prefill; the RG-LRU state over its channels
    and the ring over kv_seq in decode)."""
    arch = split.POD_ARCH if case == "decode" else \
        split.POD_SPLIT.partition(":")[0]
    got = pod_runs[0][0][case]
    want = pod_runs[1][("decode", arch)]
    if what == "prefill":
        assert_close(got["prefill"]["logits"], want["prefill"]["logits"])
        assert_leaves(got["prefill"]["cache"], want["prefill"]["cache"])
        return
    assert len(got[what]) == len(want[what]) == cases.TP_DECODE_STEPS
    for g, w in zip(got[what], want[what]):
        if what == "cache":
            assert_leaves(g, w)
        else:
            assert_close(g, w)


def test_pod_model_moe_train_step_matches_reference(pod_runs):
    """Reduced qwen2-moe: the aux losses' batch means reduced over pod
    (its batch's axis) before their product."""
    got = pod_runs[0][0]["moe train"]
    want_p, want_m = pod_runs[1][("train", split.POD_MOE)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


def test_pod_model_seq2d_train_and_round_match_reference(pod_runs):
    rg = split.POD_SPLIT.partition(":")[0]
    got = pod_runs[0][0]["split train"]
    want_p, want_m = pod_runs[1][("train", rg)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)
    got = pod_runs[0][0]["split flat f32"]
    want_c, want_loss = pod_runs[1][("flat f32", rg)]
    assert_close(got["loss"], want_loss)
    assert_leaves(got["params"], want_c)
    for rank in pod_runs[0]:
        assert set(rank["split collectives"]) <= {"all_reduce"}


@pytest.fixture
def gloo_world1():
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    yield
    dist.destroy_process_group()


def test_make_device_mesh_with_a_pod_axis(gloo_world1):
    mesh = make_device_mesh(1, 1, "cpu", n_pod=1)
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(mesh.shape) == (1, 1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_device_mesh(1, 1, "cpu", n_pod=2)
    assert make_device_mesh(1, 1, "cpu").mesh_dim_names == ("data",
                                                            "model")


def test_make_device_mesh_with_a_pod_axis_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_device_mesh(1, 1, "cpu", n_pod=1)

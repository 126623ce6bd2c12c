"""The cohort-sharded round over ``torch.distributed`` (``launch/mesh.py``,
``launch/sharding.MeshPolicy``, ``launch/steps.make_fed_round_step``).

* gloo at world size 1: the sharded round is bitwise the unsharded one on
  a reduced gemma2-2b, on the flat f32, flat int8 and tree engines (a
  one-rank all-reduce adds nothing, and the same folds take the same
  rows in the same order).
* gloo at world size 2, two processes (``torch.multiprocessing``, a
  ``FileStore`` in ``tmp_path``, joined with a timeout so a hang fails in
  seconds): K = 4 at chunk 2 and chunk 1 and K = 3 in one chunk (an
  uneven split); both ranks' new models bitwise equal, each held to the
  reference's ``make_fed_round_step(cfg, NO_POLICY)`` at
  ``tests/test_torch_steps.py``'s rtol 1e-4 / atol 1e-5; each rank's
  clients the rows ``distribute_tensor`` gives it under
  ``to_placements(cohort_specs(...))``; a live mesh with a model axis of
  2 is a tensor-parallel policy for the dense config and a live token
  split for a ``seq2d`` split of an ``ssm`` config.
* ``make_device_mesh`` refuses without a process group and at a world
  size that does not fit.
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
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.core import aggregate, comm  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

REF_CFG = ref_base.ModelConfig(pattern=(ref_base.LayerSpec("attn"),),
                               **cases.TINY)
RTOL, ATOL = 1e-4, 1e-5
JOIN_S = 60


@functools.lru_cache(maxsize=None)
def port_params():
    return tfm.init_params(torch.Generator().manual_seed(0), cases.CFG)


def ref_params():
    return jax.tree.map(jnp.asarray, interop.to_reference(port_params()))


@pytest.fixture
def gloo_world1():
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------

ENGINES = {"flat f32": None,
           "flat int8": aggregate.EngineSpec(wire=comm.WireSpec("int8", 128)),
           "tree": aggregate.EngineSpec(engine="tree")}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_world1_sharded_round_is_bitwise_unsharded(gloo_world1, engine):
    cfg = configs.get_reduced("gemma2-2b").with_overrides(
        compute_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    k, chunk = 4, 2
    cohort = tree_map(lambda x: x[None].expand((k,) + x.shape), params)
    data = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(k, 2, 2, 17)).astype(np.int32))
    simple = torch.tensor([True, False, True, False])
    policy = sharding.MeshPolicy(make_device_mesh(1, 1, "cpu"), cfg)
    kw = dict(local_steps=2, cohort_chunk=chunk, engine=ENGINES[engine])
    want_c, want_loss = steps.make_fed_round_step(cfg, **kw)(
        cohort, data, simple)
    got_c, got_loss = steps.make_fed_round_step(cfg, policy, **kw)(
        cohort, data, simple)
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got_c), tree_leaves(want_c)))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(got_c), tree_leaves(params)))


def test_make_device_mesh_refusals(gloo_world1):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_device_mesh(2, 1, "cpu")


def test_make_device_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_device_mesh(1, 1, "cpu")


# ---------------------------------------------------------------------------
# world size 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Both ranks' results (``torch_mesh_cases.rank_main``) and the
    reference's round of each cohort size K (at the first chunk listed
    for it: the round's sum does not depend on the chunking, and the
    tolerance holds the reordered sums), computed while the ranks run."""
    d = tmp_path_factory.mktemp("mesh2")
    params_path = str(d / "params.pt")
    torch.save(port_params(), params_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=cases.rank_main,
                         args=(r, 2, str(d / "store"), params_path, str(d)))
             for r in range(2)]
    for p in procs:
        p.start()
    refs = {}
    for _, k, chunk in cases.CASES:
        if k not in refs:
            refs[k] = ref_round(k, chunk)
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errors = [(d / f"rank{r}.err").read_text() for r in range(2)
              if (d / f"rank{r}.err").exists()]
    assert not hung, f"{len(hung)} rank(s) hung past {JOIN_S} s"
    assert not errors, errors
    assert [p.exitcode for p in procs] == [0, 0]
    return [torch.load(str(d / f"rank{r}.pt")) for r in range(2)], refs


def ref_round(k: int, chunk: int):
    step = ref_steps.make_fed_round_step(REF_CFG, NO_POLICY,
                                         local_steps=cases.STEPS,
                                         cohort_chunk=chunk)
    cohort = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (k,) + x.shape),
                          ref_params())
    return jax.jit(step)(cohort, jnp.asarray(cases.tokens(k)),
                         jnp.asarray(cases.is_simple(k)))


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c[0])
def test_world2_ranks_agree_and_match_reference(world2, case):
    label, k, _ = case
    ranks, refs = world2
    a, b = ranks[0][label], ranks[1][label]
    assert torch.equal(a["loss"], b["loss"])
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
    r_c, r_loss = refs[k]
    np.testing.assert_allclose(float(a["loss"]), float(r_loss), rtol=RTOL,
                               atol=ATOL)
    ref_leaves = jax.tree.leaves(r_c)
    assert len(ref_leaves) == len(tree_leaves(a["params"]))
    for x, y in zip(tree_leaves(a["params"]), ref_leaves):
        np.testing.assert_allclose(x.numpy(), np.asarray(y, np.float32),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", cases.CASES, ids=lambda c: c[0])
def test_world2_clients_are_the_dtensor_shards(world2, case):
    label, k, _ = case
    ranks = world2[0]
    rows = [ranks[r][label]["split"] for r in range(2)]
    assert rows == [ranks[r][label]["placed"] for r in range(2)]
    # every client trained exactly once, over both ranks
    assert sorted(z for r in rows for part in r for z in part) == \
        list(range(k))


def test_world2_model_axis_raises(world2):
    """A (1, 2) mesh is a live model axis for the dense config (tensor
    parallelism, ``tests/test_torch_tp.py``), and a ``seq2d`` split of an
    ``ssm``-typed config, which once raised, is a live token split (the
    xLSTM states chained across ranks)."""
    for rank in world2[0]:
        assert rank["model_axis_live"] is True
        assert rank["model_axis"] == "True", rank["model_axis"]

"""Execution over a live model axis (tensor parallelism): the train, round,
prefill and serve steps under a ``MeshPolicy`` over a ``DeviceMesh`` whose
model axis is 2 or 4, against the JAX reference's unsharded functions (what
GSPMD computes for the reference under the same policy).

* One gloo spawn at world size 2 on a (1, 2) mesh and one at world size 4
  on a (2, 2) mesh, started together (``tests/torch_mesh_cases.
  tp_rank_main``, a ``FileStore`` each, joined within 60 s), while the
  reference's unsharded steps run here: the train step on gemma2 narrow
  (replicated heads, the tied vocab-parallel table; on the (2, 2) mesh its
  batch split over data too), the round step on
  gemma2 narrow (flat f32, flat int8, tree; the (2, 2) round on flat
  f32), prefill on minitron narrow (heads sharded, GQA), recurrentgemma
  narrow (the rnn channels; K6's plain version) and llava narrow (the
  head dim, with the frontend), and at world size 4 minitron's prefill
  on a (1, 4) mesh (its kv heads replicated).  Every rank's
  ``full_tensor()``s are bitwise equal; params, losses, logits and caches are held at rtol 1e-4
  / atol 1e-5, the int8 round under ``repro_torch.parity``'s lossy-wire
  rules (as ``tests/test_torch_steps.py`` holds the unsharded one).  The
  reference's tree round is its flat f32 round (the same fold).
* The serve step in the same spawns (``cases.TP_DECODE``): each prefill's
  cache, placed by ``cache_specs``, decoded 6 teacher-forced steps with
  the exit head, against the reference's unsharded ``make_serve_step`` from
  its own prefill's cache on the same tokens: at (1, 2) gemma2 narrow (a
  ring and a dense global cache over kv_seq, the ring wrapped, the new
  slot crossing the rank boundary in both), recurrentgemma narrow (the
  ring and the RG-LRU state over its channels), minitron narrow (heads)
  and llava narrow (the head dim); at (1, 4) minitron narrow (q heads
  sharded, the cache over kv_seq); at (2, 2) gemma2 narrow at batch 2
  (over data) and 1 (the cache's sequence over data).  Logits, exit
  logits and caches of every step at rtol 1e-4 / atol 1e-5; each slot
  written by the ranks that hold it and no other rank.
* The MoE configs in the same spawns (``cases.TP_MOE_TRAIN``,
  ``cases.TP_DECODE``), against the reference's unsharded jitted steps at
  rtol 1e-4 / atol 1e-5: reduced qwen2-moe's train step at (1, 2), (1, 4)
  and (2, 2) (the experts axis over model), its round on the three
  engines at (1, 2) (a config whose shards hold whole int8 groups), its
  prefill and serve steps at (1, 2), (1, 4) and (2, 2) at batch 2; the
  expert_ffn layout (3 experts) and padded experts (3 padded to 4) at
  (1, 2); reduced kimi-k2's 2-D experts at (2, 2).  The train step's
  routing equals the unsharded step's, call for call, on every rank; the
  decode steps route the whole batch as one group, at (2, 2) each data
  rank its own rows with the queue offsets of the rank before it (kimi-
  k2's 2-D experts: the batch's rows gathered), each rank's routing the
  port's unsharded run's for its rows; the aux losses at (2, 2) equal the
  unsharded ones.  Every decode case's prefill
  logits and cache are held too.
* The xLSTM and codebook configs in the same spawns (``cases.TP_ZOO`` at
  ``cases.TP_ZOO_MESHES``): reduced xlstm-1.3b's and musicgen-large's
  train steps and their flat f32, flat int8 and tree rounds at (1, 2),
  (1, 4) and (2, 2) against the reference's unsharded jitted steps
  (xlstm's with its sLSTM output kept in f32 on both sides, and its
  train step once more with the bf16 cast, its updates at bf16 rounding
  of the port's unsharded step's; musicgen's rounds on a config whose
  shards hold whole int8 groups, the reference's round fed its codebook
  tokens folded, ``_FlatCodebooks``); their prefill and serve steps at
  the three meshes (xlstm's logits at the xLSTM tests' tolerances), each
  rank's shards of the xLSTM states
  against the reference's cache; the codebook embedding bitwise the
  unsharded sum; ``common.gather_by_sum`` against gloo's functional
  all-gather; both configs' specs against the reference's.
* What once raised over a live model axis and now runs (a seq2d split of
  the hybrid, audio, MoE and xLSTM configs, a live pod axis); the int8
  wire's group check on a leaf whose shards straddle 128-element groups (an mlp
  leaf and an expert leaf); a cohort of kimi-k2's 2-D experts, whose
  specs name data twice.
* The vocab-parallel embedding with a tied unembedding and the
  vocab-parallel CE: loss and the table's gradient against the unsharded
  run of one f64 table.
* Every kernel wrapper refuses a DTensor.
* The dry-run's collective bytes on a fake (2, 2) mesh: gemma2 narrow's
  train and serve steps, reduced qwen2-moe's and xlstm-1.3b's serve steps
  and reduced musicgen-large's prefill, serve and train steps against
  counts derived here from the layer shapes.
"""

import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.core import adapters as ref_adapters  # noqa: E402
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from test_torch_xlstm_model import f32_slstm_out  # noqa: E402
from repro_torch import interop, parity  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import comm, flatten  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_keys  # noqa

RTOL, ATOL = 1e-4, 1e-5
# xlstm's logits follow its sLSTM output's bf16 cast: the tolerances of
# tests/test_torch_xlstm_model.py (the reference tests' own, the size of a
# flipped bf16 rounding), prefill and decode
XLSTM_LOGITS = {"prefill": 6e-3, "decode": 5e-3}
BF16 = 2.0 ** -7             # bf16 rounding of a leaf's update's scale
JOIN_S = 60
MAX_SHARE = 1e-3
# (world size, mesh, arch, batch, prompt, cache_len) of each decode case
DECODE_CASES = tuple((world,) + case for world, cs in cases.TP_DECODE.items()
                     for case in cs)


def ref_config(arch):
    return cases.variant(ref_configs.get_reduced(arch.partition(":")[0]),
                         arch)


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return jax.tree.map(jnp.asarray, interop.to_reference(
        cases.tp_params(arch)))


class _FlatCodebooks(ref_adapters.LMAdapter):
    """The reference's LMAdapter on tokens whose codebook dim is folded
    into their last dim: the reference's round step transposes its data
    as (K, B, L, S+1), which codebook data (K, B, L, S+1, NC) is not, so
    a codebook round passes it as (K, B, L, (S+1) NC) and each loss
    unfolds its batch's tokens first.  Every other line is the
    reference's."""

    def _unfold(self, batch):
        t = batch["tokens"]
        return dict(batch, tokens=t.reshape(
            t.shape[:-1] + (-1, self.cfg.n_codebooks)))

    def loss_side(self, params, batch):
        return super().loss_side(params, self._unfold(batch))

    def loss_simple(self, params, batch):
        return super().loss_simple(params, self._unfold(batch))


class RefSplit(NO_POLICY.__class__):
    """The reference's policy with a token split's flags and every
    constrain the identity (its ``Policy``'s): under ``seq2d`` its
    attention is ``chunk2d_attention``, under ``dp2d`` its CE one piece --
    the program GSPMD partitions for the mesh, here on one device."""

    def __init__(self, mode: str):
        self.seq2d = mode in ("seq2d", "seq2d_fsdp")
        self.dp2d = mode == "dp2d"


def ref_policy(arch: str):
    """``RefSplit`` of ``arch``'s token split (``cases.TP_SPLIT``,
    ``cases.TP_FSDP``), else the reference's no-op policy."""
    mode = arch.partition(":")[2]
    return RefSplit(mode) if mode in ("seq2d", "dp2d", "seq2d_fsdp") \
        else NO_POLICY


def ref_round(engine: str, arch: str = cases.TP_TRAIN):
    spec = {"flat f32": None, "flat int8": ref_aggregate.EngineSpec(
        wire=ref_comm.WireSpec("int8", 128)),
        "int8 topk": ref_aggregate.EngineSpec(wire=ref_comm.WireSpec(
            "int8", 128, topk_frac=0.5)),
        "f32 topk": ref_aggregate.EngineSpec(wire=ref_comm.WireSpec(
            "float32", 128, topk_frac=0.25)),
        "scaffold": ref_aggregate.EngineSpec(
            variance_reduction="scaffold")}[engine]
    cfg = ref_config(arch)
    data, simple = cases.tp_round_inputs(arch=arch)
    saved = ref_steps.LMAdapter
    if cfg.n_codebooks > 1:
        ref_steps.LMAdapter = _FlatCodebooks
        data = data.reshape(data.shape[:3] + (-1,))
    try:
        step = ref_steps.make_fed_round_step(
            cfg, ref_policy(arch), local_steps=cases.TP_STEPS, engine=spec)
    finally:
        ref_steps.LMAdapter = saved
    cohort = jax.tree.map(lambda x: jnp.broadcast_to(
        x[None], (cases.TP_K,) + x.shape), ref_params(arch))
    return jax.jit(step)(cohort, jnp.asarray(data), jnp.asarray(simple))


def ref_train(arch: str, batch=None):
    train = ref_steps.make_train_step(ref_config(arch), ref_policy(arch))
    return jax.jit(train)(ref_params(arch), {
        k: jnp.asarray(v) for k, v in (
            batch or cases.tp_train_batch(arch)).items()})


def ref_decode(arch, batch, prompt, cache_len):
    """The reference's unsharded prefill then ``TP_DECODE_STEPS``
    teacher-forced serve steps with the exit head: each step's logits,
    exit logits and cache."""
    cfg = ref_config(arch)
    prompt_batch, forced = cases.tp_decode_inputs(arch, batch, prompt)
    logits, cache = jax.jit(ref_steps.make_prefill_step(
        cfg, ref_policy(arch), cache_len=cache_len))(ref_params(arch), {
            k: jnp.asarray(v) for k, v in prompt_batch.items()})
    serve = jax.jit(ref_steps.make_serve_step(cfg, ref_policy(arch),
                                              with_exit_head=True))
    pos = cases.first_position(arch, prompt)
    out = {"logits": [], "exit": [], "cache": [],
           "prefill": {"logits": np.asarray(logits),
                       "cache": jax.tree.map(np.asarray, cache)}}
    for i in range(cases.TP_DECODE_STEPS):
        logits, cache, exit_logits = serve(
            ref_params(arch), cache, {"tokens": jnp.asarray(forced[i])},
            jnp.int32(pos + i))
        out["logits"].append(np.asarray(logits))
        out["exit"].append(np.asarray(exit_logits))
        out["cache"].append(jax.tree.map(np.asarray, cache))
    return out


def references():
    """The reference's unsharded results of every case."""
    out = {"train": ref_train(cases.TP_TRAIN)}
    for arch in {a for cs in cases.TP_MOE_TRAIN.values() for _, _, a in cs}:
        out[("train", arch)] = ref_train(arch)
    for engine in ("flat f32", "flat int8"):
        out[engine] = ref_round(engine)
        out["moe " + engine] = ref_round(engine, cases.TP_MOE_ROUND)
    out["tree"] = out["flat f32"]
    out["moe tree"] = out["moe flat f32"]
    # xLSTM and codebooks: each step compiled once and held against every
    # mesh's run; xlstm's with its sLSTM output kept in f32, as the ranks
    # run them
    for arch in cases.TP_ZOO:
        with (f32_slstm_out() if arch == cases.TP_XLSTM
              else contextlib.nullcontext()):
            out[("train", arch)] = ref_train(arch)
            for engine in ("flat f32", "flat int8"):
                out[(engine, arch)] = ref_round(engine,
                                                cases.zoo_round_arch(arch))
        out[("tree", arch)] = out[("flat f32", arch)]
    out[("train bf16", cases.TP_XLSTM)] = ref_train(cases.TP_XLSTM)
    tokens = cases.tp_train_tokens(cases.TP_MOE)[:, :-1]
    out["moe aux"] = jax.jit(lambda p, t: ref_tfm.forward(
        p, ref_config(cases.TP_MOE), t)[2])(ref_params(cases.TP_MOE),
                                            jnp.asarray(tokens))
    for arch in cases.TP_PREFILL:
        step = ref_steps.make_prefill_step(ref_config(arch), NO_POLICY)
        batch = cases.tp_prefill_batch(arch)
        out[arch] = jax.jit(step)(ref_params(arch), {
            k: jnp.asarray(v) for k, v in batch.items()})
    for case in {c[2:] for c in DECODE_CASES}:
        out[("decode",) + case] = ref_decode(*case)
    # the compressed and SCAFFOLD specs; the token splits under their
    # flags (RefSplit), each step compiled once and held against every
    # mesh's run
    for spec in cases.TP_SPECS:
        out[("spec", spec)] = ref_round(spec, cases.TP_SPEC_ARCH)
    for arch in cases.TP_SPLIT:
        out[("train", arch)] = ref_train(arch)
        for engine in ("flat f32", "flat int8"):
            out[(engine, arch)] = ref_round(engine, arch)
        out[("tree", arch)] = out[("flat f32", arch)]
        out[("decode", arch)] = ref_decode(arch, *cases.TP_SPLIT_DECODE[1:])
    for arch, prompt, cache_len in {c[1:] for cs in cases.TP_SPLIT_B1.values()
                                    for c in cs}:
        out[("decode b1", arch)] = ref_decode(arch, 1, prompt, cache_len)
    out[("train", cases.TP_FSDP)] = ref_train(cases.TP_FSDP)
    out[("decode", cases.TP_FSDP)] = ref_decode(cases.TP_FSDP,
                                                *cases.TP_FSDP_DECODE[1:])
    long_arch = cases.TP_SPLIT[0]
    out["long train"] = ref_train(long_arch, cases.tp_long_batch(
        long_arch, prefill=False))
    long_batch = {k: jnp.asarray(v) for k, v in
                  cases.tp_long_batch(long_arch, prefill=True).items()}
    out["long prefill"] = jax.jit(ref_steps.make_prefill_step(
        ref_config(long_arch), ref_policy(long_arch)))(
        ref_params(long_arch), long_batch)
    # whole-row softmax: the function K5 computes
    out["long prefill whole"] = jax.jit(ref_steps.make_prefill_step(
        ref_config(long_arch), NO_POLICY))(ref_params(long_arch), long_batch)
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Both spawns' results by world size (a list of ranks each), and the
    reference's, computed while the ranks run."""
    d = tmp_path_factory.mktemp("tp")
    ctx = mp.get_context("spawn")
    procs = {world: [ctx.Process(target=cases.tp_rank_main, args=(
        r, world, str(d / f"store{world}"), str(d)))
        for r in range(world)] for world in (2, 4)}
    for p in procs[2] + procs[4]:
        p.start()
    refs = references()
    for p in procs[2] + procs[4]:
        p.join(JOIN_S)
    hung = [p for p in procs[2] + procs[4] if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    errors = [f.read_text() for f in sorted(d.glob("*.err"))]
    assert not hung, f"{len(hung)} rank(s) hung past {JOIN_S} s"
    assert not errors, errors
    assert all(p.exitcode == 0 for p in procs[2] + procs[4])
    return {world: [torch.load(str(d / f"tp{world}_rank{r}.pt"))
                    for r in range(world)] for world in (2, 4)}, refs


def assert_close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def assert_leaves(got_tree, want_tree):
    want = jax.tree.leaves(want_tree)
    got = tree_leaves(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert_close(g, w)


def assert_ranks_equal(results, key):
    first = tree_leaves(results[0][key])
    for other in results[1:]:
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else a == b for a, b in
                   zip(first, tree_leaves(other[key])))


MOE_ENGINES = tuple("moe " + e for e in cases.TP_ENGINES)
CASES_2 = (("train",) + cases.TP_ENGINES + cases.TP_PREFILL + ("vocab",)
           + MOE_ENGINES)
# each case's test id -> (world size, the ranks' result key)
BITWISE = {key: (2, key) for key in CASES_2}
BITWISE.update({"(2, 2) flat f32": (4, "flat f32"),
                "(2, 2) train": (4, "train"),
                "(2, 2) moe aux": (4, "(2, 2) moe aux")})
MOE_TRAIN = {key: (world, arch) for world, cs in cases.TP_MOE_TRAIN.items()
             for key, _, arch in cs}
BITWISE.update({key: (world, key) for key, (world, _) in MOE_TRAIN.items()})
BITWISE.update({cases.decode_key(*c[1:4]): (c[0], cases.decode_key(*c[1:4]))
                for c in DECODE_CASES})
# the xLSTM and codebook cases: (world size, mesh, arch, kind), kind
# "train" or a round engine
ZOO = {cases.zoo_key(kind, mesh, arch): (world, mesh, arch, kind)
       for world, meshes in cases.TP_ZOO_MESHES.items() for mesh in meshes
       for arch in cases.TP_ZOO for kind in ("train",) + cases.TP_ENGINES}
# xlstm's train step with its sLSTM output's bf16 cast, at each mesh
XLSTM_BF16 = {cases.zoo_key("train bf16", mesh, cases.TP_XLSTM): world
              for world, meshes in cases.TP_ZOO_MESHES.items()
              for mesh in meshes}
BITWISE.update({key: (world, key) for key, (world, *_) in ZOO.items()})
# the compressed and SCAFFOLD specs and the token splits: (world size,
# mesh, arch, kind)
SPLITS = {cases.split_key(kind, mesh, arch): (world, mesh, arch, kind)
         for world, meshes in cases.TP_MESHES.items() for mesh in meshes
         for arch, kinds in ((cases.TP_SPEC_ARCH, cases.TP_SPECS),) + tuple(
             (a, ("train",) + cases.TP_ENGINES + ("decode",))
             for a in cases.TP_SPLIT) for kind in kinds}
SPLITS.update({cases.split_key(kind, "(2, 2)", cases.TP_FSDP):
              (4, "(2, 2)", cases.TP_FSDP, kind)
              for kind in ("train", "decode")})
BITWISE.update({key: (world, key) for key, (world, *_) in SPLITS.items()})
# the seq2d serve steps at batch 1: (world size, mesh, arch)
SPLIT_B1 = {cases.split_key("decode b1", mesh, arch): (world, mesh, arch)
            for world, cs in cases.TP_SPLIT_B1.items()
            for mesh, arch, _, _ in cs}
BITWISE.update({key: (world, key) for key, (world, *_) in SPLIT_B1.items()})
BITWISE.update({"long train": (2, "long train"),
                "long prefill": (2, "long prefill")})
BITWISE.update({key: (world, key) for key, world in XLSTM_BF16.items()})


@pytest.mark.parametrize("key", list(BITWISE))
def test_ranks_hold_bitwise_equal_full_tensors(tp_runs, key):
    world, key = BITWISE[key]
    assert_ranks_equal(tp_runs[0][world], key)


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_matches_reference(tp_runs, world):
    """(1, 2): the batch whole on each rank; (2, 2): split over data, the
    gradients summed over it."""
    got = tp_runs[0][world][0]["train"]
    want_p, want_m = tp_runs[1]["train"]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("key", list(MOE_TRAIN))
def test_moe_train_step_matches_reference(tp_runs, key):
    """The MoE configs' train step over a live model axis: reduced
    qwen2-moe's experts axis at (1, 2), (1, 4) and (2, 2) (its batch over
    data), the expert_ffn and padded cases at (1, 2), and reduced kimi-k2's
    2-D experts at (2, 2); the aux losses are in the loss."""
    world, arch = MOE_TRAIN[key]
    got = tp_runs[0][world][0][key]
    want_p, want_m = tp_runs[1][("train", arch)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("key", [k for k, v in ZOO.items()
                                 if v[3] == "train"])
def test_xlstm_and_codebook_train_step_matches_reference(tp_runs, key):
    """Reduced xlstm-1.3b (its mixers run whole on each rank's rows, their
    gradients replicated over model) and reduced musicgen-large (its
    codebook tables vocab-parallel, its frontend) at (1, 2), (1, 4) and
    (2, 2): loss and parameters against the reference's unsharded train
    step; xlstm's sLSTM output kept in f32 on both sides."""
    world, _, arch, _ = ZOO[key]
    got = tp_runs[0][world][0][key]
    want_p, want_m = tp_runs[1][("train", arch)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("key", list(XLSTM_BF16))
def test_xlstm_train_step_with_the_bf16_cast_matches_unsharded(tp_runs,
                                                               key):
    """Reduced xlstm-1.3b's train step as the config runs it, the sLSTM
    output's bf16 cast in place, at (1, 2), (1, 4) and (2, 2): the loss
    against the reference's at rtol 1e-4, and each leaf's update (after -
    before) against the port's unsharded train step on the same rank at
    bf16 rounding of its scale (an f32 difference between the frameworks
    flips bf16 roundings beyond that rule, so the reference's update is not
    the yardstick here; the f32 cases above hold it).  A gradient left
    ``Partial`` over model, or divided by the mesh size, is off by a
    factor of 2 or 4."""
    world = XLSTM_BF16[key]
    got = tp_runs[0][world][0][key]
    _, want_m = tp_runs[1][("train bf16", cases.TP_XLSTM)]
    np.testing.assert_allclose(got["loss"].item(), float(want_m["loss"]),
                               rtol=1e-4)
    before = tree_leaves(cases.tp_params(cases.TP_XLSTM))
    got_p = tree_leaves(got["params"])
    want_p = tree_leaves(tp_runs[0][world][0]["train bf16 unsharded"])
    assert len(got_p) == len(want_p) == len(before)
    for x0, a, b in zip(before, got_p, want_p):
        step = (b - x0).float().numpy()
        np.testing.assert_allclose((a - x0).float().numpy(), step,
                                   rtol=BF16,
                                   atol=BF16 * float(np.abs(step).max()))


def test_moe_routing_equals_the_unsharded_step(tp_runs):
    """Every routing call of reduced qwen2-moe's train step at (1, 2)
    (forward and remat recompute) gives the unsharded step's slots,
    bitwise, on every rank."""
    for rank in tp_runs[0][2]:
        slots = rank["moe slots"]
        assert len(slots["sharded"]) == len(slots["unsharded"]) > 0
        for a, b in zip(slots["sharded"], slots["unsharded"]):
            assert torch.equal(a, b)


def test_moe_aux_losses_equal_unsharded_at_2x2(tp_runs):
    """Reduced qwen2-moe's forward at (2, 2), the batch over data: both aux
    losses against the reference's unsharded ones (``load_balance`` is a
    product of two batch means, reduced over data before the product)."""
    want = tp_runs[1]["moe aux"]
    for rank in tp_runs[0][4]:
        got = rank["(2, 2) moe aux"]
        assert set(got) == {"load_balance", "router_z"}
        for name in got:
            assert_close(got[name], want[name])


@pytest.mark.parametrize("world,engine", [(2, e) for e in cases.TP_ENGINES]
                         + [(4, "flat f32")] + [(2, e) for e in MOE_ENGINES])
def test_round_step_matches_reference(tp_runs, world, engine):
    got = tp_runs[0][world][0][engine]
    want_c, want_loss = tp_runs[1][engine]
    assert_close(got["loss"], want_loss)
    # the new model comes back as DTensors placed like the parameters
    assert any("Shard" in p for p in got["placements"])
    if not engine.endswith("flat int8"):
        assert_leaves(got["params"], want_c)
        return
    # the int8 wire: the lossy-wire rules against the reference's round
    _int8_round_close(got, want_c, cases.TP_MOE_ROUND
                      if engine.startswith("moe") else cases.TP_TRAIN)


def _int8_round_close(got, want_c, arch):
    """The int8 wire's round under the lossy-wire rules against the
    reference's."""
    layout = flatten.build_layout(cases.tp_params(arch),
                                  total_multiple=2048)
    spec = comm.WireSpec("int8", 128)
    a = flatten.pack(layout, got["params"])
    b = flatten.pack(layout, interop.from_reference(
        jax.tree.map(np.asarray, want_c)))
    step = torch.maximum(parity.wire_step(spec, flatten.pack(
        layout, cases.tp_params(arch))), parity.wire_step(spec, b))
    res = parity.lossy_compare(a, b, step)
    assert res["share"] <= MAX_SHARE and res["worst"] <= 1.0, res


@pytest.mark.parametrize("key", [k for k, v in ZOO.items()
                                 if v[3] != "train"])
def test_xlstm_and_codebook_round_step_matches_reference(tp_runs, key):
    """Reduced xlstm-1.3b and musicgen-large's rounds (K = 2, one simple)
    on the flat f32, flat int8 and tree engines at (1, 2), (1, 4) and
    (2, 2), each rank folding its local shards: against the reference's
    unsharded round (its flat f32 round for the tree engine), the int8
    round under the lossy-wire rules.  musicgen's rounds run on a config
    whose shards hold whole int8 groups; the reference's round takes its
    codebook tokens through ``_FlatCodebooks``."""
    world, _, arch, engine = ZOO[key]
    got = tp_runs[0][world][0][key]
    want_c, want_loss = tp_runs[1][(engine, arch)]
    assert_close(got["loss"], want_loss)
    assert any("Shard" in p for p in got["placements"])
    if engine == "flat int8":
        _int8_round_close(got, want_c, cases.zoo_round_arch(arch))
    else:
        assert_leaves(got["params"], want_c)


@pytest.mark.parametrize("arch", cases.TP_PREFILL)
def test_prefill_step_matches_reference(tp_runs, arch):
    got = tp_runs[0][2][0][arch]
    want_logits, want_cache = tp_runs[1][arch]
    assert tuple(got["logits"].shape) == tuple(want_logits.shape)
    assert_close(got["logits"], want_logits)
    assert_leaves(got["cache"], want_cache)


def test_prefill_reads_replicated_kv_heads_over_four_ranks(tp_runs):
    """minitron narrow on a (1, 4) mesh: its 4 query heads sharded, its 2 kv
    heads replicated (2 does not divide 4), each rank reading the kv head
    its query head needs; every rank's full tensors equal."""
    ranks = tp_runs[0][4]
    assert_ranks_equal(ranks, "minitron-8b (1, 4)")
    want_logits, want_cache = tp_runs[1]["minitron-8b"]
    got = ranks[0]["minitron-8b (1, 4)"]
    assert_close(got["logits"], want_logits)
    assert_leaves(got["cache"], want_cache)


def _decode_id(case):
    return cases.decode_key(*case[1:4])


def assert_logits(got, want, arch, when):
    """Logits at rtol 1e-4 / atol 1e-5; xlstm's at ``XLSTM_LOGITS``."""
    assert tuple(got.shape) == tuple(want.shape)
    if arch != cases.TP_XLSTM:
        assert_close(got, want)
        return
    tol = XLSTM_LOGITS[when]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("what", ["logits", "exit", "cache"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_serve_step_matches_reference(tp_runs, case, what):
    """Each step's logits, exit logits or cache against the reference's
    unsharded decode; the logits come back placed as the reference's
    ``("batch", "seq", "vocab")`` constrain resolves on them
    (vocab-parallel, or musicgen's over its codebooks where they divide
    the model axis, whole where they do not)."""
    got = tp_runs[0][case[0]][0][cases.decode_key(*case[1:4])]
    want = tp_runs[1][("decode",) + case[2:]]
    assert len(got[what]) == len(want[what]) == cases.TP_DECODE_STEPS
    for g, w in zip(got[what], want[what]):
        if what == "cache":
            assert_leaves(g, w)
        else:
            assert_logits(g, w, case[2], "decode")
    assert got["placements"] == [got["want_placements"]] * 2
    if case[2] != cases.TP_MUSICGEN:
        assert all("Shard(dim=2)" in p for p in got["placements"])


@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_prefill_before_decode_matches_reference(tp_runs, case):
    """Each decode case's sharded prefill: its logits and its cache (as
    ``cache_specs`` places it) whole, against the reference's unsharded
    prefill of the same prompt."""
    got = tp_runs[0][case[0]][0][cases.decode_key(*case[1:4])]["prefill"]
    want = tp_runs[1][("decode",) + case[2:]]["prefill"]
    assert_logits(got["logits"], want["logits"], case[2], "prefill")
    assert_leaves(got["cache"], want["cache"])


def assert_rank_routing(calls, whole):
    """Each routing call of a rank's serve steps (``torch_mesh_cases.
    rank_routing``) against the unsharded run's: the rank's tokens (from
    ``start`` in the group) chose the unsharded run's experts, kept the
    same pairs, and each kept pair's local slot plus the queue offset (the
    unsharded run's pairs before ``start`` that chose its expert) is its
    slot in the whole group."""
    assert len(calls) == len(whole) > 0
    for got, want in zip(calls, whole):
        b, s, k = got["experts"].shape
        start, (e, c) = got["start"], got["buffer"]
        c_whole = want["buffer"][1]
        experts = want["experts"][:, start:start + s]
        assert torch.equal(got["experts"], experts)
        w_slot = want["slot"][:, start:start + s]
        kept = w_slot < e * c_whole
        assert torch.equal(got["slot"] < e * c, kept)
        before = want["experts"][:, :start].reshape(b, -1)
        offset = torch.zeros((b, e), dtype=torch.long).scatter_add_(
            1, before, torch.ones_like(before))
        offset = torch.gather(offset, 1, experts.reshape(b, -1)).reshape(
            experts.shape)
        assert torch.equal((got["slot"] % c + offset)[kept],
                           (w_slot % c_whole)[kept])


MOE_DECODE_CASES = tuple(c for c in DECODE_CASES
                         if cases.tp_config(c[2]).moe is not None)


@pytest.mark.parametrize("case", MOE_DECODE_CASES, ids=_decode_id)
def test_moe_decode_routing_is_the_unsharded_routing_of_each_ranks_rows(
        tp_runs, case):
    """Every MoE serve step's routing on each rank: its rows of the
    unsharded run's one group (the whole batch), routed with the queue
    offsets of the ranks before it where the batch is sharded over data,
    or the whole group where it is not (kimi-k2's 2-D experts gather the
    batch's rows)."""
    key = cases.decode_key(*case[1:4]) + " written"
    for rank in tp_runs[0][case[0]]:
        assert_rank_routing(rank[key]["routing"],
                            rank[key]["unsharded routing"])


@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_serve_step_writes_each_slot_on_its_owner_only(tp_runs, case):
    """At each step every rank changes exactly the new slot of each KV
    cache leaf where its rows hold it (a ring's slot ``pos % size``, a
    dense cache's ``pos``) and nothing elsewhere; where the rows are
    sharded (kv_seq) the owner changes over the steps (the ring's and the
    dense cache's slots cross the rank boundary)."""
    world, _, arch, _, prompt, cache_len = case
    ranks = [r[cases.decode_key(*case[1:4]) + " written"]["rows"]
             for r in tp_runs[0][world]]
    first = cases.first_position(arch, prompt)
    owners = {}
    for step in range(cases.TP_DECODE_STEPS):
        pos = first + step
        for path in ranks[0][step]:
            size = ranks[0][step][path][2]
            slot = pos % size if size < cache_len else pos
            wrote = []
            for r, written in enumerate(ranks):
                start, stop, _, rows = written[step][path]
                assert rows == ([slot] if start <= slot < stop else []), \
                    (path, step, r, rows)
                if rows:
                    wrote.append(r)
            if any(w[step][path][:2] != (0, size) for w in ranks):
                owners.setdefault(path, set()).add(tuple(wrote))
    assert all(len(o) > 1 for o in owners.values()), owners
    if arch in ("gemma2-2b", "recurrentgemma-2b") or (
            arch == "minitron-8b" and world == 4):
        assert owners       # the cases whose caches go over kv_seq


# what ran out of scope before and now runs: a seq2d split of the hybrid
# and audio configs, of the MoE configs (their queue positions counted
# across ranks) and of the xLSTM configs (their states chained across
# ranks) is a live token split, and the round's data group over a pod axis
# is the pod x data group (here one pod of one data rank: world size 1)
LIFTED = {"seq2d recurrentgemma-2b": "True", "seq2d musicgen-large": "True",
          "seq2d qwen2-moe-a2.7b": "True", "seq2d xlstm-1.3b": "True",
          "pod axis": "1"}


@pytest.mark.parametrize("name", list(LIFTED))
def test_lifted_refusals_now_run(tp_runs, name):
    assert tp_runs[0][2][0]["refusals"][name] == LIFTED[name]


def test_seq2d_fsdp_cohort_is_refused_as_the_reference_refuses_it(
        tp_runs):
    """A seq2d_fsdp cohort's specs name data twice, even at data size 1
    (the client axis and each weight's ZeRO-3 dim): placing it raises, as
    the reference's ``NamedSharding`` does, so its round step does not
    run."""
    msg = tp_runs[0][2][0]["refusals"]["seq2d_fsdp cohort"]
    assert msg.startswith("ValueError"), msg
    assert "'data' to two dims" in msg


@pytest.mark.parametrize("key", [k for k, v in SPLITS.items()
                                 if v[3] in cases.TP_SPECS])
def test_spec_round_matches_reference_and_its_base_bitwise(tp_runs, key):
    """The compressed-wire (int8 and f32 top-k) and SCAFFOLD specs over a
    live model axis at (1, 2), (1, 4) and (2, 2): against the reference's
    unsharded round step with the same spec (int8 under the lossy-wire
    rules), and bitwise the port's round without the extra options at the
    same mesh -- the reference's round step folds the dense uploads at the
    payload dtype and no control variates."""
    world, mesh, arch, spec = SPLITS[key]
    got = tp_runs[0][world][0][key]
    want_c, want_loss = tp_runs[1][("spec", spec)]
    assert_close(got["loss"], want_loss)
    if spec == "int8 topk":
        _int8_round_close(got, want_c, arch)
    else:
        assert_leaves(got["params"], want_c)
    base = tp_runs[0][world][0][cases.split_key(cases.TP_SPEC_BASE[spec],
                                                mesh, arch)]
    assert torch.equal(got["loss"], base["loss"])
    got_p, base_p = tree_leaves(got["params"]), tree_leaves(base["params"])
    assert len(got_p) == len(base_p)
    assert all(torch.equal(a, b) for a, b in zip(got_p, base_p))


@pytest.mark.parametrize("key", [k for k, v in SPLITS.items()
                                 if v[3] == "train"])
def test_token_split_train_step_matches_reference(tp_runs, key):
    """gemma2 narrow's train step under seq2d and dp2d at (1, 2), (1, 4)
    and (2, 2), llava narrow's under seq2d_fsdp at (2, 2) (its weights
    gathered over data at their use, its frontend rows): loss and
    parameters against the reference's train step under the mode's flags
    (``RefSplit``)."""
    world, _, arch, _ = SPLITS[key]
    got = tp_runs[0][world][0][key]
    want_p, want_m = tp_runs[1][("train", arch)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("key", [k for k, v in SPLITS.items()
                                 if v[3] in cases.TP_ENGINES])
def test_token_split_round_step_matches_reference(tp_runs, key):
    """gemma2 narrow's round (K = 2, one simple) under seq2d and dp2d on
    the flat f32, flat int8 and tree engines at (1, 2), (1, 4) and (2, 2),
    each client under the model group's policy: against the reference's
    round under the mode's flags (its flat f32 round for the tree engine),
    the int8 round under the lossy-wire rules."""
    world, _, arch, engine = SPLITS[key]
    got = tp_runs[0][world][0][key]
    want_c, want_loss = tp_runs[1][(engine, arch)]
    assert_close(got["loss"], want_loss)
    if engine == "flat int8":
        _int8_round_close(got, want_c, arch)
    else:
        assert_leaves(got["params"], want_c)


@pytest.mark.parametrize("what", ["prefill", "logits", "exit", "cache"])
@pytest.mark.parametrize("key", [k for k, v in SPLITS.items()
                                 if v[3] == "decode"])
def test_token_split_prefill_and_serve_match_reference(tp_runs, key, what):
    """Prefill on each rank's query rows (seq2d, seq2d_fsdp) or batch rows
    (dp2d), its cache placed by ``cache_specs``, then 6 teacher-forced
    serve steps with the exit head on the heads- or kv_seq-split cache:
    the prefill's logits and cache, each step's logits, exit logits and
    cache against the reference's under the mode's flags; the logits
    placed as the reference's ``("batch", "seq", "vocab")`` resolves."""
    world, _, arch, _ = SPLITS[key]
    got = tp_runs[0][world][0][key]
    want = tp_runs[1][("decode", arch)]
    if what == "prefill":
        assert_logits(got["prefill"]["logits"], want["prefill"]["logits"],
                      arch, "prefill")
        assert_leaves(got["prefill"]["cache"], want["prefill"]["cache"])
        return
    assert len(got[what]) == len(want[what]) == cases.TP_DECODE_STEPS
    for g, w in zip(got[what], want[what]):
        if what == "cache":
            assert_leaves(g, w)
        else:
            assert_logits(g, w, arch, "decode")
    assert got["placements"] == [got["want_placements"]] * 2


COLLECTIVES = {cases.split_key(f"{kind} collectives", mesh, arch): world
               for world, meshes in cases.TP_MESHES.items()
               for mesh in meshes for arch in cases.TP_SPLIT
               for kind in ("train", "decode")}
COLLECTIVES.update({cases.split_key("decode b1 collectives", mesh, arch):
                    world for world, mesh, arch in SPLIT_B1.values()})
COLLECTIVES[cases.split_key("decode collectives", "(2, 2)",
                            cases.TP_FSDP)] = 4


@pytest.mark.parametrize("what", ["prefill", "logits", "exit", "cache"])
@pytest.mark.parametrize("key", list(SPLIT_B1))
def test_seq2d_serve_step_at_batch_1_matches_reference(tp_runs, key, what):
    """A seq2d prefill and 6 serve steps at batch 1, the batch split over a
    data dim of one rank (decode's attention output placed whole over
    it, ``attention._attend_sharded``): reduced gemma2-2b and qwen2-moe at
    (1, 2) and (1, 4) against the reference's under seq2d's flags."""
    world, _, arch = SPLIT_B1[key]
    got = tp_runs[0][world][0][key]
    want = tp_runs[1][("decode b1", arch)]
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
    assert got["placements"] == [got["want_placements"]] * 2


@pytest.mark.parametrize("key", list(COLLECTIVES))
def test_token_split_steps_issue_all_reduces_only(tp_runs, key):
    """Every collective of a token split's train step (forward and
    backward) and of its prefill and serve steps is an all-reduce (the
    card's gloo cannot run an all-gather, a reduce-scatter or an
    all-to-all on CUDA tensors)."""
    for rank in tp_runs[0][COLLECTIVES[key]]:
        assert set(rank[key]) <= {"all_reduce"}, rank[key]


def test_token_split_chunk2d_route_train_matches_reference(tp_runs):
    """gemma2 narrow's train step under seq2d at (1, 2) on a sequence of
    2048 (chunk2d on each rank's two whole 512-row chunks against the
    gathered keys): against the reference's under seq2d's flags."""
    got = tp_runs[0][2][0]["long train"]
    want_p, want_m = tp_runs[1]["long train"]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


def test_token_split_chunk2d_route_prefill_matches_reference(tp_runs):
    """gemma2 narrow's prefill under seq2d at (1, 2) on 2048 positions: K5
    (its plain version) on each rank's 1024 query rows at ``q_offset``
    0 and 1024 against the key prefix, the cache reached by all-reduces.
    The logits and the cache against the reference's chunk2d prefill and
    against its prefill without the seq2d flags (its softmax over whole
    rows, the function K5 computes); both also against the port's
    unsharded prefill on the same rank."""
    got = tp_runs[0][2][0]["long prefill"]
    for key in ("long prefill", "long prefill whole"):
        want_logits, want_cache = tp_runs[1][key]
        assert_logits(got["logits"], want_logits, cases.TP_SPLIT[0],
                      "prefill")
        assert_leaves(got["cache"], want_cache)
    unsharded = got["unsharded"]
    assert_close(got["logits"], unsharded["logits"])
    got_c, want_c = tree_leaves(got["cache"]), tree_leaves(unsharded["cache"])
    assert len(got_c) == len(want_c)
    for a, b in zip(got_c, want_c):
        assert_close(a, b.numpy())
    assert set(got["collectives"]) == {"all_reduce"}


XLSTM_DECODE = [c for c in DECODE_CASES if c[2] == cases.TP_XLSTM]
# the xLSTM state leaves cache_specs splits over model, by name: the
# mLSTM's C (its value index), n (its key index) and conv (its channels),
# and the sLSTM's n
SPLIT = ("C", "n", "conv")


@pytest.mark.parametrize("case", XLSTM_DECODE, ids=_decode_id)
def test_xlstm_serve_step_writes_only_its_own_state_slices(tp_runs, case):
    """At each serve step every rank's shard of every xLSTM state leaf
    changed and equals its slice of the reference's unsharded cache after
    that step; C, n and conv (and the sLSTM's n) stay split over model
    (never replicated), the ranks' slices tiling the leaf."""
    world = case[0]
    want = tp_runs[1][("decode",) + case[2:]]["cache"]
    ranks = [r[cases.decode_key(*case[1:4]) + " written"]["states"]
             for r in tp_runs[0][world]]
    for step in range(cases.TP_DECODE_STEPS):
        ref = dict(tree_leaves_with_keys(interop.from_reference(
            jax.tree.map(np.asarray, want[step]))))
        paths = {"/".join(map(str, k)): k for k in ref}
        assert set(ranks[0][step]) == set(paths)
        for path, keys in paths.items():
            held = set()
            for states in ranks:
                offsets, placed, local, changed = states[step][path]
                assert changed, (path, step)
                region = tuple(slice(o, o + n)
                               for o, n in zip(offsets, local.shape))
                assert_close(local, ref[keys][region])
                held.add((offsets, tuple(local.shape)))
            split = keys[-1] in SPLIT
            assert ("Shard(dim=3)" in placed) == split, (path, placed)
            # over the ranks the shards hold every element once
            assert sum(math.prod(n) for _, n in held) == \
                ref[keys].numel(), (path, held)


@pytest.mark.parametrize("mesh", ["(1, 2)", "(1, 4)", "(2, 2)"])
def test_codebook_embedding_is_the_unsharded_sum_bitwise(tp_runs, mesh):
    """Reduced musicgen-large's embedding with bf16 tables over the
    vocabulary: one all-reduce of every codebook's rows, then the adds in
    the reference's order, bitwise the unsharded port's sum."""
    world = 2 if mesh == "(1, 2)" else 4
    for rank in tp_runs[0][world]:
        got = rank["codebook embed " + mesh]
        assert "Shard(dim=1)" in got["tables"]
        assert got["got"].dtype == got["want"].dtype
        assert torch.equal(got["got"], got["want"])


@pytest.mark.parametrize("mesh", ["(1, 2)", "(1, 4)", "(2, 2)"])
def test_gather_by_sum_is_the_functional_gather(tp_runs, mesh):
    """``common.gather_by_sum`` (one SUM all-reduce) equals gloo's
    functional all-gather on every rank, but for the sign of a zero."""
    world = 2 if mesh == "(1, 2)" else 4
    for rank in tp_runs[0][world]:
        got, want = rank["gather " + mesh]["got"], rank["gather " + mesh][
            "want"]
        assert torch.equal(got, want)
        flipped = got.signbit() != want.signbit()
        assert bool((want[flipped] == 0).all()) and bool(
            want.signbit().any())


ZOO_SPEC_MESHES = {"(1, 2)": (1, 2), "(1, 4)": (1, 4), "(2, 2)": (2, 2)}


@pytest.mark.parametrize("mesh", list(ZOO_SPEC_MESHES))
@pytest.mark.parametrize("arch", cases.TP_ZOO)
def test_zoo_param_and_cache_specs_equal_the_reference(arch, mesh):
    """The port's ``param_specs`` and ``cache_specs`` of reduced
    xlstm-1.3b and musicgen-large (a decode cache of batch 2) equal the
    reference's, and so does ``MeshPolicy.spec`` of musicgen-large's 4-D
    logits under the 3-entry ``("batch", "seq", "vocab")``."""
    shape = ZOO_SPEC_MESHES[mesh]
    rm = AbstractMesh(shape, ("data", "model"))
    pm = MeshShape(shape, ("data", "model"))
    r_cfg, cfg = ref_config(arch), cases.tp_config(arch)
    r_params = jax.eval_shape(lambda k: ref_tfm.init_params(k, r_cfg),
                              jax.random.PRNGKey(0))
    r_cache = jax.eval_shape(lambda: ref_tfm.init_cache(r_cfg, 2, 32))
    params = tfm.abstract_params(cfg)
    cache = tfm.init_cache(cfg, 2, 32, device="meta")

    def ref_leaves(tree):
        return [tuple(x) for x in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, JaxP))]
    for port, ref in (
            (sharding.param_specs(params, cfg, pm),
             ref_sharding.param_specs(r_params, r_cfg, rm)),
            (sharding.cache_specs(cache, cfg, pm),
             ref_sharding.cache_specs(r_cache, r_cfg, rm))):
        assert [tuple(x) for x in tree_leaves(port)] == ref_leaves(ref)
    logits = (4, 1536, 4, 2048)
    axes = ("batch", "seq", "vocab")
    assert tuple(sharding.MeshPolicy(pm, cfg).spec(logits, axes)) == \
        tuple(ref_sharding.MeshPolicy(rm, r_cfg).spec(logits, axes))


def test_int8_wire_refuses_shards_that_straddle_groups(tp_runs):
    msg = tp_runs[0][2][0]["refusals"]["int8 groups"]
    assert msg.startswith("ValueError"), msg
    assert "periods/#0/mlp/" in msg and "groups of 128" in msg


def test_int8_wire_refuses_expert_shards_that_straddle_groups(tp_runs):
    """3 experts do not divide the model axis of 2, so expert_ffn (128) is
    split in 64s: an int8 round's expert shards would hold half groups."""
    msg = tp_runs[0][2][0]["refusals"]["int8 expert groups"]
    assert msg.startswith("ValueError"), msg
    assert "/mlp/experts/" in msg and "groups of 128" in msg


def test_cohort_of_2d_experts_is_refused_as_the_reference_refuses_it(
        tp_runs):
    """kimi-k2's 2-D experts put expert_ffn over data, which a cohort's
    client axis takes too: ``cohort_specs`` names data twice, and placing
    it raises, as the reference's ``NamedSharding`` does."""
    msg = tp_runs[0][2][0]["refusals"]["cohort 2-D experts"]
    assert msg.startswith("ValueError"), msg
    assert "'data' to two dims" in msg


def test_vocab_parallel_embedding_with_tied_unembedding(tp_runs):
    """Loss and the table's gradient against the unsharded run of the same
    f64 table; the gradient stays row-sharded (the lookup and the
    unembedding each give ``Shard(0)``)."""
    got = tp_runs[0][2][0]["vocab"]
    table, tokens = cases.vocab_case()
    table = table.clone().requires_grad_(True)
    h = common.apply_embedding({"table": table}, tokens)
    logits = common.apply_unembedding({"table": table}, h)
    loss = common.softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    (grad,) = torch.autograd.grad(loss, [table])
    assert got["grad_placements"] == ["R", "S(0)"]
    # the CE widens to f32 (the reference's formula) and the vocab-parallel
    # sum of exponentials adds the ranks' partial sums in another order
    torch.testing.assert_close(got["loss"], loss.detach(), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got["grad"], grad, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# kernel wrappers and DTensors (one rank, in process)
# ---------------------------------------------------------------------------

def _wrapper_calls():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.masked_agg import ops as agg
    from repro_torch.kernels.rglru_scan import ops as scan
    z, n = 2, 256
    f32 = dict(dtype=torch.float32)
    return {
        "flash_attention": lambda d: fa.flash_attention(
            d(torch.zeros(1, 8, 2, 32)), d(torch.zeros(1, 8, 2, 32)),
            d(torch.zeros(1, 8, 2, 32))),
        "lru_scan": lambda d: scan.lru_scan(d(torch.zeros(1, 4, 8)),
                                            d(torch.zeros(1, 4, 8))),
        "lru_scan_gated": lambda d: scan.lru_scan_gated(
            d(torch.zeros(1, 4, 8)), *(d(torch.zeros(8)) for _ in range(5))),
        "masked_agg_acc_": lambda d: agg.masked_agg_acc_(
            d(torch.zeros(n)), d(torch.zeros(z, n)),
            d(torch.ones(n, dtype=torch.bool)), d(torch.ones(z, **f32)),
            d(torch.ones(z, **f32))),
        "masked_agg_acc_deq_": lambda d: agg.masked_agg_acc_deq_(
            d(torch.zeros(n)), d(torch.zeros(z, n, dtype=torch.int8)),
            d(torch.ones(z, n // 128)), d(torch.ones(n, dtype=torch.bool)),
            d(torch.ones(z)), d(torch.ones(z)), quant_block=128),
        "masked_agg_": lambda d: agg.masked_agg_(
            d(torch.zeros(z, n)), d(torch.ones(n, dtype=torch.bool)),
            d(torch.ones(z)), d(torch.ones(z))),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_dtensors(name):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_device_mesh
    call = _wrapper_calls()[name]
    call(lambda x: x)        # local tensors: the plain version runs
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = make_device_mesh(1, 1, "cpu")
        with pytest.raises(TypeError, match="local_map"):
            call(lambda x: distribute_tensor(x, mesh, [Replicate()] * 2))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry-run's collective bytes on a fake (2, 2) mesh
# ---------------------------------------------------------------------------

def hand_count(cfg, shape, m: int, d: int) -> int:
    """Result bytes a chip receives in gemma2 narrow's train step on a
    (d, m) mesh (f32; heads replicated, the MLP and the tied table sharded
    over model, the batch over data), derived from the layer shapes:

    * over model: an all-reduce of a (B/d, S, D) activation at the
      embedding and at each layer's MLP in the forward, again in the
      checkpointed periods' recompute, and in the backward at each MLP's
      input and at each head's input to the tied unembedding; for each
      head's vocab-parallel CE three of a (B/d, S) f32 value (the max, the
      sum of exponentials, the gold logit); the
      gradients of the norm scales whose output feeds a column-parallel
      matmul (each layer's mlp_norm, exit_norm and final_norm); one scalar
      (the clip's sum of squares over the sharded gradients);
    * over data: every parameter's local gradient (each rank's shard), and
      the loss."""
    b, s, dm, v, f = (shape.global_batch // d, shape.seq_len, cfg.d_model,
                      cfg.vocab_size, cfg.d_ff)
    n, heads = cfg.n_layers, 2
    act = b * s * dm * 4
    over_model = ((1 + 3 * n + heads) * act + heads * 3 * b * s * 4
                  + (n + 2) * dm * 4 + 4)
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    local = (v // m * dm                               # the table
             + n * 3 * dm * f // m                     # gate, up, down
             + n * (2 * dm * h * dh + 2 * dm * kh * dh)  # wq, wo, wk, wv
             + n * 2 * dm + 2 * dm)                    # the norms
    return over_model + local * 4 + 4


def hand_count_decode(cfg, shape, d: int) -> tuple:
    """``(all-reduces, result bytes)`` a chip takes part in during gemma2
    narrow's serve step on a (d, m) mesh (f32; the batch over data, the
    caches' rows (kv_seq), the MLP and the tied table over model), derived
    from the layer shapes: one of the (B/d, 1, D) embedding and one of
    each layer's (B/d, 1, D) MLP output; for each attention layer three
    for the merge of its kv_seq-sharded softmax: the MAX of the row maxima
    and the SUM of the exponentials, each a (B/d, Kh, G, 1, 1) value, and
    the SUM of the (B/d, 1, Kh, G, Dh) output.  ``wo`` is replicated
    (``attn_shard="replicate"``), so its product needs no all-reduce; the
    logits and the exit logits stay vocab-parallel."""
    b, dm, h = shape.global_batch // d, cfg.d_model, cfg.n_heads
    act = b * dm * 4
    merge = 2 * b * h * 4 + b * h * cfg.resolved_head_dim * 4
    n = cfg.n_layers
    return 1 + n + 3 * n, act + n * (act + merge)


def hand_count_moe_decode(cfg, shape, d: int) -> dict:
    """``{collective: (count, result bytes)}`` a chip takes part in during
    reduced qwen2-moe's serve step on a (d, m) mesh (f32; the batch over
    data, the heads, the experts and the tied table over model), derived
    from the layer shapes: an all-reduce of the (B/d, 1, D) embedding;
    for each layer an all-reduce of the attention's (B/d, 1, D) output
    (``wo`` is row-parallel); decode routes the whole batch as one group,
    each rank its own rows, so the MoE block gathers nothing: an
    all-reduce of every data rank's (1, E) f32 expert counts, one (d, 1,
    E) (the queue offsets), one of the aux losses' 2E + 1 sums over data,
    one of the (B/d, 1, D) combine (each rank's experts' terms) and one of
    the shared experts' (B/d, 1, D) output (their row-parallel ``down``,
    summed on each rank first)."""
    b, dm, n, e = shape.global_batch, cfg.d_model, cfg.n_layers, \
        cfg.moe.n_experts
    local = b // d * dm * 4
    moe = d * e * 4 + (2 * e + 1) * 4 + 2 * local
    return {"all-reduce": (1 + 5 * n, local + n * (local + moe))}


def hand_count_xlstm_decode(cfg, shape, d: int) -> tuple:
    """``(all-reduces, result bytes)`` a chip takes part in during reduced
    xlstm-1.3b's serve step on a (d, m) mesh (f32; the batch over data, the
    mixers' weights replicated, the cache's C, n and conv and the sLSTM's
    n over model, the tied table over model), derived from the layer
    shapes: one of the (B/d, 1, D) embedding; for each mLSTM layer three,
    the gathered (B/d, 1, Di) conv output, the (B/d, NH) denominator's
    partial sums and the gathered (B/d, NH, DH) cell output; for each
    sLSTM layer one, its gathered (B/d, NH, D / NH) cell output.  The
    logits and the exit logits stay vocab-parallel."""
    b, dm, nh = shape.global_batch // d, cfg.d_model, cfg.n_heads
    di = int(dm * cfg.mlstm_proj_factor)
    kinds = [spec.mixer for spec in cfg.pattern] * cfg.n_periods
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    mlstm = b * di * 4 + b * nh * 4 + b * di * 4
    return 1 + 3 * n_m + n_s, b * dm * 4 + n_m * mlstm + n_s * b * dm * 4


def hand_count_codebooks(cfg, shape, d: int) -> tuple:
    """``(all-reduces, result bytes)`` a chip takes part in during reduced
    musicgen-large's prefill (``shape.kind`` "prefill", the frontend's N
    rows then S - N frames) or serve step (one frame) on a (d, m) mesh whose model axis divides the codebooks (f32; the
    batch over data, heads, ffn and the codebook tables' vocabulary over
    model), derived from the layer shapes: one of the codebooks' stacked
    (B/d, S - N, NC, D) embedding rows; for each layer one of the (B/d, S,
    D) attention output (``wo`` row-parallel) and one of the MLP's
    (``down`` row-parallel); one of the (B/d, S, NC, V) logits (prefill's
    cover the frontend's rows too), the vocabulary gathered before each
    rank keeps its codebooks."""
    b, dm, n = shape.global_batch // d, cfg.d_model, cfg.n_layers
    nc, v = cfg.n_codebooks, cfg.vocab_size
    s = shape.seq_len if shape.kind == "prefill" else 1
    frames = s - cfg.frontend.n_tokens if shape.kind == "prefill" else 1
    return (2 + 2 * n, (b * frames * nc * dm + 2 * n * b * s * dm
                        + b * s * nc * v) * 4)


def hand_count_codebooks_train(cfg, shape, d: int, m: int) -> int:
    """Result bytes a chip receives in reduced musicgen-large's train step
    on a (d, m) mesh, its heads replicated (as gemma2 narrow's are: the
    sharded heads' backward collectives are DTensor's own), f32, the ffn
    and the codebook tables' vocabulary over model, the batch over data;
    derived from the layer shapes.  Over model: the stacked (B/d, S - N,
    NC, D) embedding rows; each layer's (B/d, S, D) MLP output in the
    forward and again in the checkpointed periods' recompute; in the
    backward the gradient at each block's output and at the embedding's
    (the exit head's ``Partial`` joins the stream's at its period), n + 1
    of (B/d, S, D); for each of the two heads its (B/d, S - N, NC, V)
    logits' vocabulary gathered, in the backward their gradient summed
    over the codebooks' ranks, and its CE sum over its codebooks (a
    scalar); the gradients of the norm scales before a column-parallel
    matmul or a head (the stacked mlp_norm, exit_norm, final_norm); the
    clip's scalar.  Over data: every parameter's local gradient, and the
    loss."""
    b, dm, n = shape.global_batch // d, cfg.d_model, cfg.n_layers
    nc, v, f = cfg.n_codebooks, cfg.vocab_size, cfg.d_ff
    s, frames = shape.seq_len, shape.seq_len - cfg.frontend.n_tokens
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    act = b * s * dm
    logits = b * frames * nc * v
    over_model = (b * frames * nc * dm + n * act + n * act + (n + 1) * act
                  + 2 * (2 * logits + 1) + (n + 2) * dm + 1)
    local = (nc * v // m * dm + cfg.frontend.d_in * dm
             + n * (4 * dm * h * dh + 2 * dm * f // m + 2 * dm) + 2 * dm)
    return (over_model + local) * 4 + 4


def test_dryrun_collective_bytes_on_a_fake_mesh_match_the_hand_count():
    """gemma2 narrow's train step and its serve step (batch 4, a ring of
    16 and a dense cache of 32 rows, each over model), reduced qwen2-moe's
    serve step (batch 4, heads over model), reduced xlstm-1.3b's serve
    step (batch 4), and reduced musicgen-large's prefill (4 frontend rows
    and 12 frames), serve step and train step (its heads replicated), on a
    fake (2, 2) mesh."""
    cfg = cases.tp_config(cases.TP_TRAIN)
    mesh = MeshShape((2, 2), ("data", "model"))
    shape = InputShape("train_narrow", 16, 4, "train")
    decode = InputShape("decode_narrow", 32, 4, "decode")
    assert not dist.is_initialized()
    rec = dryrun.lower_one(cfg.name, shape, cfg_override=cfg, mesh=mesh,
                           verbose=False)
    serve = dryrun.lower_one(cfg.name, decode, cfg_override=cfg, mesh=mesh,
                             verbose=False)
    moe_cfg = cases.tp_config(cases.TP_MOE)
    moe = dryrun.lower_one(moe_cfg.name, decode, cfg_override=moe_cfg,
                           mesh=mesh, verbose=False)
    assert not dist.is_initialized()
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["coll_bytes_per_chip"] == hand_count(cfg, shape, 2, 2)
    assert rec["t_collective"] > 0
    counts = rec["coll_breakdown"]["counts"]
    # the vocab-parallel CE: no logits gathered, all-reduces only
    assert counts["all-gather"] == 0 and counts["reduce-scatter"] == 0
    assert rec["notes"]["coll_bytes_per_chip"].startswith("the collectives")
    assert math.isclose(rec["t_collective"],
                        rec["coll_bytes_per_chip"] / 450e9)
    # the serve step: all-reduces only, none of them a gathered cache
    n_reduce, n_bytes = hand_count_decode(cfg, decode, 2)
    counts = serve["coll_breakdown"]["counts"]
    assert counts["all-reduce"] == n_reduce
    assert sum(counts.values()) == n_reduce
    assert serve["coll_bytes_per_chip"] == n_bytes
    assert serve["notes"]["coll_bytes_per_chip"].startswith(
        "the collectives")
    want = hand_count_moe_decode(moe_cfg, decode, 2)
    got = moe["coll_breakdown"]
    assert {k: v for k, v in got["counts"].items() if v} == \
        {k: n for k, (n, _) in want.items()}
    assert {k: got[k] for k in want} == {k: b for k, (_, b) in want.items()}
    assert moe["coll_bytes_per_chip"] == sum(b for _, b in want.values())
    prefill = InputShape("prefill_narrow", 16, 4, "prefill")
    x_cfg = cases.tp_config(cases.TP_XLSTM)
    m_cfg = cases.tp_config(cases.TP_MUSICGEN)
    t_cfg = m_cfg.with_overrides(attn_shard="replicate")
    for c, sh, want in (
            (x_cfg, decode, hand_count_xlstm_decode(x_cfg, decode, 2)),
            (m_cfg, prefill, hand_count_codebooks(m_cfg, prefill, 2)),
            (m_cfg, decode, hand_count_codebooks(m_cfg, decode, 2)),
            (t_cfg, shape, (None, hand_count_codebooks_train(
                t_cfg, shape, 2, 2)))):
        rec = dryrun.lower_one(c.name, sh, cfg_override=c, mesh=mesh,
                               verbose=False)
        counts = rec["coll_breakdown"]["counts"]
        # all-reduces only: none of them a gathered cache or table
        assert sum(counts.values()) == counts["all-reduce"]
        if want[0] is not None:
            assert counts["all-reduce"] == want[0], (c.name, sh.kind)
        assert rec["coll_bytes_per_chip"] == want[1], (c.name, sh.kind)

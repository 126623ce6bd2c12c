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
  decode steps' routing is bitwise equal over the ranks; the aux losses
  at (2, 2) equal the unsharded ones.  Every decode case's prefill logits
  and cache are held too.
* The refusals over a live model axis (xLSTM, codebooks, seq2d / dp2d /
  seq2d_fsdp, the compressed wire, SCAFFOLD, an xLSTM serve step), each
  ``NotImplementedError`` naming its ``ROADMAP.md`` item; the int8 wire's
  group check on a leaf whose shards straddle 128-element groups (an mlp
  leaf and an expert leaf); a cohort of kimi-k2's 2-D experts, whose
  specs name data twice.
* The vocab-parallel embedding with a tied unembedding and the
  vocab-parallel CE: loss and the table's gradient against the unsharded
  run of one f64 table.
* Every kernel wrapper refuses a DTensor.
* The dry-run's collective bytes on a fake (2, 2) mesh: gemma2 narrow's
  train and serve steps and reduced qwen2-moe's serve step against counts
  derived here from the layer shapes.
"""

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

from repro import configs as ref_configs  # noqa: E402
from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro_torch import interop, parity  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import comm, flatten  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
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


def ref_round(engine: str, arch: str = cases.TP_TRAIN):
    spec = {"flat f32": None, "flat int8": ref_aggregate.EngineSpec(
        wire=ref_comm.WireSpec("int8", 128))}[engine]
    data, simple = cases.tp_round_inputs(arch=arch)
    step = ref_steps.make_fed_round_step(
        ref_config(arch), NO_POLICY, local_steps=cases.TP_STEPS,
        engine=spec)
    cohort = jax.tree.map(lambda x: jnp.broadcast_to(
        x[None], (cases.TP_K,) + x.shape), ref_params(arch))
    return jax.jit(step)(cohort, jnp.asarray(data), jnp.asarray(simple))


def ref_train(arch: str):
    train = ref_steps.make_train_step(ref_config(arch), NO_POLICY)
    return jax.jit(train)(ref_params(arch), {
        "tokens": jnp.asarray(cases.tp_train_tokens(arch))})


def ref_decode(arch, batch, prompt, cache_len):
    """The reference's unsharded prefill then ``TP_DECODE_STEPS``
    teacher-forced serve steps with the exit head: each step's logits,
    exit logits and cache."""
    cfg = ref_config(arch)
    prompt_batch, forced = cases.tp_decode_inputs(arch, batch, prompt)
    logits, cache = jax.jit(ref_steps.make_prefill_step(
        cfg, NO_POLICY, cache_len=cache_len))(ref_params(arch), {
            k: jnp.asarray(v) for k, v in prompt_batch.items()})
    serve = jax.jit(ref_steps.make_serve_step(cfg, NO_POLICY,
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
    arch = cases.TP_MOE_ROUND if engine.startswith("moe") \
        else cases.TP_TRAIN
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


@pytest.mark.parametrize("what", ["logits", "exit", "cache"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_serve_step_matches_reference(tp_runs, case, what):
    """Each step's logits, exit logits or cache against the reference's
    unsharded decode; the logits come back vocab-parallel."""
    got = tp_runs[0][case[0]][0][cases.decode_key(*case[1:4])]
    want = tp_runs[1][("decode",) + case[2:]]
    assert len(got[what]) == len(want[what]) == cases.TP_DECODE_STEPS
    for g, w in zip(got[what], want[what]):
        if what == "cache":
            assert_leaves(g, w)
        else:
            assert tuple(g.shape) == tuple(w.shape)
            assert_close(g, w)
    assert all("Shard(dim=2)" in p for p in got["placements"])


@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_prefill_before_decode_matches_reference(tp_runs, case):
    """Each decode case's sharded prefill: its logits and its cache (as
    ``cache_specs`` places it) whole, against the reference's unsharded
    prefill of the same prompt."""
    got = tp_runs[0][case[0]][0][cases.decode_key(*case[1:4])]["prefill"]
    want = tp_runs[1][("decode",) + case[2:]]["prefill"]
    assert tuple(got["logits"].shape) == want["logits"].shape
    assert_close(got["logits"], want["logits"])
    assert_leaves(got["cache"], want["cache"])


@pytest.mark.parametrize("case", DECODE_CASES, ids=_decode_id)
def test_serve_step_writes_each_slot_on_its_owner_only(tp_runs, case):
    """At each step every rank changes exactly the new slot of each KV
    cache leaf where its rows hold it (a ring's slot ``pos % size``, a
    dense cache's ``pos``) and nothing elsewhere; where the rows are
    sharded (kv_seq) the owner changes over the steps (the ring's and the
    dense cache's slots cross the rank boundary)."""
    world, _, arch, _, prompt, cache_len = case
    ranks = [r[cases.decode_key(*case[1:4]) + " written"]
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


REFUSALS = {"xlstm": "item 12", "codebooks": "item 12",
            "seq2d": "item 15", "dp2d": "item 15", "seq2d_fsdp": "item 15",
            "compressed": "item 13", "scaffold": "item 14",
            "serve xlstm": "item 12"}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_out_of_scope_raises_naming_its_roadmap_item(tp_runs, name):
    msg = tp_runs[0][2][0]["refusals"][name]
    assert msg.startswith("NotImplementedError"), msg
    assert f"ROADMAP.md §1 {REFUSALS[name]}" in msg


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
    (``wo`` is row-parallel), an all-gather of the MoE block's (B, 1, D)
    input over data (decode routes the whole batch as one group), an
    all-reduce of the (1, B, D) combine (each rank's experts' terms) and
    one of the shared experts' (1, B, D) output (their row-parallel
    ``down``, summed on each rank first).  The router and the routing add
    none."""
    b, dm, n = shape.global_batch, cfg.d_model, cfg.n_layers
    local, whole = b // d * dm * 4, b * dm * 4
    return {"all-reduce": (1 + 3 * n, local + n * (local + 2 * whole)),
            "all-gather": (n, n * whole)}


def test_dryrun_collective_bytes_on_a_fake_mesh_match_the_hand_count():
    """gemma2 narrow's train step and its serve step (batch 4, a ring of
    16 and a dense cache of 32 rows, each over model), and reduced
    qwen2-moe's serve step (batch 4, heads over model), on a fake (2, 2)
    mesh."""
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

"""The MoE token splits over a live model axis, and decode's one routing
group over ranks: reduced qwen2-moe-a2.7b and kimi-k2-1t-a32b under
``seq2d``, ``dp2d`` and ``seq2d_fsdp``, against the JAX reference's
unsharded steps (``NO_POLICY``, each jitted once a config).

* One gloo spawn at world size 2 on a (1, 2) and a (2, 1) mesh and one at
  world size 4 on (1, 4) and (2, 2) meshes, started together
  (``tests/torch_split_moe_cases.moe_rank_main``, a ``FileStore`` each,
  joined within ``JOIN_S``), while the reference's steps run here.
  Reduced qwen2-moe under each mode at each of (1, 2), (1, 4), (2, 2):
  the train step (batch 4, 16 tokens: loss with its aux losses, and the
  parameters), the aux losses of a forward alone, the prefill (batch 4,
  16 prompt tokens) whose logits and cache are held to the reference's
  prefill, then 6 teacher-forced serve steps with the exit head, and
  under seq2d and dp2d the flat f32, flat int8 and tree rounds (K = 2,
  one simple).  Reduced kimi-k2 under seq2d and dp2d at (2, 2): train,
  aux, prefill and serve.  Every rank's ``full_tensor()``s bitwise equal;
  params, losses, logits and caches at rtol 1e-4 / atol 1e-5, the int8
  rounds under ``repro_torch.parity``'s lossy-wire rules.
* Capacity across the rank boundary: capacity factor 1.0 under seq2d at
  (1, 2) and (1, 4), where the last rank drops pairs that a routing of
  its own rows (its own capacity, no offsets) would keep -- asserted to
  exist in the data -- and the train step still matches the reference.
* Decode's one routing group over data without a token split, at (2, 2)
  (the experts over model) and at (2, 1) (a data-only mesh), and
  kimi-k2's 2-D experts gathered over data by all-reduces (its train step
  at (2, 1); its serve steps gather the batch's rows instead): the steps'
  collectives hold no all-gather.  Every token split's train, prefill and
  serve steps issue all-reduces only.  Each rank's routing of every serve
  step is the port's unsharded run's for its rows, less the queue
  offsets of the ranks before it.
* ``mlp._route`` on a group cut in pieces, each piece routed with the
  queue offsets of the pieces before it, composes the whole group's
  routing; with no pieces it is the routing without a group, bitwise.
* The dry-run per chip of a ``seq2d`` qwen2-moe prefill and train step
  on a fake (16, 16) and (2, 16, 16) mesh against a hand count: the
  offsets' all-reduce and the aux's reductions in each MoE layer; and of
  full-width kimi-k2's decode_32k on (16, 16): the batch's rows gathered,
  its 2-D experts kept split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.models import transformer as ref_tfm  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
import torch_split_cases as split  # noqa: E402
import torch_split_moe_cases as moe  # noqa: E402
from test_torch_split_hybrid_audio import _ref_round, _ref_train  # noqa: E402
from test_torch_tp import (_int8_round_close, assert_close,  # noqa: E402
                           assert_leaves, assert_rank_routing,
                           assert_ranks_equal, ref_config, ref_decode,
                           ref_params)
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import InputShape, LayerSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

JOIN_S = 240
WORLDS = (2, 4)
# (world size, mesh) of each spawn's token-split meshes
MESHES = tuple((world, mesh) for world, names in moe.MESHES.items()
               for mesh in names)


def _ref_aux(arch):
    tokens = split.train_batch(arch)["tokens"][:, :-1]
    return jax.jit(lambda p, t: ref_tfm.forward(p, ref_config(arch), t)[2])(
        ref_params(arch), jnp.asarray(tokens))


def references():
    """The reference's unsharded steps of each config, each compiled once
    and held against every mode and mesh (kimi-k2's 2-D variant is the
    same function as kimi-k2)."""
    out = {}
    for arch in (moe.MOE, moe.KIMI):
        out[("train", arch)] = _ref_train(arch)
        out[("aux", arch)] = _ref_aux(arch)
        out[("decode", arch)] = ref_decode(arch, split.B, split.PROMPT,
                                           split.CACHE_LEN)
    for wire in ("flat f32", "flat int8"):
        out[(wire, moe.MOE)] = _ref_round(moe.MOE, wire)
    out[("tree", moe.MOE)] = out[("flat f32", moe.MOE)]
    out[("train", moe.DROP)] = _ref_train(moe.DROP)
    for kind in ("train", "decode"):
        out[(kind, moe.KIMI_2D)] = out[(kind, moe.KIMI)]
    return out


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """Both spawns' results by world size (a list of ranks each), and the
    reference's, computed while the ranks run."""
    d = tmp_path_factory.mktemp("moe")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=moe.moe_rank_main, args=(
        r, world, str(d / f"store{world}"), str(d)))
        for world in WORLDS for r in range(world)]
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
    return {world: [torch.load(str(d / f"moe{world}_rank{r}.pt"))
                    for r in range(world)] for world in WORLDS}, refs


# each result's key -> (world size, arch of the reference, kind)
CASES = {}
for _world, _mesh in MESHES:
    for _mode in moe.SPLIT_MODES:
        for _kind in ("train", "aux", "decode") + (
                moe.ENGINES if _mode in moe.ROUND_MODES else ()):
            CASES[moe.key(_kind, _mesh, moe.MOE, _mode)] = (
                _world, moe.MOE, _kind)
    if _mesh in moe.DROP_MESHES:
        CASES[moe.key("train", _mesh, moe.DROP)] = (_world, moe.DROP,
                                                    "train")
for _mode in moe.KIMI_MODES:
    for _kind in ("train", "aux", "decode"):
        CASES[moe.key(_kind, "(2, 2)", moe.KIMI, _mode)] = (4, moe.KIMI,
                                                           _kind)
for _world, _mesh in ((2, "(2, 1)"), (4, "(2, 2)")):
    for _arch in moe.GROUP_ARCHS:
        CASES[moe.key("decode", _mesh, _arch)] = (_world, _arch, "decode")
CASES[moe.key("train", "(2, 1)", moe.KIMI_2D)] = (2, moe.KIMI_2D, "train")


def _got(runs, key):
    return runs[0][CASES[key][0]][0][key]


def _want(runs, key):
    _, arch, kind = CASES[key]
    return runs[1][(kind, arch)]


@pytest.mark.parametrize("key", list(CASES))
def test_ranks_hold_bitwise_equal_full_tensors(moe_runs, key):
    assert_ranks_equal(moe_runs[0][CASES[key][0]], key)


@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[2] == "train"])
def test_train_step_matches_reference(moe_runs, key):
    """The train step on each rank's tokens (seq2d, seq2d_fsdp: a rank's
    rows of each sequence, routed with the queue offsets of the ranks
    before it and the whole sequence's capacity; dp2d: whole sequences),
    its loss with the aux losses of every MoE layer and its parameters;
    kimi-k2's 2-D experts at (2, 1) gathered over data by all-reduces."""
    got = _got(moe_runs, key)
    want_p, want_m = _want(moe_runs, key)
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[2] == "aux"])
def test_aux_losses_match_reference(moe_runs, key):
    """``load_balance`` (a product of two whole-batch means, each reduced
    before the product) and ``router_z`` of a split forward."""
    got = _got(moe_runs, key)
    want = _want(moe_runs, key)
    assert set(got) == {"load_balance", "router_z"}
    for name in got:
        assert_close(got[name], want[name])


@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[2] in moe.ENGINES])
def test_round_step_matches_reference(moe_runs, key):
    """The round (K = 2, one simple) under seq2d and dp2d on the flat f32,
    flat int8 and tree engines, against the reference's unsharded round
    (its flat f32 round for the tree engine), the int8 round under the
    lossy-wire rules."""
    got = _got(moe_runs, key)
    want_c, want_loss = _want(moe_runs, key)
    assert_close(got["loss"], want_loss)
    if CASES[key][2] == "flat int8":
        _int8_round_close(got, want_c, moe.MOE)
    else:
        assert_leaves(got["params"], want_c)


@pytest.mark.parametrize("what", ["prefill", "logits", "exit", "cache"])
@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[2] == "decode"])
def test_prefill_and_serve_match_reference(moe_runs, key, what):
    """Prefill on each rank's rows or sequences, its logits and cache held
    to the reference's prefill; then the serve steps, decode's one routing
    group (the whole batch) split over the ranks that shard the batch,
    each routing its rows with the queue offsets of the ranks before it:
    each step's logits, exit logits and cache."""
    got = _got(moe_runs, key)
    want = _want(moe_runs, key)
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


@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[2] == "decode"])
def test_decode_routing_is_the_unsharded_routing_of_each_ranks_rows(
        moe_runs, key):
    """Every serve step's routing on each rank against the port's
    unsharded run: the rank's rows of decode's one group, routed with the
    queue offsets of the ranks before it where the batch is sharded, or
    the whole group where the batch's rows are gathered (kimi-k2's 2-D
    experts over a data dim that shards the batch)."""
    for rank in moe_runs[0][CASES[key][0]]:
        routing = rank["routing " + key]
        assert_rank_routing(routing["routing"],
                            routing["unsharded routing"])


COLLECTIVES = {k.replace(v[2], v[2] + " collectives", 1): v[0]
               for k, v in CASES.items() if v[2] in ("train", "decode")
               and v[1] != moe.DROP}


@pytest.mark.parametrize("key", list(COLLECTIVES))
def test_steps_issue_all_reduces_only(moe_runs, key):
    """Every collective of the train step (forward and backward) and of
    the prefill and serve steps is an all-reduce: the queue offsets, the
    aux sums, k and v along the sequence, decode's group over data (and
    data x model under dp2d) and kimi-k2's 2-D experts over data; no
    all-gather."""
    ranks = moe_runs[0][COLLECTIVES[key]]
    for rank in ranks:
        assert rank[key] and set(rank[key]) <= {"all_reduce"}, rank[key]


def test_last_rank_drops_pairs_its_own_routing_would_keep(moe_runs):
    """At capacity factor 1.0 the last rank of a seq2d split drops pairs
    that a routing of its own rows alone would keep (the pairs of the
    ranks before it fill its experts' queues first), so the train step's
    match with the reference holds only where the offsets count them."""
    dropped = {}
    for world, mesh in MESHES:
        if mesh not in moe.DROP_MESHES:
            continue
        last = moe_runs[0][world][-1][moe.key("drops", mesh, moe.DROP)]
        assert len(last) == 2 * configs.get_reduced(moe.MOE).n_layers
        dropped[mesh] = sum(d for d, _ in last)
    assert all(n > 0 for n in dropped.values()), dropped


# ---------------------------------------------------------------------------
# the routing of a group cut in pieces, on the CPU
# ---------------------------------------------------------------------------

def _moe_cfg(capacity_factor, n_experts=4, top_k=2):
    return dataclasses.replace(configs.get_reduced(moe.MOE).moe,
                               n_experts=n_experts, top_k=top_k,
                               capacity_factor=capacity_factor)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25, 4.0])
@pytest.mark.parametrize("pieces", [2, 4])
def test_route_in_pieces_with_offsets_composes_the_whole(
        monkeypatch, capacity_factor, pieces):
    """Each piece of a group (2, 32 tokens, 6 experts, top 2) routed with
    the whole group's capacity and the counts of the pieces before it as
    its offsets keeps exactly the whole routing's pairs, each at its
    local place (whole slot - offset), in ``min(C, S_piece)`` slots; its
    gates are the whole routing's."""
    m = _moe_cfg(capacity_factor, n_experts=6)
    rng = np.random.default_rng(3)
    logits = torch.as_tensor(rng.standard_normal((2, 32, 6)).astype(
        np.float32))
    cap = mlp._capacity(m, 32)
    whole = mlp._route(logits, m, cap)
    n = 32 // pieces
    before = torch.zeros((2, 6), dtype=torch.long)
    monkeypatch.setattr(mlp, "_queue_offsets", lambda counts, group: before)
    for q in range(pieces):
        group = mlp.RoutingGroup(None, (0,), 32)
        part = mlp._route(logits[:, q * n:(q + 1) * n], m, cap, 0, group)
        slots = min(cap, n)
        assert part.slot_idx.shape == (2, 6, slots)
        experts = whole.token_expert[:, q * n:(q + 1) * n]
        assert torch.equal(part.token_expert, experts)
        w_slot = whole.token_slot[:, q * n:(q + 1) * n]
        kept = w_slot < 6 * cap
        assert torch.equal(part.token_slot < 6 * slots, kept)
        offset = torch.gather(before, 1, experts.reshape(2, -1)).reshape(
            experts.shape)
        assert torch.equal((part.token_slot % slots + offset)[kept],
                           (w_slot % cap)[kept])
        # the kept pairs' gates, at their slots
        b_i, e_i, c_i = torch.nonzero(part.slot_gate > 0, as_tuple=True)
        w_c = c_i + before[b_i, e_i]
        assert torch.equal(whole.slot_idx[b_i, e_i, w_c],
                           part.slot_idx[b_i, e_i, c_i] + q * n)
        assert torch.equal(whole.slot_gate[b_i, e_i, w_c],
                           part.slot_gate[b_i, e_i, c_i])
        before = before + torch.zeros((2, 6), dtype=torch.long).scatter_add_(
            1, experts.reshape(2, -1), torch.ones((2, n * 2),
                                                  dtype=torch.long))


def test_route_without_pieces_is_the_routing_without_a_group():
    """A group held whole on the rank (no dims that split it) routes
    bitwise as no group: the same capacity, slots, gates and
    probabilities."""
    m = _moe_cfg(1.0)
    logits = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (3, 16, 4)).astype(np.float32))
    cap = mlp._capacity(m, 16)
    plain = mlp._route(logits, m, cap, 6)
    grouped = mlp._route(logits, m, cap, 6, mlp.RoutingGroup(None, (), 16))
    assert len(plain) == len(grouped) == 5
    for a, b in zip(plain, grouped):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dry-run per chip of a seq2d qwen2-moe prefill and train step
# ---------------------------------------------------------------------------

def _seq2d_moe():
    return configs.get_reduced(moe.MOE).with_overrides(
        attn_shard="seq2d", compute_dtype="float32")


def _dense_twin(cfg):
    """``cfg`` with a dense MLP of ``d_expert`` columns in place of each
    MoE block: its leaves the MoE block's shared expert's."""
    return cfg.with_overrides(
        pattern=tuple(LayerSpec(s.mixer, "dense") for s in cfg.pattern),
        d_ff=cfg.moe.d_expert, arch_type="dense")


def _token_dims(mesh: MeshShape) -> int:
    return len(mesh.axis_names)


def hand_count_moe_seq2d_prefill(cfg, shape, mesh: MeshShape) -> tuple:
    """``(all-reduces, result bytes)`` a chip takes part in during reduced
    qwen2-moe's prefill under seq2d (f32, weights replicated, the tied
    table over model, the batch over the data axes, the sequence over
    model), derived from the layer shapes, with b = B / data, s = S, r the
    model axis, E the experts:

    * one of the vocab-parallel embedding's (b, s, D) rows;
    * each layer's attention: k and v gathered along the sequence, two of
      (b, s, Kh, Dh);
    * each MoE layer: the queue offsets, every rank's (b, E) f32 counts
      gathered over model, one (r, b, E); the aux losses' 2E + 1 sums,
      reduced over each mesh dim that splits the tokens in turn (data and
      model; pod too);
    * the final head: the sequence gathered, one of (b, s, D)."""
    data = 1
    for a in ("pod", "data"):
        data *= mesh.shape.get(a, 1)
    r = mesh.shape["model"]
    b, s, d = shape.global_batch // data, shape.seq_len, cfg.d_model
    kh, dh, e = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.moe.n_experts
    n, t = cfg.n_layers, _token_dims(mesh)
    count = 1 + n * (2 + 1 + t) + 1
    nbytes = 4 * (2 * b * s * d + n * (2 * b * s * kh * dh + r * b * e
                                       + t * (2 * e + 1)))
    return count, nbytes


def hand_count_moe_seq2d_train_extra(cfg, shape, mesh: MeshShape) -> tuple:
    """``(all-reduces, result bytes)`` that reduced qwen2-moe's train step
    under seq2d takes part in beyond the same step with a dense MLP of
    ``d_expert`` columns in each block (:func:`_dense_twin`: the MoE
    block's shared expert): in each MoE layer the queue offsets' all-reduce
    and the aux sums' reductions, in the forward and again in the
    checkpointed period's recompute (the offsets carry no gradient, and
    the aux sums' backward is the identity); and the router's and the
    three expert leaves' gradients, each ``Partial`` over every mesh dim
    that splits the tokens, reduced over each in turn."""
    data = 1
    for a in ("pod", "data"):
        data *= mesh.shape.get(a, 1)
    r = mesh.shape["model"]
    b, d = shape.global_batch // data, cfg.d_model
    e, de = cfg.moe.n_experts, cfg.moe.d_expert
    n, t = cfg.n_layers, _token_dims(mesh)
    leaves = n * (d * e + 3 * e * d * de)
    count = 2 * n * (1 + t) + 4 * t
    nbytes = 4 * (2 * n * (r * b * e + t * (2 * e + 1)) + t * leaves)
    return count, nbytes


def _walk(cfg, shape, mesh):
    assert not dist.is_initialized()
    rec = dryrun.lower_one(cfg.name, shape, cfg_override=cfg, mesh=mesh,
                           verbose=False)
    assert not dist.is_initialized()
    counts = rec["coll_breakdown"]["counts"]
    assert sum(counts.values()) == counts["all-reduce"]
    return counts["all-reduce"], rec["coll_bytes_per_chip"]


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
def test_dryrun_seq2d_moe_prefill_all_reduces_match_the_hand_count(mesh):
    """Reduced qwen2-moe under seq2d, prefill of 64 positions (4 rows a
    chip) on a fake (16, 16) mesh and a fake (2, 16, 16) one: rank 0's
    walk (``walks_per_chip``: the lifted config walks per chip), all-
    reduces only, counted and sized by hand."""
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data",
                                                      "model")
    shape = MeshShape(mesh, names)
    cfg = _seq2d_moe()
    prefill = InputShape("prefill_seq2d", 64, shape.size // 16, "prefill")
    assert dryrun.walks_per_chip(cfg, prefill, shape)
    assert _walk(cfg, prefill, shape) == hand_count_moe_seq2d_prefill(
        cfg, prefill, shape)


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
def test_dryrun_seq2d_moe_train_all_reduces_match_the_hand_count(mesh):
    """The same config's train step (64 tokens a sequence): its all-
    reduces beyond its dense twin's walk, counted and sized by hand."""
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data",
                                                      "model")
    shape = MeshShape(mesh, names)
    cfg = _seq2d_moe()
    train = InputShape("train_seq2d", 64, shape.size // 16, "train")
    assert dryrun.walks_per_chip(cfg, train, shape)
    n, nbytes = _walk(cfg, train, shape)
    n0, nbytes0 = _walk(_dense_twin(cfg), train, shape)
    assert (n - n0, nbytes - nbytes0) == hand_count_moe_seq2d_train_extra(
        cfg, train, shape)


# ---------------------------------------------------------------------------
# the dry-run per chip of kimi-k2's decode: its 2-D experts stay split
# ---------------------------------------------------------------------------

def hand_count_moe_decode_extra(cfg, shape, mesh: MeshShape) -> tuple:
    """``(all-reduces, result bytes)`` that a serve step of ``cfg`` (its
    experts over model, ``expert_ffn`` over data: kimi-k2's 2-D layout)
    takes part in beyond the same step with a dense MLP of ``d_expert``
    columns in each block (:func:`_dense_twin`), with B the global batch
    over data, D the width and E the experts, in each MoE layer: decode's
    one routing group gathered over data, B rows of ``x`` (compute dtype)
    and of the f32 router logits (two all-reduces); the ``expert_ffn``
    slices' sum reduced over data, B rows; the experts' sum reduced over
    model, a rank's B / data rows; the aux losses' 2E + 1 sums over data.
    The experts are never gathered."""
    import torch
    data = mesh.shape["data"]
    b, d, e = shape.global_batch, cfg.d_model, cfg.moe.n_experts
    size = torch.empty((), dtype=cfg.torch_compute_dtype()).element_size()
    n = sum(1 for s in cfg.pattern if s.mlp == "moe") * (
        cfg.n_layers // len(cfg.pattern))
    per_layer = size * (2 * b * d + b // data * d) + 4 * (b * e + 2 * e + 1)
    return 5 * n, n * per_layer


def _walk_counts(cfg, shape, mesh):
    rec = dryrun.lower_one(cfg.name, shape, cfg_override=cfg, mesh=mesh,
                           verbose=False)
    counts = rec["coll_breakdown"]["counts"]
    return ({k: v for k, v in counts.items() if v},
            rec["coll_breakdown"]["all-reduce"])


def test_dryrun_kimi_decode_keeps_its_2d_experts_split():
    """Full-width kimi-k2 at decode_32k (batch 128, 8 rows a data rank) on
    a fake (16, 16) mesh: its serve step's collectives beyond its dense
    twin's are all-reduces of the batch's rows, counted and sized by hand
    (about 4 MB a layer), not a gather of the experts (1.29e11 bytes a
    step when each data rank routed its own rows)."""
    from repro_torch.configs.base import DECODE_32K
    mesh = MeshShape((16, 16), ("data", "model"))
    cfg = configs.get_config(moe.KIMI)
    counts, nbytes = _walk_counts(cfg, DECODE_32K, mesh)
    counts0, nbytes0 = _walk_counts(_dense_twin(cfg), DECODE_32K, mesh)
    assert set(counts) == set(counts0) <= {"all-reduce", "all-gather"}
    assert counts.get("all-gather") == counts0.get("all-gather")
    assert (counts["all-reduce"] - counts0["all-reduce"],
            nbytes - nbytes0) == hand_count_moe_decode_extra(
                cfg, DECODE_32K, mesh)

"""The token splits of the hybrid, audio and ssm configs over a live model
axis, and K6's carry: reduced recurrentgemma-2b (RG-LRU and local
attention), reduced musicgen-large (codebooks and conditioning rows) and
reduced xlstm-1.3b (an mLSTM and an sLSTM layer, ``mlstm_chunk`` 4 on both
sides, the sLSTM output kept in f32 on both sides) under ``seq2d``,
``dp2d`` and ``seq2d_fsdp``, against the JAX reference's unsharded steps
(``NO_POLICY``, each jitted once a config).

* One gloo spawn at world size 2 on a (1, 2) mesh and one at world size 4
  on (1, 4) and (2, 2) meshes, started together
  (``tests/torch_split_cases.split_rank_main``, a ``FileStore`` each,
  joined within 120 s), while the reference's steps run here: each config
  under each mode at each mesh, the train step (batch 4, 16 tokens), the
  prefill (batch 4, 16 prompt tokens, musicgen's 4 conditioning rows
  before them) whose logits and cache are held to the reference's prefill
  without the split flags, then 6 teacher-forced serve steps with the exit
  head (the ring of 16 wraps), and under seq2d and dp2d the flat f32,
  flat int8 and tree rounds (K = 2, one simple).  Every rank's
  ``full_tensor()``s bitwise equal; params, losses, logits and caches at
  rtol 1e-4 / atol 1e-5, the int8 rounds under ``repro_torch.parity``'s
  lossy-wire rules.  The steps issue all-reduces only.  The MoE and
  xLSTM configs' policies split the tokens (the MoE configs' run in
  ``tests/test_torch_split_moe.py``).
* K6's carry on the CPU: the gated entry's plain version run in two
  halves, the second from the first's ``y_last``, is bitwise the whole
  run in bf16 and f32 (and from the first half's last bf16 row it is
  not); ``rglru.linear_scan`` over 2 and 4 row blocks composed from each
  block's ``(A_last, L_last)`` against the whole scan, values and
  gradients; the wrapper's ``y_last`` validation.
* The xLSTM chains on the CPU: ``xlstm.apply_mlstm`` and
  ``apply_slstm`` on 2 and 4 row blocks of a split sequence, the ranks run
  one after another with the all-reduces summed in turn
  (:class:`_RanksInTurn`), against the whole run: values bitwise (the
  shapes' pieces hold whole CPU vectors), the last block's cache the
  whole run's, and under training the gradients of every block's rows and
  of the weights; a split that cuts an ``mlstm_chunk`` chunk runs in
  shorter chunks, at rtol 1e-4 / atol 1e-5; rows too few for the conv's
  halo raise.
* The dry-run per chip of a ``seq2d`` recurrentgemma and xlstm prefill on
  a fake (16, 16) and (2, 16, 16) mesh against a hand count of its
  all-reduces: the halo's and the carry's in each RG-LRU layer, the
  halo's and the (C, n, m) hops in each mLSTM layer, the (c, n, h, m)
  hops in each sLSTM layer among them.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
import torch_split_cases as split  # noqa: E402
from test_torch_tp import (_FlatCodebooks, _int8_round_close,  # noqa: E402
                           assert_close, assert_leaves, assert_ranks_equal,
                           ref_config, ref_decode, ref_params)
from test_torch_xlstm_model import f32_slstm_out  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as scan_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import common, rglru, xlstm  # noqa: E402

JOIN_S = 120
RTOL, ATOL = 1e-4, 1e-5
# (world size, mesh) of each spawn's meshes
MESHES = tuple((world, mesh) for world, names in split.SPLIT_MESHES.items()
               for mesh in names)


def _ref_train(arch):
    train = ref_steps.make_train_step(ref_config(arch), NO_POLICY)
    return jax.jit(train)(ref_params(arch), {
        k: jnp.asarray(v) for k, v in split.train_batch(arch).items()})


def _ref_round(arch, wire):
    """The reference's unsharded round on ``split.round_inputs``; a
    codebook config's tokens folded as ``_FlatCodebooks`` takes them."""
    spec = None if wire == "flat f32" else ref_aggregate.EngineSpec(
        wire=ref_comm.WireSpec("int8", 128))
    cfg = ref_config(arch)
    data, simple = split.round_inputs(arch)
    saved = ref_steps.LMAdapter
    if cfg.n_codebooks > 1:
        ref_steps.LMAdapter = _FlatCodebooks
        data = data.reshape(data.shape[:3] + (-1,))
    try:
        step = ref_steps.make_fed_round_step(cfg, NO_POLICY, local_steps=1,
                                             engine=spec)
    finally:
        ref_steps.LMAdapter = saved
    cohort = jax.tree.map(lambda x: jnp.broadcast_to(
        x[None], (split.K,) + x.shape), ref_params(arch))
    return jax.jit(step)(cohort, jnp.asarray(data), jnp.asarray(simple))


def references():
    """The reference's unsharded steps of each config, each compiled once
    and held against every mode and mesh."""
    out = {}
    for arch in split.SPLIT_ARCHS:
        # xlstm's sLSTM output in f32 on both sides (the ranks run under
        # cases.f32_slstm_out), its mlstm_chunk the splits' 4
        ref = split.REF_ARCH.get(arch, arch)
        with (f32_slstm_out() if arch == "xlstm-1.3b"
              else contextlib.nullcontext()):
            out[("train", arch)] = _ref_train(ref)
            for wire in ("flat f32", "flat int8"):
                out[(wire, arch)] = _ref_round(ref, wire)
            out[("decode", arch)] = ref_decode(ref, split.B, split.PROMPT,
                                               split.CACHE_LEN)
        out[("tree", arch)] = out[("flat f32", arch)]
    return out


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """Both spawns' results by world size (a list of ranks each), and the
    reference's, computed while the ranks run."""
    d = tmp_path_factory.mktemp("split")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=split.split_rank_main, args=(
        r, world, str(d / f"store{world}"), str(d)))
        for world in (2, 4) for r in range(world)]
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
    return {world: [torch.load(str(d / f"split{world}_rank{r}.pt"))
                    for r in range(world)] for world in (2, 4)}, refs


# each case's key -> (world size, mesh, arch, mode, kind)
CASES = {split.split_key(kind, mesh, arch, mode):
         (world, mesh, arch, mode, kind)
         for world, mesh in MESHES for arch in split.SPLIT_ARCHS
         for mode in split.SPLIT_MODES
         for kind in ("train", "decode") + (
             split.ENGINES if mode in split.ROUND_MODES else ())}


def _got(runs, key):
    return runs[0][CASES[key][0]][0][key]


@pytest.mark.parametrize("key", list(CASES))
def test_ranks_hold_bitwise_equal_full_tensors(split_runs, key):
    assert_ranks_equal(split_runs[0][CASES[key][0]], key)


@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[4] == "train"])
def test_train_step_matches_reference(split_runs, key):
    """The train step on each rank's tokens: recurrentgemma's RG-LRU
    layers with the conv's halo and the composed carry (seq2d,
    seq2d_fsdp) or on whole sequences (dp2d), musicgen's codebook
    embedding (vocab-sharded tables under seq2d, replicated under dp2d)
    with its conditioning rows prepended before the split, the codebook
    heads and CE after the sequence is gathered."""
    arch = CASES[key][2]
    got = _got(split_runs, key)
    want_p, want_m = split_runs[1][("train", arch)]
    assert_close(got["loss"], want_m["loss"])
    assert_leaves(got["params"], want_p)


@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[4] in split.ENGINES])
def test_round_step_matches_reference(split_runs, key):
    """The round (K = 2, one simple) under seq2d and dp2d on the flat f32,
    flat int8 and tree engines, each client under the model group's
    policy: against the reference's unsharded round (its flat f32 round
    for the tree engine), the int8 round under the lossy-wire rules."""
    _, _, arch, mode, engine = CASES[key]
    got = _got(split_runs, key)
    want_c, want_loss = split_runs[1][(engine, arch)]
    assert_close(got["loss"], want_loss)
    if engine == "flat int8":
        _int8_round_close(got, want_c, split.split_arch(arch, mode))
    else:
        assert_leaves(got["params"], want_c)


@pytest.mark.parametrize("what", ["prefill", "logits", "exit", "cache"])
@pytest.mark.parametrize("key", [k for k, v in CASES.items()
                                 if v[4] == "decode"])
def test_prefill_and_serve_match_reference(split_runs, key, what):
    """Prefill on each rank's rows (K6's gated entry chained from the
    previous rank's ``y_last``, the halo gathered; K5 on the rank's query
    rows) or sequences (dp2d), its cache -- the RG-LRU's state and conv
    rows, the ring and the global caches -- held to the reference's
    prefill without the split flags; then the serve steps on the cache
    ``cache_specs`` places (the RG-LRU state over its channels, the ring
    over kv_seq), each step's logits, exit logits and cache."""
    arch = CASES[key][2]
    got = _got(split_runs, key)
    want = split_runs[1][("decode", arch)]
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


COLLECTIVES = {split.split_key(f"{kind} collectives", mesh, arch, mode):
               world for world, mesh in MESHES
               for arch in split.SPLIT_ARCHS for mode in split.SPLIT_MODES
               for kind in ("train", "decode")}


@pytest.mark.parametrize("key", list(COLLECTIVES))
def test_steps_issue_all_reduces_only(split_runs, key):
    """Every collective of the train step (forward and backward) and of
    the prefill and serve steps is an all-reduce: the halo, the carry's
    hops and the composed carry's gather included."""
    for rank in split_runs[0][COLLECTIVES[key]]:
        assert set(rank[key]) <= {"all_reduce"}, rank[key]


@pytest.mark.parametrize("name", [f"{mode} {arch}"
                                  for arch in ("qwen2-moe-a2.7b",
                                               "xlstm-1.3b")
                                  for mode in split.SPLIT_MODES])
def test_moe_and_ssm_token_splits_are_live(split_runs, name):
    """The MoE and xLSTM configs' token splits, which once raised, are
    live: their policy splits the tokens (``tests/test_torch_split_moe.
    py`` runs the MoE configs', the cases above the xLSTM configs')."""
    msg = split_runs[0][2][0]["refusals"][name]
    assert msg == "True", msg


# ---------------------------------------------------------------------------
# K6's carry on the CPU
# ---------------------------------------------------------------------------

def _gate_args(dtype, b=2, s=48, d=32, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((b, s, d)).astype(np.float32)
                        ).to(dtype)
    vecs = [torch.as_tensor(rng.standard_normal(d).astype(np.float32))
            for _ in range(4)]
    u = 0.9 + 0.099 * rng.random(d).astype(np.float32)
    lam = torch.log(torch.expm1(-torch.log(torch.as_tensor(u)) / 8.0))
    c = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam))
    return x, vecs + [c]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cut", [1, 17, 47])
def test_gated_entry_in_two_halves_from_y_last_is_bitwise_whole(dtype, cut):
    """The second half from the first half's ``y_last`` equals the whole
    run's rows bitwise, and its ``y_last`` the whole run's; the wrapper
    and the plain version agree, and ``y_last`` changes no row of y."""
    x, vecs = _gate_args(getattr(torch, dtype))
    b, s, d = x.shape
    last = torch.empty((b, d))
    whole = scan_ops.lru_scan_gated(x, *vecs, None, last)
    assert torch.equal(whole, scan_ops.lru_scan_gated(x, *vecs))
    want_last = torch.empty((b, d))
    assert torch.equal(whole, scan_ref.lru_scan_gated_ref(x, *vecs, None,
                                                          want_last))
    assert torch.equal(last, want_last)
    first_last, second_last = torch.empty((b, d)), torch.empty((b, d))
    first = scan_ops.lru_scan_gated(x[:, :cut].contiguous(), *vecs, None,
                                    first_last)
    second = scan_ops.lru_scan_gated(x[:, cut:].contiguous(), *vecs,
                                     first_last, second_last)
    assert torch.equal(first, whole[:, :cut])
    assert torch.equal(second, whole[:, cut:])
    assert torch.equal(second_last, last)


def test_gated_entry_from_the_last_bf16_row_is_not_the_whole_run():
    """In bf16 a run's last output row is its state rounded to bf16: the
    second half run from it (in place of ``y_last``) leaves the whole
    run's rows."""
    x, vecs = _gate_args(torch.bfloat16)
    whole = scan_ops.lru_scan_gated(x, *vecs)
    first = scan_ops.lru_scan_gated(x[:, :17].contiguous(), *vecs)
    second = scan_ops.lru_scan_gated(x[:, 17:].contiguous(), *vecs,
                                     first[:, -1].float().contiguous())
    assert not torch.equal(second, whole[:, 17:])


def test_y_last_is_the_f32_state_before_the_cast():
    """``y_last`` is the f32 scan's last row: rounded to bf16 it is the
    last output row, and it is not itself that row."""
    x, vecs = _gate_args(torch.bfloat16)
    last = torch.empty((x.shape[0], x.shape[2]))
    y = scan_ops.lru_scan_gated(x, *vecs, None, last)
    assert torch.equal(last.to(torch.bfloat16), y[:, -1])
    assert not torch.equal(last, y[:, -1].float())


def test_wrapper_validates_y_last_like_y0():
    x, vecs = _gate_args(torch.float32, b=2, s=4, d=8)
    with pytest.raises(ValueError, match="y_last"):
        scan_ops.lru_scan_gated(x, *vecs, None, torch.empty((2, 7)))
    with pytest.raises(ValueError, match="y_last"):
        scan_ops.lru_scan_gated(x, *vecs, None,
                                torch.empty((2, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.lru_scan_gated(x, *vecs, None, torch.empty((8, 2)).t())
    with pytest.raises(ValueError, match="device"):
        scan_ops.lru_scan_gated(x, *vecs, None,
                                torch.empty((2, 8), device="meta"))
    before = (scan_ops.lru_scan_gated.launches,
              scan_ops.lru_scan_gated.launches_carry)
    scan_ops.lru_scan_gated(x, *vecs, None, torch.empty((2, 8)))
    # the CPU runs the plain version: no launch counted
    assert (scan_ops.lru_scan_gated.launches,
            scan_ops.lru_scan_gated.launches_carry) == before


@pytest.mark.parametrize("blocks", [2, 4])
def test_linear_scan_composed_over_row_blocks_matches_the_whole(blocks):
    """Each block scanned from 0 with its cumulative ``a``, the incoming
    state composed from the blocks before (``y = L + A y_in``, as a
    rank's rows compose it): the whole scan's values and its gradients
    with respect to a and b, at f32 rounding."""
    rng = np.random.default_rng(5)
    a0 = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 32, 6)).astype(
        np.float32)).requires_grad_(True)
    b0 = torch.as_tensor(rng.standard_normal((2, 32, 6)).astype(
        np.float32)).requires_grad_(True)
    w = torch.as_tensor(rng.standard_normal((2, 32, 6)).astype(np.float32))
    whole = rglru.linear_scan(a0, b0)
    want = torch.autograd.grad((whole * w).sum(), (a0, b0))
    n = 32 // blocks
    parts, y_in = [], None
    for q in range(blocks):
        y, cum = rglru.linear_scan(a0[:, q * n:(q + 1) * n],
                                   b0[:, q * n:(q + 1) * n], with_a=True)
        if y_in is not None:
            y = y + cum * y_in[:, None]
        parts.append(y)
        y_in = y[:, -1]
    got = torch.cat(parts, dim=1)
    grads = torch.autograd.grad((got * w).sum(), (a0, b0))
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    for g, h in zip(grads, want):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-5)


def test_tails_and_halo_of_a_rank():
    """Without a split dim the tails are the rank's last tw - 1 rows; the
    first rank's halo is zeros (``None``), rank q's rank q - 1's tail."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    tails = torch.cat([x[:, 5:], x[:, 5:] + 100.0], dim=1)
    assert common.split_halo(tails, 0, 4) is None
    assert torch.equal(common.split_halo(tails, 1, 4), x[:, 5:])
    assert torch.equal(common.split_halo(tails, 2, 4), x[:, 5:] + 100.0)


# ---------------------------------------------------------------------------
# the xLSTM chains on the CPU
# ---------------------------------------------------------------------------

class _RanksInTurn:
    """``common.all_reduce`` for ranks run one after another in one
    process: the k-th call of a rank adds its tensor to the k-th sum and
    returns the sum so far.  Every rank issues the same calls in one
    order, and the split's sums hold one nonzero term an element (a hop's
    owner, a tail's rank), so a rank reads exactly what the ranks before it
    handed on: run the forwards in rank order, then the backwards in
    reverse (a carry's gradient comes from the rank after its owner)."""

    class Mesh:
        def __init__(self, r):
            self.r = r

        def size(self, i):
            return self.r

    def __init__(self, r):
        self.mesh, self.sums, self.k = self.Mesh(r), [], 0

    def phase(self):
        """A new round of calls: the backward's, after the forward's."""
        self.sums = []

    def rank(self):
        self.k = 0

    def __call__(self, x, op, mesh, dims):
        assert op == "sum" and list(dims) == [0]
        if self.k == len(self.sums):
            self.sums.append(torch.zeros_like(x))
        self.sums[self.k] = self.sums[self.k] + x
        self.k += 1
        return self.sums[self.k - 1].clone()


# 4 heads, d_model 128 (the mLSTM's Dh 64, the sLSTM's 32), batch 4,
# mlstm_chunk 4, 16 positions: every piece of a 2- or 4-row-block split
# holds whole CPU vectors (the gates' (B, n, NH) 64 or more elements)
CHAIN_B, CHAIN_S = 4, 16


def _chain_config():
    return configs.get_reduced("xlstm-1.3b").with_overrides(
        d_model=128, n_heads=4, n_kv_heads=4, mlstm_chunk=4)


def _chain_case(block: str, seed: int = 3):
    cfg = _chain_config()
    init = xlstm.init_mlstm if block == "mlstm" else xlstm.init_slstm
    p = init(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    h = torch.as_tensor(rng.standard_normal(
        (CHAIN_B, CHAIN_S, cfg.d_model)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal(
        (CHAIN_B, CHAIN_S, cfg.d_model)).astype(np.float32))
    apply = xlstm.apply_mlstm if block == "mlstm" else xlstm.apply_slstm
    return cfg, p, h, w, apply


def _in_blocks(monkeypatch, apply, p, h, cfg, blocks, grad):
    """``apply`` on each of ``blocks`` row blocks of ``h`` as rank q of a
    seq2d split, the ranks in turn (:class:`_RanksInTurn` in place of
    ``common.all_reduce``): each block's output, the last block's cache,
    each block's input (a leaf that requires grad under ``grad``) and the
    simulated collectives, for the backwards to run in reverse."""
    sim = _RanksInTurn(blocks)
    monkeypatch.setattr(common, "all_reduce", sim)
    n = h.shape[1] // blocks
    outs, caches, ins = [], [], []
    for q in range(blocks):
        sim.rank()
        hq = h[:, q * n:(q + 1) * n].clone().requires_grad_(grad)
        split_q = common.TokenSplit(sim.mesh, [0], q * n, h.shape[1], True,
                                    [], h.shape[0])
        with torch.set_grad_enabled(grad):
            out, cache = apply(p, hq, cfg, split_q, return_state=True)
        outs.append(out)
        caches.append(cache)
        ins.append(hq)
    return outs, caches[-1], ins, sim


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_chain_over_row_blocks_is_the_whole_run(monkeypatch, block,
                                                      blocks):
    """Each block's rows from the halo (mLSTM) and the state the block
    before hands on, bitwise the whole run's rows; the last block's cache
    (the state, the mLSTM's conv rows) bitwise the whole run's."""
    cfg, p, h, _, apply = _chain_case(block)
    with torch.no_grad():
        want, want_cache = apply(p, h, cfg, return_state=True)
    outs, cache, _, _ = _in_blocks(monkeypatch, apply, p, h, cfg, blocks,
                                   grad=False)
    assert torch.equal(torch.cat(outs, dim=1), want)
    assert set(cache) == set(want_cache)
    for key in want_cache:
        assert torch.equal(cache[key], want_cache[key]), key


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_chain_gradients_are_the_whole_runs(monkeypatch, block,
                                                  blocks):
    """Under training each hop's backward all-reduces the carry's
    gradient back to its owner, the ranks' backwards run in reverse:
    every block's input gradient and the weights' (summed over the
    blocks) against the whole run's at rtol 1e-4 / atol 1e-5 (the weights'
    sums over the blocks group differently: within 8e-6 of gradients up to
    24 here); the outputs bitwise; the sLSTM output kept in f32."""
    cfg, p, h, w, apply = _chain_case(block)
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(
        p, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    with cases.f32_slstm_out():
        h0 = h.clone().requires_grad_(True)
        whole, _ = apply(p, h0, cfg, return_state=True)
        want = torch.autograd.grad((whole * w).sum(), [h0] + leaves)
        outs, _, ins, sim = _in_blocks(monkeypatch, apply, p, h, cfg, blocks,
                                       grad=True)
    n = CHAIN_S // blocks
    sim.phase()
    got_h, got_w = [None] * blocks, [torch.zeros_like(x) for x in leaves]
    for q in reversed(range(blocks)):
        sim.rank()
        g = torch.autograd.grad((outs[q] * w[:, q * n:(q + 1) * n]).sum(),
                                [ins[q]] + leaves)
        got_h[q] = g[0]
        got_w = [a + b for a, b in zip(got_w, g[1:])]
    torch.testing.assert_close(torch.cat(outs, dim=1), whole.detach(),
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(got_h, dim=1), want[0],
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(got_w, want[1:]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blocks,chunk", [(4, 8), (2, 16)])
def test_xlstm_split_that_cuts_a_chunk_runs_in_shorter_chunks(
        monkeypatch, blocks, chunk):
    """A rank's rows of a split sequence that are not whole ``mlstm_chunk``
    chunks (4 rows against 8, 8 against 16) run the scan in chunks of the
    largest size dividing both: the same function as the whole run in
    chunks of ``mlstm_chunk``, values and the last block's cache at rtol
    1e-4 / atol 1e-5 (the chunks group the sums differently)."""
    cfg = _chain_config().with_overrides(mlstm_chunk=chunk)
    _, p, h, _, apply = _chain_case("mlstm")
    with torch.no_grad():
        want, want_cache = apply(p, h, cfg, return_state=True)
    outs, cache, _, _ = _in_blocks(monkeypatch, apply, p, h, cfg, blocks,
                                   grad=False)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=RTOL,
                               atol=ATOL)
    assert set(cache) == set(want_cache)
    for key in want_cache:
        torch.testing.assert_close(cache[key], want_cache[key], rtol=RTOL,
                                   atol=ATOL)


def test_xlstm_split_whose_rows_hold_no_halo_raises():
    """A rank's 2 rows of a split sequence hold no whole conv halo of 3
    rows: ``ValueError`` naming the fix, before any collective."""
    cfg = _chain_config()
    p = xlstm.init_mlstm(torch.Generator().manual_seed(0), cfg)
    split_q = common.TokenSplit(_RanksInTurn.Mesh(8), [0], 2, 16, True, [],
                                2)
    with pytest.raises(ValueError, match="fewer ranks"):
        xlstm.apply_mlstm(p, torch.zeros((2, 2, cfg.d_model)), cfg, split_q)


# ---------------------------------------------------------------------------
# the dry-run per chip of a seq2d recurrentgemma prefill
# ---------------------------------------------------------------------------

def hand_count_rg_seq2d_prefill(cfg, shape, mesh: MeshShape) -> tuple:
    """``(all-reduces, result bytes)`` a chip takes part in during reduced
    recurrentgemma-2b's prefill under seq2d (f32, weights replicated, the
    tied table over model, the batch over the data axes, the sequence over
    model), derived from the layer shapes, with b = B / data, s = S, r the
    model axis, Dr = d_rnn:

    * one of the vocab-parallel embedding's (b, s, D) rows;
    * each RG-LRU layer: the halo, one of every rank's last tw - 1 rows
      (b, r (tw - 1), Dr); the carry's r hops, each a (b, Dr) f32 state
      (the last hands every rank the last rank's state for the cache);
    * each attention layer: k and v gathered along the sequence, two of
      (b, s, Kh, Dh);
    * the final head: the sequence gathered, one of (b, s, D), whose
      logits stay vocab-parallel.

    The cache is placed by ``cache_specs`` from whole rows by slicing
    alone."""
    data = 1
    for a in ("pod", "data"):
        data *= mesh.shape.get(a, 1)
    r = mesh.shape["model"]
    b, s, d = shape.global_batch // data, shape.seq_len, cfg.d_model
    dr, tw = cfg.resolved_d_rnn, cfg.lru_temporal_width
    kh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    mixers = [cfg.layer_spec(i).mixer for i in range(cfg.n_layers)]
    n_rg, n_attn = mixers.count("rglru"), len(mixers) - mixers.count(
        "rglru")
    count = 1 + n_rg * (1 + r) + 2 * n_attn + 1
    nbytes = 4 * (b * s * d + n_rg * (b * r * (tw - 1) * dr + r * b * dr)
                  + 2 * n_attn * b * s * kh * dh + b * s * d)
    return count, nbytes


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
def test_dryrun_seq2d_prefill_all_reduces_match_the_hand_count(mesh):
    """Reduced recurrentgemma-2b under seq2d, prefill of 64 positions (4
    rows a chip, one conv halo of 3), on a fake (16, 16) mesh and a fake
    (2, 16, 16) one whose pod axis splits the batch with data: rank 0's
    walk, all-reduces only, counted and sized by hand."""
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data",
                                                      "model")
    shape = MeshShape(mesh, names)
    cfg = configs.get_reduced("recurrentgemma-2b").with_overrides(
        attn_shard="seq2d", compute_dtype="float32")
    prefill = InputShape("prefill_seq2d", 64, shape.size // 16, "prefill")
    assert not dist.is_initialized()
    rec = dryrun.lower_one(cfg.name, prefill, cfg_override=cfg, mesh=shape,
                           verbose=False)
    assert not dist.is_initialized()
    counts = rec["coll_breakdown"]["counts"]
    n, nbytes = hand_count_rg_seq2d_prefill(cfg, prefill, shape)
    assert sum(counts.values()) == counts["all-reduce"] == n
    assert rec["coll_bytes_per_chip"] == nbytes


def hand_count_xlstm_seq2d_prefill(cfg, shape, mesh: MeshShape) -> tuple:
    """``(all-reduces, result bytes)`` a chip takes part in during reduced
    xlstm-1.3b's prefill under seq2d (f32, the mixers' weights
    replicated, the tied table over model, the batch over the data axes,
    the sequence over model), derived from the layer shapes, with b = B /
    data, s = S, r the model axis, Di = the mLSTM's inner width, NH heads
    of DH (mLSTM) or D / NH (sLSTM):

    * one of the vocab-parallel embedding's (b, s, D) rows;
    * each mLSTM layer: the conv's halo, one of every rank's last 3
      pre-conv rows (b, 3 r, Di); the chain's r hops, each the (C, n, m)
      f32 state (b, NH (DH^2 + DH + 1)), the last handing every rank the
      last rank's state for the cache;
    * each sLSTM layer: the chain's r hops, each the (c, n, h, m) f32
      state (b, 4 D);
    * the final head: the sequence gathered, one of (b, s, D), whose
      logits stay vocab-parallel.

    The cache is placed by ``cache_specs`` from whole rows by slicing
    alone."""
    data = 1
    for a in ("pod", "data"):
        data *= mesh.shape.get(a, 1)
    r = mesh.shape["model"]
    b, s, d = shape.global_batch // data, shape.seq_len, cfg.d_model
    di = int(d * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    dh = di // nh
    mixers = [cfg.layer_spec(i).mixer for i in range(cfg.n_layers)]
    n_m, n_s = mixers.count("mlstm"), mixers.count("slstm")
    count = 1 + n_m * (1 + r) + n_s * r + 1
    nbytes = 4 * (b * s * d + n_m * (b * 3 * r * di
                                     + r * b * nh * (dh * dh + dh + 1))
                  + n_s * r * b * 4 * d + b * s * d)
    return count, nbytes


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)])
def test_dryrun_xlstm_seq2d_prefill_all_reduces_match_the_hand_count(mesh):
    """Reduced xlstm-1.3b under seq2d (``mlstm_chunk`` 4), prefill of 64
    positions (4 rows a chip: one whole chunk, one conv halo of 3), on a
    fake (16, 16) mesh and a fake (2, 16, 16) one: rank 0's walk,
    all-reduces only, counted and sized by hand."""
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data",
                                                      "model")
    shape = MeshShape(mesh, names)
    cfg = configs.get_reduced("xlstm-1.3b").with_overrides(
        attn_shard="seq2d", compute_dtype="float32", mlstm_chunk=4)
    prefill = InputShape("prefill_seq2d", 64, shape.size // 16, "prefill")
    assert dryrun.walks_per_chip(cfg, prefill, shape)
    rec = dryrun.lower_one(cfg.name, prefill, cfg_override=cfg, mesh=shape,
                           verbose=False)
    assert not dist.is_initialized()
    counts = rec["coll_breakdown"]["counts"]
    n, nbytes = hand_count_xlstm_seq2d_prefill(cfg, prefill, shape)
    assert sum(counts.values()) == counts["all-reduce"] == n
    assert rec["coll_bytes_per_chip"] == nbytes


def test_common_held_rows_nest_in_mesh_order():
    """``common.held_rows`` nests shards in mesh order: 6 rows over two
    dims of 2 give 2, 1, 2, 1 (DTensor's split of a cohort over pod then
    data), where the flattened split gives 2, 2, 2, 0."""
    class Mesh:
        def __init__(self, coord):
            self.coord = coord

        def get_local_rank(self, i):
            return self.coord[i]

        def size(self, i):
            return 2
    rows = [common.held_rows(6, Mesh((p, q)), [0, 1])
            for p in range(2) for q in range(2)]
    assert rows == [(0, 2), (2, 3), (3, 5), (5, 6)]

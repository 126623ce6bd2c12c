"""The cohort-sharded round's cases and the rank processes that run them.

Imports torch and ``repro_torch`` only: ``tests/test_torch_mesh_dist.py``
spawns :func:`rank_main` in fresh processes (``torch.multiprocessing``),
which import this module and nothing of JAX.  Inputs come from numpy
seeds; the model is ``tests/test_fedround.py``'s tiny config, the weights
the port's ``init_params`` from a seeded generator (saved by the test,
which hands the reference a ``repro_torch.interop`` copy).
"""

import contextlib
import os
import traceback

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.tree import tree_leaves, tree_map

TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=64, exit_layer=1, compute_dtype="float32")
CFG = base.ModelConfig(pattern=(base.LayerSpec("attn"),), **TINY)
B, STEPS, SEQ = 2, 2, 16
# (label, K, cohort_chunk): chunk 2 splits evenly over 2 ranks, chunk 1
# leaves rank 1 empty in every chunk, K = 3 in one chunk splits 2 + 1
CASES = (("K4 chunk 2", 4, 2), ("K4 chunk 1", 4, 1), ("K3 chunk 3", 3, 3))


def tokens(k: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(k, B, STEPS, SEQ + 1)).astype(np.int32)


def is_simple(k: int) -> np.ndarray:
    return np.arange(k) < k // 2


def round_inputs(params, k: int):
    cohort = tree_map(lambda x: x[None].expand((k,) + x.shape), params)
    return cohort, torch.as_tensor(tokens(k)), torch.as_tensor(is_simple(k))


def placement_rows(mesh, params, k: int, chunk: int):
    """The client rows of each chunk that this rank holds when
    ``distribute_tensor`` shards a cohort leaf by
    ``to_placements(cohort_specs(...))``: a leaf of client ids is
    distributed and its local part read back."""
    from torch.distributed.tensor import distribute_tensor
    spec = sharding.cohort_specs(params, CFG, mesh)["final_norm"]["scale"]
    place = sharding.to_placements(spec, mesh)
    rows = []
    for start in range(0, k, chunk):
        ids = torch.arange(start, start + chunk, dtype=torch.float32)
        ids = ids[:, None].expand(chunk, TINY["d_model"]).contiguous()
        local = distribute_tensor(ids, mesh, place).to_local()
        rows.append([int(v) for v in local[:, 0].tolist()])
    return rows


def rank_main(rank: int, world: int, store_path: str, params_path: str,
              out_dir: str) -> None:
    """One rank: gloo over a FileStore, a (world, 1) mesh; each case's
    sharded round, its rows by ``steps``' split and by
    ``distribute_tensor``; then a (1, world) mesh with a model axis: a
    live tensor-parallel policy for the dense config, and whether a
    ``seq2d`` split of an ``ssm`` config is a live token split.  Writes
    ``rank<r>.pt`` (or ``rank<r>.err``)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=store)
        params = torch.load(params_path)
        mesh = make_device_mesh(world, 1, "cpu")
        policy = sharding.MeshPolicy(mesh, CFG)
        out = {}
        for label, k, chunk in CASES:
            step = steps.make_fed_round_step(CFG, policy, local_steps=STEPS,
                                             cohort_chunk=chunk)
            new_c, loss = step(*round_inputs(params, k))
            index, parts = policy.data_coordinate()
            split = [list(range(s + lo, s + hi)) for s in range(0, k, chunk)
                     for lo, hi in [sharding.shard_rows(chunk, index, parts)]]
            out[label] = {"params": new_c, "loss": loss, "split": split,
                          "placed": placement_rows(mesh, params, k, chunk)}
        wide = make_device_mesh(1, world, "cpu")
        out["model_axis_live"] = sharding.MeshPolicy(wide, CFG).model_live
        out["model_axis"] = _raises(lambda: sharding.MeshPolicy(
            wide, CFG.with_overrides(attn_shard="seq2d",
                                     arch_type="ssm")).token_split)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# A live model axis (tensor parallelism): tests/test_torch_tp.py
# ---------------------------------------------------------------------------

# narrow f32 configs: heads replicated and a tied vocab-parallel table
# (gemma2), heads sharded with GQA (minitron), the RG-LRU's rnn channels
# (recurrentgemma), the head dim sharded behind a frontend (llava)
TP_TRAIN = "gemma2-2b"
TP_PREFILL = ("minitron-8b", "recurrentgemma-2b", "llava-next-34b")
TP_K, TP_B, TP_STEPS, TP_SEQ, TP_PROMPT = 2, 2, 1, 16, 32
TP_ENGINES = ("flat f32", "flat int8", "tree")

# xLSTM blocks and codebook tables over the model axis: reduced xlstm-1.3b
# (its mixers replicated, its tied table over model; the cache's C, n and
# conv split) and reduced musicgen-large (its two codebook tables over
# model, heads and ffn sharded, a frontend).  Their train steps and rounds
# run at (1, 2), (1, 4) and (2, 2); the rounds' musicgen config holds whole
# 128-element int8 groups on each rank at model 2 and 4 (head_dim 128: one
# or two heads a rank; d_ff 512: 128 or 256 columns a rank).  xlstm's
# train steps and rounds run with its sLSTM output kept in f32
# (f32_slstm_out), as tests/test_torch_xlstm_model.py holds its round, and
# its train step once more with the bf16 cast ("train bf16"), held
# against the port's unsharded step on the same rank
TP_XLSTM, TP_MUSICGEN = "xlstm-1.3b", "musicgen-large"
TP_MUSICGEN_ROUND = "musicgen-large:groups"
TP_ZOO = (TP_XLSTM, TP_MUSICGEN)
TP_ZOO_MESHES = {2: ("(1, 2)",), 4: ("(1, 4)", "(2, 2)")}


def zoo_key(kind: str, mesh: str, arch: str) -> str:
    """The result key of an xLSTM or codebook case: ``kind`` "train" or a
    round engine."""
    return f"{kind} {arch} {mesh}"


def zoo_round_arch(arch: str) -> str:
    return TP_MUSICGEN_ROUND if arch == TP_MUSICGEN else arch


# the MoE configs over the model axis: reduced qwen2-moe (4 experts: the
# experts axis over model at 2 and 4), the expert_ffn layout (3 experts do
# not divide 2: gate / up column-parallel, down row-parallel), padded
# experts (3 padded to 4: 2 a rank, one of rank 1's never routed to), and
# reduced kimi-k2 with its 2-D experts (expert_ffn over data too); the
# rounds' config holds whole 128-element int8 groups on each rank (head
# dim 64: 2 heads a rank; d_expert 256: the shared expert's 128 a rank)
TP_MOE = "qwen2-moe-a2.7b"
TP_MOE_ROUND = "qwen2-moe-a2.7b:groups"
MOE_VARIANTS = {"qwen2-moe-a2.7b:groups": ({"d_expert": 256},
                                           {"head_dim": 64}),
                "qwen2-moe-a2.7b:ffn": ({"n_experts": 3}, {}),
                "qwen2-moe-a2.7b:pad": ({"n_experts": 3, "pad_to": 4}, {}),
                "kimi-k2-1t-a32b:2d": ({}, {"shard_experts_2d": True}),
                TP_MUSICGEN_ROUND: ({}, {"head_dim": 128, "d_ff": 512}),
                # the specs' and the token splits' configs (no MoE
                # override): see TP_SPECS and TP_SPLIT below
                "gemma2-2b:groups": ({}, {"d_ff": 512}),
                "gemma2-2b:seq2d": ({}, {"attn_shard": "seq2d"}),
                "gemma2-2b:dp2d": ({}, {"attn_shard": "dp2d"}),
                "llava-next-34b:seq2d_fsdp": ({}, {"attn_shard":
                                                   "seq2d_fsdp"}),
                # the hybrid, audio and MoE token splits
                # (tests/torch_split_cases.py, torch_split_moe_cases.py)
                **{f"{arch}:{mode}": ({}, {"attn_shard": mode})
                   for arch in ("recurrentgemma-2b", "musicgen-large",
                                "qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
                   for mode in ("seq2d", "dp2d", "seq2d_fsdp")},
                # the xLSTM token splits: mlstm_chunk 4, so that a rank's
                # rows at (1, 4) (16 tokens: 4 a rank) are one whole chunk
                **{f"xlstm-1.3b:{mode}": ({}, {"attn_shard": mode,
                                               "mlstm_chunk": 4})
                   for mode in ("seq2d", "dp2d", "seq2d_fsdp")},
                "xlstm-1.3b:chunk4": ({}, {"mlstm_chunk": 4}),
                # a capacity factor at which rank 1 of a seq2d split drops
                # pairs that a routing of its own rows would keep
                # (torch_split_moe_cases.DROP)
                "qwen2-moe-a2.7b:drop": ({"capacity_factor": 1.0}, {}),
                "qwen2-moe-a2.7b:drop-seq2d": ({"capacity_factor": 1.0},
                                               {"attn_shard": "seq2d"})}
# the train step of each MoE case by mesh: (result key, mesh, arch)
TP_MOE_TRAIN = {2: (("moe train", "(1, 2)", TP_MOE),
                    ("moe ffn train", "(1, 2)", "qwen2-moe-a2.7b:ffn"),
                    ("moe pad train", "(1, 2)", "qwen2-moe-a2.7b:pad")),
                4: (("(1, 4) moe train", "(1, 4)", TP_MOE),
                    ("(2, 2) moe train", "(2, 2)", TP_MOE),
                    ("(2, 2) kimi 2-D train", "(2, 2)",
                     "kimi-k2-1t-a32b:2d"))}


# the serve step over sharded caches, by world size: (arch, batch, prompt
# tokens, cache_len).  gemma2 narrow (window 16): 20 prompt positions wrap
# its ring of 16, and positions 20-25 move the new slot across the rank
# boundary of the ring (slots 4-9; rows 0-7 | 8-15) and of the dense
# global cache (slots 20-25; rows 0-20 | 21-41).  At world size 2 the
# (1, 2) mesh: gemma2 and recurrentgemma kv_seq (recurrentgemma's RG-LRU
# state over its channels too), minitron heads, llava the head dim (8
# frontend rows + 12 tokens); at world size 4 the (1, 4) mesh (minitron's
# q heads sharded, its cache kv_seq: 2 kv heads do not divide 4; slots
# 20-25 cross rows 16-23 | 24-31) and the (2, 2) mesh (gemma2 at batch 2,
# the batch over data; at batch 1 the cache's sequence over data); reduced
# xlstm-1.3b (16 prompt tokens: two mLSTM chunks) and musicgen-large (4
# frontend rows + 12 frames of 2 codebooks) at all three meshes
TP_DECODE_STEPS = 6
TP_DECODE = {2: (("(1, 2)", "gemma2-2b", 2, 20, 42),
                 ("(1, 2)", "recurrentgemma-2b", 2, 20, 42),
                 ("(1, 2)", "minitron-8b", 2, 20, 32),
                 ("(1, 2)", "llava-next-34b", 2, 12, 32),
                 ("(1, 2)", TP_MOE, 2, 20, 32),
                 ("(1, 2)", "qwen2-moe-a2.7b:ffn", 2, 20, 32),
                 ("(1, 2)", "qwen2-moe-a2.7b:pad", 2, 20, 32),
                 ("(1, 2)", TP_XLSTM, 2, 16, 32),
                 ("(1, 2)", TP_MUSICGEN, 2, 12, 32)),
             4: (("(1, 4)", "minitron-8b", 2, 20, 32),
                 ("(2, 2)", "gemma2-2b", 2, 20, 42),
                 ("(2, 2)", "gemma2-2b", 1, 20, 42),
                 ("(1, 4)", TP_MOE, 2, 20, 32),
                 ("(2, 2)", TP_MOE, 2, 20, 32),
                 ("(2, 2)", "kimi-k2-1t-a32b:2d", 2, 20, 32),
                 ("(1, 4)", TP_XLSTM, 2, 16, 32),
                 ("(2, 2)", TP_XLSTM, 2, 16, 32),
                 ("(1, 4)", TP_MUSICGEN, 2, 12, 32),
                 ("(2, 2)", TP_MUSICGEN, 2, 12, 32))}


# the round step's compressed-wire and SCAFFOLD specs over the model axis
# on gemma2 narrow with d_ff 512 (its mlp shards hold whole 128-element
# int8 groups at model 2 and 4), each held bitwise to the port's round
# without the extra options at the same mesh (TP_SPEC_BASE)
TP_SPEC_ARCH = "gemma2-2b:groups"
TP_SPECS = ("int8 topk", "f32 topk", "scaffold")
TP_SPEC_BASE = {"int8 topk": "flat int8", "f32 topk": "flat f32",
                "scaffold": "flat f32"}
TP_MESHES = {2: ("(1, 2)",), 4: ("(1, 4)", "(2, 2)")}

# the token splits: gemma2 narrow under seq2d and dp2d at each mesh (train,
# the three rounds, prefill then the serve steps of the (1, 2) gemma2
# decode case: batch 2, 20 prompt tokens, cache 42), llava narrow under
# seq2d_fsdp at (2, 2) (train, prefill then serve with its 8 frontend
# rows; its rounds are refused: a cohort's specs name data twice); and at
# (1, 2) seq2d's chunk2d route, S = TP_LONG (a multiple of q_chunk 512 and
# k_chunk 2048: each rank's 1024 rows are two whole chunks): one train
# step and one prefill at batch 1.  The short sequences take the
# reference's fallback route (chunked causal attention)
TP_SPLIT = ("gemma2-2b:seq2d", "gemma2-2b:dp2d")
TP_FSDP = "llava-next-34b:seq2d_fsdp"
TP_SPLIT_DECODE = ("gemma2-2b", 2, 20, 42)
TP_FSDP_DECODE = ("llava-next-34b", 2, 12, 32)
# a seq2d serve step at batch 1 (its batch split over a data dim of one
# rank), by world size: (mesh, arch, prompt tokens, cache_len)
TP_SPLIT_B1 = {2: (("(1, 2)", "gemma2-2b:seq2d", 20, 42),
                   ("(1, 2)", "qwen2-moe-a2.7b:seq2d", 20, 32)),
               4: (("(1, 4)", "gemma2-2b:seq2d", 20, 42),
                   ("(1, 4)", "qwen2-moe-a2.7b:seq2d", 20, 32))}
TP_LONG = 2048


def split_key(kind: str, mesh: str, arch: str) -> str:
    """The result key of a token-split or spec case: ``kind`` "train",
    "decode", a round engine or a spec of ``TP_SPECS``."""
    return f"{kind} {arch} {mesh}"


def tp_long_batch(arch: str, prefill: bool) -> dict:
    """Batch 1 of ``TP_LONG`` positions: a train step's ``TP_LONG + 1``
    tokens, or a prompt of ``TP_LONG``."""
    tokens = np.random.default_rng(13).integers(
        0, tp_config(arch).vocab_size,
        size=(1, TP_LONG + (0 if prefill else 1))).astype(np.int32)
    return {"tokens": tokens}


def collective_kinds(fn):
    """``fn()`` under DTensor's ``CommDebugMode``: its result and the
    functional collectives it issued, by name (forward and backward)."""
    from torch.distributed.tensor.debug import CommDebugMode
    mode = CommDebugMode()
    with mode:
        out = fn()
    return out, sorted(str(k).rsplit(".", 1)[-1]
                       for k in mode.get_comm_counts())


def decode_key(mesh: str, arch: str, batch: int) -> str:
    return f"decode {arch} b{batch} {mesh}"


def variant(cfg, arch: str):
    """``cfg`` (either package's reduced config of ``arch``'s base name)
    with ``arch``'s ``MOE_VARIANTS`` overrides."""
    import dataclasses
    moe, over = MOE_VARIANTS.get(arch, ({}, {}))
    if moe:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg.with_overrides(compute_dtype="float32", **over)


def tp_config(arch: str):
    from repro_torch import configs
    return variant(configs.get_reduced(arch.partition(":")[0]), arch)


def tp_params(arch: str):
    from repro_torch.models import transformer as tfm
    return tfm.init_params(torch.Generator().manual_seed(0),
                           tp_config(arch))


def tp_engine(name: str):
    from repro_torch.core import aggregate, comm
    return {"flat f32": None,
            "flat int8": aggregate.EngineSpec(wire=comm.WireSpec("int8",
                                                                 128)),
            "tree": aggregate.EngineSpec(engine="tree"),
            "int8 topk": aggregate.EngineSpec(wire=comm.WireSpec(
                "int8", 128, topk_frac=0.5)),
            "f32 topk": aggregate.EngineSpec(wire=comm.WireSpec(
                "float32", 128, topk_frac=0.25)),
            "scaffold": aggregate.EngineSpec(
                variance_reduction="scaffold")}[name]


def _codebooks(arch: str) -> tuple:
    """The trailing codebook dim of ``arch``'s tokens, if it has one."""
    nc = tp_config(arch).n_codebooks
    return (nc,) if nc > 1 else ()


def tp_round_inputs(k: int = TP_K, arch: str = TP_TRAIN):
    rng = np.random.default_rng(7)
    data = rng.integers(0, tp_config(arch).vocab_size, size=(
        k, TP_B, TP_STEPS, TP_SEQ + 1) + _codebooks(arch)).astype(np.int32)
    return data, np.arange(k) < k // 2


def tp_train_tokens(arch: str = TP_TRAIN) -> np.ndarray:
    return np.random.default_rng(8).integers(
        0, tp_config(arch).vocab_size,
        size=(TP_B, TP_SEQ + 1) + _codebooks(arch)).astype(np.int32)


def tp_train_batch(arch: str) -> dict:
    """The train step's batch: :func:`tp_train_tokens`, and a frontend's
    ``extra_embeds``."""
    batch = {"tokens": tp_train_tokens(arch)}
    fe = tp_config(arch).frontend
    if fe is not None:
        batch["extra_embeds"] = np.random.default_rng(10).standard_normal(
            (TP_B, fe.n_tokens, fe.d_in)).astype(np.float32)
    return batch


def tp_prefill_batch(arch: str) -> dict:
    cfg = tp_config(arch)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(
        TP_B, TP_PROMPT)).astype(np.int32)}
    if cfg.frontend is not None:
        batch["extra_embeds"] = rng.standard_normal(
            (TP_B, cfg.frontend.n_tokens, cfg.frontend.d_in)
        ).astype(np.float32)
    return batch


def tp_decode_inputs(arch: str, batch: int, prompt: int) -> tuple:
    """The prompt batch and the teacher-forced tokens
    ``(TP_DECODE_STEPS, batch, 1)`` of a decode case."""
    cfg = tp_config(arch)
    rng = np.random.default_rng(12)
    prompt_batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(
        batch, prompt) + _codebooks(arch)).astype(np.int32)}
    if cfg.frontend is not None:
        prompt_batch["extra_embeds"] = rng.standard_normal(
            (batch, cfg.frontend.n_tokens, cfg.frontend.d_in)
        ).astype(np.float32)
    forced = rng.integers(0, cfg.vocab_size, size=(
        TP_DECODE_STEPS, batch, 1) + _codebooks(arch)).astype(np.int32)
    return prompt_batch, forced


def first_position(arch: str, prompt: int) -> int:
    """The position decode starts at: the prompt's, frontend rows
    included."""
    fe = tp_config(arch).frontend
    return prompt + (fe.n_tokens if fe is not None else 0)


def _written_rows(before, cache) -> dict:
    """For each KV cache leaf, by path: ``(start, stop, size, rows)``, the
    global rows ``[start, stop)`` of its ``size`` that this rank holds and
    those of them its local shard changed since ``before`` (the local
    shards)."""
    from repro_torch.models import common
    from repro_torch.tree import tree_leaves_with_keys
    out = {}
    for (keys, x), old in zip(tree_leaves_with_keys(cache), before):
        if keys[-1] not in ("k", "v"):
            continue
        seq = 2 if "periods" in keys else 1
        local = x.to_local()
        moved = (local != old).flatten(seq + 1).any(-1)
        moved = moved.flatten(0, seq - 1).any(0)
        start = common.shard_offset(x, seq)
        out["/".join(map(str, keys))] = (
            start, start + local.shape[seq], x.shape[seq],
            [start + int(i) for i in torch.nonzero(moved).flatten()])
    return out


def _state_slices(before, cache) -> dict:
    """For each xLSTM state leaf (the mLSTM's C, n, m and conv, the
    sLSTM's c, n, h and m), by path: ``(offsets, placements, local,
    changed)``, where this rank's local shard starts in the global leaf on
    each dim, the leaf's placements, the shard, and whether the step
    changed it (``before``: the local shards)."""
    from repro_torch.models import common
    from repro_torch.tree import tree_leaves_with_keys
    out = {}
    for (keys, x), old in zip(tree_leaves_with_keys(cache), before):
        if keys[-1] in ("k", "v"):
            continue
        local = x.to_local()
        out["/".join(map(str, keys))] = (
            tuple(common.shard_offset(x, d) for d in range(x.dim())),
            str(x.placements), local.clone(), not torch.equal(local, old))
    return out


def decode_case(on, arch: str, batch: int, prompt: int,
                cache_len: int, collectives: list = None) -> dict:
    """Prefill then ``TP_DECODE_STEPS`` teacher-forced serve steps with the
    exit head under a ``MeshPolicy`` over ``on``: the prefill's logits and
    cache, each step's logits, exit logits and cache whole
    (``full_tensor``), the logits' placements and the placements the
    reference's constrain gives the logits; and apart (they differ by
    rank) the rows this rank wrote at each step (:func:`_written_rows`),
    its shards of the recurrent states (:func:`_state_slices`) and the
    steps' MoE routing (:func:`routed`).  Given a list ``collectives``, the
    names of the collectives the prefill and the serve steps issue (not
    the reads of their results) are added to it."""
    from repro_torch.launch import sharding, steps
    from repro_torch.tree import tree_leaves
    cfg = tp_config(arch)
    policy = sharding.MeshPolicy(on, cfg)
    params = sharding.distribute_params(tp_params(arch), cfg, on)
    prompt_batch, forced = tp_decode_inputs(arch, batch, prompt)
    record = collectives.extend if collectives is not None else (
        lambda kinds: None)
    (logits, cache), kinds = collective_kinds(
        lambda: steps.make_prefill_step(cfg, policy, cache_len=cache_len)(
            params, {k: torch.as_tensor(v)
                     for k, v in prompt_batch.items()}))
    record(kinds)
    serve = steps.make_serve_step(cfg, policy, with_exit_head=True)
    pos = first_position(arch, prompt)
    out = {"logits": [], "exit": [], "cache": [],
           "prefill": {"logits": logits.full_tensor(), "cache": _full(cache)}}
    written, states = [], []

    def decode():
        nonlocal cache
        for i in range(TP_DECODE_STEPS):
            before = [x.to_local().clone() for x in tree_leaves(cache)]
            (logits, cache, exit_logits), kinds = collective_kinds(
                lambda: serve(params, cache, {"tokens": torch.as_tensor(
                    forced[i])}, pos + i))
            record(kinds)
            written.append(_written_rows(before, cache))
            states.append(_state_slices(before, cache))
            out["logits"].append(logits.full_tensor())
            out["exit"].append(exit_logits.full_tensor())
            out["cache"].append(_full(cache))
        return ([str(logits.placements), str(exit_logits.placements)],
                tuple(logits.shape))
    # an MoE decode step routes the whole batch as one group; where the
    # batch is sharded each rank routes its own rows (with the queue
    # offsets of the ranks before it), so the routings are kept apart,
    # beside the unsharded run's (:func:`rank_routing`)
    (out["placements"], shape), routing = rank_routing(decode)
    # the placements the reference's ("batch", "seq", "vocab") constrain
    # resolves to on a serve step's logits
    out["want_placements"] = str(tuple(sharding.to_placements(policy.spec(
        shape, ("batch", "seq", "vocab")), on)))
    apart = {"rows": written, "states": states, "routing": routing}
    if routing:
        apart["unsharded routing"] = unsharded_decode_routing(
            arch, batch, prompt, cache_len)
    return out, apart


def rank_routing(fn):
    """``fn()`` with ``mlp._route`` recording, for each routing call, the
    experts each of this rank's tokens chose, their slots (``e * C +
    slot``, ``E_pad * C`` if dropped), ``(E_pad, C)`` and ``start``, the rank's
    first token in its group (its place among the group's ranks times its
    token count: the ranks' parts are equal here; 0 where it routes the
    whole group).  Returns ``(fn(), calls)``."""
    from repro_torch.models import mlp
    route, calls = mlp._route, []

    def record(logits, moe, capacity, e_pad=0, group=None):
        r = route(logits, moe, capacity, e_pad, group)
        start = group.place() * logits.shape[1] if group is not None \
            and group.dims else 0
        calls.append({"experts": r.token_expert.clone(),
                      "slot": r.token_slot.clone(),
                      "buffer": tuple(r.slot_idx.shape[1:]),
                      "start": start})
        return r
    mlp._route = record
    try:
        return fn(), calls
    finally:
        mlp._route = route


_UNSHARDED_ROUTING = {}


def unsharded_decode_routing(arch: str, batch: int, prompt: int,
                             cache_len: int) -> list:
    """:func:`rank_routing` of the serve steps of :func:`decode_case` run
    unsharded (no policy, plain tensors), once a case in a process."""
    case = (arch, batch, prompt, cache_len)
    if case not in _UNSHARDED_ROUTING:
        cfg = tp_config(arch)
        params = tp_params(arch)
        prompt_batch, forced = tp_decode_inputs(arch, batch, prompt)
        _, cache = steps.make_prefill_step(cfg, cache_len=cache_len)(
            params, {k: torch.as_tensor(v) for k, v in prompt_batch.items()})
        serve = steps.make_serve_step(cfg, with_exit_head=True)
        pos = first_position(arch, prompt)

        def decode():
            c = cache
            for i in range(TP_DECODE_STEPS):
                _, c, _ = serve(params, c, {"tokens": torch.as_tensor(
                    forced[i])}, pos + i)
        _UNSHARDED_ROUTING[case] = rank_routing(decode)[1]
    return _UNSHARDED_ROUTING[case]


def routed(fn):
    """``fn()`` with ``mlp._route`` recording: its result and the
    ``slot_idx`` of each routing call, in order (none for a dense
    config)."""
    from repro_torch.models import mlp
    route, slots = mlp._route, []

    def record(*args, **kwargs):
        r = route(*args, **kwargs)
        slots.append(r.slot_idx.clone())
        return r
    mlp._route = record
    try:
        return fn(), slots
    finally:
        mlp._route = route


@contextlib.contextmanager
def f32_slstm_out():
    """The port's ``_slstm_out`` without its bf16 cast, the norm and the
    FFN in the cell output's own dtype (f32 in the reduced config): the
    port half of ``tests/test_torch_xlstm_model.f32_slstm_out``, which the
    reference's xlstm steps run under in ``tests/test_torch_tp.py``."""
    from repro_torch.models import common, xlstm
    from repro_torch.models.mlp import gelu

    def port_out(p, hs, cfg):
        b, s, nh, dh = hs.shape
        h = common.apply_rmsnorm(p["norm"], hs, cfg.norm_eps).reshape(
            b, s, nh * dh)
        g = torch.matmul(h, p["ff_gate"].to(h.dtype))
        return torch.matmul(gelu(g), p["ff_down"].to(h.dtype))

    saved = xlstm._slstm_out
    xlstm._slstm_out = port_out
    try:
        yield
    finally:
        xlstm._slstm_out = saved


def _full(tree):
    """Each leaf whole, a copy: a replicated DTensor's ``full_tensor()`` is
    its local tensor, which a later serve step updates in place."""
    from repro_torch.launch import sharding
    return tree_map(lambda x: x.full_tensor().clone()
                    if sharding.is_dtensor(x) else x, tree)


def _raises(fn) -> str:
    """What ``fn()`` raised, or ``str`` of what it returned."""
    try:
        value = fn()
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"
    except Exception as e:  # noqa: BLE001
        return f"{type(e).__name__}: {e}"
    return str(value)


def vocab_parallel_case(mesh) -> dict:
    """The trap of a tied table over a vocab-sharded mesh: the lookup and
    the unembedding of one f64 table, its CE loss and the table's
    gradient, through ``common.apply_embedding`` (the ``local_map``
    lookup), the tied ``h @ table.T`` and the vocab-parallel CE."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import common
    table, tokens = vocab_case()
    placements = [Replicate(), Shard(0)]
    dt = distribute_tensor(table, mesh, placements,
                           src_data_rank=None).requires_grad_(True)
    with implicit_replication():
        h = common.apply_embedding({"table": dt}, tokens)
        h = h.redistribute(mesh, [Replicate(), Replicate()])
        logits = common.apply_unembedding({"table": dt}, h)
        loss = common.softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
        (grad,) = torch.autograd.grad(loss, [dt])
    return {"loss": loss.full_tensor(), "grad": grad.full_tensor(),
            "grad_placements": [str(p) for p in grad.placements]}


def vocab_case():
    rng = np.random.default_rng(11)
    table = torch.as_tensor(rng.standard_normal((64, 16)))      # f64
    tokens = torch.as_tensor(rng.integers(0, 64, size=(3, 9)))
    return table, tokens


def refusals(mesh) -> dict:
    """What raises over a live model axis, each with its message; and the
    token splits and the pod axis that no longer do."""
    from repro_torch.launch import sharding, steps
    cfg = tp_config(TP_TRAIN)
    out = {}
    # the token splits of the configs whose blocks once did not run on a
    # rank's rows: RG-LRU, codebooks, MoE (queue positions across ranks)
    # and xLSTM (their states chained across ranks)
    for arch in ("recurrentgemma-2b", "qwen2-moe-a2.7b", "xlstm-1.3b",
                 "musicgen-large"):
        seq2d = tp_config(arch).with_overrides(attn_shard="seq2d")
        out["seq2d " + arch] = _raises(lambda c=seq2d: sharding.MeshPolicy(
            mesh, c).token_split)
    # a seq2d_fsdp cohort names data twice (the client axis and the
    # weights' ZeRO-3 dim), which the reference's NamedSharding refuses
    fsdp = tp_config(TP_FSDP)
    out["seq2d_fsdp cohort"] = _raises(lambda: sharding.distribute_cohort(
        tree_map(lambda x: x[None].expand((2,) + x.shape), tfm_init(fsdp)),
        fsdp, mesh))
    # a live pod axis: the round's data group over pod and data
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    pod = DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(
        1, 1, -1), mesh_dim_names=("pod", "data", "model"))
    out["pod axis"] = _raises(lambda: dist.get_world_size(
        sharding.MeshPolicy(pod, cfg).data_group()))
    # an int8 round whose mlp shards hold 64 of a 128-element group, and
    # one whose expert_ffn shards do (3 experts: d_expert 128 over 2; its
    # heads at Dh 64 hold whole groups)
    data, simple = tp_round_inputs(2)
    for name, narrow in (("int8 groups", cfg.with_overrides(d_ff=128)),
                         ("int8 expert groups",
                          tp_config("qwen2-moe-a2.7b:ffn").with_overrides(
                              head_dim=64))):
        cohort = sharding.distribute_cohort(tree_map(
            lambda x: x[None].expand((2,) + x.shape), tfm_init(narrow)),
            narrow, mesh)
        out[name] = _raises(lambda n=narrow, c=cohort: steps.
                            make_fed_round_step(
                                n, sharding.MeshPolicy(mesh, n),
                                local_steps=1,
                                engine=tp_engine("flat int8"))(
            c, torch.as_tensor(data), torch.as_tensor(simple)))
    # kimi-k2's 2-D experts name data twice in a cohort's specs (the
    # client axis and expert_ffn), which the reference's cohort_specs
    # refuses too
    kimi = tp_config("kimi-k2-1t-a32b:2d")
    out["cohort 2-D experts"] = _raises(lambda: sharding.distribute_cohort(
        tree_map(lambda x: x[None].expand((2,) + x.shape), tfm_init(kimi)),
        kimi, mesh))
    return out


def moe_aux(mesh) -> dict:
    """The aux losses of reduced qwen2-moe's forward on ``mesh``, its batch
    over data: ``load_balance`` is a product of two batch means, each
    reduced over the data ranks before the product."""
    from repro_torch.launch import sharding
    from repro_torch.models import transformer as tfm
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = tp_config(TP_MOE)
    params = sharding.distribute_params(tp_params(TP_MOE), cfg, mesh)
    tokens = torch.as_tensor(tp_train_tokens(TP_MOE))
    with torch.no_grad(), implicit_replication():
        _, _, aux = tfm.forward(params, cfg, tokens[:, :-1],
                                policy=sharding.MeshPolicy(mesh, cfg))
    return _full(aux)


def tfm_init(cfg):
    from repro_torch.models import transformer as tfm
    return tfm.init_params(torch.Generator().manual_seed(0), cfg)


def gather_case(mesh) -> dict:
    """``common.gather_by_sum`` against the functional all-gather over the
    model dim, on a tensor whose slices differ by rank and hold -0.0: the
    gathered dim second of three, each rank's slice (3, 2, 5)."""
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.models import common
    rank = mesh.get_local_rank(1)
    n = mesh.size(1)
    x = torch.as_tensor(np.random.default_rng(20 + rank).standard_normal(
        (3, 2, 5)).astype(np.float32))
    x[0, 0, :2] = -0.0
    want = funcol.wait_tensor(funcol.all_gather_tensor(
        x.movedim(1, 0).contiguous(), 0, (mesh, 1))).movedim(0, 1)
    got = common.gather_by_sum(x, 1, 2 * rank, 2 * n, mesh, [1])
    return {"got": got, "want": want}


def codebook_embed_case(mesh) -> dict:
    """Reduced musicgen-large's codebook embedding with bf16 tables (their
    adds round), vocab-sharded over ``mesh``, and unsharded on the same
    tables and tokens: ``embed_inputs`` whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import sharding
    from repro_torch.models import transformer as tfm
    cfg = tp_config(TP_MUSICGEN).with_overrides(param_dtype="bfloat16")
    params = tfm_init(cfg)
    tokens = torch.as_tensor(tp_train_tokens(TP_MUSICGEN))
    want = tfm.embed_inputs(params, cfg, tokens)
    placed = sharding.distribute_params(tree_map(lambda x: x, params), cfg,
                                        mesh)
    with torch.no_grad(), implicit_replication():
        got = tfm.embed_inputs(placed, cfg, tokens,
                               policy=sharding.MeshPolicy(mesh, cfg))
    return {"got": got.full_tensor(), "want": want,
            "tables": str(placed["embed"]["tables"].placements)}


def tp_rank_main(rank: int, world: int, store_path: str,
                 out_dir: str) -> None:
    """One rank of the tensor-parallel cases: gloo over a FileStore; at
    world size 2 a (1, 2) mesh (train, the three round engines, the
    prefills, the vocab-parallel trap, the refusals; the MoE train step
    and its routing against the unsharded step's, and its three round
    engines), at 4 a (2, 2) mesh (train on a batch split over data, the
    flat f32 round: data and model together; the MoE aux losses) and a
    (1, 4) mesh (minitron's prefill, its kv heads replicated); the MoE
    train steps of ``TP_MOE_TRAIN``; at each of ``TP_ZOO_MESHES`` the
    xLSTM and codebook configs' train steps and three rounds, the
    gather check and the codebook embedding; then the decode cases of
    ``TP_DECODE`` at each world size, the specs and the token splits, and
    the seq2d serve steps at batch 1 of ``TP_SPLIT_B1``.  Each result is saved
    whole (``full_tensor``) to ``tp<world>_rank<r>.pt`` (or the traceback
    to ``tp<world>_rank<r>.err``)."""
    import torch.distributed as dist
    from repro_torch.launch import sharding, steps
    torch.set_num_threads(1)
    tag = os.path.join(out_dir, f"tp{world}_rank{rank}")
    try:
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world))
        n_data = world // 2
        mesh = make_device_mesh(n_data, 2, "cpu")
        cfg = tp_config(TP_TRAIN)
        policy = sharding.MeshPolicy(mesh, cfg)
        data, simple = tp_round_inputs()
        out = {}

        def prefill_of(arch, on):
            a_cfg = tp_config(arch)
            a_params = sharding.distribute_params(tp_params(arch), a_cfg, on)
            batch = {k: torch.as_tensor(v) for k, v in
                     tp_prefill_batch(arch).items()}
            logits, cache = steps.make_prefill_step(
                a_cfg, sharding.MeshPolicy(on, a_cfg))(a_params, batch)
            return {"logits": _full(logits), "cache": _full(cache)}

        def round_of(engine, arch=TP_TRAIN, on=mesh):
            a_cfg = tp_config(arch)
            a_data, a_simple = tp_round_inputs(arch=arch)
            cohort = sharding.distribute_cohort(tree_map(
                lambda x: x[None].expand((TP_K,) + x.shape),
                tp_params(arch)), a_cfg, on)
            new_c, loss = steps.make_fed_round_step(
                a_cfg, sharding.MeshPolicy(on, a_cfg), local_steps=TP_STEPS,
                engine=tp_engine(engine))(cohort, torch.as_tensor(a_data),
                                          torch.as_tensor(a_simple))
            placed = [str(x.placements) for x in tree_leaves(new_c)]
            return {"params": _full(new_c), "loss": loss,
                    "placements": placed}

        def train_of(arch, on, batch=None, collectives=None):
            a_cfg = tp_config(arch)
            params = sharding.distribute_params(tp_params(arch), a_cfg, on)
            step = steps.make_train_step(a_cfg, sharding.MeshPolicy(on,
                                                                    a_cfg))
            (new, metrics), kinds = collective_kinds(lambda: step(
                params, {k: torch.as_tensor(v) for k, v in (
                    batch or tp_train_batch(arch)).items()}))
            if collectives is not None:
                collectives.extend(kinds)
            return {"params": _full(new), "loss": metrics["loss"]}

        out["train"] = train_of(TP_TRAIN, mesh)
        meshes = {"(1, 2)": mesh, "(2, 2)": mesh}
        if world == 2:
            for engine in TP_ENGINES:
                out[engine] = round_of(engine)
                out["moe " + engine] = round_of(engine, TP_MOE_ROUND)
            for arch in TP_PREFILL:
                out[arch] = prefill_of(arch, mesh)
            out["vocab"] = vocab_parallel_case(mesh)
            out["refusals"] = refusals(mesh)
            # the routing of the unsharded MoE train step, here
            out["moe slots"] = {"unsharded": routed(
                lambda: steps.make_train_step(tp_config(TP_MOE))(
                    tp_params(TP_MOE), {"tokens": torch.as_tensor(
                        tp_train_tokens(TP_MOE))}))[1]}
        else:
            out["flat f32"] = round_of("flat f32")
            # minitron's 4 query heads over 4 ranks, its 2 kv heads
            # replicated: each rank reads the kv head its query head needs
            wide = make_device_mesh(1, world, "cpu")
            meshes["(1, 4)"] = wide
            out["minitron-8b (1, 4)"] = prefill_of("minitron-8b", wide)
            out["(2, 2) moe aux"] = moe_aux(mesh)
        for key, name, arch in TP_MOE_TRAIN[world]:
            out[key], slots = routed(lambda a=arch, n=name: train_of(
                a, meshes[n]))
            if key == "moe train":
                out["moe slots"]["sharded"] = slots
        # xLSTM and codebooks: train and the three rounds at each mesh
        for name in TP_ZOO_MESHES[world]:
            for arch in TP_ZOO:
                with (f32_slstm_out() if arch == TP_XLSTM
                      else contextlib.nullcontext()):
                    out[zoo_key("train", name, arch)] = train_of(
                        arch, meshes[name])
                    for engine in TP_ENGINES:
                        out[zoo_key(engine, name, arch)] = round_of(
                            engine, zoo_round_arch(arch), meshes[name])
            # and xlstm's train step with its sLSTM output's bf16 cast
            out[zoo_key("train bf16", name, TP_XLSTM)] = train_of(
                TP_XLSTM, meshes[name])
            out["gather " + name] = gather_case(meshes[name])
            out["codebook embed " + name] = codebook_embed_case(meshes[name])
        # ... held against the port's unsharded train step on this rank
        out["train bf16 unsharded"] = steps.make_train_step(
            tp_config(TP_XLSTM))(tp_params(TP_XLSTM), {
                k: torch.as_tensor(v) for k, v in
                tp_train_batch(TP_XLSTM).items()})[0]
        for name, arch, batch, prompt, cache_len in TP_DECODE[world]:
            key = decode_key(name, arch, batch)
            out[key], out[key + " written"] = decode_case(
                meshes[name], arch, batch, prompt, cache_len)
        # the compressed and SCAFFOLD specs, and their base rounds where
        # the cases above did not run them at this mesh; the token splits
        for name in TP_MESHES[world]:
            for engine in TP_SPECS + ("flat f32", "flat int8"):
                out[split_key(engine, name, TP_SPEC_ARCH)] = round_of(
                    engine, TP_SPEC_ARCH, meshes[name])
            for arch in TP_SPLIT:
                # the steps' collectives: all-reduces only
                kinds = out[split_key("train collectives", name, arch)] = []
                out[split_key("train", name, arch)] = train_of(
                    arch, meshes[name], collectives=kinds)
                for engine in TP_ENGINES:
                    out[split_key(engine, name, arch)] = round_of(
                        engine, arch, meshes[name])
                kinds = out[split_key("decode collectives", name, arch)] = []
                out[split_key("decode", name, arch)] = decode_case(
                    meshes[name], arch, *TP_SPLIT_DECODE[1:],
                    collectives=kinds)[0]
        for name, arch, prompt, cache_len in TP_SPLIT_B1[world]:
            kinds = out[split_key("decode b1 collectives", name, arch)] = []
            out[split_key("decode b1", name, arch)] = decode_case(
                meshes[name], arch, 1, prompt, cache_len,
                collectives=kinds)[0]
        if world == 2:
            long_arch = TP_SPLIT[0]
            out["long train"] = train_of(long_arch, mesh, tp_long_batch(
                long_arch, prefill=False))
            l_cfg = tp_config(long_arch)
            l_batch = {k: torch.as_tensor(v) for k, v in tp_long_batch(
                long_arch, prefill=True).items()}
            placed = sharding.distribute_params(tp_params(long_arch), l_cfg,
                                                mesh)
            (logits, cache), kinds = collective_kinds(
                lambda: steps.make_prefill_step(
                    l_cfg, sharding.MeshPolicy(mesh, l_cfg))(placed,
                                                             l_batch))
            # and the port's unsharded prefill here
            logits0, cache0 = steps.make_prefill_step(l_cfg)(
                tp_params(long_arch), l_batch)
            out["long prefill"] = {"logits": _full(logits),
                                   "cache": _full(cache),
                                   "collectives": kinds,
                                   "unsharded": {"logits": logits0,
                                                 "cache": cache0}}
        else:
            out[split_key("train", "(2, 2)", TP_FSDP)] = train_of(
                TP_FSDP, mesh)
            kinds = out[split_key("decode collectives", "(2, 2)",
                                  TP_FSDP)] = []
            out[split_key("decode", "(2, 2)", TP_FSDP)] = decode_case(
                mesh, TP_FSDP, *TP_FSDP_DECODE[1:], collectives=kinds)[0]
        torch.save(out, tag + ".pt")
        dist.destroy_process_group()
    except BaseException:
        with open(tag + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise

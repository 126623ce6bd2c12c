"""The MoE token splits and decode's routing group over ranks: the cases
and the rank processes that run them.

Imports torch and ``repro_torch`` only: ``tests/test_torch_split_moe.py``
spawns :func:`moe_rank_main` in fresh processes (gloo over a
``FileStore``), which import this module and nothing of JAX.  The configs,
weights and inputs are ``tests/torch_mesh_cases.py``'s and
``tests/torch_split_cases.py``'s (numpy seeds, the port's ``init_params``
from a seeded generator); each result is saved whole (``full_tensor``) for
the test to hold against the reference's unsharded steps.
"""

import os

import torch

import torch_mesh_cases as cases
import torch_split_cases as split
from repro_torch.launch.mesh import make_device_mesh

# reduced qwen2-moe (4 experts, top 2, capacity factor 1.25, a shared
# expert) under each token split at each mesh: the train step, the aux
# losses of a forward, prefill and 6 serve steps, and under seq2d and dp2d
# the three rounds; reduced kimi-k2 under seq2d and dp2d at (2, 2)
MOE = "qwen2-moe-a2.7b"
KIMI = "kimi-k2-1t-a32b"
SPLIT_MODES = split.SPLIT_MODES
ROUND_MODES = split.ROUND_MODES
KIMI_MODES = ("seq2d", "dp2d")
MESHES = split.SPLIT_MESHES
ENGINES = split.ENGINES
# capacity factor 1.0 under seq2d (the variant "qwen2-moe-a2.7b:drop"): a
# sequence of 16 has 8 slots an expert, a rank's 8 (or 4) rows 4 (or 2)
DROP = "qwen2-moe-a2.7b:drop"
DROP_MESHES = ("(1, 2)", "(1, 4)")
# decode's one routing group over data without a token split, each
# rank's rows routed with the queue offsets of the data rank before it:
# reduced qwen2-moe and kimi-k2's 2-D experts at (2, 2) (the experts over
# model) and at (2, 1) (a data-only mesh, the card's two ranks), where
# kimi-k2's train step and prefill gather its 2-D experts over data by
# all-reduces too
GROUP_ARCHS = (MOE, "kimi-k2-1t-a32b:2d")
KIMI_2D = "kimi-k2-1t-a32b:2d"


def key(kind: str, mesh: str, arch: str, mode: str = "") -> str:
    return " ".join(x for x in (kind, arch, mode, mesh) if x)


def arch_of(arch: str, mode: str) -> str:
    """The ``torch_mesh_cases.MOE_VARIANTS`` name of ``arch`` under
    ``mode``."""
    return f"{arch}:{mode}"


def aux_case(arch: str, mesh) -> dict:
    """The aux losses of one forward of ``arch`` over ``mesh`` on the train
    batch's inputs, whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import sharding
    from repro_torch.models import transformer as tfm
    cfg = cases.tp_config(arch)
    params = sharding.distribute_params(cases.tp_params(arch), cfg, mesh)
    tokens = torch.as_tensor(split.train_batch(arch.partition(":")[0])[
        "tokens"][:, :-1])
    with torch.no_grad(), implicit_replication():
        _, _, aux = tfm.forward(params, cfg, tokens,
                                policy=sharding.MeshPolicy(mesh, cfg))
    return cases._full(aux)


def drops(fn):
    """``fn()`` with ``mlp._route`` recording, for each call that routes a
    group split across ranks: the pairs the group's routing drops that a
    routing of this rank's rows alone (their own capacity, no offsets)
    keeps, and the pairs it keeps that that routing drops.  Returns
    ``(fn(), [(dropped here only, kept here only), ...])``."""
    from repro_torch.models import mlp
    route, calls = mlp._route, []

    def record(logits, moe, capacity, e_pad=0, group=None):
        r = route(logits, moe, capacity, e_pad, group)
        if group is not None and group.dims:
            alone = route(logits.detach(), moe,
                          mlp._capacity(moe, logits.shape[1]), e_pad)
            n_group = r.slot_idx.shape[1] * r.slot_idx.shape[2]
            n_alone = alone.slot_idx.shape[1] * alone.slot_idx.shape[2]
            kept, kept_alone = r.token_slot < n_group, \
                alone.token_slot < n_alone
            calls.append((int((kept_alone & ~kept).sum()),
                          int((kept & ~kept_alone).sum())))
        return r
    mlp._route = record
    try:
        return fn(), calls
    finally:
        mlp._route = route


def decode_case(arch: str, mesh, out: dict, name: str,
                collectives: list) -> None:
    """``torch_mesh_cases.decode_case`` at ``torch_split_cases``' batch,
    prompt and cache: its whole results in ``out[name]``, and this rank's
    routing of each serve step beside the unsharded run's in
    ``out["routing " + name]`` (they differ by rank)."""
    out[name], apart = cases.decode_case(mesh, arch, split.B, split.PROMPT,
                                         split.CACHE_LEN, collectives)
    out["routing " + name] = {k: apart[k] for k in ("routing",
                                                    "unsharded routing")}


def moe_rank_main(rank: int, world: int, store_path: str,
                  out_dir: str) -> None:
    """One rank of the MoE token splits: gloo over a FileStore; at world
    size 2 the (1, 2) mesh, at 4 the (1, 4) and (2, 2) meshes; at each,
    reduced qwen2-moe under each mode (the train step and its collectives,
    the aux losses, the prefill and serve steps and their collectives,
    under seq2d and dp2d the three rounds), and at (1, 2) and (1, 4) the
    capacity-drop case's train step under seq2d and its drops; at (2, 2)
    reduced kimi-k2 under seq2d and dp2d (train, aux, prefill and serve);
    decode's group over data without a token split at (2, 2) and, at world
    size 2, at (2, 1) (with kimi-k2's train step there), each with its
    collectives.  Writes ``moe<world>_rank<r>.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)

    def body():
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world))
        out = {}
        meshes = split._meshes(world)
        for name, mesh in meshes.items():
            for mode in SPLIT_MODES:
                a = arch_of(MOE, mode)
                kinds = out[key("train collectives", name, MOE, mode)] = []
                out[key("train", name, MOE, mode)] = split.train_case(
                    a, mesh, kinds)
                out[key("aux", name, MOE, mode)] = aux_case(a, mesh)
                kinds = out[key("decode collectives", name, MOE, mode)] = []
                decode_case(a, mesh, out, key("decode", name, MOE, mode),
                            kinds)
                if mode not in ROUND_MODES:
                    continue
                for engine in ENGINES:
                    out[key(engine, name, MOE, mode)] = split.round_case(
                        a, engine, mesh)
            if name in DROP_MESHES:
                out[key("train", name, DROP)], out[key(
                    "drops", name, DROP)] = drops(
                    lambda m=mesh: split.train_case(DROP + "-seq2d", m))
        if world == 4:
            mesh = meshes["(2, 2)"]
            for mode in KIMI_MODES:
                a = arch_of(KIMI, mode)
                kinds = out[key("train collectives", "(2, 2)", KIMI,
                                mode)] = []
                out[key("train", "(2, 2)", KIMI, mode)] = split.train_case(
                    a, mesh, kinds)
                out[key("aux", "(2, 2)", KIMI, mode)] = aux_case(a, mesh)
                kinds = out[key("decode collectives", "(2, 2)", KIMI,
                                mode)] = []
                decode_case(a, mesh, out, key("decode", "(2, 2)", KIMI,
                                              mode), kinds)
            group = {"(2, 2)": mesh}
        else:
            group = {"(2, 1)": make_device_mesh(2, 1, "cpu")}
        for name, mesh in group.items():
            for a in GROUP_ARCHS:
                if a == KIMI_2D and name == "(2, 1)":
                    kinds = out[key("train collectives", name, a)] = []
                    out[key("train", name, a)] = split.train_case(a, mesh,
                                                                  kinds)
                kinds = out[key("decode collectives", name, a)] = []
                decode_case(a, mesh, out, key("decode", name, a), kinds)
        return out
    split._run(os.path.join(out_dir, f"moe{world}_rank{rank}"), body)

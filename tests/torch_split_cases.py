"""The hybrid and audio token splits and the live pod axis: the cases and
the rank processes that run them.

Imports torch and ``repro_torch`` only: ``tests/test_torch_split_hybrid_
audio.py`` and ``tests/test_torch_pod.py`` spawn :func:`split_rank_main`
and :func:`pod_rank_main` in fresh processes (gloo over a ``FileStore``),
which import this module and nothing of JAX.  The configs, weights and
inputs are ``tests/torch_mesh_cases.py``'s (numpy seeds, the port's
``init_params`` from a seeded generator); each result is saved whole
(``full_tensor``) for the test to hold against the reference's unsharded
steps.
"""

import os
import traceback

import numpy as np
import torch

import torch_mesh_cases as cases
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.tree import tree_map

# reduced recurrentgemma-2b (two RG-LRU layers and a local attention layer
# of window 16, one kv head), reduced musicgen-large (2 codebooks, 4
# conditioning rows) and reduced xlstm-1.3b (an mLSTM and an sLSTM layer,
# mlstm_chunk 4, its sLSTM output kept in f32: cases.f32_slstm_out), f32,
# under each token split at each mesh; the round step under seq2d and dp2d
# (a seq2d_fsdp cohort is refused)
SPLIT_ARCHS = ("recurrentgemma-2b", "musicgen-large", "xlstm-1.3b")
SPLIT_MODES = ("seq2d", "dp2d", "seq2d_fsdp")
# the config of each arch's unsharded reference steps (xlstm's at the
# splits' mlstm_chunk 4)
REF_ARCH = {"xlstm-1.3b": "xlstm-1.3b:chunk4"}
ROUND_MODES = ("seq2d", "dp2d")
SPLIT_MESHES = {2: ("(1, 2)",), 4: ("(1, 4)", "(2, 2)")}
ENGINES = cases.TP_ENGINES
# batch 4: dp2d splits it over (data, model) at every mesh; 16 tokens (a
# train step's 17): 4 rows a rank at (1, 4), one whole conv halo of 3;
# the prompt 16 (+ 4 conditioning rows), 6 serve steps into a cache of 32
# (the ring of 16 wraps), the round K = 2 (one simple), 1 local step
B, SEQ, K, PROMPT, CACHE_LEN = 4, 16, 2, 16, 32


def split_arch(arch: str, mode: str) -> str:
    """The ``torch_mesh_cases.MOE_VARIANTS`` name of ``arch`` under
    ``mode``."""
    return f"{arch}:{mode}"


def split_key(kind: str, mesh: str, arch: str, mode: str) -> str:
    return f"{kind} {arch} {mode} {mesh}"


def _codebooks(arch: str) -> tuple:
    nc = cases.tp_config(arch).n_codebooks
    return (nc,) if nc > 1 else ()


def train_batch(arch: str) -> dict:
    """(B, SEQ + 1) tokens (and each codebook's), and a frontend's rows."""
    cfg = cases.tp_config(arch)
    rng = np.random.default_rng(31)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(
        B, SEQ + 1) + _codebooks(arch)).astype(np.int32)}
    if cfg.frontend is not None:
        batch["extra_embeds"] = rng.standard_normal(
            (B, cfg.frontend.n_tokens, cfg.frontend.d_in)).astype(np.float32)
    return batch


def round_inputs(arch: str, k: int = K) -> tuple:
    """``(data (K, B, 1, SEQ + 1[, NC]), is_simple)``."""
    rng = np.random.default_rng(32)
    data = rng.integers(0, cases.tp_config(arch).vocab_size, size=(
        k, B, 1, SEQ + 1) + _codebooks(arch)).astype(np.int32)
    return data, np.arange(k) < k // 2


def _batch(np_batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in np_batch.items()}


def train_case(arch: str, mesh, collectives: list = None) -> dict:
    """One train step of ``arch`` (a ``MOE_VARIANTS`` name) over
    ``mesh``: the new parameters whole and the loss; with
    ``collectives`` the names of the collectives the step issues."""
    from repro_torch.launch import sharding, steps
    cfg = cases.tp_config(arch)
    params = sharding.distribute_params(cases.tp_params(arch), cfg, mesh)
    step = steps.make_train_step(cfg, sharding.MeshPolicy(mesh, cfg))
    (new, metrics), kinds = cases.collective_kinds(lambda: step(
        params, _batch(train_batch(arch.partition(":")[0]))))
    if collectives is not None:
        collectives.extend(kinds)
    return {"params": cases._full(new), "loss": metrics["loss"]}


def round_case(arch: str, engine: str, mesh, k: int = K) -> dict:
    """One round of ``arch`` over ``mesh`` (a cohort of K copies of the
    seeded weights, ``distribute_cohort``-ed where the model axis is
    live): the new model whole and the loss."""
    from repro_torch.launch import sharding, steps
    cfg = cases.tp_config(arch)
    policy = sharding.MeshPolicy(mesh, cfg)
    cohort = tree_map(lambda x: x[None].expand((k,) + x.shape),
                      cases.tp_params(arch))
    if policy.model_live:
        cohort = sharding.distribute_cohort(cohort, cfg, mesh)
    data, simple = round_inputs(arch.partition(":")[0], k)
    new_c, loss = steps.make_fed_round_step(
        cfg, policy, local_steps=1, engine=cases.tp_engine(engine))(
            cohort, torch.as_tensor(data), torch.as_tensor(simple))
    return {"params": cases._full(new_c), "loss": loss}


def decode_case(arch: str, mesh, collectives: list = None) -> dict:
    """``torch_mesh_cases.decode_case`` at batch ``B``, prompt ``PROMPT``,
    cache ``CACHE_LEN``: the prefill's logits and cache, then the serve
    steps' logits, exit logits and caches, whole."""
    return cases.decode_case(mesh, arch, B, PROMPT, CACHE_LEN,
                             collectives)[0]


def _meshes(world: int) -> dict:
    if world == 2:
        return {"(1, 2)": make_device_mesh(1, 2, "cpu")}
    return {"(1, 4)": make_device_mesh(1, 4, "cpu"),
            "(2, 2)": make_device_mesh(2, 2, "cpu")}


def split_refusals(mesh) -> dict:
    """The token splits of the ``moe`` and ``ssm`` arch types, which once
    raised: whether the policy splits the tokens, or what it raises."""
    from repro_torch.launch import sharding
    out = {}
    for arch in ("qwen2-moe-a2.7b", "xlstm-1.3b"):
        for mode in SPLIT_MODES:
            cfg = cases.tp_config(arch).with_overrides(attn_shard=mode)
            out[f"{mode} {arch}"] = cases._raises(
                lambda c=cfg: sharding.MeshPolicy(mesh, c).token_split)
    return out


def slstm_out(arch: str):
    """xlstm's sLSTM output kept in f32 (``cases.f32_slstm_out``), as the
    reference's steps run it here; nothing for another arch."""
    import contextlib
    return cases.f32_slstm_out() if arch.startswith("xlstm") \
        else contextlib.nullcontext()


def mode_cases(arch: str, mode: str, name: str, mesh) -> dict:
    """``arch`` under ``mode`` on ``mesh`` (named ``name``): the train
    step and its collectives, the prefill and serve steps
    (:func:`decode_case`) and their collectives, and under seq2d and dp2d
    the three round engines."""
    a = split_arch(arch, mode)
    out = {}
    kinds = out[split_key("train collectives", name, arch, mode)] = []
    out[split_key("train", name, arch, mode)] = train_case(a, mesh, kinds)
    kinds = out[split_key("decode collectives", name, arch, mode)] = []
    out[split_key("decode", name, arch, mode)] = decode_case(a, mesh, kinds)
    if mode in ROUND_MODES:
        for engine in ENGINES:
            out[split_key(engine, name, arch, mode)] = round_case(
                a, engine, mesh)
    return out


def _run(tag: str, body) -> None:
    """``body()`` saved to ``<tag>.pt``, or its traceback to
    ``<tag>.err`` (and raised)."""
    import torch.distributed as dist
    try:
        out = body()
        torch.save(out, tag + ".pt")
        dist.destroy_process_group()
    except BaseException:
        with open(tag + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def split_rank_main(rank: int, world: int, store_path: str,
                    out_dir: str) -> None:
    """One rank of the hybrid and audio token splits: gloo over a
    FileStore; at world size 2 the (1, 2) mesh, at 4 the (1, 4) and
    (2, 2) meshes; at each, each arch under each mode: the train step and
    its collectives, the prefill and serve steps (:func:`decode_case`)
    and their collectives, and under seq2d and dp2d the three round
    engines; at world size 2 also the refusals.  Writes
    ``split<world>_rank<r>.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)

    def body():
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world))
        out = {}
        meshes = _meshes(world)
        for name, mesh in meshes.items():
            for arch in SPLIT_ARCHS:
                with slstm_out(arch):
                    for mode in SPLIT_MODES:
                        out.update(mode_cases(arch, mode, name, mesh))
        if world == 2:
            out["refusals"] = split_refusals(meshes["(1, 2)"])
        return out
    _run(os.path.join(out_dir, f"split{world}_rank{rank}"), body)


# ---------------------------------------------------------------------------
# the live pod axis
# ---------------------------------------------------------------------------

# the (2, 2, 1) pod x data round: tests/test_fedround.py's tiny config
# (torch_mesh_cases.CFG), one chunk of K clients (K = 6: 2, 1, 2, 1 rows a
# rank, nested as DTensor places a cohort; K = 8: 2 each); the (2, 1, 2)
# pod x model cells: reduced gemma2-2b's train, rounds, prefill and serve
# (the (2, 2) decode case: batch 2, 20 prompt tokens, cache 42), reduced
# qwen2-moe's train step, reduced recurrentgemma-2b under seq2d (the batch
# over pod, the sequence over model: train, the f32 round, prefill and
# serve)
POD_KS = (6, 8)
POD_ARCH, POD_MOE, POD_SPLIT = "gemma2-2b", "qwen2-moe-a2.7b", \
    "recurrentgemma-2b:seq2d"
POD_DECODE = (2, 20, 42)


def tiny_params():
    """The tiny config's weights (``tests/test_torch_mesh_dist.py``'s)."""
    from repro_torch.models import transformer as tfm
    return tfm.init_params(torch.Generator().manual_seed(0), cases.CFG)


def pod_round(policy, k: int, engine: str) -> dict:
    """The tiny config's round over the pod x data mesh, one chunk of
    ``k``: the new model, the loss, the rows this rank trained
    (``MeshPolicy.data_rows``) and the rows ``distribute_tensor`` places
    on it under ``cohort_specs``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding, steps
    params = tiny_params()
    cohort, data, simple = cases.round_inputs(params, k)
    step = steps.make_fed_round_step(cases.CFG, policy,
                                     local_steps=cases.STEPS,
                                     engine=cases.tp_engine(engine))
    new_c, loss = step(cohort, data, simple)
    mesh = policy.device_mesh
    spec = sharding.cohort_specs(params, cases.CFG, mesh)["final_norm"][
        "scale"]
    ids = torch.arange(k, dtype=torch.float32)[:, None].expand(
        k, cases.TINY["d_model"]).contiguous()
    placed = distribute_tensor(ids, mesh, sharding.to_placements(
        spec, mesh)).to_local()[:, 0].tolist()
    return {"params": new_c, "loss": loss,
            "rows": list(range(*policy.data_rows(k))),
            "placed": [int(v) for v in placed]}


def pod_rank_main(rank: int, world: int, store_path: str,
                  out_dir: str) -> None:
    """One rank of the live pod axis at world size 4: the (2, 2, 1) mesh's
    rounds (:func:`pod_round` at each K and engine, the data group's size
    and this rank's coordinate), then the (2, 1, 2) mesh's cells.  Writes
    ``pod_rank<r>.pt``."""
    import torch.distributed as dist
    from repro_torch.launch import sharding
    torch.set_num_threads(1)

    def body():
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world))
        out = {}
        mesh = make_device_mesh(2, 1, "cpu", n_pod=2)
        policy = sharding.MeshPolicy(mesh, cases.CFG)
        for k in POD_KS:
            for engine in ENGINES:
                out[f"round K{k} {engine}"] = pod_round(policy, k, engine)
        out["group"] = (dist.get_world_size(policy.data_group()),
                        policy.data_coordinate())
        wide = make_device_mesh(1, 2, "cpu", n_pod=2)
        wide_policy = sharding.MeshPolicy(wide, cases.tp_config(POD_ARCH))
        out["wide group"] = (dist.get_world_size(wide_policy.data_group()),
                             wide_policy.data_coordinate())
        out["train"] = train_case(POD_ARCH, wide)
        for engine in ENGINES:
            out[engine] = round_case(POD_ARCH, engine, wide)
        out["decode"] = cases.decode_case(wide, POD_ARCH, *POD_DECODE)[0]
        out["moe train"] = train_case(POD_MOE, wide)
        kinds = out["split collectives"] = []
        out["split train"] = train_case(POD_SPLIT, wide, kinds)
        out["split flat f32"] = round_case(POD_SPLIT, "flat f32", wide)
        out["split decode"] = decode_case(POD_SPLIT, wide, kinds)
        return out
    _run(os.path.join(out_dir, f"pod_rank{rank}"), body)

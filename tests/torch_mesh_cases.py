"""The cohort-sharded round's cases and the rank processes that run them.

Imports torch and ``repro_torch`` only: ``tests/test_torch_mesh_dist.py``
spawns :func:`rank_main` in fresh processes (``torch.multiprocessing``),
which import this module and nothing of JAX.  Inputs come from numpy
seeds; the model is ``tests/test_fedround.py``'s tiny config, the weights
the port's ``init_params`` from a seeded generator (saved by the test,
which hands the reference a ``repro_torch.interop`` copy).
"""

import os
import traceback

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.tree import tree_map

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
    ``distribute_tensor``; then whether a (1, world) mesh with a model
    axis raises.  Writes ``rank<r>.pt`` (or ``rank<r>.err``)."""
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
        try:
            sharding.MeshPolicy(make_device_mesh(1, world, "cpu"), CFG)
            out["model_axis"] = "no error"
        except NotImplementedError as e:
            out["model_axis"] = f"NotImplementedError: {e}"
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise

"""Dry-run of a complete FedHeN ROUND at production scale, on ``meta``
tensors: the port of ``repro.launch.fedround_dryrun``.

The paper's communication pattern on the mesh: a cohort of K clients is
simulated client-parallel over the ``data`` (and ``pod``) axis of the
reference's production mesh shape, each client runs its local SGD steps,
and the masked fold reduces the cohort axis, which is the round's
all-reduce over the data ranks (``steps.make_fed_round_step`` under a live
``MeshPolicy``; ``aggregate.allreduce_state``).  K is the data size, or
with ``cohort_chunk`` four times it rounded up to ``lcm(chunk, data
size)``, as the reference rounds it.

What it reports for one data rank, without a card:

* the roofline walk's counts (``roofline/torch_walk``) over a ``meta`` run
  of rank 0's share of the cohort: the clients ``Shard(0)`` gives rank 0
  of each chunk (``sharding.shard_rows``), trained and folded by the same
  round step, the first half of the cohort simple;
* ``collective_bytes``: the exact bytes of the round's all-reduce, every
  tensor of the engine state a fold adds into plus the loss sum
  (``aggregate.allreduce_bytes``);
* the model's bytes (one client's upload).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.fedround_dryrun \\
        [arch] [local_steps] [single|multi] [cohort_chunk]
"""

from __future__ import annotations

import math
import sys
import time

import torch

from repro_torch import configs
from repro_torch.core import aggregate, comm, flatten, masking
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_fed_round_step
from repro_torch.models import transformer as tfm
from repro_torch.roofline import torch_walk
from repro_torch.tree import tree_leaves, tree_map

# one block size for both the step's layout and the flat mask built here
AGG_BLOCK_N = 2048
SEQ, BATCH = 1024, 4


def make_round_step(cfg, policy, *, local_steps: int, lr=0.1, clip=10.0,
                    cohort_chunk: int = 0, agg_block_n: int = AGG_BLOCK_N):
    """The streamed FedHeN round step (see ``steps.make_fed_round_step``)."""
    return make_fed_round_step(
        cfg, policy, local_steps=local_steps, lr=lr,
        clip_norm=clip, cohort_chunk=cohort_chunk,
        engine=aggregate.EngineSpec(algorithm="fedhen",
                                    block_n=agg_block_n,
                                    wire=comm.WireSpec("float32", 128)))


def cohort_size(data_size: int, cohort_chunk: int) -> int:
    """The reference's K: the data size, or with chunking four times it,
    rounded up so that both the chunk and the data size divide it."""
    if cohort_chunk <= 0:
        return data_size
    step = math.lcm(cohort_chunk, data_size)
    return -(-4 * data_size // step) * step


def rank_share(k_clients: int, cohort_chunk: int, data_size: int,
               index: int = 0):
    """``(clients, chunk)`` of data rank ``index``: the rows
    ``Shard(0)`` gives it of each chunk, as one cohort it streams in
    chunks of its per-chunk share."""
    chunk = k_clients if cohort_chunk <= 0 else cohort_chunk
    lo, hi = sharding.shard_rows(chunk, index, data_size)
    return (k_clients // chunk) * (hi - lo), hi - lo


def run(arch: str = "gemma2-2b", local_steps: int = 2, multi: bool = False,
        cohort_chunk: int = 0, cfg=None, seq: int = SEQ,
        batch: int = BATCH) -> dict:
    """The dry-run's numbers (module docstring) as a dict."""
    cfg = cfg or configs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi)
    data_size = mesh.shape["data"] * mesh.shape.get("pod", 1)
    k_clients = cohort_size(data_size, cohort_chunk)
    k_rank, chunk_rank = rank_share(k_clients, cohort_chunk, data_size)

    params = tfm.abstract_params(cfg)
    cohort = tree_map(lambda x: x[None].expand((k_rank,) + x.shape), params)
    tok = torch.int32
    shape = (k_rank, batch, local_steps, seq + 1) + (
        (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    data = torch.empty(shape, dtype=tok, device="meta")
    first = k_clients // 2          # rank 0's rows are the cohort's first
    is_simple = torch.arange(k_rank) < first
    layout = flatten.layout_of(params, total_multiple=AGG_BLOCK_N)
    flat_mask = flatten.pack_mask(
        layout, masking.transformer_subnet_mask(params, cfg), "meta")
    step = make_round_step(cfg, sharding.MeshPolicy(mesh, cfg),
                           local_steps=local_steps, cohort_chunk=chunk_rank)
    t0 = time.time()
    _, walk = torch_walk.walk(step, cohort, data, is_simple, flat_mask)
    t_walk = time.time() - t0
    init = aggregate.make_engine(aggregate.EngineSpec(
        algorithm="fedhen", block_n=AGG_BLOCK_N, mask=masking.
        transformer_subnet_mask(params, cfg), layout=layout,
        flat_mask=flat_mask, wire=comm.WireSpec("float32", 128)))[0]
    coll = aggregate.allreduce_bytes(
        init(params), torch.zeros((), device="meta"))
    return {"arch": cfg.name, "mesh": "2x16x16" if multi else "16x16",
            "data_size": data_size, "k_clients": k_clients,
            "cohort_chunk": cohort_chunk, "rank_clients": k_rank,
            "rank_chunk": chunk_rank, "local_steps": local_steps,
            "flops": walk["flops"], "hbm_bytes": walk["hbm_bytes"],
            "kernels": walk["kernels"], "collective_bytes": coll,
            "collective": "one all_reduce(SUM) over data",
            "model_bytes": sum(x.numel() * x.element_size()
                               for x in tree_leaves(params)),
            "n_flat": layout.n_flat, "t_walk_s": t_walk}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    arch = argv[0] if len(argv) > 0 else "gemma2-2b"
    local_steps = int(argv[1]) if len(argv) > 1 else 2
    multi = len(argv) > 2 and argv[2] == "multi"
    cohort_chunk = int(argv[3]) if len(argv) > 3 else 0
    r = run(arch, local_steps, multi, cohort_chunk)
    print(f"\nFedHeN round dry-run (meta): {r['arch']}, K={r['k_clients']} "
          f"clients x {local_steps} local steps, mesh {r['mesh']}"
          f"{f', chunk={cohort_chunk}' if cohort_chunk else ''} (walked "
          f"in {r['t_walk_s']:.0f} s)")
    print(f"  data rank 0 trains {r['rank_clients']} clients in chunks of "
          f"{r['rank_chunk']}: {r['flops']:.3e} flops, "
          f"{r['hbm_bytes'] / 2**30:.2f} GiB of HBM traffic")
    print(f"  per-rank collective bytes: {r['collective_bytes'] / 2**30:.2f}"
          f" GiB ({r['collective']})")
    print(f"  model size (1 client upload): {r['model_bytes'] / 2**30:.2f} "
          f"GiB; the aggregation all-reduce is the round's communication")
    return r


if __name__ == "__main__":
    main()

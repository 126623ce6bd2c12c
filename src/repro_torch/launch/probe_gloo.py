"""Which collectives gloo takes on CUDA tensors: two ranks sharing the one
card, each collective in its own pair of processes, so a crash names its
collective (exit codes -11 on both ranks: a segfault; ``faulthandler``
prints where).

The model-axis phase of ``chip_smoke.py`` runs two ranks on one card over
gloo (NCCL refuses two ranks on one device); this probe says which of the
c10d collectives, the functional collectives DTensor issues, and a
DTensor redistribute (``Partial`` and ``Shard`` to ``Replicate``) work
there.

Usage (on a machine with a CUDA card):
    PYTHONPATH=src python -m repro_torch.launch.probe_gloo [name ...]
"""
import faulthandler
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def probe(rank, world, store, name):
    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    x = torch.full((4, 8), float(rank + 1), device="cuda")
    if name == "all_reduce":
        dist.all_reduce(x)
        out = x
    elif name == "all_gather_into_tensor":
        out = torch.empty((8, 8), device="cuda")
        dist.all_gather_into_tensor(out, x)
    elif name == "reduce_scatter_tensor":
        out = torch.empty((2, 8), device="cuda")
        dist.reduce_scatter_tensor(out, x)
    elif name.startswith("funcol"):
        import torch.distributed._functional_collectives as fc
        g = dist.group.WORLD
        op = name.split(":")[1]
        if op == "all_reduce":
            out = fc.all_reduce(x, "sum", g)
        elif op == "all_gather":
            out = fc.all_gather_tensor(x, 0, g)
        else:
            out = fc.reduce_scatter_tensor(x, "sum", 0, g)
        out = fc.wait_tensor(out)
    elif name.startswith("dtensor"):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              DTensor)
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                          mesh_dim_names=("data", "model"))
        d = DTensor.from_local(x, mesh, [Replicate(), Partial()])
        out = d.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        s = DTensor.from_local(x, mesh, [Replicate(), Shard(1)])
        out = s.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    torch.cuda.synchronize()
    print(f"probe {name} rank {rank}: ok {tuple(out.shape)} "
          f"{float(out.sum()):.1f}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    print(torch.__version__, torch.version.cuda, flush=True)
    names = sys.argv[1:] or ["all_reduce", "all_gather_into_tensor",
                             "reduce_scatter_tensor", "funcol:all_reduce",
                             "funcol:all_gather", "funcol:reduce_scatter",
                             "dtensor"]
    ctx = mp.get_context("spawn")
    for name in names:
        d = tempfile.mkdtemp()
        ps = [ctx.Process(target=probe, args=(r, 2, d + "/s", name))
              for r in range(2)]
        for p in ps:
            p.start()
        for p in ps:
            p.join(120)
        print(f"== {name}: exit codes {[p.exitcode for p in ps]}",
              flush=True)
        for p in ps:
            if p.is_alive():
                p.kill()

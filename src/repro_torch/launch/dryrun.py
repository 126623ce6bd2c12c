"""Production-mesh dry-run on ``meta`` tensors: the port of
``repro.launch.dryrun``.

For an (architecture x input shape x mesh) combination: abstract params
and caches (``transformer.abstract_params``, ``init_cache(...,
device="meta")``) and the input shape's ``meta`` batch
(``configs.input_specs``); their specs at the reference's production mesh
shape (``launch/mesh.make_production_mesh``: 16 x 16 or 2 x 16 x 16) and
the bytes a chip holds under them; then the shape's step
(``steps.step_for_shape`` under a ``MeshPolicy`` of that mesh) run once
on the ``meta`` tensors under the roofline walk (``roofline/torch_walk``:
every op and every kernel wrapper's reported work), and
``roofline/analysis.make_record`` over the result, with the H100's
constants.  Nothing is allocated and no card is needed.

**Over the model axis.**  A train, prefill or decode step on a mesh whose
model axis is larger than 1 (every config runs there) is walked as one
rank of the mesh: a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``, rank 0; no rank runs
and no byte moves), a ``DeviceMesh`` over it, the parameters, the batch
and (decode) the cache as ``meta`` DTensors
(``sharding.distribute_params``, ``batch_specs``, ``distribute_cache``),
the step under a ``MeshPolicy`` of that live mesh; a serve step decodes
position ``seq_len - 1``, as the whole-step walk does.  The walk then
counts rank 0's own work and every collective it takes part in
(``roofline/torch_walk``), so ``flops_per_chip`` is that rank's and
``coll_bytes_per_chip`` is the collectives' result bytes on it
(``analysis.collective_bytes``), and ``bottleneck`` includes the
collective term.

Other combinations (a mesh whose model axis is 1) differ from the
reference's compiled dry-run in three parts, and the record says so
(``notes``): ``flops_per_chip`` is the walk's global count split evenly
over the chips; ``coll_bytes_per_chip`` is ``None`` (the port issues no
collective there), so ``bottleneck`` is over compute and memory;
``peak_memory_per_chip`` is params + cache + batch bytes per chip (in
both kinds of record).  ``t_walk_s`` is the host time of the meta run.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
        --shape train_4k --mesh single,multi --out results/dryrun_torch

``main`` writes one JSON record a combination under ``--out`` (relative
to the working directory, so each checkout keeps its own) and skips a
combination whose record is already there: remove it to walk it again.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     model_axis_size)
from repro_torch.models import transformer as tfm
from repro_torch.roofline import analysis, torch_walk
from repro_torch.tree import tree_map


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape):
    """A live ``DeviceMesh`` of ``mesh``'s shape over a fake process group
    of its size, this process as rank 0: collectives are issued and
    counted but move nothing.  Raises if a process group is already
    initialised; destroys the fake one on exit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs no process group initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        sizes = tuple(mesh.shape[a] for a in mesh.axis_names)
        yield DeviceMesh("cpu", torch.arange(mesh.size).reshape(sizes),
                         mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def walks_per_chip(cfg: ModelConfig, shape: InputShape, mesh) -> bool:
    """Whether :func:`lower_one` walks this combination as one rank of a
    live mesh (module docstring)."""
    return model_axis_size(mesh) > 1


def _walk_per_chip(cfg, shape, mesh, in_specs, cache, window_override):
    """The step's walk as rank 0 of a fake mesh of ``mesh``'s shape."""
    with fake_mesh(mesh) as device_mesh:
        policy = sharding.MeshPolicy(device_mesh, cfg)
        params = sharding.distribute_params(tfm.abstract_params(cfg), cfg,
                                            device_mesh)
        batch = tree_map(lambda x, spec: sharding.distribute_leaf(
            x, device_mesh, sharding.to_placements(spec, device_mesh)),
            in_specs, sharding.batch_specs(in_specs, mesh, policy))
        step = steps.step_for_shape(cfg, shape, policy,
                                    window_override=window_override)
        if shape.kind != "decode":
            return torch_walk.walk(step, params, batch)[1]
        cache = sharding.distribute_cache(cache, cfg, device_mesh)
        return torch_walk.walk(step, params, cache, batch,
                               shape.seq_len - 1)[1]


def lower_one(arch: str, shape: InputShape, *, multi_pod: bool = False,
              mesh: Optional[MeshShape] = None,
              cfg_override: Optional[ModelConfig] = None,
              verbose: bool = True) -> dict:
    """Walk one (arch, shape, mesh) combination on ``meta``; return the
    record (a dict).  ``mesh`` replaces the production mesh (a shape such
    as ``(2, 2)`` for the tests)."""
    cfg = cfg_override or configs.get_config(arch)
    longctx = configs.needs_longctx_variant(cfg, shape)
    window_override = cfg.longctx_window if longctx else None

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    policy = sharding.MeshPolicy(mesh, cfg)
    in_specs = configs.input_specs(cfg, shape)
    params = tfm.abstract_params(cfg)
    p_bytes = sharding.bytes_per_chip(
        params, sharding.param_specs(params, cfg, mesh), mesh)
    b_bytes = sharding.bytes_per_chip(
        in_specs, sharding.batch_specs(in_specs, mesh, policy), mesh)
    step = steps.step_for_shape(cfg, shape, policy,
                                window_override=window_override)

    c_bytes, cache = 0, None
    per_chip = walks_per_chip(cfg, shape, mesh)
    t0 = time.time()
    if shape.kind != "train":
        cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               window_override=window_override,
                               device="meta")
        c_bytes = sharding.bytes_per_chip(
            cache, sharding.cache_specs(cache, cfg, mesh), mesh)
    if per_chip:
        walk = _walk_per_chip(cfg, shape, mesh, in_specs, cache,
                              window_override)
    elif shape.kind == "decode":
        _, walk = torch_walk.walk(step, params, cache, in_specs,
                                  shape.seq_len - 1)
    else:
        _, walk = torch_walk.walk(step, params, in_specs)
    t_walk = time.time() - t0
    sizes = [str(mesh.shape[a]) for a in mesh.axis_names]
    rec = analysis.make_record(
        arch=cfg.name, shape=shape, mesh_name="x".join(sizes), chips=chips,
        walk=walk, cfg=cfg, longctx_variant=longctx,
        param_bytes_chip=p_bytes, cache_bytes_chip=c_bytes,
        batch_bytes_chip=b_bytes, per_chip=per_chip)
    d = rec.to_dict()
    d["t_walk_s"] = round(t_walk, 1)
    if verbose:
        coll = ("None" if rec.coll_bytes_per_chip is None
                else f"{rec.coll_bytes_per_chip:.3e}")
        print(f"[dryrun] {cfg.name} x {shape.name} x {d['mesh']}: OK  "
              f"flops/chip={rec.flops_per_chip:.3e}  "
              f"peak={rec.peak_memory_per_chip / 2 ** 30:.2f}GiB  "
              f"coll={coll}  bottleneck={rec.bottleneck}  "
              f"(walk {t_walk:.1f}s)", flush=True)
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="comma list or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", help="single,multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--stop-on-error", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma list of cfg overrides, e.g. "
                         "attn_shard=seq2d,mlstm_chunk=512 (perf variants)")
    args = ap.parse_args(argv)

    overrides = {}
    moe_overrides = {}
    for kv in args.override.split(","):
        if not kv:
            continue
        k, v = kv.split("=")
        v = int(v) if v.lstrip("-").isdigit() else v
        if k.startswith("moe_"):
            moe_overrides[k[4:]] = v
        else:
            overrides[k] = v

    archs = list(configs.ARCH_NAMES) if args.arch == "all" \
        else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    meshes = args.mesh.split(",")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name in shapes:
            shape = INPUT_SHAPES[shape_name]
            for mesh_name in meshes:
                # an override variant gets its own record, so that a
                # base run's record is never read as the variant's
                tag = f"{arch}_{shape_name}_{mesh_name}" + (
                    "_" + args.override.replace("=", "-").replace(",", "_")
                    if args.override else "")
                out_path = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[dryrun] {tag}: {out_path} exists (an earlier "
                          f"run), skipping", flush=True)
                    continue
                try:
                    cfg_override = None
                    if overrides or moe_overrides:
                        cfg_override = configs.get_config(arch) \
                            .with_overrides(**overrides)
                        if moe_overrides and cfg_override.moe:
                            cfg_override = cfg_override.with_overrides(
                                moe=dataclasses.replace(cfg_override.moe,
                                                        **moe_overrides))
                    rec = lower_one(arch, shape,
                                    multi_pod=(mesh_name == "multi"),
                                    cfg_override=cfg_override)
                    with open(out_path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[dryrun] {tag}: FAILED {e!r}", flush=True)
                    traceback.print_exc()
                    if args.stop_on_error:
                        return 1
    print(f"[dryrun] done; {len(failures)} failures", flush=True)
    for tag, err in failures:
        print(f"  FAIL {tag}: {err}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

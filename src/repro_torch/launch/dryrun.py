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

Three parts differ from the reference's compiled dry-run, and the record
says so (``notes``): ``flops_per_chip`` is the walk's global count split
evenly over the chips; ``coll_bytes_per_chip`` is ``None`` (the port
issues no collective over the model axis yet), so ``bottleneck`` is over
compute and memory; ``peak_memory_per_chip`` is params + cache + batch
bytes per chip.  ``t_walk_s`` is the host time of the meta run.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
        --shape train_4k --mesh single,multi --out results/dryrun_torch

``main`` writes one JSON record a combination under ``--out`` (relative
to the working directory, so each checkout keeps its own) and skips a
combination whose record is already there: remove it to walk it again.
"""

from __future__ import annotations

import argparse
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.roofline import analysis, torch_walk


def lower_one(arch: str, shape: InputShape, *, multi_pod: bool,
              cfg_override: Optional[ModelConfig] = None,
              verbose: bool = True) -> dict:
    """Walk one (arch, shape, mesh) combination on ``meta``; return the
    record (a dict)."""
    cfg = cfg_override or configs.get_config(arch)
    longctx = configs.needs_longctx_variant(cfg, shape)
    window_override = cfg.longctx_window if longctx else None

    mesh = make_production_mesh(multi_pod=multi_pod)
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

    c_bytes = 0
    t0 = time.time()
    if shape.kind == "train":
        _, walk = torch_walk.walk(step, params, in_specs)
    else:
        cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               window_override=window_override,
                               device="meta")
        c_bytes = sharding.bytes_per_chip(
            cache, sharding.cache_specs(cache, cfg, mesh), mesh)
        if shape.kind == "decode":
            _, walk = torch_walk.walk(step, params, cache, in_specs,
                                      shape.seq_len - 1)
        else:
            _, walk = torch_walk.walk(step, params, in_specs)
        del cache
    t_walk = time.time() - t0
    rec = analysis.make_record(
        arch=cfg.name, shape=shape, mesh_name="2x16x16" if multi_pod
        else "16x16", chips=chips, walk=walk, cfg=cfg,
        longctx_variant=longctx, param_bytes_chip=p_bytes,
        cache_bytes_chip=c_bytes, batch_bytes_chip=b_bytes)
    d = rec.to_dict()
    d["t_walk_s"] = round(t_walk, 1)
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape.name} x {d['mesh']}: OK  "
              f"flops/chip={rec.flops_per_chip:.3e}  "
              f"peak={rec.peak_memory_per_chip / 2 ** 30:.2f}GiB  "
              f"coll=None  bottleneck={rec.bottleneck}  "
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

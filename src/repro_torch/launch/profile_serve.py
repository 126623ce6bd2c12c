"""Where full-width serving's time goes on the card.

For each serving cell of ``chip_smoke.py`` (recurrentgemma-2b: batch 4,
prompt 4096; gemma2-2b: batch 1, prompt 8192; with ``--moe`` instead the
MoE cells of its phase 15, qwen2-moe-a2.7b and kimi-k2-1t-a32b cut to one
layer, batch 1, prompt 4096; with ``--arch NAME`` the cells of that arch
alone, xlstm-1.3b's (batch 1, prompt 4096, phase 16) among them; random
weights from seed 0) it traces the
model's first prefill (which pays the caching allocator's growth and any
first launches) and runs one decode step, then traces one steady prefill
and ``DECODE_STEPS`` greedy decode steps (with the exit head, as
``serve.generate`` runs them) with ``torch.profiler`` (device activity
only), and prints for each phase (first prefill, prefill, decode): the
traced wall time, the device busy time (the sum of its kernel times) and
idle share; for the last two the wall time of the same work untraced;
the time by layer (K5, K6, matmuls, ...); and the kernels that take the
most device time.  The first line is the card's name and power limit as
``nvidia-smi`` reports them; the last is one JSON object with the same
numbers.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--moe]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch xlstm-1.3b
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import transformer as tfm

# (arch, batch, prompt, config overrides)
CELLS = (("recurrentgemma-2b", 4, 4096, {}), ("gemma2-2b", 1, 8192, {}))
MOE_CELLS = (("qwen2-moe-a2.7b", 1, 4096, {}),
             ("kimi-k2-1t-a32b", 1, 4096, {"n_layers": 1}))
XLSTM_CELLS = (("xlstm-1.3b", 1, 4096, {}),)
DECODE_STEPS = 8

# kernel-name fragments -> the layer they belong to (first match wins);
# "flash_fwd" takes both K5 kernels (flash_fwd_wgmma for bf16,
# flash_fwd_tf32 for f32); cuBLAS's Hopper GEMMs are named nvjet_* /
# sm90_xmma_* / cutlass_*, its matrix-vector products gemv* (the sLSTM's
# recurrent product a step); an MoE layer's routing sorts, scans and
# scatters
LAYERS = (("flash_fwd", "attention (K5)"), ("lru_scan", "RG-LRU scan (K6)"),
          ("nvjet", "matmul"), ("gemm", "matmul"), ("gemv", "matmul"),
          ("xmma", "matmul"),
          ("cutlass", "matmul"), ("softmax", "softmax"),
          ("Sort", "sort"), ("sort", "sort"), ("Scan", "scan"),
          ("scan", "scan"),
          ("scatter", "scatter"),
          ("Memcpy", "memcpy"), ("Memset", "memset"),
          ("CatArray", "copy"), ("copy", "copy"), ("index", "indexing"),
          ("reduce", "reduction"), ("elementwise", "elementwise"))
TOP = 8


def _layer(name: str) -> str:
    for frag, layer in LAYERS:
        if frag in name:
            return layer
    return "other"


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _traced(fn) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # the raw device records: building the profiler's op tree
    # (prof.events()) over an xLSTM prefill's ~10^6 launches takes minutes
    kernels = defaultdict(float)
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            kernels[evt.name()] += evt.duration_ns() / 1e9   # ns -> s
    busy = sum(kernels.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    by_layer = defaultdict(float)
    for name, s in kernels.items():
        by_layer[_layer(name)] += s
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"traced_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "by_layer_s": dict(sorted(by_layer.items(),
                                      key=lambda kv: -kv[1])),
            "top_kernels_s": ranked[:TOP]}


def profile_cell(arch: str, batch: int, prompt: int, over: dict) -> dict:
    cfg = configs.get_config(arch).with_overrides(**over)
    params = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
    cache_len = prompt + 2 * DECODE_STEPS + 1
    state = {}

    def prefill():
        logits, state["cache"] = tfm.prefill(params, cfg, prompts,
                                             cache_len=cache_len)
        state["tok"] = logits[:, -1].argmax(-1)[:, None]

    def decode(start: int, steps: int):
        def run():
            tok = state["tok"]
            for t in range(start, start + steps):
                logits, _, exit_logits = tfm.decode_step(
                    params, state["cache"], cfg, tok, t, with_exit_head=True)
                tok = logits[:, -1].argmax(-1)[:, None]
                exit_logits[:, -1].argmax(-1)
            state["tok"] = tok
        return run

    with torch.inference_mode():
        first_prefill = _traced(prefill)      # the model's first call
        _timed(decode(prompt, 1))
        untraced_prefill = _timed(prefill)
        traced_prefill = _traced(prefill)
        untraced_decode = _timed(decode(prompt, DECODE_STEPS))
        traced_decode = _traced(decode(prompt + DECODE_STEPS, DECODE_STEPS))
    traced_decode["traced_wall_ms_per_step"] = (
        traced_decode["traced_wall_s"] * 1e3 / DECODE_STEPS)
    out = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
           "prompt": prompt,
           "prefill": dict(traced_prefill, untraced_wall_s=untraced_prefill),
           "first_prefill": first_prefill,
           "decode": dict(traced_decode, steps=DECODE_STEPS,
                          untraced_wall_ms_per_step=untraced_decode * 1e3
                          / DECODE_STEPS)}
    del params, state
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--moe", action="store_true",
                    help="profile the MoE serving cells")
    ap.add_argument("--arch", default=None,
                    help="profile only this arch's cells (of all lists)")
    args = ap.parse_args(argv)
    cells = MOE_CELLS if args.moe else CELLS
    if args.arch is not None:
        cells = [c for c in CELLS + MOE_CELLS + XLSTM_CELLS
                 if c[0] == args.arch]
        if not cells:
            raise SystemExit(f"no serving cell of {args.arch!r}")
    resolve_device("cuda")
    build.load()            # the kernels' build is not the first prefill's
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for arch, batch, prompt, over in cells:
        row = profile_cell(arch, batch, prompt, over)
        rows.append(row)
        for phase in ("first_prefill", "prefill", "decode"):
            r = row[phase]
            untraced = ("" if phase == "first_prefill" else
                        f"; untraced {r['untraced_wall_s']:.4f} s"
                        if phase == "prefill" else
                        f"; untraced {r['untraced_wall_ms_per_step']:.2f} "
                        f"ms/step")
            print(f"{arch} ({row['layers']} layers) batch {batch} prompt "
                  f"{prompt} {phase}: traced "
                  f"{r['traced_wall_s']:.4f} s, device busy "
                  f"{r['device_busy_s']:.4f} s, idle share "
                  f"{r['idle_share']:.3f}{untraced}", flush=True)
            for layer, s in r["by_layer_s"].items():
                print(f"    {layer:18s} {s:.4f} s", flush=True)
            for name, s in r["top_kernels_s"]:
                print(f"    {s:.4f} s  {_layer(name):18s} {name[:90]}",
                      flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "cells": rows}), flush=True)


if __name__ == "__main__":
    main()

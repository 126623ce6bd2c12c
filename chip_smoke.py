#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and fails (non-zero exit,
no result line) without a card or outside a checkout.  Phases, each of
which raises on failure:

1. card report: ``nvidia-smi`` name and power limit, the device name;
2. build every kernel of the port from the checkout's sources;
3. hold the masked fold kernel against its plain PyTorch version on the
   card at the main path's shape (N = 11,175,936, Z = 5) in f32 and bf16,
   with a NaN row at weight 0, a zero-weight row, a ragged N and a
   misaligned accumulator; then time kernel and plain version (CUDA
   events) on the main path's folds: the complex population's (f32, bf16)
   and the simple population's (f32), at the model's real mask;
4. the main path: ``FederatedTrainer`` + ``ResNetAdapter`` (full-width
   PreActResNet18-GN) on ``synthetic_cifar``, the paper's federated
   setting cut to ``local_epochs=1`` and 512 test images: 2 rounds of
   fedhen, 1 of noside, 1 of decouple, evaluating after each, with the
   kernel's launch count checked against the number of folds;
5. one narrow fedhen round on the card against the same round on the CPU.

The second-to-last line is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN = 11_175_936          # n_flat of PreActResNet18-GN at agg_block_n 2048
N_RAGGED = 1_000_003
Z = 5
TOL = 1e-5                   # x max|acc|: nvcc contracts to FMA, the plain
                             # version rounds the product and the sum apart
F32_PEAK = 67e12             # H100 SXM f32 (non-tensor-core) flop/s


def memory_rate(name: str) -> tuple:
    """(bytes/s, part) of the card's HBM from its name: data-sheet rates."""
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe"
    return 3.35e12, "H100 SXM"


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fold_inputs(torch, n: int, dtype, seed: int):
    """Z=5 rows: row 2 is NaN at weight 0 (both branches), row 3 has weight
    0 inside M only, the rest are ordinary clients."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((Z, n), generator=g, device="cuda").to(dtype)
    x[2] = float("nan")
    mask = torch.rand((n,), generator=g, device="cuda") < 0.3
    w_m = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.5], device="cuda")
    w_rest = torch.tensor([0.0, 1.0, 0.0, 0.7, 0.25], device="cuda")
    acc = torch.randn((n,), generator=g, device="cuda")
    return acc, x, mask, w_m, w_rest


def main_path_mask(torch):
    """The flat index-set-M mask of full-width PreActResNet18-GN, as the
    trainer builds it (n_flat = N_MAIN)."""
    from repro_torch.core import flatten
    from repro_torch.core.adapters import ResNetAdapter
    adapter = ResNetAdapter(10)
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    layout = flatten.build_layout(params, total_multiple=2048)
    if layout.n_flat != N_MAIN:
        raise RuntimeError(f"n_flat {layout.n_flat} != {N_MAIN}")
    return flatten.pack_mask(layout, adapter.subnet_mask(params), "cuda")


def time_fold(torch, ops, ref, bw: float, mask, dtype, population: str
              ) -> dict:
    """Time one main-path fold: Z=5 clients of one population at the real
    mask.  A complex client weighs 1 on both sides of M, a simple client 1
    inside M and 0 outside, so the fold needs only the M part of its rows:
    the bound counts the bytes these weights need."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((Z, N_MAIN), generator=g, device="cuda").to(dtype)
    acc = torch.randn((N_MAIN,), generator=g, device="cuda")
    w_m = torch.ones((Z,), device="cuda")
    w_rest = w_m if population == "complex" else torch.zeros_like(w_m)
    ms = time_ms(torch, lambda: ops.masked_agg_acc_(acc, x, mask, w_m,
                                                     w_rest))
    plain_ms = time_ms(torch, lambda: ref.masked_agg_acc_ref(
        acc, x, mask, w_m, w_rest))
    rows_read = N_MAIN if population == "complex" else int(mask.sum())
    nbytes = Z * rows_read * x.element_size() + 8 * N_MAIN + N_MAIN
    bytes_ms, ops_ms = nbytes / bw * 1e3, 2 * Z * rows_read / F32_PEAK * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    out = {"fold": population, "x": str(dtype).replace("torch.", ""),
           "ms": ms, "plain_ms": plain_ms, "bytes_needed": nbytes,
           "bound_ms": bound_ms, "bound_share": bound_ms / ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"  masked_agg_acc {population} fold {out['x']} Z={Z} "
          f"N={N_MAIN:,}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB needed), bound "
          f"share {bound_ms / ms:.3f}", flush=True)
    return out


def check_masked_agg(torch, ops, ref, bw: float) -> dict:
    """Phase 3: correctness on every path of the kernel, then timing."""
    cases = [("f32", N_MAIN, torch.float32, 0), ("bf16", N_MAIN,
             torch.bfloat16, 0), ("f32 ragged", N_RAGGED, torch.float32, 0),
             ("bf16 ragged", N_RAGGED, torch.bfloat16, 0),
             ("f32 misaligned acc", N_MAIN, torch.float32, 1)]
    worst = 0.0
    for label, n, dtype, offset in cases:
        acc0, x, mask, w_m, w_rest = fold_inputs(torch, n, dtype, seed=n)
        want = ref.masked_agg_acc_ref(acc0, x, mask, w_m, w_rest)
        store = torch.empty((n + offset,), device="cuda")
        acc = store[offset:]
        acc.copy_(acc0)
        ops.masked_agg_acc_(acc, x, mask, w_m, w_rest)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(acc).all()):
            raise RuntimeError(f"masked_agg_acc {label}: non-finite output")
        diff = float((acc - want).abs().max())
        bound = TOL * float(want.abs().max())
        print(f"  masked_agg_acc {label:20s} N={n:>10,d} max|diff|={diff:.3e}"
              f" (limit {bound:.3e})", flush=True)
        if not diff <= bound:
            raise RuntimeError(f"masked_agg_acc {label}: {diff} > {bound}")
        worst = max(worst, diff)
    mask = main_path_mask(torch)
    timing = [time_fold(torch, ops, ref, bw, mask, dtype, population)
              for population, dtype in (("complex", torch.float32),
                                        ("complex", torch.bfloat16),
                                        ("simple", torch.float32))]
    return {"max_abs_err": worst, "timing": timing}


def main_path(torch, ops) -> dict:
    """Phase 4: the port's round at full width, through its entry points."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_cifar

    t0 = time.perf_counter()
    data = synthetic_cifar(50_000, 10, seed=0)
    test = synthetic_cifar(512, 10, seed=999)
    shards = [{k: torch.as_tensor(v).cuda() for k, v in s.items()}
              for s in iid_split(data, 100, seed=1)]
    print(f"  data: 50,000 images over 100 clients in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    runs = (("fedhen", 2), ("noside", 1), ("decouple", 1))
    out = {"rounds": [], "launches": 0}
    ops.masked_agg_acc_.launches = 0
    for algo, rounds in runs:
        fed = FedConfig(n_devices=100, n_simple=50, participation=0.1,
                        local_epochs=1, batch_size=50, lr=0.1,
                        algorithm=algo)
        trainer = FederatedTrainer(ResNetAdapter(10), fed, shards,
                                   device="cuda")
        before = ops.masked_agg_acc_.launches
        for _ in range(rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = trainer.run_round()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            ev = trainer.evaluate(test)
            row = {"algorithm": algo, "round": trainer.server.round,
                   "round_s": dt, **m, **{k: ev[k] for k in
                                          ("acc_simple", "acc_complex",
                                           "mbytes")}}
            print("  " + json.dumps(row), flush=True)
            if not (math.isfinite(m["loss_simple"])
                    and math.isfinite(m["loss_complex"])):
                raise RuntimeError(f"{algo}: non-finite loss {m}")
            if m["n_valid"] != trainer.k_simple + trainer.k_complex:
                raise RuntimeError(f"{algo}: n_valid {m['n_valid']}")
            out["rounds"].append(row)
        folds = ops.masked_agg_acc_.launches - before
        expected = rounds * (4 if algo == "decouple" else 2)
        print(f"  {algo}: {folds} masked_agg_acc launches over {rounds} "
              f"round(s), expected {expected}; n_params "
              f"{trainer.layout.n_params:,}, n_flat {trainer.layout.n_flat:,}",
              flush=True)
        if folds != expected:
            raise RuntimeError(f"{algo}: {folds} launches, expected "
                               f"{expected}")
    out["launches"] = ops.masked_agg_acc_.launches
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  main path peak memory {out['peak_gib']:.2f} GiB", flush=True)
    return out


def card_vs_cpu(torch) -> float:
    """Phase 5: one narrow fedhen round on the card against the CPU."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_cifar
    from repro_torch.tree import tree_leaves

    # 16x16 images, as in the CPU parity tests: at 8x8 the last stage's
    # GroupNorm groups hold 2 values and f32 rounding alone exceeds 1e-5
    shards = iid_split(synthetic_cifar(32, 10, seed=0, image_size=16), 4,
                       seed=1)
    fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                    local_epochs=1, batch_size=4, algorithm="fedhen")
    results = {}
    for dev in ("cuda", "cpu"):
        t = FederatedTrainer(ResNetAdapter(10, (8, 16, 16, 16)), fed, shards,
                             device=dev)
        results[dev] = (t.run_round(), [x.cpu() for x in
                                        tree_leaves(t.server.complex)])
    worst, worst_ratio, worst_leaf = 0.0, 0.0, -1
    for i, (a, b) in enumerate(zip(results["cuda"][1], results["cpu"][1])):
        ratio = float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
        worst = max(worst, float((a - b).abs().max()))
        if ratio > worst_ratio:
            worst_ratio, worst_leaf = ratio, i
    print(f"  narrow fedhen round, card vs CPU: max|diff| {worst:.3e}, "
          f"worst |diff| / (1e-5 + 1e-4 |cpu|) = {worst_ratio:.3f} at leaf "
          f"{worst_leaf}; losses card {results['cuda'][0]} cpu "
          f"{results['cpu'][0]}", flush=True)
    if worst_ratio > 1.0:
        raise RuntimeError("card and CPU rounds disagree beyond rtol 1e-4, "
                           "atol 1e-5")
    for key in ("loss_simple", "loss_complex"):
        if abs(results["cuda"][0][key] - results["cpu"][0][key]) > 1e-5:
            raise RuntimeError(f"card and CPU {key} disagree beyond 1e-5")
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.masked_agg import ops, ref

    resolve_device("cuda")          # TF32 off, as on every entry point
    # 1. card report
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, part = memory_rate(name)
    print("[1] card", flush=True)
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; bounds at {part} HBM {bw / 1e12:.2f} TB/s", flush=True)
    # 2. build
    print("[2] build", flush=True)
    t = time.perf_counter()
    res = build.build()
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"  masked_agg: {res.path.name} in {res.seconds:.1f} s; "
          + " | ".join(ptxas), flush=True)
    print(f"  build total {time.perf_counter() - t:.1f} s", flush=True)
    # 3. the kernel against its plain version
    print("[3] masked_agg_acc vs plain PyTorch on the card", flush=True)
    k1 = check_masked_agg(torch, ops, ref, bw)
    # 4. main path
    print("[4] main path: full-width PreActResNet18-GN rounds", flush=True)
    path = main_path(torch, ops)
    # 5. card vs CPU
    print("[5] card vs CPU", flush=True)
    card_vs_cpu(torch)

    head = k1["timing"][0]          # the complex fold in f32
    print(json.dumps({"kernels": [{
        "name": "masked_agg_acc", "route": "cuda",
        "source": "src/repro_torch/kernels/masked_agg/csrc/masked_agg_acc.cu",
        "replaces": "src/repro/kernels/masked_agg/kernel.py:106",
        "launches": path["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {"Z": Z, "N": N_MAIN, "x": head["x"], "fold": head["fold"]},
        "bound_share": head["bound_share"], "folds": k1["timing"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

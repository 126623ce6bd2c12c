"""Where one synchronous round's time goes on the card.

Builds the smoke configuration of ``chip_smoke.py`` (full-width
PreActResNet18-GN, 100 clients of 500 synthetic CIFAR images, 5 simple +
5 complex per round, batch 50, one local epoch), runs one warm-up round,
then traces one round of each algorithm on the f32 wire, one fedhen
round on the compressed wire (:data:`COMPRESSED`), one on the tree engine
and one with SCAFFOLD (whose cv store is an mmap file at this size) with
``torch.profiler``
(device activity only, so the host is barely slowed) and prints per
round: the
traced round's wall time, its device busy time (the sum of its kernel
times) and idle share, both taken from that one round; the wall time of a
further, untraced round beside them; the time by layer; and the kernels
that take the most device time.  The first line is the card's name and
power limit as ``nvidia-smi`` reports them; the last is one JSON object
with the same numbers.

    PYTHONPATH=src python -m repro_torch.launch.profile_round
"""

from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import FedConfig
from repro_torch.core.adapters import ResNetAdapter
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_cifar

# the compressed wire of BENCH_comm.json's int8+ef+topk point
# (benchmarks/comm_savings.py): int8, top-k 1/14, stochastic rounding, EF
COMPRESSED = dict(comm_dtype="int8", topk_frac=1 / 14,
                  stochastic_rounding=True, error_feedback=True)
RUNS = (("fedhen", {}), ("noside", {}), ("decouple", {}),
        ("fedhen", COMPRESSED), ("fedhen", dict(agg_engine="tree")),
        ("fedhen", dict(variance_reduction="scaffold")))

# kernel-name fragments -> the layer they belong to (first match wins);
# cuDNN's FFT convolutions run as fft / region_transform / complex-GEMM,
# PyTorch's GroupNorm as moments / fused-params / gradient kernels; the
# wire's top-k is a radix sort plus gathers and scatters of indices
LAYERS = (("masked_agg_acc_deq", "fold (K2)"),
          ("scatter_bounds", "fold (K3)"), ("scatter_apply", "fold (K3)"),
          ("masked_agg_acc", "fold (K1)"),
          ("masked_agg", "fold (K4)"),
          ("RadixSort", "top-k sort"), ("radix", "top-k sort"),
          ("index", "indexing"), ("Memcpy", "memcpy"),
          ("group_norm", "groupnorm"), ("GroupNorm", "groupnorm"),
          ("RowwiseMoments", "groupnorm"), ("FusedParams", "groupnorm"),
          ("ComputeInternalGradients", "groupnorm"),
          ("GammaBetaBackward", "groupnorm"),
          ("conv", "convolution"), ("xmma", "convolution"),
          ("cudnn", "convolution"), ("fft", "convolution"),
          ("region_transform", "convolution"), ("cf32", "convolution"),
          ("wgrad", "convolution"), ("flip_filter", "convolution"),
          ("gemm", "matmul"),
          ("reduce", "reduction"), ("elementwise", "elementwise"))
TOP = 8                      # kernels listed per round, overall and "other"


def _layer(name: str) -> str:
    for frag, layer in LAYERS:
        if frag in name:
            return layer
    return "other"


def timed_round(trainer: FederatedTrainer) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.run_round()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def profile_round(trainer: FederatedTrainer) -> dict:
    """One traced round, then one untraced round.  Busy time, wall time and
    idle share all come from the traced round; the untraced round's wall
    time stands beside them to show what the tracer costs."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        metrics = trainer.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] += evt.device_time_total / 1e6   # us -> s
    busy = sum(kernels.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    by_layer = defaultdict(float)
    for name, s in kernels.items():
        by_layer[_layer(name)] += s
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    other = [kv for kv in ranked if _layer(kv[0]) == "other"][:TOP]
    return {"algorithm": trainer.fed.algorithm,
            "wire": trainer.fed.comm_dtype
            + ("+topk+sr+ef" if trainer.wire.uses_deltas else ""),
            "engine": trainer.fed.agg_engine,
            "variance_reduction": trainer.fed.variance_reduction,
            "ef_backend": (trainer.ef_store.backend
                           if trainer.ef_store is not None else None),
            "cv_backend": (trainer.cv_store.backend
                           if trainer.cv_store is not None else None),
            "traced_wall_s": wall,
            "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "untraced_wall_s": timed_round(trainer),
            "by_layer_s": dict(sorted(by_layer.items(),
                                      key=lambda kv: -kv[1])),
            "top_kernels_s": ranked[:TOP], "top_other_s": other, **metrics}


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    shards = iid_split(synthetic_cifar(50_000, 10, seed=0), 100, seed=1)
    rows = []
    for algo, wire in RUNS:
        fed = FedConfig(n_devices=100, n_simple=50, participation=0.1,
                        local_epochs=1, batch_size=50, lr=0.1,
                        algorithm=algo, **wire)
        trainer = FederatedTrainer(ResNetAdapter(10), fed, shards)
        timed_round(trainer)         # warm-up: cuDNN plans, allocator
        row = profile_round(trainer)
        rows.append(row)
        print(f"{algo} on the {row['wire']} wire, {row['engine']} engine, "
              f"variance reduction {row['variance_reduction']} (EF store: "
              f"{row['ef_backend']}, cv store: {row['cv_backend']}): "
              f"traced round "
              f"{row['traced_wall_s']:.3f} s, device "
              f"busy {row['device_busy_s']:.3f} s, idle share "
              f"{row['idle_share']:.3f}; untraced round "
              f"{row['untraced_wall_s']:.3f} s", flush=True)
        for layer, s in row["by_layer_s"].items():
            print(f"    {layer:12s} {s:.4f} s", flush=True)
        for name, s in row["top_kernels_s"] + row["top_other_s"]:
            print(f"    {s:.4f} s  {_layer(name):12s} {name[:100]}",
                  flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "rounds": rows}), flush=True)


if __name__ == "__main__":
    main()

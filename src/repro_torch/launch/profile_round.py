"""Where one synchronous round's time goes on the card.

Builds the smoke configuration of ``chip_smoke.py`` (full-width
PreActResNet18-GN, 100 clients of 500 synthetic CIFAR images, 5 simple +
5 complex per round, batch 50, one local epoch), runs one warm-up round,
then traces one round of each algorithm with ``torch.profiler`` (device
activity only, so the host is barely slowed) and prints per round: the
traced round's wall time, its device busy time (the sum of its kernel
times) and idle share, both taken from that one round; the wall time of a
further, untraced round beside them; the time by layer; and the kernels
that take the most device time.  The last line is one JSON object with
the same numbers.

    PYTHONPATH=src python -m repro_torch.launch.profile_round
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import FedConfig
from repro_torch.core.adapters import ResNetAdapter
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_cifar

# kernel-name fragments -> the layer they belong to (first match wins);
# cuDNN's FFT convolutions run as fft / region_transform / complex-GEMM,
# PyTorch's GroupNorm as moments / fused-params / gradient kernels
LAYERS = (("masked_agg", "fold (K1)"),
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
    return {"algorithm": trainer.fed.algorithm, "traced_wall_s": wall,
            "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "untraced_wall_s": timed_round(trainer),
            "by_layer_s": dict(sorted(by_layer.items(),
                                      key=lambda kv: -kv[1])),
            "top_kernels_s": ranked[:TOP], "top_other_s": other, **metrics}


def main():
    shards = iid_split(synthetic_cifar(50_000, 10, seed=0), 100, seed=1)
    rows = []
    for algo in ("fedhen", "noside", "decouple"):
        fed = FedConfig(n_devices=100, n_simple=50, participation=0.1,
                        local_epochs=1, batch_size=50, lr=0.1,
                        algorithm=algo)
        trainer = FederatedTrainer(ResNetAdapter(10), fed, shards)
        timed_round(trainer)         # warm-up: cuDNN plans, allocator
        row = profile_round(trainer)
        rows.append(row)
        print(f"{algo}: traced round {row['traced_wall_s']:.3f} s, device "
              f"busy {row['device_busy_s']:.3f} s, idle share "
              f"{row['idle_share']:.3f}; untraced round "
              f"{row['untraced_wall_s']:.3f} s", flush=True)
        for layer, s in row["by_layer_s"].items():
            print(f"    {layer:12s} {s:.4f} s", flush=True)
        for name, s in row["top_kernels_s"] + row["top_other_s"]:
            print(f"    {s:.4f} s  {_layer(name):12s} {name[:100]}",
                  flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rounds": rows}), flush=True)


if __name__ == "__main__":
    main()

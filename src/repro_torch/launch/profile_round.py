"""Where one synchronous round's time goes on the card.

The ResNet columns: builds the smoke configuration of ``chip_smoke.py``
(full-width PreActResNet18-GN, 100 clients of 500 synthetic CIFAR images,
5 simple + 5 complex per round, batch 50, one local epoch), runs one
warm-up round,
then traces one round of each algorithm on the f32 wire, one fedhen
round on the compressed wire (:data:`COMPRESSED`), one on the tree engine
and one with SCAFFOLD (whose cv store is an mmap file at this size) with
``torch.profiler``
(device activity only, so the host is barely slowed) and prints per
round: the
traced round's wall time, its device busy time (the sum of its kernel
times) and idle share, both taken from that one round; the wall time of a
further, untraced round beside them; the time by layer; and the kernels
that take the most device time.

The LM column: the full-width Gemma-2 2B cell of :mod:`lm_cell` (also
``chip_smoke.py``'s phase 9: bf16, 8 clients, one simple and one complex
a round, 2 SGD steps of 2 x 512 tokens each), one fedhen round traced
after a warm-up round, with host activity too, so that each kernel's
time is charged to the module that launched it (:data:`LM_RANGES`,
``record_function`` ranges put around those functions for the traced
round only); a backward kernel is charged to the range of the forward op
its autograd node came from (matched by sequence number).

``--async-lag L`` builds every trainer with ``FedConfig(async_lag=L)``:
the traced round is then the second, in which the first ``L`` chunk
folds train on the previous round's model (the async engine,
``core/async_rounds.py``).

The first line is the card's name and power limit as ``nvidia-smi``
reports them; the last is one JSON object with the same numbers.

    PYTHONPATH=src python -m repro_torch.launch.profile_round [--lm-only] \
        [--async-lag L]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregate, federated, flatten, masking
from repro_torch.core.adapters import ResNetAdapter
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.federated import iid_split
from repro_torch.data.synthetic import synthetic_cifar
from repro_torch.launch import lm_cell
from repro_torch.models import attention, common, mlp
from repro_torch.models import transformer as tfm

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
# the LM column's kernel classes: no convolutions, and cuBLAS's bf16
# GEMMs on Hopper run as nvjet / sm90 xmma kernels
LM_LAYERS = (("masked_agg_acc", "fold (K1)"), ("masked_agg", "fold (K4)"),
             ("nvjet", "matmul"), ("gemm", "matmul"), ("xmma", "matmul"),
             ("cutlass", "matmul"), ("softmax", "softmax"),
             ("index", "indexing"), ("Memcpy", "memcpy"),
             ("reduce", "reduction"), ("elementwise", "elementwise"))

# (label, module, function): the ranges a traced LM round is cut into
LM_RANGES = (
    ("embedding", tfm, "embed_inputs"),
    ("attention projections (QKV, RoPE, out)", attention,
     "apply_attention_train"),
    ("attention core (scores, softcap, mask, softmax, PV)", attention,
     "chunked_causal_attention"),
    ("MLP (gate, up, gelu, down)", mlp, "apply_mlp"),
    ("RMSNorm", common, "apply_rmsnorm"),
    ("CE", common, "softmax_cross_entropy_sum"),
    ("head (norm, unembedding, softcap)", tfm, "logits_from_hidden"),
    ("SGD (clip, update)", federated, "sgd_update"),
    ("pack", flatten, "pack_into"),
    ("NaN check", masking, "tree_isfinite"),
    ("fold", aggregate, "streaming_fold"),
    ("finalize", aggregate, "streaming_finalize"),
)


def _layer(name: str, layers=LAYERS) -> str:
    for frag, layer in layers:
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
            "async_lag": trainer.fed.async_lag,
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


@contextlib.contextmanager
def lm_ranges():
    """Put a ``record_function`` range named by its label around each
    function of :data:`LM_RANGES` (module attributes, looked up at call
    time by their callers), and take them off again."""
    saved = []
    for label, module, name in LM_RANGES:
        fn = getattr(module, name)

        def ranged(*args, _fn=fn, _label=label, **kwargs):
            with record_function(_label):
                return _fn(*args, **kwargs)

        saved.append((module, name, fn))
        setattr(module, name, ranged)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _is_backward(evt) -> bool:
    return "Backward" in evt.name or evt.name.startswith("autograd::engine")


def attribute(events, time_of) -> dict:
    """Seconds of ``time_of(evt)`` (a host event's own kernels' device
    time) by range: an op inside a range is charged to the innermost one
    (attention's core is inside its layer, whose own ops are then the
    projections); a backward op
    to ``"<range> (backward)"`` of the forward op with its autograd
    node's sequence number; anything else to its own op name's class
    (``"other: <op>"``)."""
    labels = {label for label, _, _ in LM_RANGES}

    def range_of(evt):
        while evt is not None:
            if evt.name in labels:
                return evt.name
            evt = evt.cpu_parent
        return None

    cpu = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    fwd = defaultdict(list)        # sequence number -> [(start, range)]
    for e in cpu:
        if e.sequence_nr >= 0 and not _is_backward(e):
            r = range_of(e)
            if r is not None:
                fwd[e.sequence_nr].append((e.time_range.start, r))

    def forward_range(node):
        """The range of the last forward op before ``node`` with its
        sequence number (a number can recur across steps)."""
        best = None
        for start, r in fwd.get(node.sequence_nr, ()):
            if start <= node.time_range.start:
                best = r
        return best

    out = defaultdict(float)
    for e in cpu:
        t = time_of(e)
        if t <= 0:
            continue
        r = range_of(e)
        if r is None:
            node = e
            while node is not None and not (node.sequence_nr >= 0
                                            and _is_backward(node)):
                node = node.cpu_parent
            fr = forward_range(node) if node is not None else None
            if fr is not None:
                r = fr + " (backward)"
            elif node is not None:
                r = "other backward: " + node.name.split(": ")[-1]
            else:
                r = "other: " + e.name
        out[r] += t
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_lm_round(trainer: FederatedTrainer) -> dict:
    """One traced fedhen round of the LM cell (host and device activity,
    :func:`lm_ranges` on), then one untraced round.  Busy time and idle
    share come from the traced round's device events; the layer table
    charges each kernel to its module (:func:`attribute`)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with lm_ranges(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        metrics = trainer.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.events()
    labels = {label for label, _, _ in LM_RANGES}
    # device events, without the ranges' own device-side spans
    kernels = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not (
                e.name in labels or getattr(e, "is_user_annotation", False)):
            kernels[e.name] += e.device_time_total / 1e6
    busy = sum(kernels.values())
    if busy <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    by_kernel_class = defaultdict(float)
    for name, sec in kernels.items():
        by_kernel_class[_layer(name, LM_LAYERS)] += sec
    by_module = attribute(events, lambda e: e.self_device_time_total / 1e6)
    # K1 and K4 launch through ctypes, outside any PyTorch op: their time
    # is charged to the fold by kernel name
    by_module["fold"] = by_module.get("fold", 0.0) + sum(
        sec for name, sec in kernels.items() if "masked_agg" in name)
    return {"algorithm": trainer.fed.algorithm, "model": lm_cell.ARCH,
            "async_lag": trainer.fed.async_lag,
            "n_flat": trainer.layout.n_flat, "traced_wall_s": wall,
            "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "traced_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "untraced_wall_s": timed_round(trainer),
            "attributed_s": sum(by_module.values()),
            "by_module_s": dict(sorted(by_module.items(),
                                       key=lambda kv: -kv[1])),
            "by_kernel_class_s": dict(sorted(by_kernel_class.items(),
                                             key=lambda kv: -kv[1])),
            "top_kernels_s": sorted(kernels.items(),
                                    key=lambda kv: -kv[1])[:TOP],
            **metrics}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lm-only", action="store_true",
                    help="trace the LM column only")
    ap.add_argument("--async-lag", type=int, default=0,
                    help="build every trainer with this async lag")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    if not args.lm_only:
        rows = resnet_columns(args.async_lag)
    trainer = lm_cell.trainer(lm_cell.shards(), async_lag=args.async_lag)
    timed_round(trainer)             # warm-up: cuBLAS plans, allocator
    row = profile_lm_round(trainer)
    del trainer
    print(f"LM fedhen async lag {args.async_lag}, gemma2-2b full width, "
          f"n_flat {row['n_flat']:,}: "
          f"traced round {row['traced_wall_s']:.3f} s, device busy "
          f"{row['device_busy_s']:.3f} s, idle share "
          f"{row['idle_share']:.3f}; untraced round "
          f"{row['untraced_wall_s']:.3f} s; kernels charged to modules "
          f"{row['attributed_s']:.3f} s", flush=True)
    for layer, sec in row["by_module_s"].items():
        print(f"    {sec:.4f} s  {layer}", flush=True)
    for layer, sec in row["by_kernel_class_s"].items():
        print(f"    {sec:.4f} s  kernel class {layer}", flush=True)
    for name, sec in row["top_kernels_s"]:
        print(f"    {sec:.4f} s  {name[:100]}", flush=True)
    rows.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card, "rounds": rows}), flush=True)


def resnet_columns(async_lag: int = 0) -> list:
    shards = iid_split(synthetic_cifar(50_000, 10, seed=0), 100, seed=1)
    rows = []
    for algo, wire in RUNS:
        fed = FedConfig(n_devices=100, n_simple=50, participation=0.1,
                        local_epochs=1, batch_size=50, lr=0.1,
                        algorithm=algo, async_lag=async_lag, **wire)
        trainer = FederatedTrainer(ResNetAdapter(10), fed, shards)
        timed_round(trainer)         # warm-up: cuDNN plans, allocator
        row = profile_round(trainer)
        rows.append(row)
        print(f"{algo} async lag {async_lag} on the {row['wire']} wire, "
              f"{row['engine']} engine, "
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
        del trainer
    return rows


if __name__ == "__main__":
    main()

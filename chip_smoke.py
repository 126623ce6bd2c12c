#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and fails (non-zero exit,
no result line) without a card or outside a checkout.  Phases, each of
which raises on failure:

1. card report: ``nvidia-smi`` name and power limit, the device name;
2. build every kernel of the port from the checkout's sources (one nvcc
   per source, all started together) and print ptxas's registers and
   spills;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (N = 11,175,936, Z = 5), then time kernel and plain
   version (device time, below) on the main path's folds at the model's real
   mask:
   K1 (masked fold) in f32 and bf16, with a NaN row at weight 0, a
   zero-weight row, a ragged N and a misaligned accumulator;
   K2 (int8 fold, quant_block 128) with a NaN-scale row at weight 0, a
   ragged N (quant_block 1) and a misaligned accumulator;
   K1 and K2 where rows are dead (f32 and bf16; int8 at quant_block 128
   and 1; the vector and scalar kernels): a simple fold and an all-dead
   launch at the model's mask and a random one, a NaN row at weight 0,
   -0.0 in the accumulator, every element no live row touches bitwise
   ``acc + 0.0``; K1's and K2's folds timed twice, on ``time_ms`` and
   with the L2 flushed between calls (``time_ms_flushed``), each against
   the bytes its weights need (acc read, the mask, the live rows, acc
   written where a live row changes it) and against the bound that stores
   every element;
   K3 (top-k scatter fold, two launches: each row's run per span, then
   the fold over the spans with entries) at k = 798,208 and 48,384 (the
   complex and simple populations' top-k 1/14), indices colliding across
   rows, for int8 payloads with scales and for bf16, and at Z = 1 with
   k = 128, every index in one span, k = N / 2 and a misaligned
   accumulator; timed against two bounds, 8 acc bytes an entry and the
   32-byte sectors the indices touch (counted on the card);
   K4 (the tree engine's masked fold over a table of leaves), bitwise,
   f32 and bf16 with a NaN row at weight 0 and a zero-weight row: through
   the one-shot entry, each of the model's 59 leaves as a strided view of
   the (5, 11,175,936) chunk buffer with the leaf's own mask, the whole
   buffer at a per-element random mask, and a ragged N = 1,000,003; the
   engine's fold of all 59 leaves accumulated in one launch; timed as that
   one launch and on the largest leaf;
4. the main path: ``FederatedTrainer`` + ``ResNetAdapter`` (full-width
   PreActResNet18-GN) on ``synthetic_cifar``, the paper's federated
   setting cut to ``local_epochs=1`` and 512 test images: on the f32
   wire 2 rounds of fedhen, 1 of noside, 1 of decouple; on the int8 wire
   2 rounds of fedhen; on the compressed wire (int8, top-k 1/14,
   stochastic rounding, error feedback) 2 rounds of fedhen and 1 of
   decouple; on the tree engine 2 rounds of fedhen and 1 of decouple;
   SCAFFOLD 2 fedhen rounds on the flat engine and 1 on the tree engine
   (its cv store's backend printed); 1 fedhen round with uniform cohort
   sampling — evaluating after each, with each kernel's launch count
   (counted from 0 for each run) checked against the folds and the
   bytes billed each round against the wire's (for uniform sampling,
   the plan's realised clients);
5. one narrow fedhen round on the card against the same round on the CPU,
   on the f32 wire and on the compressed wire (one CPU-drawn bit provider
   for both; the lossy-wire rules of ``repro_torch.parity``), and two
   narrow fedhen rounds on the tree engine with SCAFFOLD (server params,
   ``cv_global`` and the cv rows at rtol 1e-4, atol 1e-5);
6. the serving kernels against their plain versions on the card, then
   timed beside their bounds: K5 has two kernels, chosen by dtype — bf16
   on the tensor cores (wgmma), f32 on the CUDA cores (8 x 8 register
   tiles) — and each call is checked to launch its dtype's kernel; bf16 at
   recurrentgemma-2b's prefill shape (4, 4096, 10 / 1, 256), window 2048,
   with ``F.scaled_dot_product_attention`` timed beside it (the causal
   window as a boolean mask, the kv head expanded), at gemma2-2b's
   (1, 8192, 8 / 4, 256) with softcap 50, window 4096 and global, and at
   the dense configs' shapes (gemma3-4b (1, 8192, 8 / 4, 256) window 1024,
   minitron-8b (1, 4096, 32 / 8, 128), starcoder2-15b (1, 4096, 48 / 4,
   128), qwen2-moe-a2.7b (1, 4096, 16 / 16, 128) and kimi-k2 (1, 4096,
   64 / 8, 112), SDPA beside each); f32 at the recurrentgemma-2b shape (SDPA
   beside it) and gemma2-2b's global layer; untimed edge cases (a ragged
   S, G = 3 and G = 130, Dh 32, 128 and 256, softcap with a window, a
   window under a key tile, Dh 112 in both dtypes); each timed row with
   its TFLOP/s and bound share at its route's peak (f32 rows also at
   split TF32's 165 TFLOP/s);
   K6 (RG-LRU scan), both entries bitwise against their plain versions:
   the scan at (4, 4096, 2560) f32 and bf16 and at shapes that cut a time
   tile or a channel stripe (on TMA and on the producer's loads), timed
   in f32 beside its byte bound; the gated entry (the recurrent layer's
   gates computed in the kernel, then the scan) at (4, 4096, 2560) bf16
   and f32 x, with and without y0, and ragged, also against the unfused
   composition it replaces (``_gates``, K6, the cast), timed in bf16
   beside its bound (bytes, and its gate math's FP32 and MUFU
   instructions counted from the SASS) and beside that composition;
7. full-width serving through ``repro_torch.launch.serve.generate``, random
   weights from seed 0: recurrentgemma-2b (batch 4, prompt 4096, 32 new
   tokens, greedy) and gemma2-2b (batch 1, prompt 8192, 8 new tokens),
   with prefill seconds, decode ms per step, new tokens per second, the
   exit head's statistics and peak memory; each bf16 prefill must launch
   the tensor-core K5 once per attention layer, the CUDA-core K5 never,
   and K6 once per RG-LRU layer ((8, 0, 18) and (26, 0, 0)), all of K6's
   through its gated entry, and decode none of them;
8. narrow serving (the reduced configs deepened to two periods, a
   remainder and an exit before the last layer; prompt 64 against window
   16) on the card against the CPU: prefill logits and 8 teacher-forced
   decode steps (final and exit heads), in f32 (K5 on the CUDA cores) at
   rtol 1e-4 / atol 1e-5 and in bf16 (K5 on the tensor cores) within 5 %
   of max|logit|, each config's card run launching its dtype's K5; the
   reduced gemma3-4b (qk-norm, window 16), minitron-8b and starcoder2-15b
   (the plain MLP) the same way in f32; the reduced MoE configs
   (qwen2-moe-a2.7b, and kimi-k2-1t-a32b at its published head dim 112,
   so the CUDA-core K5 runs Dh 112 in a model) in both dtypes, every MoE
   layer's routing held call by call (f32: the CPU's slot_idx equal to
   the card's; bf16: the CPU's routing from the card's router logits
   equal to the card's, and the tokens the CPU's own logits route
   elsewhere counted with their margins; a difference prints the margins
   and fails); and on the card, f32 token-by-token decode against the
   prefill's logits at every position (MoE at capacity factor 64), at
   rtol 1e-4 / atol 1e-5;
9. the LM round cell (``repro_torch.launch.lm_cell``):
   ``FederatedTrainer(LMAdapter(cfg), ...)`` on
   Gemma-2 2B at full width (bf16, n_flat 2,614,224,896 > 2**31), weights
   from seed 0 drawn on the card, 8 clients (one simple, one complex a
   round), batch 2 x 512 tokens, 2 SGD steps a client, ``synthetic_lm``
   over the first 4,096 ids, the f32 wire: 2 fedhen and 1 noside round on
   the flat engine and 1 fedhen round on the tree engine, each evaluated,
   with wall time, losses, metrics, bytes billed against the wire's
   closed form, peak memory, and K1's / K4's launches against the folds;
   then K1 and K4 at the cell's fold (Z = 1, N = n_flat, the real mask;
   for K4 the layout's leaf table and work list) bitwise against their
   plain versions in pieces, each timed beside its byte bound;
10. narrow LM rounds on the card against the CPU at rtol 1e-4 / atol 1e-5:
   attn4 (the BENCH rows' config) fedhen and decouple on the flat engine
   and fedhen on the tree engine, reduced recurrentgemma-2b, gemma3-4b,
   minitron-8b, starcoder2-15b, qwen2-moe-a2.7b and kimi-k2-1t-a32b
   fedhen;
11. async rounds (``repro_torch.core.async_rounds``): at the ResNet round
   cell, f32 fedhen through ``AsyncRoundEngine(lag=0)`` against the sync
   trainer, 2 rounds each under deterministic cuDNN, bitwise in server
   params, metrics, bytes and launches; then ``FedConfig(async_lag=L)``
   runs: f32 at lag 3 for 3 rounds (3 versions; round 2 trains the simple
   chunk on a model two rounds old), the int8 wire, the compressed wire
   and the tree engine at lag 1 for 2 rounds, each round's wall,
   schedule, weights and bytes (the closed form less the savings a
   ``comm.VersionCache`` replay finds) printed and checked, K1-K4's
   launches equal to sync rounds'; the LM round cell at lag 1 for 3
   rounds (the simple chunk one round stale at weight 0.70710677), with
   wall, losses, n_valid, bytes, peak memory and K1's launches; narrow
   async rounds on the card against the CPU at rtol 1e-4 / atol 1e-5
   (attn4 fedhen and decouple at lag 1 and 3, the narrow ResNet at lag 1);
12. checkpoints (``repro_torch.checkpoint``): the LM cell's trainer after
   phase 11's third round saved in tree format (5.23 GB, to a temporary
   directory with 12 GB free, removed after) and restored into it, timed,
   bitwise, then one more round from versions reset to the restored
   model; the ResNet cell's f32 trainer in tree and flat format, bitwise,
   timed; narrow resume on the card (attn4 async lag 1, the narrow ResNet
   with SCAFFOLD and with int8 error feedback): 2 rounds, save, restore
   into a new trainer, 2 rounds, against one trainer whose server was
   replaced at round 2, bitwise or within rtol 1e-4 / atol 1e-5 with the
   largest difference printed; phase 8's narrow configs (f32, bf16)
   restored from ``save_tree`` by ``serve.load_params`` serve prefill
   logits bitwise equal to the in-memory params', and ``serve.main
   --checkpoint`` runs on both reduced archs (K5, K6 launched);
13. telemetry (``repro_torch.obs``), telemetry off in phases 1-12: at the
   ResNet round cell (f32 fedhen), (a) two runs of 2 rounds from the same
   seed without ``cudnn.deterministic``, bitwise or not (printed); (b)
   telemetry off against ``Telemetry([NullSink()])``, 2 rounds each,
   bitwise in params, metrics and bytes with K1's 2 launches a round
   (under deterministic cuDNN if (a) was not bitwise); (c) 2 rounds sync
   and 2 async lag 1 on the tree engine (K4 2 a round) into JSONL run logs
   (a temporary directory, removed after), each summarized by
   ``repro_torch.obs.report`` and checked against its trainer (rounds,
   byte total, one ``execute`` span a round, the kernel library's
   ``compile`` span in round 0 only, the health counters and ledgers), its
   report's rounds, comm and health sections printed; (d) the LM round
   cell with telemetry, 16 fedhen rounds evaluated every 4: round walls,
   peak, K1's 2 launches a round, the byte ledger against the closed form
   33,107,097,600 a round; then the trained model served at phase 7's
   gemma2-2b cell (batch 1, prompt 8192, 8 new tokens, greedy) from a
   ``synthetic_lm`` prompt and a random one, at exit threshold 0 and 0.3,
   with the exit head's agreement and confidence (a measurement, not a
   gate); (e) alternate rounds of an off trainer and an on one (null sink,
   then JSONL sink), 4 each, median walls printed;
14. full-width serving of the dense configs through ``serve.generate``,
   bf16, random weights from seed 0, greedy, batch 1: gemma3-4b (prompt
   8192 past its 1024 window, 8 new tokens), minitron-8b and
   starcoder2-15b (prompt 4096, 8 new tokens), as phase 7 prints them;
   each prefill must launch the tensor-core K5 once per layer (34, 32,
   40), the CUDA-core K5 never, and decode none;
15. full-width serving of the MoE configs the same way: qwen2-moe-a2.7b
   at published widths and depth and kimi-k2-1t-a32b at published widths
   cut to 1 of its 61 layers (prompt 4096, 8 new tokens), each prefill
   launching the tensor-core K5 once a layer (24, 1; kimi at Dh 112),
   the CUDA-core K5 never, decode none; with the share of (token, choice)
   pairs prefill dropped at capacity and the tokens an expert (largest
   and mean), a measurement.

Kernel times are device times (``time_ms``: a CUDA graph of the timed
calls between two events, so the host's launch rate does not enter).  The
second-to-last line is one JSON object ``{"kernels": [...]}`` (K1-K4,
both K5 kernels, K6's two entries; K1 and K4 with their launches on the
LM path of phase 9 beside phase 4's, and their LM-shape times; K1-K4 with
their launches on phase 11's async path, K5 and K6 with theirs on phase
12's serving from checkpoints; K1-K4 with their launches on phase 13's
telemetry path, the tensor-core K5 with its serving of the trained model
there and its launches in phase 14's dense serving and phase 15's MoE
serving); the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN = 11_175_936          # n_flat of PreActResNet18-GN at agg_block_n 2048
N_RAGGED = 1_000_003
Z = 5
QB = 128                     # the int8 wire's quant_block
K_COMPLEX = 798_208          # topk_count at 1/14 of 11,173,461 params
K_SIMPLE = 48_384            # ... and of |M| = 676,171
TOL = 1e-5                   # x max|acc|: K1 contracts to FMA, the plain
                             # version rounds the product and the sum apart
                             # (K2, K3 and K4 round as the plain version
                             # does, and are held bitwise)
F32_PEAK = 67e12             # H100 SXM f32 (non-tensor-core) flop/s
# f32 products in split TF32 on the tensor cores: each is three dense TF32
# products (hi.hi + hi.lo + lo.hi) at 495 TFLOP/s, so 165 TFLOP/s of f32
TF32_SPLIT_PEAK = 495e12 / 3
BF16_PEAK = 989e12           # H100 SXM dense bf16 tensor-core flop/s
COMPRESSED = dict(comm_dtype="int8", topk_frac=1 / 14,
                  stochastic_rounding=True, error_feedback=True)
TREE = dict(agg_engine="tree")
SCAFFOLD = dict(variance_reduction="scaffold")
# bytes per round (down + up) at the smoke configuration, from the wire's
# closed forms: 5 simple clients exchange |M|, 5 complex ones every param;
# SCAFFOLD adds the raw f32 cv exchange both ways, doubling the f32 wire
F32_BYTES = 473_985_280
PER_SIMPLE_F32 = 2 * 2_704_684       # down + up of |M| = 676,171 in f32
PER_COMPLEX_F32 = 2 * 44_693_844     # ... of all 11,173,461 params
# (label, algorithm, rounds, config, launches per round of K1, K2, K3 (two
#  a fold: bounds, apply), K4 (one a tree fold), bytes per round; None:
#  the plan's realised clients decide)
RUNS = (("f32", "fedhen", 2, {}, (2, 0, 0, 0), F32_BYTES),
        ("f32", "noside", 1, {}, (2, 0, 0, 0), F32_BYTES),
        ("f32", "decouple", 1, {}, (4, 0, 0, 0), F32_BYTES),
        ("int8", "fedhen", 2, dict(comm_dtype="int8"), (0, 2, 0, 0),
         122_199_360),
        ("compressed", "fedhen", 2, COMPRESSED, (2, 0, 4, 0), 82_396_760),
        ("compressed", "decouple", 1, COMPRESSED, (4, 0, 8, 0), 82_396_760),
        ("tree f32", "fedhen", 2, TREE, (0, 0, 0, 2), F32_BYTES),
        ("tree f32", "decouple", 1, TREE, (0, 0, 0, 2), F32_BYTES),
        ("flat f32 scaffold", "fedhen", 2, SCAFFOLD, (4, 0, 0, 0),
         2 * F32_BYTES),
        ("tree f32 scaffold", "fedhen", 1, dict(TREE, **SCAFFOLD),
         (2, 0, 0, 2), 2 * F32_BYTES),
        ("flat f32 uniform", "fedhen", 1, dict(sample_uniform=True),
         (2, 0, 0, 0), None))


def memory_rate(name: str) -> tuple:
    """(bytes/s, part) of the card's HBM from its name: data-sheet rates."""
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe"
    return 3.35e12, "H100 SXM"


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured into one
    CUDA graph, the graph replayed once to warm up and once between two
    CUDA events, over ``iters``.  The graph launches its kernels back to
    back without the host, so a kernel shorter than the host's launch time
    is timed on the device, not by how fast the host queues it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


FLUSH_BYTES = 256 << 20      # over five times the H100's 50 MB L2


def time_ms_flushed(torch, fn, iters: int = 30) -> float:
    """:func:`time_ms` with the L2 flushed before every call: each call of
    ``fn`` in the graph follows a ``zero_()`` of ``FLUSH_BYTES``, and the
    graph of those writes alone, timed the same way, is subtracted.  The
    plain timer replays back-to-back calls on the same buffers, so a fold
    whose working set is near the L2's size reads part of it from there."""
    flush = torch.empty((FLUSH_BYTES // 4,), device="cuda")

    def flushed():
        flush.zero_()
        fn()
    ms = time_ms(torch, flushed, iters) - time_ms(torch, flush.zero_, iters)
    del flush
    return ms


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


def main_path_layout(torch):
    """The flat layout of full-width PreActResNet18-GN and its index-set-M
    mask on the card, as the trainer builds them (n_flat = N_MAIN)."""
    from repro_torch.core import flatten
    from repro_torch.core.adapters import ResNetAdapter
    adapter = ResNetAdapter(10)
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    layout = flatten.build_layout(params, total_multiple=2048)
    if layout.n_flat != N_MAIN:
        raise RuntimeError(f"n_flat {layout.n_flat} != {N_MAIN}")
    return layout, flatten.pack_mask(layout, adapter.subnet_mask(params),
                                     "cuda")


def fold_bytes(torch, mask, w_m, w_rest, row_bytes) -> int:
    """The least bytes a dense accumulating fold (K1, K2) moves for these
    weights: acc read (4N) and the mask (N); each row's payload where its
    weight is live, ``row_bytes(live inside M, live outside M)``; and acc
    written, 4 bytes for each element that a live row changes.  Counted
    from the mask and the weights, never from the output."""
    n, n_m = mask.numel(), int(mask.sum())
    live_m, live_rest = (w_m > 0).tolist(), (w_rest > 0).tolist()
    rows = sum(row_bytes(a, b) for a, b in zip(live_m, live_rest))
    changed = n_m * any(live_m) + (n - n_m) * any(live_rest)
    return 5 * n + rows + 4 * changed


def _bound(nbytes: float, flops: float, bw: float) -> tuple:
    """(bound ms, what bounds it) of ``nbytes`` moved and ``flops`` done."""
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / F32_PEAK * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def _fold_row(torch, label: str, fn, plain_ms: float, nbytes: int,
              all_bytes: int, flops: float, bw: float,
              flushed: bool = True, iters: int = 30) -> dict:
    """Time a K1 or K2 fold on both timers and hold it to the bound of
    the bytes its weights need (``nbytes``, :func:`fold_bytes`) and to the
    bound that stores every element (``all_bytes``: the live rows' bytes
    and acc read and written everywhere, the count the kernels that
    stored everywhere were held to), so the rows compare with theirs."""
    ms = time_ms(torch, fn, iters=iters)
    bound_ms, bound_by = _bound(nbytes, flops, bw)
    all_ms = _bound(all_bytes, flops, bw)[0]
    out = {"fold": label, "ms": ms, "plain_ms": plain_ms,
           "bytes_needed": nbytes, "bound_ms": bound_ms,
           "bound_share": bound_ms / ms, "bound_by": bound_by,
           "store_all_bytes": all_bytes, "store_all_bound_ms": all_ms,
           "store_all_bound_share": all_ms / ms}
    text = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB needed), share "
            f"{bound_ms / ms:.3f}; storing everywhere {all_ms:.4f} ms "
            f"({all_bytes / 1e6:.1f} MB), share {all_ms / ms:.3f}")
    if flushed:
        out["flushed_ms"] = flushed_ms = time_ms_flushed(torch, fn, iters)
        out["flushed_bound_share"] = bound_ms / flushed_ms
        out["flushed_store_all_bound_share"] = all_ms / flushed_ms
        text += (f"; L2 flushed {flushed_ms:.4f} ms, share "
                 f"{bound_ms / flushed_ms:.3f} (storing everywhere "
                 f"{all_ms / flushed_ms:.3f})")
    print(f"  {label}: {text}", flush=True)
    return out


def time_fold(torch, ops, ref, bw: float, mask, dtype, population: str,
              z: int = Z) -> dict:
    """Time one main-path fold: ``z`` clients of one population at the
    real mask (z = 1: the base term of a delta fold).  A complex client
    weighs 1 on both sides of M, a simple client 1 inside M and 0 outside,
    so the fold needs only the M part of its rows and changes only M's
    elements: the bound counts the bytes these weights need."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((z, N_MAIN), generator=g, device="cuda").to(dtype)
    acc = torch.randn((N_MAIN,), generator=g, device="cuda")
    w_m = torch.full((z,), float(Z) if z == 1 else 1.0, device="cuda")
    w_rest = w_m if population == "complex" else torch.zeros_like(w_m)
    n_m, size = int(mask.sum()), x.element_size()
    rows_read = N_MAIN if population == "complex" else n_m
    nbytes = fold_bytes(torch, mask, w_m, w_rest, lambda a, b: size * (
        n_m * a + (N_MAIN - n_m) * b))
    plain_ms = time_ms(torch, lambda: ref.masked_agg_acc_ref(
        acc, x, mask, w_m, w_rest))
    out = _fold_row(
        torch, f"masked_agg_acc {population}{' base' if z == 1 else ''} "
        f"fold {str(dtype).replace('torch.', '')} Z={z} N={N_MAIN:,}",
        lambda: ops.masked_agg_acc_(acc, x, mask, w_m, w_rest), plain_ms,
        nbytes, z * rows_read * size + 9 * N_MAIN, 2 * z * rows_read, bw)
    out.update(fold=population + (" base" if z == 1 else ""),
               x=str(dtype).replace("torch.", ""), Z=z)
    return out


def _check(torch, name: str, label: str, got, want, n: int) -> float:
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name} {label}: non-finite output")
    diff = float((got - want).abs().max())
    bound = TOL * float(want.abs().max())
    print(f"  {name} {label:28s} N={n:>10,d} max|diff|={diff:.3e} "
          f"(limit {bound:.3e})", flush=True)
    if not diff <= bound:
        raise RuntimeError(f"{name} {label}: {diff} > {bound}")
    return diff


def check_dead_rows(torch, ops, ref, mask, deq: bool) -> float:
    """Phase 3, the dead-row paths of K1 (``deq`` False: f32 and bf16 rows)
    or K2 (int8 at quant_block 128 and 1): a simple fold (``w_rest`` 0) and
    an all-dead launch (both weights 0), at the model's mask and at a
    random one, through the vector kernel, the scalar kernel (a
    misaligned acc) and a ragged N.  Row 2 is NaN (K2: NaN scales) at
    weight 0 everywhere, and acc holds -0.0 at every 7th element.  Each
    case is held to its plain version at ``TOL``, and every element that
    no live row touches bitwise to ``acc + 0.0``.  Returns the largest
    difference."""
    g = torch.Generator(device="cuda").manual_seed(17)
    masks = (("model's M", mask),
             ("random mask",
              torch.rand((N_MAIN,), generator=g, device="cuda") < 0.3))
    zero = torch.zeros((Z,), device="cuda")
    weights = (("simple", torch.tensor([1.0, 1.0, 0.0, 0.5, 1.0],
                                       device="cuda"), zero),
               ("all dead", zero, zero))
    name = "masked_agg_acc_deq" if deq else "masked_agg_acc"
    kinds = ((("int8 qb 128", QB), ("int8 qb 1", 1)) if deq else
             (("f32", torch.float32), ("bf16", torch.bfloat16)))
    worst = 0.0
    for kind, arg in kinds:
        for path, n, offset in (("vector", N_MAIN, 0),
                                ("scalar, misaligned acc", N_MAIN, 1),
                                ("scalar, ragged N", N_RAGGED, 0)):
            if deq and n % arg:
                continue             # quant_block 128 does not divide it
            acc0 = torch.randn((n,), generator=g, device="cuda")
            acc0[::7] = -0.0
            if deq:
                payload = (torch.randint(-127, 128, (Z, n), generator=g,
                                         device="cuda", dtype=torch.int8),
                           torch.rand((Z, n // arg), generator=g,
                                      device="cuda") * 0.01)
                payload[1][2] = float("nan")
                fold, plain = (functools.partial(
                    f, quant_block=arg) for f in (ops.masked_agg_acc_deq_,
                                                  ref.masked_agg_acc_deq_ref))
            else:
                payload = (torch.randn((Z, n), generator=g,
                                       device="cuda").to(arg),)
                payload[0][2] = float("nan")
                fold, plain = ops.masked_agg_acc_, ref.masked_agg_acc_ref
            dead_counts = []
            for mask_name, full in masks:
                m = full[:n].contiguous()
                for w_name, w_m, w_rest in weights:
                    label = f"{name} {kind} {path}, {mask_name}, {w_name}"
                    want = plain(acc0, *payload, m, w_m, w_rest)
                    acc = torch.empty((n + offset,), device="cuda")[offset:]
                    acc.copy_(acc0)
                    fold(acc, *payload, m, w_m, w_rest)
                    torch.cuda.synchronize()
                    diff = float((acc - want).abs().max())
                    if not bool(torch.isfinite(acc).all()) or \
                            not diff <= TOL * float(want.abs().max()):
                        raise RuntimeError(f"{label}: max|diff| {diff} or "
                                           f"non-finite")
                    dead = ~((m & bool((w_m > 0).any()))
                             | (~m & bool((w_rest > 0).any())))
                    if not torch.equal(acc.view(torch.int32)[dead],
                                       (acc0 + 0.0).view(torch.int32)[dead]):
                        raise RuntimeError(f"{label}: an element no live row "
                                           f"touches is not acc + 0.0")
                    worst = max(worst, diff)
                    dead_counts.append(int(dead.sum()))
            print(f"  {name} dead rows {kind}, {path} N={n:,}: simple and "
                  f"all-dead folds at the model's M and a random mask within"
                  f" TOL; {dead_counts} elements with no live row bitwise "
                  f"acc + 0.0", flush=True)
    return worst


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
        acc = torch.empty((n + offset,), device="cuda")[offset:]
        acc.copy_(acc0)
        ops.masked_agg_acc_(acc, x, mask, w_m, w_rest)
        worst = max(worst, _check(torch, "masked_agg_acc", label, acc, want,
                                  n))
    mask = main_path_layout(torch)[1]
    worst = max(worst, check_dead_rows(torch, ops, ref, mask, deq=False))
    timing = [time_fold(torch, ops, ref, bw, mask, dtype, population, z)
              for population, dtype, z in (
                  ("complex", torch.float32, Z),
                  ("complex", torch.bfloat16, Z),
                  ("simple", torch.float32, Z),
                  ("complex", torch.float32, 1),
                  ("simple", torch.float32, 1))]
    return {"max_abs_err": worst, "timing": timing}


def _deq_inputs(torch, n: int, quant_block: int, seed: int):
    """K2 inputs: int8 payload and per-group scales; row 2 has NaN scales
    at weight 0 (both branches), row 3 weight 0 inside M only."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, (Z, n), generator=g, device="cuda",
                      dtype=torch.int8)
    scales = torch.rand((Z, n // quant_block), generator=g,
                        device="cuda") * 0.01
    scales[2] = float("nan")
    mask = torch.rand((n,), generator=g, device="cuda") < 0.3
    w_m = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.5], device="cuda")
    w_rest = torch.tensor([0.0, 1.0, 0.0, 0.7, 0.25], device="cuda")
    acc = torch.randn((n,), generator=g, device="cuda")
    return acc, q, scales, mask, w_m, w_rest


def _timed(torch, name: str, label: str, fn, plain, nbytes: float,
           flops: float, bw: float) -> dict:
    ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
    bound_ms, bound_by = _bound(nbytes, flops, bw)
    out = {"fold": label, "ms": ms, "plain_ms": plain_ms,
           "bytes_needed": nbytes, "bound_ms": bound_ms,
           "bound_share": bound_ms / ms, "bound_by": bound_by}
    print(f"  {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB needed), bound "
          f"share {bound_ms / ms:.3f}", flush=True)
    return out


def check_deq(torch, ops, ref, bw: float, mask) -> dict:
    """Phase 3, K2: correctness on every path of the kernel, then the
    main path's two int8 folds (complex: weights 1 on both sides of M;
    simple: 1 inside M, 0 outside, so only M's bytes are needed)."""
    worst = 0.0
    for label, n, qb, offset in (("qb 128", N_MAIN, QB, 0),
                                 ("qb 8", N_MAIN, 8, 0),
                                 ("ragged qb 1", N_RAGGED, 1, 0),
                                 ("misaligned acc qb 128", N_MAIN, QB, 1)):
        acc0, q, scales, m, w_m, w_rest = _deq_inputs(torch, n, qb, seed=n)
        want = ref.masked_agg_acc_deq_ref(acc0, q, scales, m, w_m, w_rest,
                                          quant_block=qb)
        acc = torch.empty((n + offset,), device="cuda")[offset:]
        acc.copy_(acc0)
        ops.masked_agg_acc_deq_(acc, q, scales, m, w_m, w_rest,
                                quant_block=qb)
        worst = max(worst, _check(torch, "masked_agg_acc_deq", label, acc,
                                  want, n))
    worst = max(worst, check_dead_rows(torch, ops, ref, mask, deq=True))
    acc, q, scales, _, _, _ = _deq_inputs(torch, N_MAIN, QB, seed=7)
    scales = scales.nan_to_num()
    ones = torch.ones((Z,), device="cuda")
    m_elems = int(mask.sum())
    groups = mask.view(-1, QB)
    m_groups = int(groups.any(dim=1).sum())
    rest_groups = int((~groups).any(dim=1).sum())

    def row_bytes(live_m, live_rest):
        if live_m and live_rest:
            return N_MAIN + 4 * (N_MAIN // QB)
        return live_m * (m_elems + 4 * m_groups) + live_rest * (
            N_MAIN - m_elems + 4 * rest_groups)
    timing = []
    for population, w_rest, rows, n_groups in (
            ("complex", ones, N_MAIN, N_MAIN // QB),
            ("simple", torch.zeros_like(ones), m_elems, m_groups)):
        args = (acc, q, scales, mask, ones, w_rest)
        plain_ms = time_ms(torch, lambda: ref.masked_agg_acc_deq_ref(
            *args, quant_block=QB))
        label = f"{population} fold int8 Z={Z}"
        timing.append(_fold_row(
            torch, f"masked_agg_acc_deq {label}",
            lambda: ops.masked_agg_acc_deq_(*args, quant_block=QB), plain_ms,
            fold_bytes(torch, mask, ones, w_rest, row_bytes),
            Z * rows + 4 * Z * n_groups + 9 * N_MAIN, 3 * Z * rows, bw))
        timing[-1]["fold"] = label
    return {"max_abs_err": worst, "timing": timing}


def _scatter_inputs(torch, k: int, dtype, seed: int, positions=None):
    """K3 inputs at the main path's N: each row's k indices sorted and
    distinct, drawn from ``positions`` (default every position), so rows
    collide; values int8 with scales, or bf16 without.  Row 2 is NaN at
    weight 0 (both branches), row 3 has weight 0 inside M only."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = positions if positions is not None else \
        torch.arange(N_MAIN, device="cuda")
    idx = torch.stack([pool[torch.randperm(pool.numel(), generator=g,
                                           device="cuda")[:k]].sort().values
                       for _ in range(Z)]).to(torch.int32)
    scales = None
    if dtype == torch.int8:
        values = torch.randint(-127, 128, (Z, k), generator=g, device="cuda",
                               dtype=torch.int8)
        scales = torch.rand((Z, k // QB), generator=g, device="cuda") * 0.01
    else:
        values = torch.randn((Z, k), generator=g, device="cuda").to(dtype)
    acc = torch.randn((N_MAIN,), generator=g, device="cuda")
    return acc, values, scales, idx


def _sector_bytes(torch, idx, k: int) -> int:
    """What a top-k fold of the live rows ``idx`` (Z, k) moves at the
    card's 32-byte sector: every sector of acc its positions touch, read
    and written, every mask sector read once, and the payload (int8
    values, int32 indices, one f32 scale per QB entries)."""
    flat = idx.flatten().to(torch.int64)
    acc_sectors = int(torch.unique(flat // 8).numel())
    mask_sectors = int(torch.unique(flat // 32).numel())
    z = idx.shape[0]
    return 64 * acc_sectors + 32 * mask_sectors + z * k * 5 + \
        4 * z * (k // QB)


def _launch_breakdown(torch, fn, calls: int = 20) -> dict:
    """Mean device time (us) of each kernel or memset that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls after a
    warm-up; empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = re.search(r"(\w+)(?:<[^(]*>)?\(", ev.key)
            out[name.group(1) if name else ev.key] = \
                ev.device_time_total / calls
    return out


def check_scatter(torch, ops, ref, bw: float, mask) -> dict:
    """Phase 3, K3: correctness at both populations' k, for int8 with
    scales and bf16, at Z = 1 and k = QB, with every index in one span,
    with rows dense enough to take several staging rounds, and on a
    misaligned accumulator; then the main path's two top-k folds (int8 +
    scales; the simple clients' entries all lie in M), each against two
    bounds: 8 acc bytes an entry, and the 32-byte sectors its indices
    touch."""
    worst = 0.0
    w_m = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.5], device="cuda")
    w_rest = torch.tensor([0.0, 1.0, 0.0, 0.7, 0.25], device="cuda")

    def check(label, acc0, values, scales, idx, wm, wr, offset=0):
        nonlocal worst
        want = ref.masked_scatter_acc_ref(acc0, values, scales, idx, mask,
                                          wm, wr, quant_block=QB)
        acc = torch.empty((N_MAIN + offset,), device="cuda")[offset:]
        acc.copy_(acc0)
        ops.masked_scatter_acc_(acc, values, scales, idx, mask, wm, wr,
                                quant_block=QB)
        worst = max(worst, _check(torch, "masked_scatter_acc", label, acc,
                                  want, N_MAIN))

    for k in (K_COMPLEX, K_SIMPLE):
        for dtype in (torch.int8, torch.bfloat16):
            acc0, values, scales, idx = _scatter_inputs(torch, k, dtype,
                                                        seed=k)
            if scales is not None:
                scales[2] = float("nan")
            else:
                values[2] = float("nan")
            check(f"k={k:,} {str(dtype).replace('torch.', '')}", acc0,
                  values, scales, idx, w_m, w_rest)
    acc0, values, scales, idx = _scatter_inputs(torch, QB, torch.int8, 5)
    one = torch.ones((1,), device="cuda")
    check("Z=1 k=128 int8", acc0, values[:1], scales[:1], idx[:1], one,
          one * 0.5)
    span = torch.arange(5_000_000, 5_000_000 + 1024, device="cuda")
    acc0, values, scales, idx = _scatter_inputs(torch, 256, torch.int8, 6,
                                                positions=span)
    check("one span int8", acc0, values, scales, idx, w_m, w_rest)
    acc0, values, scales, idx = _scatter_inputs(torch, N_MAIN // 2,
                                                torch.bfloat16, 8)
    check("k=N/2 bf16 (staging rounds)", acc0, values, scales, idx, w_m,
          w_rest)
    acc0, values, scales, idx = _scatter_inputs(torch, K_COMPLEX, torch.int8,
                                                9)
    check("misaligned acc int8", acc0, values, scales, idx, w_m, w_rest,
          offset=1)
    ones = torch.ones((Z,), device="cuda")
    timing = []
    in_m = torch.nonzero(mask).flatten()
    for population, k, w_rest, pool in (
            ("complex", K_COMPLEX, ones, None),
            ("simple", K_SIMPLE, torch.zeros_like(ones), in_m)):
        acc, values, scales, idx = _scatter_inputs(torch, k, torch.int8,
                                                   seed=3, positions=pool)
        args = (acc, values, scales, idx, mask, ones, w_rest)
        out = _timed(
            torch, "masked_scatter_acc", f"{population} fold int8 Z={Z} "
            f"k={k:,}", lambda: ops.masked_scatter_acc_(*args, quant_block=QB),
            lambda: ref.masked_scatter_acc_ref(*args, quant_block=QB),
            Z * k * (1 + 4 + 1 + 8) + 4 * Z * (k // QB), 3 * Z * k, bw)
        # the card moves 32-byte sectors: the bound of what these indices
        # touch (counted here, outside the timed calls)
        sectors = _sector_bytes(torch, idx, k)
        out["entry_bound_ms"] = out["bound_ms"]
        out["entry_bound_share"] = out["bound_share"]
        out["bytes_needed"] = sectors
        out["bound_ms"] = max(sectors / bw * 1e3, out["bound_ms"])
        out["bound_share"] = out["bound_ms"] / out["ms"]
        print(f"    sector bound {out['bound_ms']:.4f} ms ({sectors / 1e6:.1f}"
              f" MB of 32-byte sectors), share {out['bound_share']:.3f}; "
              f"per-entry share {out['entry_bound_share']:.3f}", flush=True)
        out["launch_us"] = _launch_breakdown(
            torch, lambda: ops.masked_scatter_acc_(*args, quant_block=QB))
        print("    device time by launch (us, mean of 20 calls): " +
              ", ".join(f"{k} {v:.2f}" for k, v in out["launch_us"].items()),
              flush=True)
        # context, not the function: one index_add_ of values already
        # dequantized and weighted
        flat_idx = idx.flatten().to(torch.int64)
        weighted = (values.float() * scales.repeat_interleave(QB, dim=1)
                    ).flatten()
        out["index_add_context_ms"] = time_ms(
            torch, lambda: acc.index_add_(0, flat_idx, weighted))
        print(f"    context: index_add_ of the pre-weighted values "
              f"{out['index_add_context_ms']:.4f} ms", flush=True)
        timing.append(out)
    return {"max_abs_err": worst, "timing": timing}


def check_tree_fold(torch, ops, ref, bw: float) -> dict:
    """Phase 3, K4: bitwise against its plain version, f32 and bf16 at
    Z = 5 with a NaN row at weight 0 and a zero-weight row.  The one-shot
    entry: every one of the model's 59 leaves as a strided view of the
    (5, N_MAIN) chunk buffer with the leaf's own mask, the whole buffer at
    a per-element random mask, and a ragged N.  The tree engine's fold:
    all 59 leaves accumulated in one launch, against ``acc +
    masked_agg_ref(leaf)`` per leaf, on f32 rows and on bf16 rows widened
    as the engine widens them.  Then the main path's timings: the fold as
    the engine launches it, the largest leaf through the one-shot entry,
    and the earlier design's 59 one-shot launches beside them."""
    from repro_torch.core import flatten
    from repro_torch.tree import tree_leaves, tree_map
    layout, flat_mask = main_path_layout(torch)
    leaf_masks = flatten.unpack(layout, flat_mask, cast=False)
    plan = ops.fold_plan(layout, "cuda")
    worst, checked = 0.0, 0

    def same(label, got, want):
        nonlocal worst, checked
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"masked_agg {label}: dtype or non-finite")
        diff = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        worst, checked = max(worst, diff), checked + 1
        if diff != 0.0:
            raise RuntimeError(f"masked_agg {label}: max|diff| {diff} != 0")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        acc0, x, mask, w_m, w_rest = fold_inputs(torch, N_MAIN, dtype,
                                                 seed=11)
        stacked = flatten.unpack_stacked(layout, x)
        for i, (leaf, m) in enumerate(zip(tree_leaves(stacked),
                                          tree_leaves(leaf_masks))):
            rows = leaf.reshape(Z, -1)
            same(f"{name} leaf {i}", ops.masked_agg_(rows, m.reshape(-1),
                                                     w_m, w_rest),
                 ref.masked_agg_ref(rows, m.reshape(-1), w_m, w_rest))
        same(f"{name} whole buffer, random mask",
             ops.masked_agg_(x, mask, w_m, w_rest),
             ref.masked_agg_ref(x, mask, w_m, w_rest))
        x32 = x.to(torch.float32)
        acc = acc0.clone()
        before = ops.masked_agg_fold_.launches
        ops.masked_agg_fold_(acc, x32, flat_mask, w_m, w_rest, plan)
        if ops.masked_agg_fold_.launches != before + 1:
            raise RuntimeError("masked_agg_fold_: not one launch")
        same(f"{name} fold of 59 leaves, accumulated", acc,
             ref.masked_agg_fold_ref(acc0, x32, flat_mask, w_m, w_rest,
                                     plan.leaves))
        _, x, mask, w_m, w_rest = fold_inputs(torch, N_RAGGED, dtype,
                                              seed=12)
        same(f"{name} ragged", ops.masked_agg_(x, mask, w_m, w_rest),
             ref.masked_agg_ref(x, mask, w_m, w_rest))
    print(f"  masked_agg: {checked} cases (59 leaves as strided views, the "
          f"whole buffer, N={N_RAGGED:,}, the accumulated fold of all 59 "
          f"leaves; f32 and bf16) bitwise equal to the plain version, "
          f"max|diff| {worst}", flush=True)
    # the main path's fold: f32 rows, complex clients (weight 1 both sides)
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((Z, N_MAIN), generator=g, device="cuda")
    acc = torch.randn((N_MAIN,), generator=g, device="cuda")
    ones = torch.ones((Z,), device="cuda")
    n_all = layout.n_params
    leaves = plan.leaves.cpu()     # the plain version reads it on the host
    fold = _timed(torch, "masked_agg_fold", f"tree fold, one launch, "
                  f"{layout.n_leaves} leaves accumulated, f32 Z={Z} "
                  f"N={n_all:,}",
                  lambda: ops.masked_agg_fold_(acc, x, flat_mask, ones, ones,
                                               plan),
                  lambda: ref.masked_agg_fold_ref(acc, x, flat_mask, ones,
                                                  ones, leaves),
                  Z * 4 * n_all + n_all + 8 * n_all, 2 * Z * n_all, bw)
    # the one-shot function's bound (no accumulator read), which the
    # earlier design's 59-launch fold was held to
    fold["oneshot_bound_ms"] = (Z * 4 + 1 + 4) * n_all / bw * 1e3
    fold["oneshot_bound_share"] = fold["oneshot_bound_ms"] / fold["ms"]
    print(f"    against the one-shot fold's bound "
          f"{fold['oneshot_bound_ms']:.4f} ms: share "
          f"{fold['oneshot_bound_share']:.3f}", flush=True)
    stacked = flatten.unpack_stacked(layout, x)
    sizes = [s.size for s in layout.slots]
    big = max(range(len(sizes)), key=sizes.__getitem__)
    rows = tree_leaves(stacked)[big].reshape(Z, -1)
    m = tree_leaves(leaf_masks)[big].reshape(-1)
    n_big = sizes[big]
    leaf = _timed(torch, "masked_agg", f"largest leaf f32 Z={Z} "
                  f"N={n_big:,} (strided rows)",
                  lambda: ops.masked_agg_(rows, m, ones, ones),
                  lambda: ref.masked_agg_ref(rows, m, ones, ones),
                  Z * 4 * n_big + n_big + 4 * n_big, 2 * Z * n_big, bw)
    per_leaf = time_ms(torch, lambda: ops.masked_agg_tree(
        stacked, leaf_masks, ones, ones))
    fold["per_leaf_launches_ms"] = per_leaf
    print(f"    context: the earlier design's path, {len(sizes)} one-shot "
          f"launches (masked_agg_tree, no accumulate) {per_leaf:.4f} ms",
          flush=True)
    fold["N"], leaf["N"], fold["launches"] = n_all, n_big, 1
    return {"max_abs_err": worst, "timing": [fold, leaf]}


def _counts(ops) -> tuple:
    """Launches of K1, K2, K3 (its two passes) and K4 (both entries)."""
    return (ops.masked_agg_acc_.launches, ops.masked_agg_acc_deq_.launches,
            ops.masked_scatter_acc_.launches,
            ops.masked_agg_.launches + ops.masked_agg_fold_.launches)


def _zero_counts(ops) -> None:
    for fn in (ops.masked_agg_acc_, ops.masked_agg_acc_deq_,
               ops.masked_scatter_acc_, ops.masked_agg_,
               ops.masked_agg_fold_):
        fn.launches = 0


def resnet_cell_data(torch) -> tuple:
    """The ResNet round cell's data: 50,000 synthetic CIFAR images over
    100 clients (on the card) and 512 test images."""
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_cifar
    t0 = time.perf_counter()
    data = synthetic_cifar(50_000, 10, seed=0)
    test = synthetic_cifar(512, 10, seed=999)
    shards = [{k: torch.as_tensor(v).cuda() for k, v in s.items()}
              for s in iid_split(data, 100, seed=1)]
    print(f"  data: 50,000 images over 100 clients in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    return shards, test


def main_path(torch, ops) -> dict:
    """Phase 4: the port's round at full width, through its entry points,
    on every wire, both engines, SCAFFOLD and uniform sampling.  Each
    run's kernel launches are counted from 0 and checked per round."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer

    shards, test = resnet_cell_data(torch)
    out = {"rounds": []}
    total = (0, 0, 0, 0)
    for label, algo, rounds, cfg, per_round, per_round_bytes in RUNS:
        fed = FedConfig(n_devices=100, n_simple=50, participation=0.1,
                        local_epochs=1, batch_size=50, lr=0.1,
                        algorithm=algo, **cfg)
        trainer = FederatedTrainer(ResNetAdapter(10), fed, shards,
                                   device="cuda")
        stores = {name: f"{st.backend} {st.nbytes / 1e9:.2f} GB"
                  for name, st in (("ef", trainer.ef_store),
                                   ("cv", trainer.cv_store))
                  if st is not None}
        _zero_counts(ops)
        for _ in range(rounds):
            plan = trainer.sampler.plan(trainer.server.round)
            billed = trainer.total_bytes
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = trainer.run_round()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            billed = trainer.total_bytes - billed
            ev = trainer.evaluate(test)
            n_real = plan.n_real_simple + plan.n_real_complex
            row = {"run": label, "algorithm": algo,
                   "round": trainer.server.round, "round_s": dt,
                   "stores": stores, "realised_clients": n_real,
                   "bytes": billed,
                   **m, **{k: ev[k] for k in ("acc_simple", "acc_complex",
                                              "mbytes_down", "mbytes_up")}}
            print("  " + json.dumps(row), flush=True)
            if not (math.isfinite(m["loss_simple"])
                    and math.isfinite(m["loss_complex"])):
                raise RuntimeError(f"{label} {algo}: non-finite loss {m}")
            if m["n_valid"] != n_real:
                raise RuntimeError(f"{label} {algo}: n_valid {m['n_valid']}"
                                   f", {n_real} clients realised")
            want = per_round_bytes
            if want is None:        # uniform: only realised clients pay
                want = (plan.n_real_simple * PER_SIMPLE_F32
                        + plan.n_real_complex * PER_COMPLEX_F32)
            if billed != want:
                raise RuntimeError(f"{label} {algo}: {billed} bytes billed, "
                                   f"expected {want}")
            out["rounds"].append(row)
        launched = _counts(ops)
        expected = tuple(rounds * n for n in per_round)
        print(f"  {label} {algo}: launches K1/K2/K3/K4 {launched} over "
              f"{rounds} round(s), expected {expected}; bytes per round "
              f"{trainer.bytes_per_round:,.0f} (down "
              f"{trainer.bytes_down_per_round:,.0f}, up "
              f"{trainer.bytes_up_per_round:,.0f}); stores {stores}",
              flush=True)
        if launched != expected:
            raise RuntimeError(f"{label} {algo}: launches {launched}, "
                               f"expected {expected}")
        total = tuple(a + b for a, b in zip(total, launched))
        del trainer
    out["launches"] = total
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  main path launches K1/K2/K3/K4 {total}; peak memory "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    return out


def card_vs_cpu(torch) -> None:
    """Phase 5: one narrow fedhen round on the card against the CPU, on
    the f32 wire (rtol 1e-4, atol 1e-5) and on the compressed wire (the
    lossy-wire rules; both runs draw their stochastic-rounding bits from
    the same CPU provider, the default)."""
    from repro_torch import parity
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import flatten
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_cifar

    # 16x16 images, as in the CPU parity tests: at 8x8 the last stage's
    # GroupNorm groups hold 2 values and f32 rounding alone exceeds 1e-5
    shards = iid_split(synthetic_cifar(32, 10, seed=0, image_size=16), 4,
                       seed=1)
    for wire, cfg in (("f32", {}), ("compressed", COMPRESSED)):
        fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                        local_epochs=1, batch_size=4, algorithm="fedhen",
                        **cfg)
        results, steps = {}, []
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            t = FederatedTrainer(ResNetAdapter(10, (8, 16, 16, 16)), fed,
                                 shards, device=dev)
            start = flatten.pack(t.layout, t.server.complex)
            uploads = parity.UploadSteps()
            with uploads():
                metrics = t.run_round()
            end = flatten.pack(t.layout, t.server.complex)
            steps.append(parity.round_step(t.wire, start, end, uploads))
            ef = (t.ef_store.gather(range(4)).flatten()
                  if t.ef_store is not None else None)
            results[side] = (metrics, end, ef)
        step = torch.maximum(*steps)
        res = parity.lossy_compare(results["card"][1], results["cpu"][1],
                                   step)
        print(f"  narrow fedhen round on the {wire} wire, card vs CPU: "
              f"{json.dumps(res)}; losses card {results['card'][0]} cpu "
              f"{results['cpu'][0]}", flush=True)
        # the f32 wire has no step: every element within rtol/atol
        if res["share"] > 1e-3 or res["worst"] > 1.0:
            raise RuntimeError(f"{wire}: card and CPU rounds disagree "
                               f"beyond the lossy-wire rules: {res}")
        if results["card"][2] is not None:
            res = parity.lossy_compare(results["card"][2],
                                       results["cpu"][2], step.repeat(4))
            print(f"  EF rows, card vs CPU: {json.dumps(res)}", flush=True)
            if res["share"] > 1e-3 or res["worst"] > 1.0:
                raise RuntimeError(f"EF rows disagree: {res}")
        for key in ("loss_simple", "loss_complex"):
            if abs(results["card"][0][key] - results["cpu"][0][key]) > 1e-5:
                raise RuntimeError(f"{wire}: card and CPU {key} disagree "
                                   f"beyond 1e-5")
    # two tree-engine SCAFFOLD rounds: the second trains with c != 0
    fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                    local_epochs=1, batch_size=4, algorithm="fedhen",
                    agg_engine="tree", variance_reduction="scaffold")
    runs = {}
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        t = FederatedTrainer(ResNetAdapter(10, (8, 16, 16, 16)), fed,
                             shards, device=dev)
        metrics = [t.run_round() for _ in range(2)]
        runs[side] = (metrics, flatten.pack(t.layout, t.server.complex).cpu(),
                      t.cv_global.cpu(), t.cv_store.gather(range(4)).cpu())
    worst = 0.0
    for what, a, b in zip(("server params", "cv_global", "cv rows"),
                          runs["card"][1:], runs["cpu"][1:]):
        excess = float(((a - b).abs() - (1e-5 + 1e-4 * b.abs())).max())
        worst = max(worst, float((a - b).abs().max()))
        if excess > 0:
            raise RuntimeError(f"tree SCAFFOLD {what}: card and CPU differ "
                               f"beyond rtol 1e-4 / atol 1e-5")
    for mc, mp in zip(*(runs[k][0] for k in ("card", "cpu"))):
        for key in ("loss_simple", "loss_complex"):
            if abs(mc[key] - mp[key]) > 1e-5:
                raise RuntimeError(f"tree SCAFFOLD: card and CPU {key} "
                                   f"disagree beyond 1e-5")
    print(f"  two narrow tree-engine SCAFFOLD fedhen rounds, card vs CPU: "
          f"server params, cv_global and cv rows within rtol 1e-4 / atol "
          f"1e-5 (max abs {worst:.3e}); losses card {runs['card'][0]} cpu "
          f"{runs['cpu'][0]}", flush=True)


def _pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal window keeps: key j <= query i and,
    when windowed, i - j < window."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _close(torch, name: str, got, want, rtol: float, atol: float) -> float:
    """Every element within atol + rtol * |want|; returns max |diff|."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise RuntimeError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                           f"{want.dtype} {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    excess = float((diff - atol - rtol * want.float().abs()).max())
    worst = float(diff.max())
    print(f"  {name}: max|diff| {worst:.3e} (rtol {rtol:g}, atol {atol:g})",
          flush=True)
    if excess > 0:
        raise RuntimeError(f"{name}: beyond rtol {rtol} / atol {atol} "
                           f"(max|diff| {worst})")
    return worst


# (label, B, S, H, Kh, Dh, window, softcap, dtype, timed): bf16 runs on
# the tensor-core kernel, f32 on the CUDA-core kernel
FLASH_CASES = (
    ("recurrentgemma-2b prefill", 4, 4096, 10, 1, 256, 2048, 0.0, "bfloat16",
     True),
    ("gemma2-2b local prefill", 1, 8192, 8, 4, 256, 4096, 50.0, "bfloat16",
     True),
    ("gemma2-2b global prefill", 1, 8192, 8, 4, 256, 0, 50.0, "bfloat16",
     True),
    ("gemma3-4b local prefill", 1, 8192, 8, 4, 256, 1024, 0.0, "bfloat16",
     True),
    ("minitron-8b prefill", 1, 4096, 32, 8, 128, 0, 0.0, "bfloat16", True),
    ("starcoder2-15b prefill", 1, 4096, 48, 4, 128, 0, 0.0, "bfloat16",
     True),
    ("qwen2-moe-a2.7b prefill", 1, 4096, 16, 16, 128, 0, 0.0, "bfloat16",
     True),
    ("kimi-k2 prefill", 1, 4096, 64, 8, 112, 0, 0.0, "bfloat16", True),
    ("recurrentgemma-2b shape in f32", 4, 4096, 10, 1, 256, 2048, 0.0,
     "float32", True),
    ("gemma2-2b global in f32", 1, 8192, 8, 4, 256, 0, 50.0, "float32",
     True),
    ("f32", 2, 1024, 4, 2, 128, 256, 0.0, "float32", False),
    ("ragged S f32", 2, 1000, 6, 2, 64, 0, 30.0, "float32", False),
    ("G 3, ragged S f32", 2, 1000, 6, 2, 64, 0, 0.0, "float32", False),
    ("G 130 f32", 1, 70, 130, 1, 256, 0, 0.0, "float32", False),
    ("Dh 32 f32", 2, 190, 4, 1, 32, 0, 0.0, "float32", False),
    ("window under a tile, softcap f32", 2, 700, 8, 4, 256, 9, 30.0,
     "float32", False),
    ("Dh 32 bf16", 3, 513, 4, 1, 32, 40, 0.0, "bfloat16", False),
    ("G 3, ragged S bf16", 2, 1000, 6, 2, 64, 0, 0.0, "bfloat16", False),
    ("Dh 128, softcap and window bf16", 2, 777, 4, 2, 128, 200, 30.0,
     "bfloat16", False),
    ("G 130 bf16", 1, 70, 130, 1, 64, 0, 0.0, "bfloat16", False),
    ("Dh 112 f32", 2, 1000, 8, 2, 112, 300, 30.0, "float32", False),
    ("Dh 112 bf16", 3, 513, 8, 8, 112, 0, 0.0, "bfloat16", False),
)
# (route, peak the bound counts, peak of a second share): f32 stays on the
# CUDA cores (67 TFLOP/s); split TF32 on the tensor cores (TF32_SPLIT_PEAK,
# 495 / 3 = 165 TFLOP/s of f32 products) could not hold the f32 tolerance
# (``launch/tune_flash.py``), and the second share is against that rate
FLASH_ROUTES = {"bfloat16": ("tensor cores (wgmma)", BF16_PEAK, None),
                "float32": ("CUDA cores", F32_PEAK, TF32_SPLIT_PEAK)}


def check_flash(torch, bw: float) -> dict:
    """Phase 6, K5's two kernels: against the plain version (f32 on the
    CUDA cores at rtol = atol = 1e-5, bf16 on the tensor cores within one
    bf16 rounding: rtol = atol = 2**-7), each call checked to launch its
    dtype's kernel, then timed at the path's shapes beside SDPA.  The bound
    counts the kept pairs' 4 * Dh flops at the route's peak (dense bf16
    tensor cores, or f32 CUDA cores) and q, k, v and out once at the HBM
    rate; f32 rows also print their share of the bound at split TF32's
    peak."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    fa = ops.flash_attention
    worst = {"bfloat16": 0.0, "float32": 0.0}
    timing = []
    for label, b, s, h, kh, dh, window, cap, dtype, timed in FLASH_CASES:
        g = torch.Generator(device="cuda").manual_seed(s + h)
        dt = getattr(torch, dtype)
        q = (torch.randn((b, s, h, dh), generator=g, device="cuda") * 2
             ).to(dt)
        k = (torch.randn((b, s, kh, dh), generator=g, device="cuda") * 2
             ).to(dt)
        v = torch.randn((b, s, kh, dh), generator=g, device="cuda").to(dt)
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7
        route, peak, peak2 = FLASH_ROUTES[dtype]
        before = (fa.launches_tc, fa.launches)
        got = fa(q, k, v, window=window, softcap=cap)
        tc = dtype == "bfloat16"
        if (fa.launches_tc, fa.launches) != (before[0] + tc,
                                             before[1] + (not tc)):
            raise RuntimeError(f"flash_attention {label}: {dtype} did not "
                               f"launch the {route} kernel once")
        want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
        worst[dtype] = max(worst[dtype], _close(
            torch, f"flash_attention [{route}] {label} {(b, s, h, kh, dh)} "
            f"{dtype} window {window} softcap {cap:g}", got, want, tol, tol))
        del got, want
        if not timed:
            continue
        pairs = _pairs(s, window)
        flops = 4 * dh * pairs * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / bw * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        ms = time_ms(torch, lambda: fa(q, k, v, window=window, softcap=cap),
                     iters=10, warmup=2)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, window=window, softcap=cap), iters=3, warmup=1)
        row = {"case": label, "route": route,
               "shape": {"B": b, "S": s, "H": h, "Kh": kh, "Dh": dh,
                         "window": window, "softcap": cap, "dtype": dtype},
               "ms": ms, "plain_ms": plain_ms, "pairs": pairs,
               "flops": flops, "bytes_needed": nbytes, "peak_flops": peak,
               "bound_ms": bound_ms, "bound_share": bound_ms / ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": flops / ms / 1e9, "library_ms": None}
        if peak2 is not None:
            row["bound_ms_at_tf32_split"] = max(flops / peak2 * 1e3,
                                                bytes_ms)
            row["bound_share_at_tf32_split"] = (
                row["bound_ms_at_tf32_split"] / ms)
        if not cap:
            # the library call: SDPA on the same inputs, the causal window
            # as a boolean mask, the kv head expanded to every query head
            pos = torch.arange(s, device="cuda")
            mask = pos[:, None] >= pos[None, :]
            if window:
                mask &= (pos[:, None] - pos[None, :]) < window
            qt = q.transpose(1, 2)
            kt = k.repeat_interleave(h // kh, dim=2).transpose(1, 2)
            vt = v.repeat_interleave(h // kh, dim=2).transpose(1, 2)

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
            row["library_ms"] = time_ms(torch, lib, iters=5, warmup=2)
            row["library_max_abs_diff"] = float(
                (lib().transpose(1, 2).float() - fa(
                    q, k, v, window=window).float()).abs().max())
            del qt, kt, vt, mask
        print(f"  flash_attention [{route}] {label}: kernel {ms:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({row['bound_by']} at "
              f"{peak / 1e12:.0f} TFLOP/s; {pairs:,} pairs x {b * h} "
              f"heads), bound share {bound_ms / ms:.4f}"
              + ("" if peak2 is None else
                 f" (at {peak2 / 1e12:.0f} TFLOP/s: "
                 f"{row['bound_ms_at_tf32_split']:.4f} ms, share "
                 f"{row['bound_share_at_tf32_split']:.4f})")
              + ("" if row["library_ms"] is None else
                 f", SDPA {row['library_ms']:.4f} ms"), flush=True)
        timing.append(row)
        del q, k, v
    return {"max_abs_err": worst, "timing": timing}


K6_PATH = (4, 4096, 2560)   # recurrentgemma-2b's prefill: batch 4, prompt
                            # 4096, d_rnn 2560


def gate_inputs(torch, b: int, s: int, d: int, dtype, seed: int,
                with_y0: bool = False) -> tuple:
    """x (B, S, D) in ``dtype`` and one RG-LRU layer's gate parameters:
    lam drawn as ``init_rglru`` draws it, w_r, b_r, w_i, b_i normal (the
    init's zeros would hold every gate at 0.5); y0 (B, D) f32 or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, d), generator=g, device="cuda").to(dtype)
    p = {k: torch.randn((d,), generator=g, device="cuda")
         for k in ("w_r", "b_r", "w_i", "b_i")}
    u = 0.9 + (0.999 - 0.9) * torch.rand((d,), generator=g, device="cuda")
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / 8.0))
    y0 = (torch.randn((b, d), generator=g, device="cuda") if with_y0
          else None)
    return x, p, y0


def gates_composition(p: dict, x):
    """What the gated entry replaces, unfused: ``rglru._gates`` (about
    seventeen f32 passes), K6 on its a and b, the cast to x's dtype."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.models import rglru
    a, b = rglru._gates(p, x)
    return ops.lru_scan(a, b).to(x.dtype)


def time_composition(torch) -> float:
    """Device ms of one layer's unfused composition at the path's shape,
    bf16 x (the gated entry's yardstick)."""
    x, p, _ = gate_inputs(torch, *K6_PATH, torch.bfloat16, seed=5)
    ms = time_ms(torch, lambda: gates_composition(p, x), iters=10,
                 warmup=2)
    print(f"  unfused gates + K6 + cast {K6_PATH} bf16 x: {ms:.4f} ms a "
          f"layer, {18 * ms:.3f} ms a prefill of 18 RG-LRU layers",
          flush=True)
    return ms


# K6's plain cases (B, S, D, dtype, timed): the path's shape (timed in
# f32), then shapes that cut a time tile (S = 16 k + 1 and 64 k + 1: the
# plain and the gated tiling's) and a channel stripe (D = 128 + 1,
# 2 x 128 + 4, 32 + 1, 2 x 32 + 4), B x D under one stripe, S = 1, and rows
# TMA cannot describe (D x size not a multiple of 16 bytes, or under one
# box: the producer warp's loads); the gated cases (B, S, D, dtype, y0,
# timed), timed in bf16, the model's dtype
SCAN_CASES = ((4, 4096, 2560, "float32", True),
              (4, 4096, 2560, "bfloat16", False),
              (3, 1000, 77, "float32", False),
              (2, 17, 130, "bfloat16", False),
              (2, 129, 129, "float32", False),
              (2, 129, 260, "float32", False),
              (3, 65, 2560, "bfloat16", False),
              (1, 300, 8, "float32", False),
              (3, 1, 64, "float32", False))
GATED_CASES = ((4, 4096, 2560, "bfloat16", False, True),
               (4, 4096, 2560, "bfloat16", True, False),
               (4, 4096, 2560, "float32", True, False),
               (3, 1000, 77, "bfloat16", True, False),
               (2, 129, 68, "float32", False, False),
               (2, 129, 68, "bfloat16", True, False),
               (3, 65, 33, "float32", True, False))
# FP32 instructions a second (two flops an FMA) and MUFU operations a
# second (16 a clock an SM) of an H100 SXM at its 1.98 GHz boost clock
F32_ISSUE = F32_PEAK / 2
MUFU_RATE = 16 * 132 * 1.98e9
F32_CLASS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSET", "FSETP",
             "FCHK", "FRND", "FSWZADD")


def _sass_ops(torch, gated: bool, bf16: bool) -> list:
    """The opcodes of K6's main body (up to its last EXIT: the slow paths
    of IEEE division and sqrt, called subroutines, come after it), in
    order, from the built library's SASS (``cuobjdump -sass``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import build
    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
         str(build.build().path)], capture_output=True, text=True,
        check=True, timeout=120).stdout
    tag = ("It" if bf16 else "If") + ("Lb1E" if gated else "Lb0E")
    bodies = [f for f in sass.split("Function : ")[1:]
              if "lru_scan_kernel" in f.split("\n", 1)[0]
              and tag in f.split("\n", 1)[0]]
    if len(bodies) != 1:
        raise RuntimeError(f"K6 {tag}: {len(bodies)} functions in the SASS")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", bodies[0])
    return ops[:max(i for i, op in enumerate(ops) if op == "EXIT") + 1]


def gate_ops(torch) -> dict:
    """FP32 and MUFU instructions an element of the gate math, from the
    gated bf16 kernel's SASS.  A gate thread takes E elements a tile
    (``ops.GATED``: 8), unrolled and straight-line, seven MUFU an element
    (four EX2 for the expf, two RCP, one RSQ): the first run of 7 E MUFU
    with no branch among them holds their math (the exact paths of
    out-of-range operands come after a branch, the prologue's integer
    division before one).  The FP32 instructions of the first element
    before its first MUFU and of the last after its last are missed, so
    the bound is a little low."""
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    tl = scan_ops.GATED
    elements = tl.tile * tl.stripe // (32 * tl.gate_warps)
    ops = _sass_ops(torch, True, True)
    at = [i for i, op in enumerate(ops) if op == "MUFU"]
    n = 7 * elements
    run = next((ops[at[k]:at[k + n - 1] + 1] for k in range(len(at) - n + 1)
                if "BRA" not in ops[at[k]:at[k + n - 1] + 1]), None)
    if run is None:
        raise RuntimeError(f"no run of {n} MUFU without a branch in the "
                           f"gated kernel's SASS ({len(at)} MUFU)")
    f32 = sum(op in F32_CLASS for op in run)
    print(f"  gate math from the SASS: {f32} FP32 and {n} MUFU instructions "
          f"for {elements} elements, in a straight run of {len(run)} (the "
          f"main body: {len(ops)}, {len(at)} MUFU)", flush=True)
    return {"fp32_per_element": f32 / elements, "mufu_per_element": 7.0,
            "sass_elements": elements}


def _equal(torch, label: str, got, want) -> None:
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max()
        raise RuntimeError(f"{label}: not bitwise equal to the plain "
                           f"version (max|diff| {float(diff)})")
    print(f"  {label}: bitwise equal to the plain version", flush=True)


def check_scan(torch, bw: float) -> dict:
    """Phase 6, K6's two entries, each against its plain version bitwise
    (``lru_scan`` at ``SCAN_CASES``, ``lru_scan_gated`` at
    ``GATED_CASES``), each call checked to launch its entry of K6 once,
    then timed at the path's shape.  The plain entry's bound: a and b read
    once, y written once (12 bytes an element in f32) at the HBM rate.
    Beside it, as diagnostics and not the kernel's number: a PyTorch add
    of the same a and b (the same bytes read and written), then the
    kernel timed again on the same inputs (its first time, right after
    phase 6's attention work, has read up to a fifth slower than later
    ones).  The gated entry's: the larger of x read and y written (4 bytes an element in
    bf16) at the HBM rate and its gate math's FP32 and MUFU instructions
    (counted from the SASS) at the card's issue rates; its yardstick is
    the unfused composition it replaces (``_gates``, K6, the cast)."""
    from repro_torch.kernels.rglru_scan import ops, ref
    timing = []
    def scan_inputs(b, s, d, dt):
        g = torch.Generator(device="cuda").manual_seed(s + d)
        a = torch.sigmoid(torch.randn((b, s, d), generator=g, device="cuda")
                          ).to(dt)
        return a, (torch.randn((b, s, d), generator=g, device="cuda") * 0.2
                   ).to(dt)

    for b, s, d, dtype, timed in SCAN_CASES:
        dt = getattr(torch, dtype)
        a, bb = scan_inputs(b, s, d, dt)
        plan = ops.scan_plan(b, s, d, dt)
        before = (ops.lru_scan.launches, ops.lru_scan_gated.launches)
        got = ops.lru_scan(a, bb)
        if (ops.lru_scan.launches, ops.lru_scan_gated.launches) != (
                before[0] + 1, before[1]):
            raise RuntimeError(f"lru_scan {(b, s, d)}: K6's plain entry "
                               f"not launched once")
        _equal(torch, f"lru_scan {(b, s, d)} {dtype} "
               f"[{'TMA' if plan.tma else 'loads'}, {plan.grid} blocks]",
               got, ref.lru_scan_ref(a, bb))
        if not timed:
            continue
        nbytes = 3 * a.numel() * a.element_size()
        bound_ms = nbytes / bw * 1e3
        ms = time_ms(torch, lambda: ops.lru_scan(a, bb), iters=20, warmup=3)
        plain_ms = time_ms(torch, lambda: ref.lru_scan_ref(a, bb), iters=2,
                           warmup=1)
        stream_ms = time_ms(torch, lambda: torch.add(a, bb), iters=20,
                            warmup=3)
        later_ms = time_ms(torch, lambda: ops.lru_scan(a, bb), iters=20,
                           warmup=3)
        timing.append({"entry": "lru_scan",
                       "shape": {"B": b, "S": s, "D": d, "dtype": dtype},
                       "ms": ms, "plain_ms": plain_ms,
                       "bytes_needed": nbytes, "bound_ms": bound_ms,
                       "bound_share": bound_ms / ms, "bound_by": "bytes",
                       "library_ms": None, "plan": plan._asdict(),
                       "stream_ms": stream_ms,
                       "stream_note": "diagnostic, not the kernel's time: "
                       "torch.add of the same a and b on the same "
                       "allocations, the same bytes read and written",
                       "later_ms": later_ms,
                       "later_note": "diagnostic, not the kernel's time: "
                       "the kernel timed again on the same inputs after "
                       "the plain version and the add"})
        print(f"  lru_scan {(b, s, d)} {dtype}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB needed), bound share "
              f"{bound_ms / ms:.3f}; library call: none (no single PyTorch "
              f"call computes a first-order linear recurrence); diagnostic: "
              f"torch.add of the same a and b {stream_ms:.4f} ms (share "
              f"{bound_ms / stream_ms:.3f}), the kernel again "
              f"{later_ms:.4f} ms (share {bound_ms / later_ms:.3f})",
              flush=True)
        del a, bb, got
    counted = gate_ops(torch)
    for b, s, d, dtype, with_y0, timed in GATED_CASES:
        dt = getattr(torch, dtype)
        x, p, y0 = gate_inputs(torch, b, s, d, dt, seed=s + d,
                               with_y0=with_y0)
        c = -8.0 * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
        args = (x, p["w_r"], p["b_r"], p["w_i"], p["b_i"], c, y0)
        plan = ops.scan_plan(b, s, d, dt, gated=True)
        before = (ops.lru_scan.launches, ops.lru_scan_gated.launches)
        got = ops.lru_scan_gated(*args)
        if (ops.lru_scan.launches, ops.lru_scan_gated.launches) != (
                before[0], before[1] + 1):
            raise RuntimeError(f"lru_scan_gated {(b, s, d)}: K6's gated "
                               f"entry not launched once")
        _equal(torch, f"lru_scan_gated {(b, s, d)} {dtype} x"
               f"{', y0' if with_y0 else ''} "
               f"[{'TMA' if plan.tma else 'loads'}, {plan.grid} blocks]",
               got, ref.lru_scan_gated_ref(*args))
        if with_y0 is False and (b, s, d) == K6_PATH:
            # the unfused composition from the same inputs, bitwise too
            _equal(torch, f"lru_scan_gated {(b, s, d)} {dtype} x against "
                   f"_gates + K6 + cast", got, gates_composition(p, x))
        if not timed:
            continue
        n = x.numel()
        nbytes = 2 * n * x.element_size() + 5 * d * 4
        bytes_ms = nbytes / bw * 1e3
        f32_ms = n * counted["fp32_per_element"] / F32_ISSUE * 1e3
        mufu_ms = n * counted["mufu_per_element"] / MUFU_RATE * 1e3
        bound_ms = max(bytes_ms, f32_ms, mufu_ms)
        ms = time_ms(torch, lambda: ops.lru_scan_gated(*args), iters=20,
                     warmup=3)
        plain_ms = time_ms(torch, lambda: ref.lru_scan_gated_ref(*args),
                           iters=2, warmup=1)
        library_ms = time_ms(torch, lambda: gates_composition(p, x),
                             iters=10, warmup=2)
        timing.append({"entry": "lru_scan_gated",
                       "shape": {"B": b, "S": s, "D": d, "dtype": dtype},
                       "ms": ms, "plain_ms": plain_ms,
                       "bytes_needed": nbytes, "bytes_ms": bytes_ms,
                       "fp32_ms": f32_ms, "mufu_ms": mufu_ms,
                       "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                       "bound_by": "bytes" if bytes_ms >= max(
                           f32_ms, mufu_ms) else "operations",
                       "library_ms": library_ms,
                       "speedup_over_library": library_ms / ms,
                       "plan": plan._asdict(), **counted})
        print(f"  lru_scan_gated {(b, s, d)} {dtype} x: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (bytes "
              f"{bytes_ms:.4f}, FP32 issue {f32_ms:.4f}, MUFU "
              f"{mufu_ms:.4f}), bound share {bound_ms / ms:.3f}; the "
              f"unfused composition {library_ms:.4f} ms "
              f"({library_ms / ms:.2f}x the kernel)", flush=True)
        del x, p, y0, c, args, got
    return {"max_abs_err": 0.0, "timing": timing}


# (arch, batch, prompt, new tokens, launches of one prefill: K5 on the
#  tensor cores, K5 on the CUDA cores, K6)
SERVE_RUNS = (("recurrentgemma-2b", 4, 4096, 32, (8, 0, 18)),
              ("gemma2-2b", 1, 8192, 8, (26, 0, 0)))
# phase 14, the dense configs: gemma3-4b's prompt runs past its 1024 window,
# so its 29 local layers' ring caches wrap; every layer is attention
DENSE_SERVE_RUNS = (("gemma3-4b", 1, 8192, 8, (34, 0, 0)),
                    ("minitron-8b", 1, 4096, 8, (32, 0, 0)),
                    ("starcoder2-15b", 1, 4096, 8, (40, 0, 0)))
# phase 15, the MoE configs at published widths, with the config's
# overrides last: qwen2-moe-a2.7b whole (28.0 GB of bf16 weights);
# kimi-k2-1t-a32b cut from 61 layers to 1 (36.5 GB a layer: two would
# leave no room on an 80 GB card)
MOE_SERVE_RUNS = (("qwen2-moe-a2.7b", 1, 4096, 8, (24, 0, 0), {}),
                  ("kimi-k2-1t-a32b", 1, 4096, 8, (1, 0, 0),
                   {"n_layers": 1}))


def _routing_stats(torch, calls) -> dict:
    """Over MoE routing calls (``_routes``): the share of (token, choice)
    pairs dropped at capacity, and the tokens an expert was chosen by in
    one call (largest and mean over experts and calls), beside the
    capacity."""
    pairs = sum(c["experts"].numel() for c in calls)
    dropped = sum(int((c["slot"] == c["slot_idx"][0].numel()).sum())
                  for c in calls)
    asked = [torch.bincount(c["experts"].flatten(),
                            minlength=c["logits"].shape[-1]).float()
             for c in calls]
    return {"moe_calls": len(calls), "pairs": pairs, "dropped": dropped,
            "dropped_share": dropped / max(pairs, 1),
            "expert_tokens_max": max(float(a.max()) for a in asked),
            "expert_tokens_mean": sum(float(a.mean()) for a in asked)
            / len(asked),
            "capacity": calls[0]["slot_idx"].shape[-1]}


def serving(torch, runs=SERVE_RUNS) -> dict:
    """Phases 7, 14 and 15: full-width serving through ``serve.generate``.
    Launch counts are zeroed before each run, read when prefill is done and
    again at the end.  A run of an MoE config also prints its prefill's
    routing: pairs dropped at capacity and tokens an expert (a
    measurement, not a gate)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import lru_scan, lru_scan_gated
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves

    out, total, gated = {"runs": []}, (0, 0, 0), 0

    def counts():
        return (flash_attention.launches_tc, flash_attention.launches,
                lru_scan.launches + lru_scan_gated.launches)
    for arch, batch, prompt, gen, expected, *over in runs:
        cfg = configs.get_config(arch).with_overrides(**(over[0] if over
                                                         else {}))
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        n_params = sum(x.numel() for x in tree_leaves(params))
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(1))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        marks = {}

        def prefill_done():
            torch.cuda.synchronize()
            marks["t"], marks["counts"] = time.perf_counter(), counts()
            marks["routed"] = len(routed)
            marks["gated"] = lru_scan_gated.launches

        flash_attention.launches_tc = flash_attention.launches = 0
        lru_scan.launches = lru_scan_gated.launches = 0
        torch.cuda.synchronize()
        with _routes() as routed:
            t0 = time.perf_counter()
            tokens, stats = generate(params, cfg, prompts, gen,
                                     on_prefill_done=prefill_done)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        launched = counts()
        prefill_counts = marks["counts"]
        decode_counts = tuple(a - b for a, b in zip(launched,
                                                    prefill_counts))
        if tuple(tokens.shape) != (batch, prompt + gen) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise RuntimeError(f"{arch}: tokens {tuple(tokens.shape)} out "
                               f"of shape or vocabulary")
        if not torch.equal(tokens[:, :prompt], prompts):
            raise RuntimeError(f"{arch}: the prompt was not kept")
        row = {"arch": arch, "params": n_params,
               "param_count": cfg.param_count(), "batch": batch,
               "prompt": prompt, "gen": gen, "init_s": init_s,
               "prefill_s": marks["t"] - t0,
               "decode_ms_per_step": (t1 - marks["t"]) / max(gen - 1, 1)
               * 1e3,
               "new_tokens_per_s": batch * gen / (t1 - t0),
               "prefill_tokens_per_s": batch * prompt / (marks["t"] - t0),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches_prefill": prefill_counts,
               "launches_prefill_gated_k6": marks["gated"],
               "launches_decode": decode_counts, "layers": cfg.n_layers,
               **stats}
        if cfg.moe is not None:
            if marks["routed"] != cfg.n_layers or len(routed) != \
                    cfg.n_layers * gen:
                raise RuntimeError(f"{arch}: {marks['routed']} MoE routing "
                                   f"calls in prefill, {len(routed)} in all")
            row["prefill_routing"] = _routing_stats(
                torch, routed[:marks["routed"]])
        elif routed:
            raise RuntimeError(f"{arch}: a dense config routed")
        print("  " + json.dumps(row), flush=True)
        if prefill_counts != expected or decode_counts != (0, 0, 0):
            raise RuntimeError(f"{arch}: K5 (tensor cores, CUDA cores) and "
                               f"K6 launches {prefill_counts} in prefill "
                               f"(expected {expected}), {decode_counts} in "
                               f"decode (expected none)")
        if marks["gated"] != prefill_counts[2] or \
                lru_scan_gated.launches != marks["gated"]:
            raise RuntimeError(f"{arch}: {marks['gated']} of prefill's "
                               f"{prefill_counts[2]} K6 launches through "
                               f"the gated entry (expected all), "
                               f"{lru_scan_gated.launches} in all")
        out["runs"].append(row)
        total = tuple(a + b for a, b in zip(total, launched))
        gated += lru_scan_gated.launches
        del params, prompts, tokens, routed
        torch.cuda.empty_cache()
    out["launches"], out["launches_gated"] = total, gated
    return out


def _narrow_configs(dtype: str):
    from repro_torch import configs
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    return (configs.get_reduced("recurrentgemma-2b").with_overrides(
                n_layers=8, exit_layer=3, **dt),
            configs.get_reduced("gemma2-2b").with_overrides(
                n_layers=5, exit_layer=2, **dt))


DENSE = ("gemma3-4b", "minitron-8b", "starcoder2-15b")
MOE = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")


def _moe_configs(dtype: str):
    """The reduced MoE configs of phases 8 and 10, kimi-k2 at its
    published head dim 112 (K5 pads it to 128 columns)."""
    from repro_torch import configs
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    return (configs.get_reduced("qwen2-moe-a2.7b").with_overrides(**dt),
            configs.get_reduced("kimi-k2-1t-a32b").with_overrides(
                head_dim=112, **dt))


@contextlib.contextmanager
def _routes(replay=None):
    """Wrap ``mlp._route`` (every MoE layer's routing) for one run: yields
    the list of its calls, each {logits, slot_idx, experts, slot, top_k},
    kept where the run made them (no copy, no sync).  With ``replay`` (an
    earlier run's calls) each call routes from that run's router logits
    instead of its own, records that routing as ``replayed``, and still
    records the routing its own logits give."""
    from repro_torch.models import mlp
    route, calls = mlp._route, []

    def record(r, logits):
        return {"logits": logits, "slot_idx": r.slot_idx,
                "experts": r.token_expert, "slot": r.token_slot,
                "top_k": r.token_expert.shape[-1]}

    def wrapped(logits, moe, capacity, e_pad=0):
        own = route(logits, moe, capacity, e_pad)
        calls.append(record(own, logits))
        if replay is None:
            return own
        theirs_logits = replay[len(calls) - 1]["logits"].to(logits.device)
        theirs = route(theirs_logits, moe, capacity, e_pad)
        calls[-1]["replayed"] = record(theirs, theirs_logits)
        return theirs
    mlp._route = wrapped
    try:
        yield calls
    finally:
        mlp._route = route


def _margins(torch, rec, tokens) -> list:
    """The gap between the k-th and (k+1)-th router probabilities of the
    given tokens of one routing call (the near-tie a flip crosses)."""
    probs = torch.sort(torch.softmax(rec["logits"].float().cpu(), dim=-1),
                       dim=-1, descending=True).values
    k = rec["top_k"]
    gap = probs[..., k - 1] - probs[..., k]
    return [float(gap[t]) for t in zip(*tokens)]


def _hold_routes(torch, label: str, card: list, cpu: list,
                 replayed: bool) -> list:
    """Routing card against CPU, call by call: slot_idx equal (the CPU's
    own, or with ``replayed`` the CPU's routing from the card's router
    logits); a difference prints the margins of the tokens whose experts
    differ and fails.  Returns, with ``replayed``, the margins of the
    tokens the CPU's own logits route to other experts (a measurement)."""
    if len(card) != len(cpu) or not card:
        raise RuntimeError(f"{label}: {len(card)} routing calls on the card, "
                           f"{len(cpu)} on the CPU")

    def moved(a, b):          # tokens whose chosen experts differ
        return torch.nonzero((torch.sort(a.cpu(), -1).values
                              != torch.sort(b.cpu(), -1).values).any(-1),
                             as_tuple=True)
    flips = []
    for i, (c, h) in enumerate(zip(card, cpu)):
        mine = h["replayed"] if replayed else h
        if not torch.equal(c["slot_idx"].cpu(), mine["slot_idx"].cpu()):
            toks = moved(c["experts"], mine["experts"])
            raise RuntimeError(
                f"{label}: routing call {i} differs card against CPU"
                f"{' from the same router logits' if replayed else ''}; "
                f"margins of the tokens whose experts differ (card logits) "
                f"{_margins(torch, c, toks)}, (CPU logits) "
                f"{_margins(torch, h, toks)}")
        if replayed:
            flips += _margins(torch, h, moved(c["experts"], h["experts"]))
    return flips


def serving_card_vs_cpu(torch) -> dict:
    """Phase 8: narrow serving on the card (K5, K6) against the CPU (their
    plain versions): f32, where K5 runs on the CUDA cores, at rtol 1e-4 /
    atol 1e-5; bf16 params and compute, where K5 runs on the tensor cores
    and rounds its probabilities to bf16, within 5 % of the CPU prefill's
    max |logit| (the bound of the CPU test
    ``test_bf16_prefill_and_decode_match_reference``); then the card's f32
    decode against its prefill.  f32 also serves the reduced dense configs
    as they are (gemma3-4b: its window 16 and qk-norm; minitron-8b;
    starcoder2-15b: the plain MLP).  Both dtypes serve the reduced MoE
    configs (qwen2-moe-a2.7b; kimi-k2 at head dim 112, K5's padded Dh),
    with every MoE layer's routing held call by call: in f32 the CPU's
    slot_idx equal to the card's; in bf16, where a bf16 ulp of the
    activations moves a router logit by about 1e-3 and can flip a
    near-tie (``tests/test_torch_moe_configs.py``), the CPU routes from
    the card's router logits and its slot_idx must equal the card's, and
    the tokens its own logits would route elsewhere are counted with their
    margins; a slot that differs prints the margins and fails.  The MoE
    configs' decode-against-prefill check runs at capacity factor 64, as
    ``test_moe_no_drop`` does (decode routes the batch as one group at
    capacity 1 and drops pairs prefill keeps).  Each config's card run
    must launch its dtype's K5; each dtype's card runs start from zeroed
    counts; returns their K5 launches (tensor cores, CUDA cores)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    rtol, atol = 1e-4, 1e-5
    prompt, steps, batch = 64, 8, 2
    launches = {}
    for dtype in ("float32", "bfloat16"):
        flash_attention.launches_tc = flash_attention.launches = 0
        dense = ([configs.get_reduced(a) for a in DENSE]
                 if dtype == "float32" else [])
        for cfg in (list(_narrow_configs(dtype)) + dense
                    + list(_moe_configs(dtype))):
            moe = cfg.moe is not None
            params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
            tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + steps),
                                   generator=torch.Generator().manual_seed(1))
            sides, routed = {}, {}
            before = (flash_attention.launches_tc, flash_attention.launches)
            for dev in ("cuda", "cpu"):
                p = tree_map(lambda x: x.to(dev), params)
                toks = tokens.to(dev)
                replay = (routed["cuda"] if dev == "cpu" and moe
                          and dtype != "float32" else None)
                with torch.inference_mode(), _routes(replay) as calls:
                    logits, cache = tfm.prefill(p, cfg, toks[:, :prompt],
                                                cache_len=prompt + steps)
                    outs = [logits]
                    for t in range(prompt, prompt + steps):
                        lg, cache, ex = tfm.decode_step(
                            p, cache, cfg, toks[:, t:t + 1], t,
                            with_exit_head=True)
                        outs += [lg, ex]
                sides[dev] = [o.cpu().float() for o in outs]
                routed[dev] = calls
                if dev == "cuda":
                    tc = dtype == "bfloat16"
                    got = (flash_attention.launches_tc - before[0],
                           flash_attention.launches - before[1])
                    if (got[0] > 0) != tc or (got[1] > 0) == tc:
                        raise RuntimeError(
                            f"{cfg.name} narrow {dtype}: K5 launches "
                            f"(tensor cores, CUDA cores) {got}, expected "
                            f"only the {'tensor' if tc else 'CUDA'}-core "
                            f"kernel")
            routing = ""
            if moe:
                replayed = dtype != "float32"
                flips = _hold_routes(torch, f"{cfg.name} narrow {dtype}",
                                     routed["cuda"], routed["cpu"],
                                     replayed)
                routing = (f"; routing of {len(routed['cuda'])} MoE calls "
                           f"equal card vs CPU"
                           + (" from the card's router logits; tokens the "
                              f"CPU's own logits route elsewhere: "
                              f"{len(flips)}, margins {flips}"
                              if replayed else ""))
            elif routed["cuda"] or routed["cpu"]:
                raise RuntimeError(f"{cfg.name}: a dense config routed")
            worst = 0.0
            top = float(sides["cpu"][0].abs().max())      # max |logit|
            rule = ("rtol 1e-4 / atol 1e-5" if dtype == "float32"
                    else "5 % of max|logit|")
            for i, (c, h) in enumerate(zip(sides["cuda"], sides["cpu"])):
                diff = (c - h).abs()
                worst = max(worst, float(diff.max()))
                limit = (atol + rtol * h.abs() if dtype == "float32"
                         else 0.05 * top)
                if float((diff - limit).max()) > 0:
                    raise RuntimeError(
                        f"{cfg.name} narrow {dtype}: card and CPU differ "
                        f"beyond {rule} in output {i} (prefill, then "
                        f"final/exit per step)")
            print(f"  {cfg.name} narrow {dtype} ({cfg.n_layers} layers, exit "
                  f"after {cfg.resolved_exit_layer}, window {cfg.window}, "
                  f"qk-norm {cfg.use_qk_norm}, glu {cfg.mlp_glu}, head dim "
                  f"{cfg.resolved_head_dim}, K5 "
                  f"launches {got}, prompt {prompt}): prefill logits and "
                  f"{steps} "
                  f"teacher-forced decode steps (final and exit heads), card "
                  f"vs CPU max|diff| {worst:.3e} = {worst / top:.5f} of "
                  f"max|logit| ({rule}){routing}", flush=True)
            if dtype != "float32":
                continue
            # the card's decode, token by token from an empty cache, against
            # the card's prefill of the whole sequence (MoE: no drops)
            if moe:
                cfg = cfg.with_overrides(moe=dataclasses.replace(
                    cfg.moe, capacity_factor=64.0))
            p = tree_map(lambda x: x.cuda(), params)
            toks = tokens.cuda()
            n = prompt + steps
            with torch.inference_mode():
                full, _ = tfm.prefill(p, cfg, toks)
                cache = tfm.init_cache(cfg, batch, n, device="cuda")
                worst = 0.0
                for t in range(n):
                    lg, cache = tfm.decode_step(p, cache, cfg,
                                                toks[:, t:t + 1], t)
                    diff = (lg[:, 0] - full[:, t]).abs()
                    worst = max(worst, float(diff.max()))
                    if float((diff - atol - rtol * full[:, t].abs()).max()) \
                            > 0:
                        raise RuntimeError(f"{cfg.name} narrow: decode at "
                                           f"position {t} differs from "
                                           f"prefill")
            print(f"  {cfg.name} narrow on the card: decode of {n} positions "
                  f"against prefill, max|diff| {worst:.3e}"
                  + (" (capacity factor 64)" if moe else ""), flush=True)
        launches[dtype] = (flash_attention.launches_tc,
                           flash_attention.launches)
        tc = dtype == "bfloat16"
        if (launches[dtype][0] > 0) != tc or (launches[dtype][1] > 0) == tc:
            raise RuntimeError(f"narrow {dtype} serving: K5 launches "
                               f"(tensor cores, CUDA cores) "
                               f"{launches[dtype]}, expected only the "
                               f"{'tensor-core' if tc else 'CUDA-core'} "
                               f"kernel")
        print(f"  narrow {dtype} serving on the card: K5 launches (tensor "
              f"cores, CUDA cores) {launches[dtype]}", flush=True)
    return launches


# Phase 9: the full-width LM round cell (repro_torch.launch.lm_cell:
# Gemma-2 2B, bf16, n_flat above 2**31, one simple and one complex client
# a round, 2 SGD steps of 2 x 512 tokens each, the f32 wire).
# (label, algorithm, rounds, config, launches per round of K1, K4)
LM_RUNS = (("flat f32", "fedhen", 2, {}, (2, 0)),
           ("flat f32", "noside", 1, {}, (2, 0)),
           ("tree f32", "fedhen", 1, TREE, (0, 2)))
LM_SLICE = 1 << 28           # elements of one plain-version slice


def lm_cell(torch, ops, ref, bw: float) -> dict:
    """Phase 9: federated training of Gemma-2 2B at full width through
    ``FederatedTrainer(LMAdapter(cfg), ...)`` (``lm_cell.trainer``),
    weights drawn on the card from seed 0: 2 fedhen and 1 noside round on
    the flat engine, 1 fedhen round on the tree engine, each evaluated.
    Per round: wall time, losses, eval metrics, bytes billed against the
    f32 wire's closed form (4 bytes down and 4 up of |M| for the simple
    client and of every param for the complex one) and peak memory; K1's
    and K4's launches, counted from 0 for each run, against the folds.
    Then, with the trainers freed, K1 and K4 at the cell's fold shape
    (Z = 1, N = n_flat, the real mask and leaf table) against their plain
    versions, bitwise, and timed (:func:`check_folds_lm`)."""
    import gc
    from repro_torch.launch import lm_cell as cell

    t0 = time.perf_counter()
    shards = cell.shards("cuda")
    test = cell.test_batch()
    print(f"  data: {len(shards) * cell.PER_CLIENT} sequences of "
          f"{cell.SEQ} tokens over {len(shards)} clients in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    out = {"rounds": [], "runs": []}
    total = (0, 0)
    layout = mask = None
    for label, algo, rounds, extra, per_round in LM_RUNS:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer = cell.trainer(shards, algo, **extra)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        layout = trainer.layout
        n_m = int(trainer.flat_mask.sum())
        want_bytes = 8 * (n_m + layout.n_params)
        print(f"  {label} {algo}: n_flat {layout.n_flat:,} "
              f"({layout.n_flat / 2**31:.3f} x 2**31), "
              f"{layout.n_params:,} params in {layout.n_leaves} leaves, "
              f"|M| {n_m:,}; trainer built in {init_s:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held",
              flush=True)
        if trainer.bytes_per_round != want_bytes:
            raise RuntimeError(f"LM {label} {algo}: the wire bills "
                               f"{trainer.bytes_per_round} bytes a round, "
                               f"the closed form {want_bytes}")
        _zero_counts(ops)
        for _ in range(rounds):
            billed = trainer.total_bytes
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = trainer.run_round()
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t
            t = time.perf_counter()
            ev = trainer.evaluate(test)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t
            billed = trainer.total_bytes - billed
            row = {"run": label, "algorithm": algo,
                   "round": trainer.server.round, "round_s": round_s,
                   "eval_s": eval_s, "bytes": billed,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "train": m, "eval": ev}
            print("  " + json.dumps(row), flush=True)
            values = [m["loss_simple"], m["loss_complex"]] + [
                ev[k] for k in ("loss_simple", "loss_complex", "acc_simple",
                                "acc_complex")]
            if not all(math.isfinite(v) for v in values):
                raise RuntimeError(f"LM {label} {algo}: non-finite loss or "
                                   f"metric {m} {ev}")
            if m["n_valid"] != 2:
                raise RuntimeError(f"LM {label} {algo}: n_valid "
                                   f"{m['n_valid']}, 2 clients trained")
            if billed != want_bytes:
                raise RuntimeError(f"LM {label} {algo}: {billed} bytes "
                                   f"billed, expected {want_bytes}")
            out["rounds"].append(row)
        c = _counts(ops)
        launched = (c[0], c[3])
        expected = tuple(rounds * k for k in per_round)
        print(f"  {label} {algo}: launches K1/K4 {launched} over {rounds} "
              f"round(s), expected {expected} (one a fold); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if launched != expected or c[1] or c[2]:
            raise RuntimeError(f"LM {label} {algo}: launches K1/K2/K3/K4 "
                               f"{c}, expected K1/K4 {expected}")
        out["runs"].append({"run": label, "algorithm": algo,
                            "init_s": init_s, "launches": launched,
                            "peak_gib": torch.cuda.max_memory_allocated()
                            / 2**30})
        total = tuple(a + b for a, b in zip(total, launched))
        mask = trainer.flat_mask
        out.update(n_flat=layout.n_flat, n_params=layout.n_params, n_m=n_m)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    del shards
    out["launches"] = total
    out.update(check_folds_lm(torch, ops, ref, bw, layout, mask))
    return out


def _leaf_groups(leaves, span: int):
    """Runs of consecutive rows of a leaf table (L, 3) whose elements span
    at most ``span`` (a larger leaf makes a run of its own), each as
    ``(lo, hi, rows)`` with the rows' offsets made relative to ``lo``."""
    rows = leaves.tolist()
    i = 0
    while i < len(rows):
        j, lo = i + 1, rows[i][0]
        while j < len(rows) and rows[j][0] + rows[j][1] - lo <= span:
            j += 1
        hi = rows[j - 1][0] + rows[j - 1][1]
        yield lo, hi, [[x - lo, n, o - lo] for x, n, o in rows[i:j]]
        i = j


def check_folds_lm(torch, ops, ref, bw: float, layout, mask) -> dict:
    """K1 and K4 at the LM cell's fold: Z = 1, N = n_flat > 2**31, the
    real mask (and for K4 the layout's leaf table, past offset 2**31 and
    its int32 work list), as a complex client (weight 1 on both sides of
    M) and a simple one (1 inside, 0 outside), on one random f32 row and
    accumulator.  Each is held bitwise to its plain version, computed
    piece by piece so that memory stays bounded (the folds are elementwise
    in N, and at weight 1 the kernels' FMA rounds as the plain versions'
    product and sum): K1 in slices of ``LM_SLICE``, K4 in runs of leaves
    spanning at most as much (``masked_agg_fold_ref`` over the run).  Then
    each is timed beside its byte bound and its plain version's pieced
    time."""
    n = mask.numel()
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((1, n), generator=g, device="cuda")
    acc0 = torch.randn((n,), generator=g, device="cuda")
    n_m = int(mask.sum())
    n_all = layout.n_params
    plan = ops.fold_plan(layout, "cuda")
    leaves = plan.leaves.cpu()
    ones = torch.ones((1,), device="cuda")
    out = {"k1": {"N": n, "Z": 1, "timing": []},
           "k4": {"N": n, "Z": 1, "n_params": n_all,
                  "leaves": layout.n_leaves,
                  "work_items": plan.items.shape[0], "timing": []}}

    def k1_pieces(acc, w_rest):
        for a in range(0, n, LM_SLICE):
            e = min(a + LM_SLICE, n)
            yield f"slice [{a:,}, {e:,})", acc[a:e], \
                lambda a=a, e=e: ref.masked_agg_acc_ref(
                    acc0[a:e], x[:, a:e], mask[a:e], ones, w_rest)

    def k4_pieces(acc, w_rest):
        for lo, hi, rows in _leaf_groups(leaves, LM_SLICE):
            yield f"leaves over [{lo:,}, {hi:,})", acc[lo:hi], \
                lambda lo=lo, hi=hi, rows=rows: ref.masked_agg_fold_ref(
                    acc0[lo:hi], x[:, lo:hi], mask[lo:hi], ones, w_rest,
                    torch.tensor(rows, dtype=torch.int64))

    kernels = (
        ("k1", "masked_agg_acc", n,
         lambda acc, w_rest: ops.masked_agg_acc_(acc, x, mask, ones, w_rest),
         k1_pieces),
        ("k4", "masked_agg_fold", n_all,
         lambda acc, w_rest: ops.masked_agg_fold_(acc, x, mask, ones, w_rest,
                                                  plan),
         k4_pieces))
    for key, name, n_touched, launch, pieces in kernels:
        for population, w_rest in (("complex", ones), ("simple", ones * 0)):
            acc = acc0.clone()
            launch(acc, w_rest)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for what, got, plain in pieces(acc, w_rest):
                want = plain()
                if not torch.equal(got, want):
                    diff = float((got - want).abs().max())
                    raise RuntimeError(f"{name} at N={n:,}, {population}: "
                                       f"{what} differs from the plain "
                                       f"version by {diff:.3e}")
                del want
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            del acc
            # x is read where the weight is not 0; K4 reads and writes the
            # leaves' elements only, K1 writes only the elements a live row
            # changes
            rows_read = n_touched if population == "complex" else n_m
            flops = 2 * rows_read
            title = (f"{name} {population} fold f32 Z=1 N={n:,} (N / 2**31 "
                     f"= {n / 2**31:.3f}"
                     + (f"; {layout.n_leaves} leaves, "
                        f"{out['k4']['work_items']:,} work items"
                        if key == "k4" else "")
                     + "): bitwise equal to the plain version")
            if key == "k1":
                print(f"  {title}", flush=True)
                row = _fold_row(
                    torch, f"{name} {population} fold Z=1",
                    lambda: launch(acc0, w_rest), plain_ms,
                    fold_bytes(torch, mask, ones, w_rest,
                               lambda a, b: 4 * (n_m * a + (n - n_m) * b)),
                    4 * rows_read + 9 * n, flops, bw, iters=10)
            else:
                ms = time_ms(torch, lambda: launch(acc0, w_rest), iters=10)
                nbytes = 4 * rows_read + 8 * n_touched + n_touched
                bound_ms, bound_by = _bound(nbytes, flops, bw)
                row = {"fold": population, "ms": ms, "bytes_needed": nbytes,
                       "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                       "bound_by": bound_by}
                print(f"  {title}; kernel {ms:.4f} ms, plain (pieced) "
                      f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({nbytes / 1e9:.2f} GB needed), bound share "
                      f"{bound_ms / ms:.3f}", flush=True)
            row.update(fold=population, plain_ms=plain_ms,
                       plain_note="in pieces, with the bitwise check",
                       max_abs_err=0.0)
            out[key]["timing"].append(row)
    del x, acc0
    torch.cuda.empty_cache()
    return out


# Phase 10: the attention-only config of every committed BENCH row
# (benchmarks/fed_common.py's BENCH_CFG), field for field
def attn4_config():
    from repro_torch.configs.base import LayerSpec, ModelConfig
    return ModelConfig(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256,
                       pattern=(LayerSpec("attn"),), exit_layer=2,
                       compute_dtype="float32")


def lm_card_vs_cpu(torch) -> None:
    """Phase 10: narrow LM rounds on the card against the same rounds on
    the CPU (weights drawn on the CPU from seed 0, the same schedule):
    attn4 fedhen and decouple on the flat engine, fedhen on the tree
    engine, reduced recurrentgemma-2b, gemma3-4b, minitron-8b,
    starcoder2-15b, qwen2-moe-a2.7b and kimi-k2-1t-a32b fedhen (the MoE
    trees, router and experts, fold through K1).  Server params (and
    decouple's simple host) at rtol 1e-4 / atol 1e-5, losses and eval
    metrics within 1e-5, n_valid and bytes equal.  (A round trains
    through the chunked attention of the training forward, not K5:
    prefill alone runs K5.)"""
    from repro_torch import configs
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_lm

    runs = (("attn4", attn4_config(), "fedhen", {}),
            ("attn4", attn4_config(), "decouple", {}),
            ("attn4 tree", attn4_config(), "fedhen", TREE),
            ("recurrentgemma-2b reduced",
             configs.get_reduced("recurrentgemma-2b"), "fedhen", {})) + tuple(
                (f"{a} reduced", configs.get_reduced(a), "fedhen", {})
                for a in DENSE + MOE)
    for label, cfg, algo, extra in runs:
        shards = [{"tokens": s["tokens"]} for s in iid_split(
            synthetic_lm(32, 16, cfg.vocab_size, seed=0), 4, seed=1)]
        test = {"tokens": synthetic_lm(8, 16, cfg.vocab_size,
                                       seed=999)["tokens"]}
        fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                        local_epochs=1, batch_size=4, cohort_chunk=1,
                        algorithm=algo, **extra)
        sides = _narrow_pair_runs(torch, lambda dev: FederatedTrainer(
            LMAdapter(cfg), fed, shards, device=dev,
            generator=torch.Generator().manual_seed(0)), 1, test)
        worst = _hold(f"LM {label} {algo}", sides["card"], sides["cpu"])
        print(f"  narrow LM round {label} {algo}, card vs CPU: server "
              f"params within rtol 1e-4 / atol 1e-5 (max abs {worst:.3e}); "
              f"card {json.dumps(sides['card'][0][-1])}", flush=True)


# Phase 11: async rounds.  (label, config, lag, rounds, launches per round of
# K1, K2, K3, K4 -- a sync round's -- and closed-form bytes per round)
ASYNC_RUNS = (("f32", {}, 3, 3, (2, 0, 0, 0), F32_BYTES),
              ("int8", dict(comm_dtype="int8"), 1, 2, (0, 2, 0, 0),
               122_199_360),
              ("compressed", COMPRESSED, 1, 2, (2, 0, 4, 0), 82_396_760),
              ("tree f32", TREE, 1, 2, (0, 0, 0, 2), F32_BYTES))
RESNET_FED = dict(n_devices=100, n_simple=50, participation=0.1,
                  local_epochs=1, batch_size=50, lr=0.1)
NARROW_FED = dict(n_devices=4, n_simple=2, participation=1.0,
                  local_epochs=1, batch_size=4, cohort_chunk=1)
LM_WEIGHT_1 = 0.70710677     # f32 of (1 + 1) ** -0.5: a one-round-stale fold


class _Deterministic:
    """cuDNN's deterministic algorithms while active (the ResNet's
    convolutions otherwise may pick nondeterministic ones); restores the
    previous settings, so no other phase runs under them."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.saved = (self.cudnn.deterministic, self.cudnn.benchmark)
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.saved


def _flat_server(trainer):
    """The trainer's server models, each packed, on the host."""
    from repro_torch.core import flatten
    return [flatten.pack(trainer.layout, m).cpu()
            for m in (trainer.server.complex, trainer.server.simple_host)
            if m is not None]


def _replay_bill(trainer, plan, sched, r, cache) -> tuple:
    """(bytes the version cache saves this round, its hits): each real
    client billed through ``comm.VersionCache`` for the version its chunk
    trains on, the dict oracle of the engine's billing."""
    eng = trainer.async_engine
    saved = hits = 0
    for ids, real, s, chunk, nbytes in (
            (plan.simple_ids, plan.simple_real, sched[0], eng.chunk_s,
             trainer.per_simple_bytes),
            (plan.complex_ids, plan.complex_real, sched[1], eng.chunk_c,
             trainer.per_complex_bytes)):
        for pos, (cid, ok) in enumerate(zip(ids, real)):
            if ok and cache.bill(int(cid), r - int(s[pos // chunk]),
                                 nbytes) == 0:
                saved += nbytes
                hits += 1
    return saved, hits


def _async_round(torch, trainer, cache, closed_bytes) -> dict:
    """One timed async round, its schedule, weights and bytes checked
    against the closed form less the cache hits."""
    from repro_torch.core.async_rounds import staleness_weight
    eng = trainer.async_engine
    r = trainer.server.round
    plan = trainer.sampler.plan(r)
    sched = eng.schedule(r)
    weights = [staleness_weight(s, scheme=trainer.fed.async_staleness,
                                decay=trainer.fed.async_decay).tolist()
               for s in sched]
    saved, hits = _replay_bill(trainer, plan, sched, r, cache)
    billed, hits0 = trainer.total_bytes, eng.cache_hits
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = trainer.run_round()
    torch.cuda.synchronize()
    row = {"round": trainer.server.round, "round_s": time.perf_counter() - t,
           "staleness": [list(map(int, s)) for s in sched],
           "weights": weights, "bytes": trainer.total_bytes - billed,
           "bytes_closed_form": closed_bytes, "cache_hits":
           eng.cache_hits - hits0, "bytes_saved": saved, **m}
    if not (math.isfinite(m["loss_simple"])
            and math.isfinite(m["loss_complex"])):
        raise RuntimeError(f"async round {r}: non-finite loss {m}")
    if row["bytes"] != closed_bytes - saved or row["cache_hits"] != hits:
        raise RuntimeError(f"async round {r}: {row['bytes']} bytes billed "
                           f"with {row['cache_hits']} cache hits, expected "
                           f"{closed_bytes - saved} with {hits}")
    return row


def async_resnet(torch, ops) -> tuple:
    """Phase 11(a): async rounds at the ResNet round cell.  First f32 flat
    fedhen through ``AsyncRoundEngine(lag=0)`` against the sync trainer, 2
    rounds each under deterministic cuDNN, bitwise in server params,
    metrics, bytes and launches.  Then ``ASYNC_RUNS`` through
    ``FedConfig(async_lag=L)``: each round's wall, schedule, weights and
    bytes (the closed form less the version cache's savings), and K1-K4's
    launches, counted from 0 a run, equal to a sync round's (staleness adds
    no fold).  Returns (launches of K1-K4 over the runs, the f32 trainer
    after its rounds, the shards)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import comm
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.async_rounds import AsyncRoundEngine
    from repro_torch.core.federated import FederatedTrainer

    shards, _ = resnet_cell_data(torch)
    make = lambda **kw: FederatedTrainer(
        ResNetAdapter(10), FedConfig(algorithm="fedhen", **RESNET_FED, **kw),
        shards, device="cuda")
    runs = {}
    with _Deterministic(torch):
        for side in ("sync", "async lag 0"):
            tr = make()
            runner = tr if side == "sync" else AsyncRoundEngine(tr, lag=0)
            _zero_counts(ops)
            t = time.perf_counter()
            ms = [runner.run_round() for _ in range(2)]
            torch.cuda.synchronize()
            runs[side] = (ms, _flat_server(tr),
                          (tr.total_bytes_down, tr.total_bytes_up),
                          _counts(ops), time.perf_counter() - t)
            del tr, runner
    (ms_a, srv_a, b_a, c_a, s_a), (ms_b, srv_b, b_b, c_b, s_b) = \
        runs["sync"], runs["async lag 0"]
    diff = max(float((a - b).abs().max()) for a, b in zip(srv_a, srv_b))
    print(f"  f32 fedhen, 2 rounds: sync {s_a:.2f} s, async lag 0 "
          f"{s_b:.2f} s; server params max|diff| {diff:.3e}; metrics "
          f"{ms_b}; bytes {b_b}; launches K1/K2/K3/K4 {c_b} (sync {c_a})",
          flush=True)
    if diff or ms_a != ms_b or b_a != b_b or c_a != c_b:
        raise RuntimeError(f"async lag 0 is not the sync round: params "
                           f"max|diff| {diff}, metrics {ms_a} / {ms_b}, "
                           f"bytes {b_a} / {b_b}, launches {c_a} / {c_b}")
    total, keep = (0, 0, 0, 0), None
    for label, cfg, lag, rounds, per_round, closed in ASYNC_RUNS:
        tr = make(async_lag=lag, **cfg)
        eng = tr.async_engine
        print(f"  {label} fedhen async lag {lag}: {eng.folds_per_round} "
              f"folds a round, {eng.n_versions} versions", flush=True)
        cache = comm.VersionCache()
        _zero_counts(ops)
        for _ in range(rounds):
            row = _async_round(torch, tr, cache, closed)
            print("  " + json.dumps({"run": label, "lag": lag, **row}),
                  flush=True)
        launched = _counts(ops)
        expected = tuple(rounds * n for n in per_round)
        print(f"  {label} async lag {lag}: launches K1/K2/K3/K4 {launched} "
              f"over {rounds} rounds, expected {expected} (a sync round's)",
              flush=True)
        if launched != expected:
            raise RuntimeError(f"{label} async: launches {launched}, "
                               f"expected {expected}")
        total = tuple(a + b for a, b in zip(total, launched))
        if label == "f32":
            keep = tr
        del tr, eng
    return total, keep, shards


def async_lm(torch, ops) -> tuple:
    """Phase 11(b): the LM round cell (``launch/lm_cell.py``, Gemma-2 2B at
    full width, F = 2) at ``async_lag`` 1 for 3 rounds: from round 1 the
    simple chunk trains on the previous round's model and folds at
    0.70710677.  Wall, losses, n_valid, bytes (the closed form less the
    cache hits), peak memory from a reset before the trainer is built, and
    K1's launches (2 a round).  Returns (K1 launches, the trainer, its
    rows)."""
    from repro_torch.core import comm
    from repro_torch.launch import lm_cell as cell

    shards = cell.shards("cuda")
    torch.cuda.reset_peak_memory_stats()
    tr = cell.trainer(shards, "fedhen", device="cuda", async_lag=1)
    eng = tr.async_engine
    closed = 8 * (int(tr.flat_mask.sum()) + tr.layout.n_params)
    cache = comm.VersionCache()
    rows = []
    _zero_counts(ops)
    for _ in range(3):
        row = _async_round(torch, tr, cache, closed)
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print("  " + json.dumps({"run": "LM fedhen async lag 1", **row}),
              flush=True)
        if row["n_valid"] != 2:
            raise RuntimeError(f"LM async: n_valid {row['n_valid']}")
        rows.append(row)
    weight_1 = torch.tensor(LM_WEIGHT_1, dtype=torch.float32).item()
    if rows[1]["weights"][0] != [weight_1] or \
            rows[1]["staleness"] != [[1], [0]]:
        raise RuntimeError(f"LM async round 1: schedule {rows[1]}")
    c = _counts(ops)
    print(f"  LM async lag 1: launches K1/K2/K3/K4 {c} over 3 rounds, "
          f"expected (6, 0, 0, 0); {eng.n_versions} versions, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if c != (6, 0, 0, 0):
        raise RuntimeError(f"LM async: launches {c}")
    return c[0], tr, rows


def _narrow_pair_runs(torch, build, rounds: int, test=None) -> dict:
    """``build(device)`` run ``rounds`` rounds on the card and on the CPU:
    {side: (metrics per round, packed server models)}.  The last round's
    metrics gain the evaluation on ``test`` where one is given, else the
    total bytes as ``mbytes``."""
    sides = {}
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        t = build(dev)
        ms = [t.run_round() for _ in range(rounds)]
        ms[-1].update(t.evaluate(test) if test is not None
                      else dict(mbytes=t.total_bytes))
        sides[side] = (ms, _flat_server(t))
    return sides


def _hold(label: str, mine, theirs, rtol=1e-4, atol=1e-5) -> float:
    """Two runs of one config, each (metrics per round, tensors): the
    tensors within rtol/atol, the metrics within atol, n_valid and bytes
    equal; returns the tensors' max |diff|."""
    worst = 0.0
    for a, b in zip(mine[1], theirs[1]):
        a, b = a.cpu(), b.cpu()
        worst = max(worst, float((a - b).abs().max()))
        if float(((a - b).abs() - (atol + rtol * b.abs())).max()) > 0:
            raise RuntimeError(f"{label}: server state differs beyond rtol "
                               f"{rtol} / atol {atol} (max abs "
                               f"{worst:.3e})")
    for mc, mp in zip(mine[0], theirs[0]):
        for key in mp:
            exact = key in ("n_valid", "mbytes", "mbytes_down", "mbytes_up")
            if abs(mc[key] - mp[key]) > (0.0 if exact else atol):
                raise RuntimeError(f"{label}: {key} {mc[key]} against "
                                   f"{mp[key]}")
    return worst


def async_card_vs_cpu(torch) -> None:
    """Phase 11(c): narrow async rounds, 3 each, on the card against the
    CPU at rtol 1e-4 / atol 1e-5: attn4 fedhen and decouple at lag 1 and
    3 (F = 4), the ResNet narrow config of phase 5 at lag 1 (f32 wire)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import LMAdapter, ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_cifar, synthetic_lm

    cfg = attn4_config()
    lm_shards = [{"tokens": s["tokens"]} for s in iid_split(
        synthetic_lm(32, 16, cfg.vocab_size, seed=0), 4, seed=1)]
    img_shards = iid_split(synthetic_cifar(32, 10, seed=0, image_size=16),
                           4, seed=1)
    runs = [(f"attn4 {algo} lag {lag}", LMAdapter(cfg), lm_shards,
             dict(algorithm=algo, async_lag=lag))
            for algo in ("fedhen", "decouple") for lag in (1, 3)]
    runs.append(("ResNet narrow fedhen lag 1", ResNetAdapter(
        10, (8, 16, 16, 16)), img_shards,
        dict(algorithm="fedhen", async_lag=1)))
    for label, adapter, shards, kw in runs:
        sides = _narrow_pair_runs(torch, lambda dev: FederatedTrainer(
            adapter, FedConfig(**NARROW_FED, **kw), shards, device=dev,
            generator=torch.Generator().manual_seed(0)), 3)
        worst = _hold(label, sides["card"], sides["cpu"])
        print(f"  narrow {label}, 3 rounds, card vs CPU: server params "
              f"within rtol 1e-4 / atol 1e-5 (max abs {worst:.3e}); card "
              f"{json.dumps(sides['card'][0][-1])}", flush=True)


def _free_disk_check(path: str, need: float) -> float:
    free = shutil.disk_usage(path).free
    if free < need:
        raise RuntimeError(f"{free / 1e9:.1f} GB free at {path}, the "
                           f"checkpoint needs {need / 1e9:.0f} GB")
    return free


def _same_leaves(torch, a, b) -> bool:
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def checkpoint_lm(torch, trainer) -> dict:
    """Phase 12, LM cell: ``save_trainer`` (tree format) of the trainer
    phase 11(b) left after its third round, to a fresh temporary
    directory (12 GB free asked first), timed, with the file's size; then
    ``restore_trainer`` into the same trainer, timed.  Every leaf must be
    bitwise the pre-save server's, the round kept, and the async versions
    reset to the restored model; one more round must run finitely."""
    from repro_torch.checkpoint.checkpoint import (restore_trainer,
                                                   save_trainer)
    tmp = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        free = _free_disk_check(tmp, 12e9)
        path = os.path.join(tmp, "gemma2-2b.ckpt")
        before = trainer.server
        t = time.perf_counter()
        save_trainer(path, trainer)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        restore_trainer(path, trainer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        restored = trainer.server
        if restored is before or restored.round != before.round or \
                not _same_leaves(torch, restored.complex, before.complex):
            raise RuntimeError("LM checkpoint: the restored server is not "
                               "the saved one bitwise")
        del before
        eng = trainer.async_engine
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.run_round()
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t
        if eng.versions()[1] is not restored.complex or \
                trainer.server.round != restored.round + 1 or not (
                    math.isfinite(m["loss_simple"])
                    and math.isfinite(m["loss_complex"])):
            raise RuntimeError(f"LM checkpoint: the round after the restore "
                               f"did not restart the versions from it: {m}")
        out = {"bytes": size, "save_s": save_s, "restore_s": restore_s,
               "free_gb": free / 1e9, "round_after_restore_s": round_s,
               "round": trainer.server.round, **m}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  LM checkpoint: " + json.dumps(out), flush=True)
    return out


def checkpoint_resnet(torch, trainer, shards) -> dict:
    """Phase 12, ResNet cell: tree and flat (f32 wire) trainer checkpoints
    of phase 11(a)'s f32 trainer restored into a fresh trainer, bitwise,
    each save and restore timed."""
    from repro_torch.checkpoint.checkpoint import (restore_trainer,
                                                   save_trainer)
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    out = {}
    tmp = tempfile.mkdtemp(prefix="resnet_ckpt_")
    try:
        for fmt in ("tree", "flat"):
            path = os.path.join(tmp, f"resnet_{fmt}.ckpt")
            t = time.perf_counter()
            save_trainer(path, trainer, fmt=fmt)
            save_s = time.perf_counter() - t
            fresh = FederatedTrainer(ResNetAdapter(10), trainer.fed, shards,
                                     device="cuda")
            t = time.perf_counter()
            restore_trainer(path, fresh, fmt=fmt)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            ok = (_same_leaves(torch, fresh.server.complex,
                               trainer.server.complex)
                  and fresh.server.round == trainer.server.round
                  and (fresh.client_state.array
                       == trainer.client_state.array).all())
            out[fmt] = {"bytes": os.path.getsize(path), "save_s": save_s,
                        "restore_s": restore_s, "bitwise": bool(ok)}
            print(f"  ResNet {fmt} checkpoint: {json.dumps(out[fmt])}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"ResNet {fmt} checkpoint: the restored "
                                   f"trainer differs")
            del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def resume_card(torch) -> dict:
    """Phase 12, narrow resume on the card: 2 rounds, ``save_trainer``,
    ``restore_trainer`` into a new trainer, 2 rounds, against one trainer
    run 4 rounds whose server is replaced at round 2 (what the restore
    does; an async run's versions restart there): attn4 async lag 1, and
    the ResNet narrow config with SCAFFOLD (``__cv_store__``) and with
    error feedback on the int8 wire (``__ef_store__``).  Bitwise, or held
    at rtol 1e-4 / atol 1e-5 with the largest difference reported."""
    import dataclasses
    from repro_torch.checkpoint.checkpoint import (restore_trainer,
                                                   save_trainer)
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import LMAdapter, ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    from repro_torch.data.federated import iid_split
    from repro_torch.data.synthetic import synthetic_cifar, synthetic_lm

    cfg = attn4_config()
    lm_shards = [{"tokens": s["tokens"]} for s in iid_split(
        synthetic_lm(32, 16, cfg.vocab_size, seed=0), 4, seed=1)]
    img_shards = iid_split(synthetic_cifar(32, 10, seed=0, image_size=16),
                           4, seed=1)
    runs = (("attn4 async lag 1", LMAdapter(cfg), lm_shards,
             dict(async_lag=1)),
            ("ResNet narrow SCAFFOLD", ResNetAdapter(10, (8, 16, 16, 16)),
             img_shards, dict(variance_reduction="scaffold")),
            ("ResNet narrow int8 EF", ResNetAdapter(10, (8, 16, 16, 16)),
             img_shards, dict(comm_dtype="int8", error_feedback=True)))
    out = {}
    tmp = tempfile.mkdtemp(prefix="resume_")
    try:
        for label, adapter, shards, kw in runs:
            make = lambda: FederatedTrainer(
                adapter, FedConfig(algorithm="fedhen", **NARROW_FED, **kw),
                shards, device="cuda",
                generator=torch.Generator().manual_seed(0))
            whole = make()
            ms_w = [whole.run_round() for _ in range(2)]
            whole.server = dataclasses.replace(whole.server)
            ms_w += [whole.run_round() for _ in range(2)]
            part = make()
            for _ in range(2):
                part.run_round()
            path = os.path.join(tmp, "narrow.ckpt")
            save_trainer(path, part)
            resumed = make()
            restore_trainer(path, resumed)
            ms_r = [resumed.run_round() for _ in range(2)]
            pairs = list(zip(_flat_server(resumed),
                             _flat_server(whole)))
            for store in ("cv_store", "ef_store"):
                if getattr(whole, store) is not None:
                    pairs.append((getattr(resumed, store).gather(range(4)),
                                  getattr(whole, store).gather(range(4))))
            if whole.cv_global is not None:
                pairs.append((resumed.cv_global, whole.cv_global))
            worst = _hold(f"resume {label}",
                          (ms_r, [a for a, _ in pairs]),
                          (ms_w[2:], [b for _, b in pairs]))
            bitwise = worst == 0.0 and ms_r == ms_w[2:]
            out[label] = {"bitwise": bitwise, "max_abs_diff": worst}
            print(f"  resume on the card, {label}: 2 + save + restore + 2 "
                  f"rounds against 4: "
                  + ("bitwise" if bitwise else f"max|diff| {worst:.3e}"),
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def serve_checkpoint(torch) -> tuple:
    """Phase 12, serving from a checkpoint: phase 8's narrow configs (f32
    and bf16) saved as bare params trees (``save_tree``) and restored by
    ``serve.load_params`` (the ``--checkpoint`` path) over a fresh draw
    from another seed: prefill logits (K5, K6) bitwise those of the
    in-memory params; then ``serve.main --checkpoint`` on the reduced
    gemma2-2b and recurrentgemma-2b.  Returns the launches of K5 (tensor
    cores, CUDA cores) and K6 over the phase."""
    from repro_torch import configs
    from repro_torch.checkpoint.checkpoint import save_tree
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import lru_scan, lru_scan_gated
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    flash_attention.launches_tc = flash_attention.launches = 0
    lru_scan.launches = lru_scan_gated.launches = 0
    tmp = tempfile.mkdtemp(prefix="serve_ckpt_")
    try:
        for dtype in ("float32", "bfloat16"):
            for cfg in _narrow_configs(dtype):
                path = os.path.join(tmp, f"{cfg.name}_{dtype}.npz")
                params = tfm.init_params(
                    torch.Generator("cuda").manual_seed(0), cfg)
                save_tree(path, params)
                restored = serve.load_params(cfg, 5, "cuda", path)
                toks = torch.randint(0, cfg.vocab_size, (2, 64),
                                     device="cuda",
                                     generator=torch.Generator("cuda")
                                     .manual_seed(1))
                with torch.inference_mode():
                    want, _ = tfm.prefill(params, cfg, toks)
                    got, _ = tfm.prefill(restored, cfg, toks)
                same = torch.equal(got, want)
                print(f"  {cfg.name} narrow {dtype} from a save_tree "
                      f"checkpoint: prefill logits "
                      + ("bitwise equal" if same else "DIFFER")
                      + " to the in-memory params'", flush=True)
                if not same:
                    raise RuntimeError(f"{cfg.name} {dtype}: restored "
                                       f"params serve other logits")
        for arch in ("gemma2-2b", "recurrentgemma-2b"):
            cfg = configs.get_reduced(arch)
            path = os.path.join(tmp, f"{arch}_reduced.npz")
            save_tree(path, tfm.init_params(
                torch.Generator("cuda").manual_seed(11), cfg))
            stats = serve.main(["--arch", arch, "--batch", "2",
                                "--prompt-len", "32", "--gen", "4",
                                "--checkpoint", path, "--device", "cuda"])
            print(f"  serve.main --arch {arch} --checkpoint: {stats}",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = (flash_attention.launches_tc, flash_attention.launches,
                lru_scan_gated.launches)
    print(f"  serving from checkpoints: K5 launches (tensor cores, CUDA "
          f"cores) {launched[:2]}, K6 {launched[2]} (all through the gated "
          f"entry; the plain entry {lru_scan.launches})", flush=True)
    if not all(launched) or lru_scan.launches:
        raise RuntimeError(f"serving from checkpoints launched K5/K6 "
                           f"{launched}, K6's plain entry "
                           f"{lru_scan.launches}: one never ran, or the "
                           f"model ran the plain entry")
    return launched


# -- phase 13: telemetry ------------------------------------------------------

LM_TEL_ROUNDS, LM_TEL_EVAL = 16, 4
LM_ROUND_BYTES = 33_107_097_600      # the LM cell's f32 wire, down + up
TEL_SERVE = (1, 8192, 8)             # phase 7's gemma2-2b cell: batch,
                                     # prompt, new tokens
EXIT_THRESHOLD = 0.3                 # the exit head's confidence threshold
OVERHEAD_ROUNDS = 4


def _resnet_trainer(shards, telemetry=None, **kw):
    """The ResNet round cell's f32 fedhen trainer (phase 4's config)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.core.federated import FederatedTrainer
    return FederatedTrainer(
        ResNetAdapter(10), FedConfig(algorithm="fedhen", **RESNET_FED, **kw),
        shards, device="cuda", telemetry=telemetry)


def _timed_rounds(torch, trainer, n: int) -> tuple:
    """``n`` rounds, each timed between two synchronizes: (metrics,
    walls)."""
    ms, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ms.append(trainer.run_round())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return ms, walls


def _run_of(torch, ops, trainer, rounds: int, per_round: tuple) -> tuple:
    """``rounds`` rounds of ``trainer`` with K1-K4's launches counted from
    0 and checked against ``per_round``: ((metrics, packed server, bytes),
    walls, launches)."""
    _zero_counts(ops)
    ms, walls = _timed_rounds(torch, trainer, rounds)
    launched = _counts(ops)
    want = tuple(rounds * n for n in per_round)
    if launched != want:
        raise RuntimeError(f"telemetry phase: launches K1/K2/K3/K4 "
                           f"{launched}, expected {want}")
    state = (ms, _flat_server(trainer),
             (trainer.total_bytes_down, trainer.total_bytes_up))
    return state, walls, launched


def _same_run(a: tuple, b: tuple) -> tuple:
    """(bitwise equal, params max|diff|) of two ``_run_of`` states."""
    diff = max(float((x - y).abs().max()) for x, y in zip(a[1], b[1]))
    return diff == 0.0 and a[0] == b[0] and a[2] == b[2], diff


def _add(total: tuple, launched: tuple) -> tuple:
    return tuple(x + y for x, y in zip(total, launched))


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def _check_log(torch, trainer, events, rounds: int, per_round: tuple
               ) -> dict:
    """Phase 13(c)'s checks of one JSONL run log against its trainer:
    ``summarize``'s round count and byte total, one ``execute`` span a
    round, one ``compile`` span, in round 0, and the health counters and
    ledgers against the trainer's state.  Returns the summary."""
    from repro_torch.obs import report
    s = report.summarize(events)
    h = s["health"]
    eng = trainer.async_engine
    spans = lambda name: [e["round"] for e in events
                          if e["kind"] == "span" and e["name"] == name]
    want = {
        "n_rounds": (s["rounds"]["n_rounds"], rounds),
        "cum_total": (s["comm"]["cum_total"], trainer.total_bytes),
        "execute rounds": (spans("execute"), list(range(rounds))),
        # the kernel library's load, on the card only
        "compile rounds": (spans("compile"),
                           [0] if trainer.device.type == "cuda" else []),
        "nan_excluded_devices": (h["nan_excluded_devices"], 0),
        "padding_weight0_clients": (h["padding_weight0_clients"], 0),
        "client_state_bytes": (h["client_state_bytes"],
                               trainer.client_state.nbytes),
        "participation_hist": (
            h["participation_hist"],
            trainer.client_state.participation_histogram()),
        "version cache": ((h["version_cache_hit"], h["version_cache_miss"]),
                          (eng.cache_hits, eng.cache_misses)
                          if eng is not None else (0, 0)),
    }
    if eng is not None:
        hist = {}
        for r in range(rounds):
            for v in list(eng.schedule(r)[0]) + list(eng.schedule(r)[1]):
                hist[str(int(v))] = hist.get(str(int(v)), 0) + 1
        want["staleness_hist"] = (h["staleness_hist"], hist)
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise RuntimeError(f"telemetry run log disagrees with its trainer: "
                           f"{bad}")
    return s


def _nondeterministic_op(torch, shards) -> dict:
    """The first ATen op whose outputs differ between two runs of one
    full-width complex client's first SGD step (forward and backward of
    ``loss_side`` over its first 50 images) from the same params, cuDNN
    as configured; ``None`` if the two op streams agree bitwise."""
    from repro_torch.core.adapters import ResNetAdapter
    from repro_torch.launch.probe_ce_fork import OpRecord, op_diff
    from repro_torch.tree import tree_leaves, tree_map
    adapter = ResNetAdapter(10)
    params = adapter.init(torch.Generator().manual_seed(0), "cuda")
    batch = {k: v[:50] for k, v in shards[-1].items()}
    runs = []
    for _ in range(2):
        p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                     params)
        with OpRecord(keep_on="cuda") as rec:
            loss = adapter.loss_side(p, batch)
            torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
        runs.append(rec.ops)
    for k, ((name, a), (_, b)) in enumerate(zip(*runs)):
        diffs = [op_diff(y.cpu(), x.cpu()) for x, y in zip(a, b)]
        if any(d for d, _ in diffs):
            return {"at": k, "of": len(runs[0]), "op": name,
                    "max_abs": max(d for d, _ in diffs),
                    "outside": sum(o for _, o in diffs),
                    "shapes": [list(x.shape) for x in a]}
    return None


def telemetry_resnet(torch, ops) -> tuple:
    """Phase 13 (a), (b), (c), (e) at the ResNet round cell (f32 fedhen,
    phase 4's configuration).  Returns (K1-K4 launches over them, the
    printed numbers)."""
    from repro_torch.obs import report
    from repro_torch.obs import telemetry as obslib

    shards, _ = resnet_cell_data(torch)
    out, total = {}, (0, 0, 0, 0)
    # (a) determinism: the same seed twice, no deterministic setting
    runs = []
    for _ in range(2):
        tr = _resnet_trainer(shards)
        state, walls, launched = _run_of(torch, ops, tr, 2, (2, 0, 0, 0))
        runs.append((state, walls))
        total = _add(total, launched)
        del tr
    bitwise, diff = _same_run(runs[0][0], runs[1][0])
    untraced = runs[0][1] + runs[1][1]
    out["determinism"] = {"bitwise": bitwise, "params_max_abs": diff,
                          "walls": untraced}
    print(f"  (a) ResNet f32 fedhen, 2 rounds twice from seed 0, cuDNN "
          f"as configured (deterministic={torch.backends.cudnn.deterministic}"
          f", benchmark={torch.backends.cudnn.benchmark}): "
          f"{'bitwise' if bitwise else 'NOT bitwise'}; params max|diff| "
          f"{diff:.3e}; metrics {runs[0][0][0]} / {runs[1][0][0]}; walls "
          f"{[round(w, 4) for w in untraced]}", flush=True)
    if not bitwise:
        out["determinism"]["first_op"] = first = _nondeterministic_op(
            torch, shards)
        print(f"  (a) one complex client's first step twice from the same "
              f"params: first op whose outputs differ {json.dumps(first)}",
              flush=True)
    # (b) a null sink steers nothing (under deterministic cuDNN if (a)
    # was not bitwise: otherwise the comparison could not be)
    with (contextlib.nullcontext() if bitwise else _Deterministic(torch)):
        off, null = (_resnet_trainer(shards, tel) for tel in (
            None, obslib.Telemetry([obslib.NullSink()])))
        (s_off, _, l_off), (s_null, _, l_null) = (
            _run_of(torch, ops, tr, 2, (2, 0, 0, 0)) for tr in (off, null))
    total = _add(_add(total, l_off), l_null)
    same, diff = _same_run(s_off, s_null)
    out["null_sink"] = {"bitwise": same, "params_max_abs": diff,
                        "deterministic_cudnn": not bitwise}
    cudnn = "cuDNN as configured" if bitwise else "under deterministic cuDNN"
    print(f"  (b) telemetry off against Telemetry([NullSink()]), 2 rounds "
          f"each, {cudnn}: {'bitwise' if same else 'NOT bitwise'} (params "
          f"max|diff| "
          f"{diff:.3e}; metrics {s_null[0]}; bytes {s_null[2]}; K1 "
          f"launches {l_off[0]} / {l_null[0]})", flush=True)
    if not same:
        raise RuntimeError(f"a null sink changed the round: params "
                           f"max|diff| {diff}, metrics {s_off[0]} / "
                           f"{s_null[0]}, bytes {s_off[2]} / {s_null[2]}")
    # (c) JSONL run logs, checked against their trainers
    tmp = tempfile.mkdtemp(prefix="telemetry_")
    try:
        out["logs"] = {}
        jsonl_tr = None
        for label, kw, per_round in (
                ("sync f32", {}, (2, 0, 0, 0)),
                ("async lag 1 tree", dict(async_lag=1, agg_engine="tree"),
                 (0, 0, 0, 2))):
            path = os.path.join(tmp, label.replace(" ", "_") + ".jsonl")
            tel = obslib.Telemetry([obslib.JsonlSink(path)])
            tr = _resnet_trainer(shards, tel, **kw)
            _, walls, launched = _run_of(torch, ops, tr, 2, per_round)
            total = _add(total, launched)
            tel.close()
            events = obslib.read_jsonl(path)
            s = _check_log(torch, tr, events, 2, per_round)
            text = report.render(s)
            keep = text[text.index("-- rounds --"):]
            print(f"  (c) {label}: {len(events)} events, checks passed; "
                  f"launches K1/K2/K3/K4 {launched}; execute median "
                  f"{s['rounds']['execute_median_s']:.4f} s beside an "
                  f"untraced round's {_median(untraced):.4f} s (a); "
                  f"compile (kernel library load) "
                  f"{s['rounds']['compile_s']:.4f} s; report:", flush=True)
            for ln in keep.splitlines():
                print("      " + ln, flush=True)
            out["logs"][label] = {
                "events": len(events), "walls": walls,
                "execute_median_s": s["rounds"]["execute_median_s"],
                "compile_s": s["rounds"]["compile_s"],
                "phase_wall": s["rounds"]["phase_wall"], "comm": s["comm"]}
            if label == "sync f32":
                jsonl_tr = tr
            else:
                del tr
        # (e) overhead: alternate rounds of the off trainer and an on one
        out["overhead"] = {}
        for label, on in (("null sink", null), ("jsonl sink", jsonl_tr)):
            w_off, w_on = [], []
            for _ in range(OVERHEAD_ROUNDS):
                for tr, walls in ((off, w_off), (on, w_on)):
                    _, w, launched = _run_of(torch, ops, tr, 1,
                                             (2, 0, 0, 0))
                    walls += w
                    total = _add(total, launched)
            out["overhead"][label] = {"off": w_off, "on": w_on}
            print(f"  (e) {label}: median round wall off "
                  f"{_median(w_off):.4f} s, on {_median(w_on):.4f} s "
                  f"({(_median(w_on) / _median(w_off) - 1) * 100:+.2f} %); "
                  f"off {[round(w, 4) for w in w_off]}, on "
                  f"{[round(w, 4) for w in w_on]}", flush=True)
        del off, null, jsonl_tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total, out


def telemetry_lm(torch, ops) -> tuple:
    """Phase 13 (d): the LM round cell (Gemma-2 2B at full width) with
    telemetry on, 16 fedhen rounds evaluated every 4, then its trained
    server model served at phase 7's gemma2-2b cell.  Returns (K1
    launches, tensor-core K5 launches, the printed numbers)."""
    import gc

    from repro_torch.data.synthetic import synthetic_lm
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import lm_cell as cell
    from repro_torch.launch.serve import generate
    from repro_torch.obs import telemetry as obslib

    # an async trainer and its engine refer to each other: only the
    # cycle collector frees an earlier phase's LM trainer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (d) {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the LM trainer is built", flush=True)
    shards = cell.shards("cuda")
    torch.cuda.reset_peak_memory_stats()
    mem = obslib.MemorySink()
    tr = cell.trainer(shards, "fedhen", device="cuda",
                      telemetry=obslib.Telemetry([mem]))
    _zero_counts(ops)
    t0 = time.perf_counter()
    tr.run(LM_TEL_ROUNDS, eval_every=LM_TEL_EVAL,
           test_batch=cell.test_batch())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _counts(ops)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rounds = [e["dur_s"] for e in mem.named("round")]
    execs = [e["dur_s"] for e in mem.named("execute")]
    ledgers = [e["values"] for e in mem.named("comm_bytes")]
    evals = [(e["round"], e["values"]) for e in mem.named("eval")]
    out = {"round_s": rounds, "execute_s": execs, "peak_gib": peak,
           "wall_s": wall, "launches": launched,
           "eval": [(r, {k: v[k] for k in ("loss_complex", "loss_simple",
                                           "acc_complex", "acc_simple")})
                    for r, v in evals]}
    print(f"  (d) Gemma-2 2B, {LM_TEL_ROUNDS} fedhen rounds with telemetry "
          f"in {wall:.2f} s: round walls {[round(x, 4) for x in rounds]}; "
          f"execute {[round(x, 4) for x in execs]}; peak {peak:.2f} GiB; "
          f"launches K1/K2/K3/K4 {launched}", flush=True)
    for r, v in out["eval"]:
        print(f"      eval after round {r}: {json.dumps(v)}", flush=True)
    for e in mem.named("log"):
        print("      " + e["message"], flush=True)
    bad_bytes = [i for i, led in enumerate(ledgers)
                 if led["down"] + led["up"] != LM_ROUND_BYTES]
    if launched != (2 * LM_TEL_ROUNDS, 0, 0, 0) or bad_bytes or \
            len(ledgers) != LM_TEL_ROUNDS or \
            ledgers[-1]["cum_total"] != tr.total_bytes or \
            len(evals) != LM_TEL_ROUNDS // LM_TEL_EVAL or not all(
                math.isfinite(v["loss_complex"]) for _, v in evals):
        raise RuntimeError(f"LM telemetry run: launches {launched}, rounds "
                           f"off the byte closed form {bad_bytes}, "
                           f"{len(ledgers)} byte ledgers, evals {evals}")
    params, cfg = tr.server.complex, tr.adapter.cfg
    del tr, shards, mem
    gc.collect()
    torch.cuda.empty_cache()
    # serve the trained model at phase 7's gemma2-2b cell
    batch, prompt, gen = TEL_SERVE
    prompts = {
        "synthetic_lm": torch.as_tensor(synthetic_lm(
            batch, prompt, cell.DATA_VOCAB, seed=7)["tokens"][:, :prompt]
        ).cuda(),
        "random": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                device="cuda", generator=torch.Generator(
                                    "cuda").manual_seed(1))}
    out["serve"] = []
    tc = 0
    for name, toks in prompts.items():
        for threshold in (0.0, EXIT_THRESHOLD):
            flash_attention.launches_tc = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            tokens, stats = generate(params, cfg, toks, gen,
                                     adaptive_threshold=threshold)
            torch.cuda.synchronize()
            row = {"prompt": name, "threshold": threshold,
                   "s": time.perf_counter() - t,
                   "k5_launches": flash_attention.launches_tc, **stats}
            print("      serve " + json.dumps(row), flush=True)
            if tuple(tokens.shape) != (batch, prompt + gen) or \
                    row["k5_launches"] != SERVE_RUNS[1][4][0]:
                raise RuntimeError(f"serving the trained model: {row}")
            tc += row["k5_launches"]
            out["serve"].append(row)
    del params, prompts
    torch.cuda.empty_cache()
    return launched[0], tc, out


def telemetry_phase(torch, ops) -> tuple:
    """Phase 13: telemetry on the card.  Returns (K1-K4 launches over the
    phase, tensor-core K5 launches, the printed numbers)."""
    t = time.perf_counter()
    total, out = telemetry_resnet(torch, ops)
    lm_k1, k5, out["lm"] = telemetry_lm(torch, ops)
    total = (total[0] + lm_k1,) + total[1:]
    print(f"  telemetry phase launches K1/K2/K3/K4 {total}, K5 (tensor "
          f"cores) {k5}, in {time.perf_counter() - t:.1f} s", flush=True)
    if not (total[0] and total[3]):
        raise RuntimeError(f"telemetry path launches K1/K2/K3/K4 {total}: "
                           f"K1 or K4 never ran")
    return total, k5, out


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
    name_of_card = torch.cuda.get_device_name(0)
    bw, part = memory_rate(name_of_card)
    print("[1] card", flush=True)
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name_of_card}; bounds at {part} HBM {bw / 1e12:.2f} TB/s",
          flush=True)
    # 2. build
    print("[2] build", flush=True)
    t = time.perf_counter()
    res = build.build()
    print(f"  {res.path.name} in {res.seconds:.1f} s", flush=True)
    for ln in res.log.splitlines():
        if ln.startswith("==") or "registers" in ln or "spill" in ln:
            print("  " + ln.strip(), flush=True)
    print(f"  build total {time.perf_counter() - t:.1f} s", flush=True)
    # 3. the kernels against their plain versions
    print("[3] kernels vs plain PyTorch on the card", flush=True)
    k1 = check_masked_agg(torch, ops, ref, bw)
    mask = main_path_layout(torch)[1]
    k2 = check_deq(torch, ops, ref, bw, mask)
    k3 = check_scatter(torch, ops, ref, bw, mask)
    k4 = check_tree_fold(torch, ops, ref, bw)
    # 4. main path
    print("[4] main path: full-width PreActResNet18-GN rounds", flush=True)
    path = main_path(torch, ops)
    # 5. card vs CPU
    print("[5] card vs CPU", flush=True)
    card_vs_cpu(torch)
    # 6. the serving kernels
    print("[6] serving kernels vs plain PyTorch on the card", flush=True)
    k5 = check_flash(torch, bw)
    k6 = check_scan(torch, bw)
    # 7. full-width serving
    print("[7] full-width serving: recurrentgemma-2b and gemma2-2b",
          flush=True)
    serve_path = serving(torch)
    # 8. narrow serving, card vs CPU, decode vs prefill
    print("[8] narrow serving: card vs CPU, decode vs prefill", flush=True)
    narrow = serving_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    # 9. the full-width LM round cell
    print("[9] LM round cell: Gemma-2 2B federated training at full width",
          flush=True)
    lm = lm_cell(torch, ops, ref, bw)
    # 10. narrow LM rounds, card vs CPU
    print("[10] narrow LM rounds: card vs CPU", flush=True)
    lm_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    # 11. async rounds
    print("[11] async rounds: the ResNet and LM cells, narrow card vs CPU",
          flush=True)
    async_launches, resnet_tr, resnet_shards = async_resnet(torch, ops)
    lm_k1, lm_tr, _ = async_lm(torch, ops)
    async_launches = (async_launches[0] + lm_k1,) + async_launches[1:]
    if not all(async_launches):
        raise RuntimeError(f"async path launches K1/K2/K3/K4 "
                           f"{async_launches}: a kernel never ran")
    async_card_vs_cpu(torch)
    # 12. checkpoints
    print("[12] checkpoints: the LM and ResNet cells, narrow resume, "
          "serving from a checkpoint", flush=True)
    checkpoint_lm(torch, lm_tr)
    del lm_tr
    torch.cuda.empty_cache()
    checkpoint_resnet(torch, resnet_tr, resnet_shards)
    del resnet_tr, resnet_shards
    resume_card(torch)
    serve_launches = serve_checkpoint(torch)
    torch.cuda.empty_cache()
    # 13. telemetry
    print("[13] telemetry: determinism, null sink, run logs, Gemma-2 2B "
          "trained and served, overhead", flush=True)
    tel_launches, tel_k5, _ = telemetry_phase(torch, ops)
    gc.collect()
    torch.cuda.empty_cache()
    # 14. full-width serving of the dense configs
    print("[14] full-width serving: gemma3-4b, minitron-8b, starcoder2-15b",
          flush=True)
    dense_path = serving(torch, DENSE_SERVE_RUNS)
    torch.cuda.empty_cache()
    # 15. full-width serving of the MoE configs
    print("[15] full-width serving: qwen2-moe-a2.7b, kimi-k2-1t-a32b at "
          "published widths (depth 1)", flush=True)
    moe_path = serving(torch, MOE_SERVE_RUNS)

    src = "src/repro_torch/kernels/masked_agg/csrc/"
    kernels = []
    for (name, source, line, shape), result, launches in zip(
            (("masked_agg_acc", "masked_agg_acc.cu", 106,
              {"Z": Z, "N": N_MAIN, "x": "float32", "fold": "complex"}),
             ("masked_agg_acc_deq", "masked_agg_acc_deq.cu", 160,
              {"Z": Z, "N": N_MAIN, "quant_block": QB, "fold": "complex"}),
             ("masked_scatter_acc", "masked_scatter_acc.cu", 248,
              {"Z": Z, "N": N_MAIN, "k": K_COMPLEX, "values": "int8",
               "fold": "complex", "bound": "32-byte sectors touched"}),
             ("masked_agg", "masked_agg.cu", 69,
              {"Z": Z, "N": k4["timing"][0]["N"], "x": "float32",
               "fold": "tree fold, 59 leaves accumulated, one launch"})),
            (k1, k2, k3, k4), path["launches"]):
        head = result["timing"][0]     # the complex fold / the tree fold
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": f"src/repro/kernels/masked_agg/kernel.py:{line}",
            "launches": launches, "max_abs_err": result["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": shape,
            "bound_share": head["bound_share"], "folds": result["timing"]})
    for kernel, launches in zip(kernels, async_launches):
        kernel["launches_async"] = launches
        kernel["launches_async_path"] = "phase 11: async rounds"
    for kernel, launches in zip(kernels, tel_launches):
        kernel["launches_telemetry"] = launches
        kernel["launches_telemetry_path"] = ("phase 13: rounds with "
                                             "telemetry")
    for i, key, fold in ((0, "k1", "complex"),
                         (3, "k4", "tree fold, every leaf, one launch")):
        head = lm[key]["timing"][0]     # the complex client's fold
        kernels[i]["launches_lm"] = lm["launches"][0 if key == "k1" else 1]
        kernels[i]["lm"] = {
            "shape": {"Z": 1, "N": lm[key]["N"], "x": "float32",
                      "fold": fold, "mask": "gemma2-2b index set M"},
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_share": head["bound_share"], "max_abs_err": 0.0,
            "folds": lm[key]["timing"]}
    k5_src = "src/repro_torch/kernels/flash_attention/csrc/"
    k5_replaces = "src/repro/kernels/flash_attention/kernel.py:83"
    for name, source, dtype, launches, path in (
            ("flash_attention_wgmma", "flash_attention_wgmma.cu", "bfloat16",
             serve_path["launches"][0], "phase 7: full-width bf16 serving"),
            ("flash_attention", "flash_attention.cu", "float32",
             narrow["float32"][1], "phase 8: narrow f32 serving on the "
             "card")):
        rows = [r for r in k5["timing"] if r["shape"]["dtype"] == dtype]
        head = rows[0]     # the recurrentgemma-2b prefill shape
        kernels.append({
            "name": name, "route": "cuda", "source": k5_src + source,
            "replaces": k5_replaces, "launches": launches,
            "launches_path": path,
            "max_abs_err": k5["max_abs_err"][dtype], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "bound_share": head["bound_share"],
            "tflops": head["tflops"], "cases": rows})
    kernels[-2]["launches_checkpoint"] = serve_launches[0]
    kernels[-1]["launches_checkpoint"] = serve_launches[1]
    kernels[-2]["launches_telemetry"] = tel_k5
    kernels[-2]["launches_telemetry_path"] = ("phase 13: serving the "
                                              "trained Gemma-2 2B")
    kernels[-2]["launches_dense"] = dense_path["launches"][0]
    kernels[-2]["launches_dense_path"] = ("phase 14: full-width serving of "
                                          "gemma3-4b, minitron-8b and "
                                          "starcoder2-15b")
    kernels[-2]["launches_moe"] = moe_path["launches"][0]
    kernels[-2]["launches_moe_path"] = ("phase 15: full-width serving of "
                                        "qwen2-moe-a2.7b and kimi-k2 "
                                        "(depth 1, Dh 112)")
    # K6 as the model's paths launch it: through the gated entry only
    # (phases 7 and 12 check it); the plain entry's own case beside it,
    # which no path launches
    gated = next(r for r in k6["timing"] if r["entry"] == "lru_scan_gated")
    plain = next(r for r in k6["timing"] if r["entry"] == "lru_scan")
    kernels.append({
        "name": "lru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:52",
        "entry": "lru_scan_gated", "launches": serve_path["launches_gated"],
        "launches_path": "phase 7: full-width bf16 serving",
        "max_abs_err": k6["max_abs_err"], "ms": gated["ms"],
        "plain_ms": gated["plain_ms"], "bound_ms": gated["bound_ms"],
        "bound_by": gated["bound_by"], "library_ms": gated["library_ms"],
        "library_note": "the unfused composition the gated entry "
        "replaces: rglru._gates (PyTorch ops), K6's plain entry, the cast "
        "to bf16", "shape": gated["shape"],
        "bound_share": gated["bound_share"],
        "launches_checkpoint": serve_launches[2],
        "launches_checkpoint_path": "phase 12: serving from save_tree "
        "checkpoints",
        "cases": [gated, dict(plain, launches=serve_path["launches"][2]
                              - serve_path["launches_gated"],
                              launches_note="ops.lru_scan(a, b): no model "
                              "path launches it; the tests and phase 6's "
                              "composition call it")]})
    for kernel in kernels[-3:-1]:
        kernel["launches_checkpoint_path"] = ("phase 12: serving from "
                                              "save_tree checkpoints")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name_of_card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
